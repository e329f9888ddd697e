"""Launch plans of the BatchNorm(+ReLU) CUDA kernels, and the backward
without dx, on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` phase 3).
Here: ``plan`` picks block, cluster or split for every BatchNorm of a
ResNet-50 step at batch 32 and of a resnet-20 step at batch 128 (the
CIFAR twin) as the slab table of ``kernels/batchnorm.py`` says, and for
the zoo's inception-bn, inception-v3, inception-resnet-v2 and resnext-50
at batch 32 the plans a step takes, by kind and unit; stays within one
H100 block's shared memory and the portable cluster sizes (every zoo
shape), and flags planes that cannot move in 16-byte units; the
per-channel buffer the wrapper hands the kernels keeps the split scratch
16-byte aligned. The backward without dx gives dβ and dγ of the full call
(and of the JAX VJP with respect to γ and β only, the work the JAX step
does). Tolerance of the JAX comparison as in ``test_torch_batchnorm.py``.
"""
import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.nn import _bn_train_core

import chip_smoke
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels import batchnorm as K
from mxnet_tpu_torch.ops.nn import bn_train_core

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 2e-5
F32, BF16 = torch.float32, torch.bfloat16

# plane side -> (forward plan, backward plan) at batch 32, as (kind, k)
WANT = {
    F32: {224: (("split", 1), ("split", 1)),
          112: (("cluster", 8), ("split", 1)),
          56: (("cluster", 2), ("cluster", 4)),
          28: (("block", 1), ("block", 1)),
          14: (("block", 1), ("block", 1)),
          7: (("block", 1), ("block", 1))},
    BF16: {224: (("split", 1), ("split", 1)),
           112: (("cluster", 4), ("cluster", 8)),
           56: (("block", 1), ("cluster", 2)),
           28: (("block", 1), ("block", 1)),
           14: (("block", 1), ("block", 1)),
           7: (("block", 1), ("block", 1))},
}


# resnet-20 at batch 128: a 28² channel's slab is 401,408 bytes of f32
# (two of them in the backward), over one block's 231,424
WANT_128 = {
    F32: {28: (("cluster", 2), ("cluster", 4)),
          14: (("block", 1), ("block", 1)),
          7: (("block", 1), ("block", 1))},
    BF16: {28: (("block", 1), ("cluster", 2)),
           14: (("block", 1), ("block", 1)),
           7: (("block", 1), ("block", 1))},
}


def _resnet50_shapes():
    counts = chip_smoke.model_bn_shapes(tmx, "resnet-50", (3, 224, 224),
                                        1000, 32)
    assert sum(counts.values()) == 51
    return sorted(counts)


def _resnet20_shapes():
    counts = chip_smoke.model_bn_shapes(tmx, "resnet-20", (3, 28, 28), 10,
                                        128)
    assert sum(counts.values()) == 20
    return sorted(counts)


RESNET50 = _resnet50_shapes()
RESNET20 = _resnet20_shapes()


# The zoo's BatchNorms at batch 32 and published input, after the
# BN+ReLU fusion: (image, BatchNorms a step, fused with ReLU, plans by
# (kind, unit bytes) and the calls of a step that take each).
ZOO = {
    "inception-bn": ((3, 224, 224), 69, 69, {
        F32: {"fwd": {"block.16": 50, "block.4": 16, "cluster.16": 3},
              "bwd": {"block.16": 50, "block.4": 16, "cluster.16": 2,
                      "split.16": 1}},
        BF16: {"fwd": {"block.16": 19, "block.4": 33, "block.2": 16,
                       "cluster.16": 1},
               "bwd": {"block.16": 17, "block.4": 33, "block.2": 16,
                       "cluster.16": 3}}}),
    "inception-v3": ((3, 299, 299), 94, 94, {
        F32: {"fwd": {"block.4": 69, "block.16": 20, "cluster.4": 2,
                      "split.4": 3},
              "bwd": {"block.4": 46, "cluster.4": 25, "block.16": 20,
                      "split.4": 3}},
        BF16: {"fwd": {"block.2": 69, "block.16": 20, "cluster.2": 5},
               "bwd": {"block.2": 69, "block.16": 20, "cluster.2": 2,
                       "split.2": 3}}}),
    "inception-resnet-v2": ((3, 299, 299), 114, 114, {
        F32: {"fwd": {"block.4": 85, "block.16": 24, "cluster.4": 2,
                      "split.4": 3},
              "bwd": {"cluster.4": 41, "block.4": 46, "block.16": 24,
                      "split.4": 3}},
        BF16: {"fwd": {"block.2": 85, "block.16": 24, "cluster.2": 5},
               "bwd": {"block.2": 85, "block.16": 24, "cluster.2": 2,
                       "split.2": 3}}}),
    "resnext-50": ((3, 224, 224), 54, 33, {
        F32: {"fwd": {"block.16": 32, "cluster.16": 12, "block.4": 9,
                      "split.16": 1},
              "bwd": {"block.16": 32, "cluster.16": 11, "block.4": 9,
                      "split.16": 2}},
        BF16: {"fwd": {"block.16": 24, "block.4": 19, "block.2": 9,
                       "cluster.16": 1, "split.16": 1},
               "bwd": {"block.16": 13, "block.4": 19, "block.2": 9,
                       "cluster.16": 12, "split.16": 1}}}),
}


def _zoo_shapes(network):
    image = ZOO[network][0]
    return chip_smoke.model_bn_shapes(tmx, network, image, 1000, 32)


ZOO_SHAPES = {net: _zoo_shapes(net) for net in ZOO}


@pytest.mark.parametrize("network", sorted(ZOO))
def test_zoo_plans_by_kind_and_unit(network):
    """Each network's BatchNorm calls a step, by plan: odd planes (149²,
    147², 73², 71², 35², 17², 7²) move as 4-byte (float32) or 2-byte
    (bfloat16) units."""
    _, n_bn, n_relu, want = ZOO[network]
    counts = ZOO_SHAPES[network]
    assert sum(counts.values()) == n_bn
    assert sum(n for k, n in counts.items() if k[2]) == n_relu
    for dtype in (F32, BF16):
        for op in ("fwd", "bwd"):
            got = {}
            for (shape, _, _, need_dx), n in counts.items():
                p = K.plan(op, shape, dtype, need_dx)
                key = "%s.%d" % (p.kind, p.unit_bytes)
                got[key] = got.get(key, 0) + n
            assert got == want[dtype][op], (dtype, op)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("network", sorted(ZOO))
def test_zoo_plans_stay_within_one_block_and_the_clusters(network, dtype):
    """At every zoo shape (channel counts such as 48, 80, 96, 160, 192,
    224, 288, 320, 384, 448 and 1536 among them) the plan fits one
    block's shared memory, uses a portable cluster, and covers the
    channel's units exactly once."""
    es = 4 if dtype == F32 else 2
    for shape, _, _, need_dx in ZOO_SHAPES[network]:
        for op in ("fwd", "bwd"):
            p = K.plan(op, shape, dtype, need_dx)
            units = shape[0] * shape[2] * shape[3] * es // p.unit_bytes
            assert units * p.unit_bytes == shape[0] * shape[2] * \
                shape[3] * es
            assert p.smem <= K.SMEM_BYTES - 1024
            assert p.cluster in (1, 2, 4, 8)
            assert 128 <= p.threads <= 1024 and p.threads % 32 == 0
            if p.kind == "split":
                assert p.smem == 0 and p.chunks * p.share >= units
                assert (p.chunks - 1) * p.share < units
            else:
                kept = 1 if op == "fwd" else (2 if need_dx else 0)
                assert p.chunks == 1 and p.cluster * p.share >= units
                assert p.smem == p.share * p.unit_bytes * kept


def test_only_the_data_batchnorm_skips_dx():
    no_dx = [k for k in RESNET50 if not k[3]]
    assert [k[0] for k in no_dx] == [(32, 3, 224, 224)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("key", RESNET50 + RESNET20,
                         ids=["x".join(map(str, k[0]))
                              + ("-fixg" if k[1] else "")
                              + ("-relu" if k[2] else "")
                              + ("" if k[3] else "-nodx")
                              for k in RESNET50 + RESNET20])
def test_plan_follows_the_slab_table(key, dtype):
    shape, _, _, need_dx = key
    fwd, bwd = (WANT if shape[0] == 32 else WANT_128)[dtype][shape[2]]
    pf = K.plan("fwd", shape, dtype)
    pb = K.plan("bwd", shape, dtype, need_dx)
    assert (pf.kind, pf.cluster) == fwd
    assert (pb.kind, pb.cluster) == bwd
    es = 4 if dtype == F32 else 2
    for p, arrays in ((pf, 1), (pb, 2 if need_dx else 0)):
        units = shape[0] * shape[2] * shape[3] * es // p.unit_bytes
        assert p.smem <= K.SMEM_BYTES - 1024
        assert p.cluster in (1, 2, 4, 8)
        assert 128 <= p.threads <= 1024 and p.threads % 32 == 0
        if p.kind == "split":
            assert p.smem == 0 and p.chunks * p.share >= units
            assert (p.chunks - 1) * p.share < units
        else:
            assert p.chunks == 1 and p.cluster * p.share >= units
            assert p.smem == p.share * p.unit_bytes * arrays


@pytest.mark.parametrize("shape,dtype,unit_bytes", [
    ((32, 2048, 7, 7), F32, 4),      # 196-byte planes at c·196
    ((32, 2048, 7, 7), BF16, 2),
    ((32, 1024, 14, 14), F32, 16),
    ((32, 1024, 14, 14), BF16, 4),   # 392-byte planes
    ((32, 512, 28, 28), BF16, 16),
    ((5, 3, 17, 13), F32, 4),
    ((5, 3, 17, 13), BF16, 2),
    ((4, 6), F32, 4),                # (N, C): one element a plane
])
def test_unaligned_planes_are_flagged(shape, dtype, unit_bytes):
    for op in ("fwd", "bwd"):
        p = K.plan(op, shape, dtype)
        assert p.unit_bytes == unit_bytes
        assert p.aligned == (unit_bytes == 16)


def test_misaligned_pointers_narrow_the_unit():
    assert K.plan("fwd", (32, 64, 56, 56), F32, align=16).unit_bytes == 16
    assert K.plan("fwd", (32, 64, 56, 56), F32, align=8).unit_bytes == 4
    assert K.plan("fwd", (32, 64, 56, 56), BF16, align=2).unit_bytes == 2


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(tmx.MXNetError):
        K.plan("both", (2, 3, 4, 4), F32)
    with pytest.raises(tmx.MXNetError):
        K.plan("fwd", (2, 3, 4, 4), torch.float16)


@pytest.mark.parametrize("op,flag,shape", [
    ("fwd", False, (32, 3, 224, 224)),
    ("fwd", True, (32, 3, 224, 224)),
    ("bwd", True, (32, 3, 224, 224)),
    ("bwd", False, (32, 3, 224, 224)),
    ("fwd", False, (32, 64, 56, 56)),
    ("bwd", True, (32, 256, 14, 14)),
    ("fwd", True, (5, 3, 17, 13)),
    # inception-v3's and inception-resnet-v2's split plans on odd planes
    ("bwd", True, (32, 32, 149, 149)),
    ("fwd", False, (32, 64, 147, 147)),
    ("fwd", True, (32, 64, 147, 147)),
])
def test_call_packs_the_plan_and_aligns_the_scratch(op, flag, shape):
    x = torch.empty(shape, device="meta")
    call = K._call(op, x, flag, 16)
    p = K.plan(op, shape, F32, need_dx=flag if op == "bwd" else True)
    C = shape[1]
    results = 5 if op == "fwd" else 2
    parts = 2 if (op == "fwd" and flag) else 1
    if p.kind == "split":
        # 2·C·chunks floats (twice under exact) from a 16-byte boundary
        assert call.rows == call.scratch_row + 2 * p.chunks * parts
        assert call.scratch_row >= results
        assert (4 * call.scratch_row * C) % 16 == 0
    else:
        assert call.rows == results
    assert list(call.ints) == [0, p.unit_bytes, {"block": 0, "cluster": 1,
                                                 "split": 2}[p.kind],
                               p.cluster, p.threads, p.smem, p.share,
                               p.chunks, shape[0], C, shape[2] * shape[3]]
    assert K._call(op, x, flag, 16) is call


@pytest.mark.parametrize("ptrs,want", [((256,), 16), ((256, 1024 + 8), 8),
                                       ((2, 16), 2), ((0,), 16)])
def test_alignment_of_addresses(ptrs, want):
    assert K._align(*ptrs) == want


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    C = shape[1]
    x = (rs.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (rs.rand(C) + 0.5).astype(np.float32)
    beta = (rs.randn(C) * 0.1).astype(np.float32)
    c = (rs.randn(C) * 0.1).astype(np.float32)
    dout = rs.randn(*shape).astype(np.float32)
    return x, gamma, beta, c, dout


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_backward_without_dx_matches_the_full_call(relu, dtype):
    x, gamma, beta, c, dout = _inputs((3, 5, 4, 6), seed=5)
    tx = torch.tensor(x).to(dtype)
    _, mean, _, rstd, scale, shift = K.bn_fwd(
        tx, torch.tensor(gamma), torch.tensor(beta), torch.tensor(c), EPS,
        False, relu, False)
    du = torch.tensor(dout).to(dtype)
    full = K.bn_bwd(du, tx, rstd, mean, scale, shift, relu)
    part = K.bn_bwd(du, tx, rstd, mean, scale, shift, relu, need_dx=False)
    assert full[0] is not None and part[0] is None
    assert torch.equal(part[1], full[1]) and torch.equal(part[2], full[2])


@pytest.mark.parametrize("relu", [False, True])
def test_core_skips_dx_and_matches_jax_parameter_vjp(relu):
    """x without a gradient (the data's BatchNorm): the core returns none
    for x, and dγ, dβ agree with JAX's VJP taken with respect to γ and β
    only."""
    shape = (4, 8, 5, 7)
    x, gamma, beta, c, dout = _inputs(shape, seed=21)

    def jcore(g, b):
        return _bn_train_core(jnp.asarray(x), g, b, jnp.asarray(c), EPS,
                              False, relu)

    _, vjp = jax.vjp(jcore, jnp.asarray(gamma), jnp.asarray(beta))
    C = shape[1]
    jdg, jdb = vjp((jnp.asarray(dout), jnp.zeros(C), jnp.zeros(C)))
    tx = torch.tensor(x)
    tg = torch.tensor(gamma, requires_grad=True)
    tb = torch.tensor(beta, requires_grad=True)
    ty, _, _ = bn_train_core(tx, tg, tb, torch.tensor(c), EPS, False, relu)
    ty.backward(torch.tensor(dout))
    assert tx.grad is None
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jdg),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb),
                               rtol=1e-5, atol=1e-6)


def test_bn_path_imports_no_triton():
    for rel in ("kernels/batchnorm.py", "kernels/build.py", "ops/nn.py"):
        path = os.path.join(ROOT, "mxnet_tpu_torch", rel)
        tree = ast.parse(open(path).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m.split(".")[0] == "triton"], rel
    assert not os.path.exists(os.path.join(
        ROOT, "mxnet_tpu_torch", "kernels", "batchnorm_triton.py"))
