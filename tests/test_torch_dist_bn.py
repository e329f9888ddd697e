"""The cross-rank split of the BatchNorm(+ReLU) core (the four entry
points of ``kernels/batchnorm.py`` beside K1's one-call pair), with their
plain versions on the CPU.

Two ranks are two threads here, each holding half of the batch's rows,
with a reducer that sums a (C, 2) tensor over both (what the runtime's
all-reduce does across processes): the split forward and backward then
equal the whole-batch ``bn_fwd_plain`` and ``bn_bwd_plain`` within 1e-5
relative (float32 sums taken in another order), in the one-pass and the
exact statistics, with and without the fused ReLU. The training core
takes the split only inside a ``cross_rank_bn`` scope of two or more
ranks; the rank's dγ and dβ are its own partial sums.
"""
import threading

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import batchnorm as K
from mxnet_tpu_torch.ops import nn as tnn

REL = 1e-5
EPS = 1e-3


class _PairReducer:
    """Two threads' (C, 2) tensors summed in rank order, in place."""

    def __init__(self, world):
        self.world = world
        self.slots = [None] * world
        self.barrier = threading.Barrier(world)
        self.calls = 0

    def for_rank(self, rank):
        def reduce_(t):
            self.slots[rank] = t.clone()
            self.barrier.wait()
            total = self.slots[0].clone()
            for s in self.slots[1:]:
                total += s
            self.barrier.wait()
            t.copy_(total)
            if rank == 0:
                self.calls += 1
            return t
        return reduce_


def _inputs(shape=(8, 6, 5, 5), seed=0):
    rng = np.random.RandomState(seed)
    c = shape[1]
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    return (f(*shape) * 2 + 1, f(*shape), torch.from_numpy(
        rng.uniform(0.5, 1.5, c).astype(np.float32)), f(c) * 0.1,
        f(c) * 0.1)


def _relerr(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(b.abs().max(), 1e-30))


def _run_ranks(world, fn):
    out = [None] * world
    errs = []

    def body(r):
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in
               range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    return out


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_two_rank_split_equals_whole_batch(exact, relu, fix_gamma):
    x, du, gamma, beta, c = _inputs()
    world = 2
    red = _PairReducer(world)
    halves = list(x.chunk(world)), list(du.chunk(world))
    ref = K.bn_fwd_plain(x, gamma, beta, c, EPS, fix_gamma, relu, exact)
    fwd = _run_ranks(world, lambda r: K.bn_fwd_split(
        halves[0][r], gamma, beta, c, EPS, fix_gamma, relu, exact,
        red.for_rank(r), world))
    assert red.calls == (2 if exact else 1)
    y = torch.cat([f[0] for f in fwd])
    assert _relerr(y, ref[0]) < REL
    for r in range(world):
        for i in range(1, 6):       # mean, var, rstd, scale, shift
            assert _relerr(fwd[r][i], ref[i]) < REL, i
    _, mean, var, rstd, scale, shift = ref
    dref = K.bn_bwd_plain(du, x, rstd, mean, scale, shift, relu, True)
    red.calls = 0
    bwd = _run_ranks(world, lambda r: K.bn_bwd_split(
        halves[1][r], halves[0][r], rstd, mean, scale, shift, relu, True,
        red.for_rank(r), world))
    assert red.calls == 1
    dx = torch.cat([b[0] for b in bwd])
    assert _relerr(dx, dref[0]) < REL
    # the ranks' own partials add up to the whole batch's dβ and dγ
    assert _relerr(bwd[0][1] + bwd[1][1], dref[1]) < REL
    assert _relerr(bwd[0][2] + bwd[1][2], dref[2]) < REL
    # without dx: no reduction, only the rank's partials
    red.calls = 0
    nodx = K.bn_bwd_split(halves[1][0], halves[0][0], rstd, mean, scale,
                          shift, relu, False, red.for_rank(0), world)
    assert nodx[0] is None and red.calls == 0
    assert torch.equal(nodx[1], bwd[0][1])


def test_entry_points_plain_on_cpu_and_counted_nowhere():
    x, du, gamma, beta, c = _inputs(seed=3)
    counts = [f.launches for f in (K.bn_fwd_partials, K.bn_fwd_apply,
                                   K.bn_bwd_partials, K.bn_bwd_dx)]
    s = K.bn_fwd_partials(x, c)
    assert s.shape == (6, 2) and s.dtype == torch.float32
    assert torch.equal(s, K.bn_fwd_partials_plain(x, c))
    n = float(x.numel() // 6)
    y, mean, var, rstd, scale, shift = K.bn_fwd_apply(
        x, s, c, gamma, beta, EPS, n, False, True, False)
    want = K.bn_fwd_plain(x, gamma, beta, c, EPS, False, True, False)
    assert _relerr(y, want[0]) < REL
    g = K.bn_bwd_partials(du, x, mean, rstd, scale, shift, True)
    dx = K.bn_bwd_dx(du, x, mean, rstd, scale, shift, g, n, True)
    dwant = K.bn_bwd_plain(du, x, rstd, mean, scale, shift, True)
    assert _relerr(dx, dwant[0]) < REL
    assert counts == [f.launches for f in (K.bn_fwd_partials,
                                           K.bn_fwd_apply, K.bn_bwd_partials,
                                           K.bn_bwd_dx)]
    assert K.SPLIT_KERNELS == ("bn_fwd_partials", "bn_fwd_apply",
                               "bn_bwd_partials", "bn_bwd_dx")
    # the split plan the entry points run on, at ResNet-50's BN shapes
    for shape in ((32, 64, 112, 112), (32, 256, 56, 56), (32, 2048, 7, 7)):
        p = K.plan("fwd", shape, torch.bfloat16, split=True)
        assert p.kind == "split" and p.threads == K.SPLIT_THREADS
        assert p.chunks * p.share * p.unit_bytes >= \
            shape[0] * shape[2] * shape[3] * 2


class _Rt:
    """A stand-in runtime of ``size`` ranks for the core's route."""

    def __init__(self, size, reduce_):
        self.size = size
        self.allreduce_ = reduce_


@pytest.mark.parametrize("exact", [False, True])
def test_training_core_routes(exact, monkeypatch):
    """Outside a scope, or in a world of one, the core is K1's pair, bit
    for bit. In a two-rank scope it takes the split: with both ranks
    holding the same rows (the reduction doubles each sum) the global
    batch's statistics are this batch's, so y, dx, dγ and dβ equal the
    one-process core's within 1e-5, and the split entry points ran."""
    if exact:
        monkeypatch.setenv("MXNET_BN_EXACT_STATS", "1")
    x, du, gamma, beta, c = _inputs(seed=5)

    def core():
        xx = x.clone().requires_grad_(True)
        g = gamma.clone().requires_grad_(True)
        b = beta.clone().requires_grad_(True)
        y, mean, var = tnn.bn_train_core(xx, g, b, c, EPS, False, True)
        torch.autograd.backward(y, du)
        return y.detach(), xx.grad, g.grad, b.grad, mean, var

    base = core()
    with tnn.cross_rank_bn(_Rt(1, None)):
        one = core()
    for a, b in zip(base, one):
        assert torch.equal(a, b)
    calls = []
    for name in ("bn_fwd_split", "bn_bwd_split"):
        real = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    reductions = []

    def double(t):
        reductions.append(tuple(t.shape))
        return t.mul_(2.0)

    with tnn.cross_rank_bn(_Rt(2, double)):
        split = core()
    assert tnn._CROSS_RANK[0] is None
    assert calls == ["bn_fwd_split", "bn_bwd_split"]
    assert reductions == [(6, 2)] * (3 if exact else 2)
    for a, b in zip(split, base):
        assert _relerr(a, b) < REL
