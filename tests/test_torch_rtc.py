"""``mx.rtc`` in the PyTorch port (mxnet_tpu_torch) vs the JAX package, on
the CPU.

The same body text and the same numpy inputs from a seed go through the
JAX package's ``Rtc`` (a Pallas kernel, in interpret mode on the CPU) and
the port's (its plain PyTorch version on the CPU), within rtol 1e-6: the
bodies are elementwise float32, so only the transcendental functions'
last bits may differ. Where a sum of such terms, each of magnitude ~1,
cancels toward 0, one ulp of a term is the error that remains: atol is
2**-22, two ulps at 1.0. Also: the bodies the port refuses, its build cache,
and the Triton source its code generator writes (checked as text: the
kernel itself runs only on the card, through ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels import rtc as K
from mxnet_tpu_torch.kernels import rtc_codegen

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 2.0 ** -22

# name -> (input names, output names, body)
BODIES = {
    # tests/test_sequence_loss.py:72 and :83
    "axpy": (["x", "y"], ["z"], "z_ref[...] = x_ref[...] * 2.0 + y_ref[...]"),
    "square": (["x"], ["o"], "o_ref[...] = x_ref[...] ** 2"),
    "exp_tanh": (["x", "y"], ["o"],
                 "o_ref[...] = jnp.exp(-x_ref[...] * x_ref[...]) "
                 "+ jnp.tanh(y_ref[...])"),
    "where_max": (["x", "y"], ["o"],
                  "o_ref[...] = jnp.where(x_ref[...] > 0.0, "
                  "jnp.maximum(x_ref[...], y_ref[...]), y_ref[...] * 0.5)"),
    "two_outputs": (["x", "y"], ["s", "d"],
                    "t = x_ref[...] - y_ref[...]\n"
                    "s_ref[...] = x_ref[...] + y_ref[...]\n"
                    "d_ref[...] = t * t"),
    "constant": (["x"], ["o"],
                 "c = 0.25\no_ref[...] = 3.0 - x_ref[...] * c"),
    "log_sqrt_abs_min": (["x", "y"], ["o"],
                         "a = jnp.abs(x_ref[...])\n"
                         "o_ref[...] = jnp.log(a + 1.0) + jnp.sqrt(a) "
                         "- jnp.minimum(y_ref[...], a) / (a + 2.0) "
                         "+ y_ref[...] ** 5"),
}


def _inputs(names, shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in names]


def _push(pkg, ctx, ins_np, in_names, out_names, body):
    ins = [pkg.nd.array(v, ctx=ctx) for v in ins_np]
    outs = [pkg.nd.zeros(ins_np[0].shape, ctx=ctx) for _ in out_names]
    rtc = pkg.rtc.Rtc("k", list(zip(in_names, ins)),
                      list(zip(out_names, outs)), body)
    rtc.push(ins, outs, (1, 1, 1), (1, 1, 1))
    return [o.asnumpy() for o in outs]


@pytest.mark.parametrize("name", sorted(BODIES))
def test_rtc_body_matches_jax(name):
    in_names, out_names, body = BODIES[name]
    ins = _inputs(in_names, (8, 128), sorted(BODIES).index(name))
    want = _push(jmx, jmx.cpu(), ins, in_names, out_names, body)
    got = _push(tmx, tmx.cpu(), ins, in_names, out_names, body)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_ref_kernel_matches_jax_pallas_kernel():
    """The callable form (``PallasKernel`` in both packages)."""
    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...] ** 2

    x = _inputs(["x"], (4, 128), 11)[0]
    (want,) = jmx.rtc.PallasKernel(kern)([jmx.nd.array(x)], [(4, 128)])
    pk = tmx.rtc.PallasKernel(kern)
    assert pk.__class__ is tmx.rtc.RefKernel
    (got,) = pk([tmx.nd.array(x, ctx=tmx.cpu())], [(4, 128)])
    assert got.context == tmx.cpu()
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=RTOL)


REFUSED = {
    "sum": "z_ref[...] = jnp.sum(x_ref[...]) + y_ref[...]",
    "dot": "z_ref[...] = jnp.dot(x_ref[...], y_ref[...])",
    "slicing": "z_ref[...] = x_ref[0] + y_ref[...]",
    "slice_store": "z_ref[0:4] = x_ref[...]",
    "fractional_power": "z_ref[...] = x_ref[...] ** 0.5",
    "array_power": "z_ref[...] = x_ref[...] ** y_ref[...]",
    "store_mask": "z_ref[...] = x_ref[...] > y_ref[...]",
    "store_constant": "z_ref[...] = 2.0",
    "write_input": "x_ref[...] = y_ref[...]\nz_ref[...] = y_ref[...]",
    "no_output": "t = x_ref[...]",
    "aug_assign": "z_ref[...] = x_ref[...]\nz_ref[...] += y_ref[...]",
    "free_name": "z_ref[...] = x_ref[...] * scale",
    "other_call": "z_ref[...] = np.exp(x_ref[...])",
    "loop": "for i in range(2):\n    z_ref[...] = x_ref[...]",
    "read_output_first": "z_ref[...] = z_ref[...] + x_ref[...]",
    "syntax": "z_ref[...] = (x_ref[...]",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_rtc_refuses_bodies_outside_the_subset(name):
    x = tmx.nd.zeros((4, 8), ctx=tmx.cpu())
    with pytest.raises(tmx.MXNetError):
        tmx.rtc.Rtc("bad", [("x", x), ("y", x)], [("z", x)], REFUSED[name])


@pytest.mark.parametrize("case", ["float64", "bfloat16", "shapes"])
def test_rtc_refuses_other_dtypes_and_shapes(case):
    ctx = tmx.cpu()
    x = tmx.nd.zeros((4, 8), ctx=ctx)
    other = {"float64": tmx.nd.zeros((4, 8), ctx=ctx, dtype="float64"),
             "bfloat16": tmx.nd.zeros((4, 8), ctx=ctx, dtype="bfloat16"),
             "shapes": tmx.nd.zeros((4, 1), ctx=ctx)}[case]
    body = "z_ref[...] = x_ref[...] + y_ref[...]"
    with pytest.raises(tmx.MXNetError):
        tmx.rtc.Rtc("bad", [("x", x), ("y", other)], [("z", x)], body)
    # the same refusal at push, for the callable form
    pk = tmx.rtc.RefKernel("def k(x_ref, y_ref, z_ref):\n    " + body)
    with pytest.raises(tmx.MXNetError):
        pk([x, other], [(4, 8)])


def test_rtc_refuses_inputs_on_two_devices():
    pk = tmx.rtc.RefKernel("def k(x_ref, y_ref, z_ref):\n"
                           "    z_ref[...] = x_ref[...] + y_ref[...]")
    x = tmx.nd.zeros((4, 8), ctx=tmx.cpu())
    meta = torch.zeros((4, 8), device="meta")
    with pytest.raises(tmx.MXNetError):
        pk([x, meta], [(4, 8)])


def test_second_push_with_the_same_key_does_not_rebuild(monkeypatch):
    """The launcher's cache, with the Triton build replaced by a counter
    (a CPU cannot build Triton kernels)."""
    built = []
    monkeypatch.setattr(K, "_build_triton",
                        lambda ck, key: built.append(key) or object())
    monkeypatch.setattr(K, "_BUILT", {})
    ck = rtc_codegen.check_kernel("def k(x_ref, o_ref):\n"
                                  "    o_ref[...] = x_ref[...] ** 2\n")
    key = (ck.digest, (8, 128), 1, 1, "cuda:0")
    first = K._launcher(ck, key)
    assert K._launcher(ck, key) is first
    K._launcher(ck, key[:1] + ((4, 128),) + key[2:])
    assert len(built) == 2


def test_build_source_file_is_written_once(monkeypatch, tmp_path):
    monkeypatch.setattr(K, "_BUILD_DIR", str(tmp_path))
    path = K._write_source("A = 1\n", "rtc_x")
    assert open(path).read() == "A = 1\n"
    K._write_source("A = 2\n", "rtc_x")
    assert open(path).read() == "A = 1\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rtc_x.py"]


AXPY_TRITON = '''\
import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def rtc_kernel(in0_ptr, in1_ptr, out0_ptr, N: tl.constexpr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < N
    in0 = tl.load(in0_ptr + offs, mask=mask)
    in1 = tl.load(in1_ptr + offs, mask=mask)
    out0 = ((in0 * 2.0) + in1)
    tl.store(out0_ptr + offs, out0, mask=mask)
'''


def test_codegen_axpy_source_is_golden():
    _, _, body = BODIES["axpy"]
    ck = rtc_codegen.check_kernel(
        "def _kernel(x_ref, y_ref, z_ref):\n    %s\n" % body, n_in=2)
    src = rtc_codegen.triton_source(ck)
    assert src.endswith(AXPY_TRITON)
    assert src.count("tl.load(") == 2 and src.count("mask=mask)") == 3
    assert src.count("tl.store(") == 1
    compile(src, "<generated>", "exec")     # valid Python


def test_codegen_lowers_powers_and_functions():
    ck = rtc_codegen.check_kernel(
        "def k(x_ref, o_ref):\n"
        "    o_ref[...] = jnp.tanh(x_ref[...]) ** 3 + jnp.sqrt(x_ref[...])\n")
    src = rtc_codegen.triton_source(ck)
    assert "**" not in src
    # lax.integer_pow's square-and-multiply: x * (x * x)
    t = "libdevice.tanh(in0)"
    assert "(%s * (%s * %s))" % (t, t, t) in src
    assert "tl.sqrt_rn(in0)" in src
    compile(src, "<generated>", "exec")
