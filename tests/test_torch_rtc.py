"""``mx.rtc`` in the PyTorch port (mxnet_tpu_torch) vs the JAX package, on
the CPU.

The same body text and the same numpy inputs from a seed go through the
JAX package's ``Rtc`` (a Pallas kernel, in interpret mode on the CPU) and
the port's (its plain PyTorch version on the CPU), within rtol 1e-6: the
bodies are elementwise float32, so only the transcendental functions'
last bits may differ. Where a sum of such terms, each of magnitude ~1,
cancels toward 0, one ulp of a term is the error that remains: atol is
2**-22, two ulps at 1.0. Also: the bodies the port refuses, its build cache
(one build per body, whatever the shape), and the CUDA source its code
generator writes, checked as text (correctly rounded intrinsics, no fast
math, NaN-propagating maximum and minimum): the kernel itself runs only on
the card, through ``chip_smoke.py``.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels import rtc as K
from mxnet_tpu_torch.kernels import rtc_codegen, stream

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


def _fake_launch(monkeypatch):
    """The launcher with the build replaced by a counter: a CPU builds
    and launches nothing."""
    built = []

    def build(ck):
        built.append(ck.digest)
        return lambda *args: 0
    monkeypatch.setattr(K, "_build", build)
    monkeypatch.setattr(K, "_LIBS", {})
    monkeypatch.setattr(K, "_CALLS", {})
    return built


def test_second_push_with_the_same_key_does_not_rebuild(monkeypatch):
    """One build per body: a second key of the same body (another shape,
    other addresses mod 16, another device) prepares a new launch and
    reuses the library; another body builds once more."""
    built = _fake_launch(monkeypatch)
    compiles = K.rtc_kernel.compiles
    ck = rtc_codegen.check_kernel("def k(x_ref, o_ref):\n"
                                  "    o_ref[...] = x_ref[...] ** 2\n")
    key = (ck.digest, 8 * 128, 0, (0, 0))
    first = K._prepare(ck, key)
    assert K._CALLS[key] is first
    for other in [(ck.digest, 4 * 128, 0, (0, 0)),
                  (ck.digest, 8 * 128, 0, (4, 8)),
                  (ck.digest, 8 * 128, 1, (0, 0))]:
        call = K._prepare(ck, other)
        assert call.fn is first.fn and call.plan != first.plan
    assert built == [ck.digest]
    ck2 = rtc_codegen.check_kernel("def k(x_ref, o_ref):\n"
                                   "    o_ref[...] = x_ref[...] ** 3\n")
    K._prepare(ck2, (ck2.digest, 8 * 128, 0, (0, 0)))
    assert built == [ck.digest, ck2.digest]
    assert K.rtc_kernel.compiles == compiles + 2


def test_prepared_launch_packs_pointers_and_plan(monkeypatch):
    """The pointer array holds the inputs then the outputs, and the
    packed plan is ``stream.plan`` of the key."""
    _fake_launch(monkeypatch)
    ck = rtc_codegen.check_kernel(
        "def _kernel(x_ref, y_ref, s_ref, d_ref):\n"
        "    s_ref[...] = x_ref[...] + y_ref[...]\n"
        "    d_ref[...] = x_ref[...] - y_ref[...]\n", n_in=2)
    call = K._prepare(ck, (ck.digest, 1000, 0, (8, 0, 8, 4)))
    assert call.outs - call.ins == 16 and len(call.ptrs) == 4
    assert tuple(call.packed) == stream.plan(
        1000, (8, 0, 8, 4), 2, 2).packed()
    aligned = K._prepare(ck, (ck.digest, 1000, 0, (0,) * 4))
    assert tuple(aligned.packed) == stream.plan(
        1000, (0,) * 4, 2, 2).packed()
    assert call.plan == ctypes.addressof(call.packed)
    assert aligned.fn is call.fn
    assert tuple(aligned.packed) != tuple(call.packed)


@pytest.mark.parametrize("err", [0, 700])
def test_launch_passes_pointers_device_and_stream(monkeypatch, err):
    """A launch hands the C entry the pointer arrays, n, the packed plan,
    the refs' device and that device's current stream, counts itself,
    and raises on a CUDA error without counting."""
    _fake_launch(monkeypatch)
    seen = []
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 1000 + dev, raising=False)
    ck = rtc_codegen.check_kernel("def k(x_ref, y_ref, o_ref):\n"
                                  "    o_ref[...] = x_ref[...] + y_ref[...]\n")
    call = K._prepare(ck, (ck.digest, 64, 3, (0,) * 3))

    def fn(*args):
        seen.append((list(call.ptrs),) + args)
        return err
    call = call._replace(fn=fn)
    launches = K.rtc_kernel.launches
    if err:
        with pytest.raises(tmx.MXNetError, match="CUDA error 700"):
            K._launch(call, [16, 32, 48], 64, 3)
    else:
        K._launch(call, [16, 32, 48], 64, 3)
    assert seen == [([16, 32, 48], call.ins, call.outs, 64, call.plan, 3,
                     1003)]
    assert K.rtc_kernel.launches == launches + (0 if err else 1)


def test_build_source_file_is_written_once(monkeypatch, tmp_path):
    monkeypatch.setattr(K, "_BUILD_DIR", str(tmp_path))
    path = K._write_source("A = 1\n", "rtc_x")
    assert open(path).read() == "A = 1\n"
    K._write_source("A = 2\n", "rtc_x")
    assert open(path).read() == "A = 1\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rtc_x"]
    assert sorted(p.name for p in (tmp_path / "rtc_x").iterdir()) == \
        ["rtc.cu"]


def test_build_is_named_by_the_body_not_the_shape(monkeypatch, tmp_path):
    """``_build`` writes ``build/rtc/<digest>/rtc.cu`` and asks nvcc for
    ``librtc.so`` beside it, with the numerics flags; the digest covers
    the generated text, so the same body always lands in one place."""
    monkeypatch.setattr(K, "_BUILD_DIR", str(tmp_path))
    asked = []

    class Lib(object):
        mx_rtc = type("F", (), {})()

    def nvcc(src, lib_path, flags):
        asked.append((src, lib_path, flags))
        return Lib()
    monkeypatch.setattr(K.build, "nvcc_library", nvcc)
    ck = rtc_codegen.check_kernel("def k(x_ref, o_ref):\n"
                                  "    o_ref[...] = x_ref[...] * 3.0\n")
    K._build(ck)
    K._build(ck)
    (src, lib_path, flags), again = asked
    assert again == asked[0]
    assert os.path.dirname(src) == os.path.dirname(lib_path)
    assert os.path.basename(lib_path) == "librtc.so"
    assert open(src).read() == rtc_codegen.cuda_source(ck)
    assert {"-fmad=false", "-prec-div=true", "-prec-sqrt=true"} <= set(flags)
    assert "--use_fast_math" not in flags
    assert len(os.listdir(tmp_path)) == 1


AXPY_CUDA = '''\
struct Body {
  static constexpr int kIn = 2;
  static constexpr int kOut = 1;
  static __device__ __forceinline__ void apply(const float* in, float* out) {
    const float in0 = in[0];
    const float in1 = in[1];
    float out0 = __fadd_rn(__fmul_rn(in0, 2.0f), in1);
    out[0] = out0;
  }
};

}  // namespace

extern "C" int mx_rtc(const float* const* ins, float* const* outs,
                      long long n, const long long* plan, int device,
                      void* stream) {
  return mxstream::launch_rtc<Body>(ins, outs, n, plan, device, stream);
}
'''


def test_codegen_axpy_source_is_golden():
    _, _, body = BODIES["axpy"]
    ck = rtc_codegen.check_kernel(
        "def _kernel(x_ref, y_ref, z_ref):\n    %s\n" % body, n_in=2)
    src = rtc_codegen.cuda_source(ck)
    assert src.endswith(AXPY_CUDA)
    assert src.count('#include "stream.cuh"') == 1
    assert "//         z_ref[...] = x_ref[...] * 2.0 + y_ref[...]\n" in src
    # two roundings, as the plain version's two torch ops: no fma
    assert "fmaf(" not in src and "__fmaf" not in src


def test_codegen_lowers_powers_and_functions():
    ck = rtc_codegen.check_kernel(
        "def k(x_ref, o_ref):\n"
        "    o_ref[...] = jnp.tanh(x_ref[...]) ** 3 + jnp.sqrt(x_ref[...])\n")
    src = rtc_codegen.cuda_source(ck)
    assert "**" not in src
    # lax.integer_pow's square-and-multiply: x * (x * x)
    t = "tanhf(in0)"
    assert "__fmul_rn(%s, __fmul_rn(%s, %s))" % (t, t, t) in src
    assert "__fsqrt_rn(in0)" in src
    for fn, spelled in [("exp", "expf(in0)"), ("log", "logf(in0)"),
                        ("abs", "fabsf(in0)")]:
        ck = rtc_codegen.check_kernel(
            "def k(x_ref, o_ref):\n    o_ref[...] = jnp.%s(x_ref[...])\n"
            % fn)
        assert "float out0 = %s;" % spelled in rtc_codegen.cuda_source(ck)


def test_codegen_maximum_and_minimum_propagate_nan():
    ck = rtc_codegen.check_kernel(
        "def k(x_ref, y_ref, o_ref):\n"
        "    o_ref[...] = jnp.maximum(x_ref[...], y_ref[...]) "
        "- jnp.minimum(x_ref[...], 0.5)\n")
    src = rtc_codegen.cuda_source(ck)
    assert "__fsub_rn(mx_maximum(in0, in1), mx_minimum(in0, 0.5f))" in src
    for name, fn in (("mx_maximum", "fmaxf"), ("mx_minimum", "fminf")):
        body = src[src.index("float %s(" % name):]
        body = body[:body.index("}")]
        # NaN in either argument is the result; fmaxf/fminf drop it
        assert "a != a ? a : (b != b ? b : %s(a, b))" % fn in body


def test_codegen_constants_round_as_the_plain_version():
    """A Python constant meets a float32 array as the float torch makes
    of it; constant arithmetic stays in double, as Python's; comparisons
    compare floats; locals keep their kind."""
    ck = rtc_codegen.check_kernel(
        "def k(x_ref, o_ref):\n"
        "    c = 0.1 * 3.0\n"
        "    m = x_ref[...] > c\n"
        "    t = x_ref[...] - 0.1\n"
        "    t = t * t\n"
        "    o_ref[...] = jnp.where(m, t, -c) / 1e40\n")
    src = rtc_codegen.cuda_source(ck)
    assert "double s_c = (0.1 * 3.0);" in src
    assert "bool m_m = (in0 > (float)s_c);" in src
    assert "float v_t = __fsub_rn(in0, 0.1f);" in src
    assert "    v_t = __fmul_rn(v_t, v_t);" in src
    # 1e40 overflows float32 to inf, as torch's cast of the scalar does
    assert "float out0 = __fdiv_rn((m_m ? v_t : (float)(-s_c)), " \
        "__int_as_float(0x7f800000));" in src


@pytest.mark.parametrize("name", sorted(BODIES))
def test_codegen_uses_no_fast_math(name):
    in_names, out_names, body = BODIES[name]
    ck = rtc_codegen.check_kernel(
        "def _kernel(%s):\n%s\n" % (
            ", ".join("%s_ref" % n for n in in_names + out_names),
            "".join("    %s\n" % line for line in body.splitlines())),
        n_in=len(in_names))
    src = rtc_codegen.cuda_source(ck)
    for fast in ("__expf", "__logf", "__fdividef", "__tanhf", "__sinf",
                 "__powf", "__fmaf", "use_fast_math"):
        assert fast not in src, fast
    assert src.count("out[") == len(out_names)
    assert "kIn = %d;" % len(in_names) in src


@pytest.mark.parametrize("nvcc", ["/nonexistent/bin/nvcc", "false"])
def test_failed_build_raises(monkeypatch, tmp_path, nvcc):
    """No nvcc, or nvcc failing, raises MXNetError and leaves no library
    behind; nothing falls back."""
    monkeypatch.setattr(K.build, "_nvcc", lambda: nvcc)
    src = tmp_path / "k.cu"
    src.write_text("int x;\n")
    lib = tmp_path / "out" / "libk.so"
    with pytest.raises(tmx.MXNetError):
        K.build.nvcc_library(str(src), str(lib))
    assert not lib.exists()


def test_build_digest_covers_text_and_flags():
    d = K.build.digest("A", ())
    assert d == K.build.digest("A", ()) and len(d) == 64
    assert d != K.build.digest("B", ())
    assert d != K.build.digest("A", K.FLAGS)
