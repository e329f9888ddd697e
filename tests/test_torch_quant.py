"""The port's quantized precision modes (``mxnet_tpu_torch.precision.quant``
and the seams that consult it) against the JAX package's
(``mxnet_tpu.precision.quant``) on the CPU, with the same numpy inputs.

The JAX package on the CPU takes its native paths here (its capability
probes report int8 dot, int8 convolution and fp8 dot available), so the
reference is the exact int32 accumulation, not its fake-quant fallback.

Bit for bit: ``quantize_weight``/``quantize_params`` (q and s, the
zero-channel guard included), ``dequant_params``, ``tree_bytes``,
``fake_cast`` int8 and fp8 in float32 and bfloat16 (NaN positions
included: the e4m3 cast gives NaN above 464 and for non-finite input, as
``ml_dtypes`` does), ``to_e4m3``, the int8 products' int32 accumulators
against numpy, and the ``CalibrationTable`` JSON and digest across the two
packages.

Within a tolerance (relative to the reference's max-abs):

* ``narrow_dot`` and ``narrow_conv`` int8: 1e-6 (the integer sums are
  exact in both; the float32 rescale is the same three roundings);
* ``narrow_dot`` fp8: 1e-5 (exact e4m3 products, float32 sums in another
  order); ``narrow_conv`` fp8: 1e-5 (float32 convolutions of the same
  round-tripped operands);
* ``int8_serve`` Predictor rows: 1e-5 of the JAX package's
  ``int8_serve`` rows from the same table (a JAX-made table served by the
  port, so the site names must follow the same order), and within
  ``tolerance_check``'s 0.05 of the port's f32 rows;
* ``fp8_native`` rows: 5e-2 of the JAX package's (bfloat16 compute
  through four layers: a float32 sum in another order rounds to the
  neighbouring bfloat16, which can move the next e4m3 cast a whole step
  of 2^-3; the port and the JAX package each lie ~0.075 from their own
  f32 rows here), no further from the port's f32 rows than twice the JAX
  package's distance from its own, and within 0.1 of f32;
* ``int8_weight`` decode: the first step's logits within 1e-5 of the JAX
  engine's under the same mode; weight bytes equal to the JAX engine's.

``calibrate`` on ``tests/test_quant.py``'s MLP gives the JAX package's
sites and ranges. A range may differ only where a site's amax lies
within float32 rounding of a bucket edge; the test names such a site in
its failure instead of choosing a seed that avoids one.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JNameManager
from mxnet_tpu.precision import fake_cast as jfake_cast
from mxnet_tpu.precision import quant as jq
from mxnet_tpu.serving import decode as jdec
from mxnet_tpu.serving.predictor import Predictor as JPredictor

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.precision import MODES, fake_cast, quant, to_e4m3
from mxnet_tpu_torch.serving import decode as tdec
from mxnet_tpu_torch.serving.predictor import Predictor

torch.set_num_threads(2)

CPU = tmx.cpu()
INT8_REL = 1e-6
FP8_REL = 1e-5
ROWS_REL = 1e-5
FP8_ROWS_REL = 5e-2


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _same_bits(got, want):
    """Equal bit for bit, NaN positions included."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    gn, wn = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(got[~gn].view(np.uint32 if got.itemsize
                                                == 4 else np.uint16),
                                  want[~wn].view(np.uint32 if want.itemsize
                                                 == 4 else np.uint16))


def _crossing(shape, seed, scale=300.0):
    """float32 values crossing ±464 with the edge cases written in."""
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    flat = x.reshape(-1)
    flat[:12] = [448, 449, 463.9, 464, 464.1, 465, 500, 1e4, -1e4, -464,
                 -465, 0.0]
    flat[12:15] = [np.inf, -np.inf, np.nan]
    flat[15:18] = [2.0 ** -9, 2.0 ** -10, -3.0 * 2.0 ** -11]
    return x


# ------------------------------------------------------------ weights
def test_quantize_weight_and_params_bit_for_bit():
    rs = np.random.RandomState(0)
    w2 = rs.randn(8, 12).astype(np.float32)
    w2[3] = 0.0                                  # the zero-channel guard
    w4 = (rs.randn(6, 3, 3, 3) * 0.2).astype(np.float32)
    w4[0] = 0.0
    w1 = rs.randn(5).astype(np.float32)
    for arr in (w2, w4, w1):
        (tq_, ts), (jq_, js) = quant.quantize_weight(arr), \
            jq.quantize_weight(arr)
        np.testing.assert_array_equal(tq_, jq_)
        _same_bits(ts, js)
        assert tq_.dtype == np.int8 and ts.dtype == np.float32
    assert np.all(quant.quantize_weight(w2)[0][3] == 0)
    assert quant.quantize_weight(w2)[1][3] == 1.0
    params = {"w": w2, "k": w4, "b": w1, "idx": np.arange(4, dtype=np.int32)}
    tparams = dict(params, w=torch.from_numpy(w2),
                   k=tmx.nd.array(w4, ctx=CPU))
    tt, jt = quant.quantize_params(tparams), jq.quantize_params(params)
    assert sorted(tt) == sorted(jt)
    for k in jt:
        assert quant.is_quantized(tt[k]) == jq.is_quantized(jt[k])
        if jq.is_quantized(jt[k]):
            np.testing.assert_array_equal(tt[k].q, jt[k].q)
            _same_bits(tt[k].s, jt[k].s)
        else:
            np.testing.assert_array_equal(tt[k], jt[k])
    assert quant.tree_bytes(tt) == jq.tree_bytes(jt)
    staged = {k: quant.QuantLeaf(torch.from_numpy(v.q), torch.from_numpy(v.s))
              if quant.is_quantized(v) else torch.from_numpy(v)
              for k, v in tt.items()}
    assert quant.tree_bytes(staged) == jq.tree_bytes(jt)
    dt = quant.dequant_params(staged, torch.float32)
    dj = jq.dequant_params(jnp, jt, jnp.float32)
    for k in dj:
        _same_bits(dt[k].numpy(), np.asarray(dj[k]))


# ------------------------------------------------------------ fake_cast
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_cast_bit_for_bit(kind, dtype):
    x = _crossing((16, 37), seed=1)
    for case in (x, np.zeros((4, 5), np.float32), x * 1e-3,
                 np.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)):
        tx = torch.from_numpy(case).to(getattr(torch, dtype))
        jx = jnp.asarray(case).astype(getattr(jnp, dtype))
        got = fake_cast(tx, kind).float().numpy()
        want = np.asarray(jfake_cast(jnp, jx, kind).astype(jnp.float32))
        _same_bits(got, want)
        if not np.isnan(case).any() and np.abs(case).max() <= 464:
            assert np.isfinite(got).all()


def test_to_e4m3_nan_rule_matches_ml_dtypes():
    import ml_dtypes
    x = _crossing((64, 32), seed=2)
    got = to_e4m3(torch.from_numpy(x)).float().numpy()
    want = x.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    _same_bits(got, want)
    assert np.isnan(got).sum() == np.isnan(want).sum() > 3
    edge = torch.tensor([448.0, 449.0, 464.0, 500.0, 1e4, -1e4,
                         float("inf")])
    np.testing.assert_array_equal(
        np.isnan(to_e4m3(edge).float().numpy()),
        [False, False, False, True, True, True, True])


# ------------------------------------------------------------ the GEMMs
@pytest.mark.parametrize("M,K,N", [(1, 7, 5), (3, 64, 10), (17, 9, 3),
                                   (40, 128, 24)])
def test_int8_mm_exact(M, K, N):
    """The padded product (rows to 17, depth and width to multiples of 8)
    equals numpy's int64 product bit for bit."""
    rs = np.random.RandomState(M + K + N)
    a = rs.randint(-127, 128, (M, K)).astype(np.int8)
    b = rs.randint(-127, 128, (N, K)).astype(np.int8)
    got = quant.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)


def _policy(narrow, ranges=None):
    table_t = None if ranges is None else quant.CalibrationTable(ranges)
    table_j = None if ranges is None else jq.CalibrationTable(ranges)
    return (tmx.precision.PrecisionPolicy(narrow_math=narrow,
                                          calibration=table_t),
            jmx.precision.PrecisionPolicy(narrow_math=narrow,
                                          calibration=table_j))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 32])
def test_narrow_dot_int8(static, rows):
    rs = np.random.RandomState(rows)
    x = rs.randn(rows, 50).astype(np.float32)
    w = (rs.randn(20, 50) * 0.1).astype(np.float32)
    w[4] = 0.0
    tp, jp = _policy("int8", {"fc0": 1.7} if static else None)
    with quant.trace_gemm_scope(tp):
        got = quant.narrow_dot(torch.from_numpy(x), torch.from_numpy(w))
    with jq.trace_gemm_scope(jp):
        want = jq.narrow_dot(jnp, lax, jnp.asarray(x), jnp.asarray(w),
                             lax.Precision.HIGHEST)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= INT8_REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_dot_fp8(dtype):
    rs = np.random.RandomState(5)
    x = (rs.randn(6, 40) * 3).astype(np.float32)
    w = (rs.randn(12, 40) * 0.3).astype(np.float32)
    tp, jp = _policy("fp8")
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    with quant.trace_gemm_scope(tp):
        got = quant.narrow_dot(tx, tw)
    with jq.trace_gemm_scope(jp):
        want = jq.narrow_dot(jnp, lax, jnp.asarray(x).astype(dtype),
                             jnp.asarray(w).astype(dtype),
                             lax.Precision.HIGHEST)
    assert got.dtype == tx.dtype
    tol = FP8_REL if dtype == "float32" else 2.0 ** -8
    assert _rel(got.float().numpy(),
                np.asarray(want.astype(jnp.float32))) <= tol


def _jax_conv_kwargs(nd, stride, pad, dilate, groups, xshape, wshape):
    spec = {1: ("NCH", "OIH", "NCH"), 2: ("NCHW", "OIHW", "NCHW"),
            3: ("NCDHW", "OIDHW", "NCDHW")}[nd]
    dn = lax.conv_dimension_numbers(xshape, wshape, spec)
    return dict(window_strides=stride, padding=[(p, p) for p in pad],
                rhs_dilation=dilate, dimension_numbers=dn,
                feature_group_count=groups, precision=lax.Precision.HIGHEST)


CONV_CASES = [
    # (x shape, w shape, stride, pad, dilate, groups)
    ((2, 3, 11), (4, 3, 3), (2,), (1,), (1,), 1),
    ((2, 4, 9), (6, 2, 3), (1,), (2,), (2,), 2),
    ((1, 3, 12, 10), (8, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1),
    ((3, 8, 7, 7), (8, 2, 3, 3), (1, 1), (1, 1), (1, 1), 4),
    ((2, 4, 9, 8), (6, 4, 3, 3), (1, 2), (2, 1), (2, 2), 1),
    ((2, 16, 5, 5), (12, 16, 1, 1), (2, 2), (0, 0), (1, 1), 1),
    ((1, 2, 5, 6, 6), (4, 2, 3, 3, 3), (1, 2, 2), (1, 1, 1), (1, 1, 1), 1),
]


@pytest.mark.parametrize("case", range(len(CONV_CASES)))
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_narrow_conv(case, kind):
    xs, ws, stride, pad, dilate, groups = CONV_CASES[case]
    rs = np.random.RandomState(case)
    x = rs.randn(*xs).astype(np.float32)
    w = (rs.randn(*ws) * 0.2).astype(np.float32)
    w[1] = 0.0
    nd = len(xs) - 2
    tp, jp = _policy(kind, {"conv0": 2.5} if case % 2 else None)
    with quant.trace_gemm_scope(tp):
        got = quant.narrow_conv(torch.from_numpy(x), torch.from_numpy(w),
                                dict(stride=stride, padding=pad,
                                     dilation=dilate, groups=groups))
    with jq.trace_gemm_scope(jp):
        want = jq.narrow_conv(jnp, lax, jnp.asarray(x), jnp.asarray(w),
                              _jax_conv_kwargs(nd, stride, pad, dilate,
                                               groups, xs, ws))
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.numpy(), want) <= (INT8_REL if kind == "int8"
                                       else FP8_REL)


def test_int8_conv_accumulator_exact():
    """``int8_conv``'s int32 output equals the JAX package's int8
    convolution with an int32 accumulator, bit for bit."""
    for case in CONV_CASES:
        xs, ws, stride, pad, dilate, groups = case
        rs = np.random.RandomState(len(xs))
        qx = rs.randint(-127, 128, xs).astype(np.int8)
        qw = rs.randint(-127, 128, ws).astype(np.int8)
        got = quant.int8_conv(torch.from_numpy(qx), torch.from_numpy(qw),
                              stride, pad, dilate, groups)
        kw = _jax_conv_kwargs(len(xs) - 2, stride, pad, dilate, groups,
                              xs, ws)
        kw.pop("precision")
        want = lax.conv_general_dilated(jnp.asarray(qx), jnp.asarray(qw),
                                        preferred_element_type=jnp.int32,
                                        **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ calibration
def test_calibration_table_json_across_packages(tmp_path):
    ranges = {"fc0": 2.0, "conv3": 0.5, "fc1": 0.000244140625, "conv0": 8.0}
    t, j = quant.CalibrationTable(ranges), jq.CalibrationTable(ranges)
    assert t.digest() == j.digest()
    assert t.to_json() == j.to_json()
    t.save(str(tmp_path / "port.json"))
    j.save(str(tmp_path / "jax.json"))
    assert open(str(tmp_path / "port.json")).read() == \
        open(str(tmp_path / "jax.json")).read()
    assert jq.CalibrationTable.load(str(tmp_path / "port.json")).digest() \
        == t.digest()
    assert quant.CalibrationTable.load(str(tmp_path / "jax.json")).digest() \
        == j.digest()
    assert t.scale("fc0") == j.scale("fc0") and t.scale("x") is None
    assert t.digest() != quant.CalibrationTable(
        dict(ranges, fc0=1.0)).digest()
    for bad in (0.0, float("inf"), -1.0):
        with pytest.raises(MXNetError):
            quant.CalibrationTable({"fc0": bad})
    assert json.loads(json.dumps(t.to_json()))["version"] == 1


def _mlp(pkg, names):
    with names():
        d = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(d, num_hidden=16, name="fc1")
        h = pkg.sym.Activation(h, act_type="relu")
        return pkg.sym.FullyConnected(h, num_hidden=8, name="fc2")


def _convnet(pkg, names):
    """Sites in a fixed topological order: conv0, conv1 (grouped), fc0,
    fc1, with a BatchNorm and pooling between."""
    with names():
        s = pkg.sym
        x = s.Variable("data")
        x = s.Convolution(x, kernel=(3, 3), pad=(1, 1), num_filter=8,
                          name="c1")
        x = s.BatchNorm(x, fix_gamma=False, name="bn1")
        x = s.Activation(x, act_type="relu")
        x = s.Convolution(x, kernel=(3, 3), stride=(2, 2), num_filter=8,
                          num_group=4, name="c2")
        x = s.Activation(x, act_type="relu")
        x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="avg")
        x = s.Flatten(x)
        x = s.FullyConnected(x, num_hidden=16, name="f1")
        x = s.Activation(x, act_type="relu")
        return s.FullyConnected(x, num_hidden=10, name="f2")


NETS = {"mlp": (_mlp, (12,)), "convnet": (_convnet, (3, 10, 10))}


def _net_params(name, seed=3):
    """numpy parameters of a net, from a seed, and its aux."""
    build, feat = NETS[name]
    sym = build(tmx, TNameManager)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(8,) + feat)
    rs = np.random.RandomState(seed)
    args = {n: (rs.randn(*s) * (0.3 if n.endswith("weight") else 0.1))
            .astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes) if n != "data"}
    aux = {n: (rs.rand(*s) + (0.5 if "var" in n else -0.5))
           .astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _modules(name, precision=None, batch=8):
    """(port module, JAX module) of a net, eval-bound with the same
    parameters."""
    build, feat = NETS[name]
    args, aux = _net_params(name)
    tm = tmx.mod.Module(build(tmx, TNameManager), label_names=[],
                        context=CPU, precision=precision)
    tm.bind(data_shapes=[("data", (batch,) + feat)], for_training=False)
    tm.init_params(arg_params={k: tmx.nd.array(v, ctx=CPU)
                               for k, v in args.items()},
                   aux_params={k: tmx.nd.array(v, ctx=CPU)
                               for k, v in aux.items()})
    jm = jmx.mod.Module(build(jmx, JNameManager), label_names=[],
                        context=[jmx.cpu(0)], precision=precision)
    jm.bind(data_shapes=[("data", (batch,) + feat)], for_training=False)
    jm.init_params(arg_params={k: jmx.nd.array(v) for k, v in args.items()},
                   aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
    return tm, jm


def _data(name, n=32, seed=1):
    return (np.random.RandomState(seed).randn(n, *NETS[name][1]) * 1.5) \
        .astype(np.float32)


def _edge_sites(tt, jt, amax):
    """Sites whose ranges differ, each with its largest observed amax and
    whether that lies within float32 rounding of a bucket edge."""
    out = {}
    for site in sorted(set(tt.ranges) | set(jt.ranges)):
        if tt.ranges.get(site) != jt.ranges.get(site):
            a = amax.get(site, 0.0)
            out[site] = (a, any(abs(a - e) <= 1e-6 * e
                                for e in quant.CALIB_BUCKETS))
    return out


@pytest.mark.parametrize("name", ["mlp", "convnet"])
def test_calibrate_matches_jax(name, monkeypatch):
    X = _data(name)
    tm, jm = _modules(name)
    amax = {}
    observe = quant._observe_amax

    def record(x, site):
        amax[site] = max(amax.get(site, 0.0), float(x.abs().max()))
        observe(x, site)

    monkeypatch.setattr(quant, "_observe_amax", record)
    tt = quant.calibrate(tm, tmx.io.NDArrayIter(X, None, batch_size=8),
                         num_batches=3)
    jt = jq.calibrate(jm, jmx.io.NDArrayIter(X, None, batch_size=8),
                      num_batches=3)
    want_sites = {"mlp": {"fc0", "fc1"},
                  "convnet": {"conv0", "conv1", "fc0", "fc1"}}[name]
    assert set(tt.ranges) == set(jt.ranges) == want_sites
    from mxnet_tpu_torch import telemetry
    hists = telemetry.registry().snapshot()["histograms"]
    keys = [k for k in hists if k.startswith("quant.calib.")]
    assert len(keys) == len(want_sites)
    assert all(hists[k]["count"] == 3 for k in keys)
    if tt.ranges != jt.ranges:
        pytest.fail("calibration ranges differ at %s (site: (amax, within "
                    "rounding of a bucket edge)): port %r, JAX %r"
                    % (_edge_sites(tt, jt, amax), tt.ranges, jt.ranges))
    assert tt.digest() == jt.digest()


# ------------------------------------------------------------ serving
def _rows(pred, X):
    return np.concatenate([np.asarray(pred.predict(X[i:i + 8]))
                           for i in range(0, len(X), 8)])


@pytest.mark.parametrize("name", ["mlp", "convnet"])
def test_int8_serve_rows_match_jax(name):
    """A JAX-made table served by both packages: the port's int8_serve
    rows within 1e-5 of the JAX package's, and within tolerance_check of
    the port's f32 rows."""
    X = _data(name, n=16, seed=2)
    _, jcal = _modules(name)
    jt = jq.calibrate(jcal, jmx.io.NDArrayIter(_data(name), None,
                                               batch_size=8), num_batches=4)
    table = quant.CalibrationTable.from_json(jt.to_json())
    t32, _ = _modules(name)
    ref = _rows(Predictor(t32, max_batch_size=8), X)
    tm, jm = _modules(name, precision="int8_serve")
    tp = Predictor(tm, max_batch_size=8, calibration=table)
    jp = JPredictor(jm, max_batch_size=8, calibration=jt)
    assert tp.calibration.digest() == jt.digest()
    assert tp._base._precision.describe()["calibration_digest"] == \
        jt.digest()
    got, want = _rows(tp, X), _rows(jp, X)
    assert _rel(got, want) <= ROWS_REL
    rep = quant.tolerance_check(ref, got)
    assert rep["passed"] and rep["max_rel_err"] > 0
    # a request padded up to its bucket (act_cast scales the whole batch,
    # so its rows are not those of the 8-row request)
    assert _rel(np.asarray(tp.predict(X[:3])),
                np.asarray(jp.predict(X[:3]))) <= ROWS_REL


def test_int8_serve_needs_a_table_and_calibration_needs_narrow_math():
    tm, _ = _modules("mlp", precision="int8_serve")
    with pytest.raises(MXNetError, match="CalibrationTable"):
        Predictor(tm, max_batch_size=8)
    t32, _ = _modules("mlp")
    with pytest.raises(MXNetError, match="narrow_math"):
        Predictor(t32, max_batch_size=8,
                  calibration=quant.CalibrationTable({"fc0": 1.0}))


@pytest.mark.parametrize("name", ["mlp", "convnet"])
def test_fp8_native_rows(name, monkeypatch):
    monkeypatch.setenv("MXNET_PRECISION_EXPERIMENTAL", "1")
    X = _data(name, n=16, seed=4)
    t32, j32 = _modules(name)
    ref = _rows(Predictor(t32, max_batch_size=8), X)
    jref = _rows(JPredictor(j32, max_batch_size=8), X)
    tm, jm = _modules(name, precision="fp8_native")
    got = _rows(Predictor(tm, max_batch_size=8), X)
    want = _rows(JPredictor(jm, max_batch_size=8), X)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= FP8_ROWS_REL
    assert _rel(got, ref) <= 2 * _rel(want, jref)
    quant.tolerance_check(ref, got, tol=0.1)


# ------------------------------------------------------------ decode
def test_int8_weight_decode_matches_jax():
    tmodel = tdec.LSTMCharLM(vocab_size=32, num_hidden=32, num_embed=16)
    jmodel = jdec.LSTMCharLM(vocab_size=32, num_hidden=32, num_embed=16)
    params = tmodel.init_params(seed=5)
    t8 = tdec.DecodeEngine(tmodel, params, slots=2, max_prefill_len=8,
                           start=False, precision="int8_weight", context=CPU)
    t32 = tdec.DecodeEngine(tmodel, params, slots=2, max_prefill_len=8,
                            start=False, context=CPU)
    j8 = jdec.DecodeEngine(jmodel, params, slots=2, max_prefill_len=8,
                           start=False, precision="int8_weight")
    try:
        assert t8.weight_bytes() == j8.weight_bytes() < t32.weight_bytes()
        assert t8.step_argument_bytes() < t32.step_argument_bytes()
        tokens = np.array([3, 17], np.int64)
        rs = np.random.RandomState(0)
        h = (rs.randn(2, 1, 32) * 0.5).astype(np.float32)
        c = (rs.randn(2, 1, 32) * 0.5).astype(np.float32)
        _, tl = tmodel.step(t8._dense_params(), torch.from_numpy(tokens),
                            {"h": torch.from_numpy(h),
                             "c": torch.from_numpy(c)})
        _, jl = jmodel.step(j8._dense_params(j8._dparams),
                            jnp.asarray(tokens.astype(np.int32)),
                            {"h": jnp.asarray(h), "c": jnp.asarray(c)})
        assert _rel(tl.numpy(), jl) <= 1e-5
        for n in (1, 3, 7, 8):
            assert t8.prefill_parity(list(range(1, n + 1)))
        t8.start()
        s1 = t8.generate([1, 2, 3], max_new_tokens=6, seed=4, timeout=60)
        s2 = t8.generate([1, 2, 3], max_new_tokens=6, seed=4, timeout=60)
        assert s1 == s2 and len(s1) == 6
        d = t8.stats()["decode"]
        assert d["weight_quant"] == "int8"
        assert d["precision_mode"] == "int8_weight"
    finally:
        t8.shutdown(drain=True)
        for e in (t8, t32, j8):
            e.release()


def test_modes_match_jax_registry():
    for name in ("int8_act", "fp8", "int8_weight", "int8_serve",
                 "fp8_native"):
        assert MODES[name].describe() == jmx.precision.MODES[name] \
            .describe(), name
