"""The operator surface of the PyTorch port (mxnet_tpu_torch
``ops/elemwise.py``, ``broadcast.py``, ``init_ops.py``, ``matrix.py``,
``sample.py``, the RMSProp update ops, and the vision, detection and
sequence-loss ops of ``ops/conv.py``, ``contrib.py``, ``detection.py``,
``sequence_loss.py`` and ``plugin/warpctc.py``) against the JAX
package's, on the CPU.

The port registers every name of the JAX registry but exactly the 4
deferred ones (the parallel operators ``MoE`` and ``RingAttention``, and
``TorchModule``/``TorchCriterion``), each with the JAX op's arguments,
outputs and ``needs_rng`` flag (``Custom``'s for a property class
registered in both packages). Each operator's forward and input gradient
equals the JAX op's on float32 inputs made by numpy from a seed, under a
random head gradient: rtol 1e-5, atol 1e-6; rtol 1e-4 for ``gamma``,
``gammaln``, ``erf``, the ``arc*`` functions, the power ops and
SpatialTransformer's parameters; exact for integer-valued outputs
(comparisons, indices, one-hot, picks), whose inputs have no ties. The
detection ops and ``quantize`` are held forward only (no gradient runs
through them in the JAX graphs; ``quantize`` outputs integers). The cases follow the tables of
``tests/test_operator_parity.py``. The samplers cannot share streams
with JAX's threefry, so their moments and semantics are held, and the
public ``mx.random.uniform``/``normal``/``randint`` take the JAX
package's signatures in both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import random as mxr
from mxnet_tpu_torch import registry as treg

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
LOOSE = 1e-4

DEFERRED = {
    # ops/parallel_ops.py (ROADMAP A8b)
    "MoE", "RingAttention",
}


def test_registry_is_the_jax_one_minus_the_deferred_names():
    jax_names, port_names = set(jreg.list_ops()), set(treg.list_ops())
    assert len(DEFERRED) == 2
    assert port_names <= jax_names, sorted(port_names - jax_names)
    assert jax_names - port_names == DEFERRED, \
        sorted((jax_names - port_names) ^ DEFERRED)
    assert len(port_names) == len(jax_names) - 2 == 265


ATTR_PROBES = ({}, {"use_sequence_length": True}, {"mode": "gru"},
               {"num_args": 3}, {"ret_typ": "both"},
               {"state_outputs": True}, {"num_outputs": 2})


def _register_probe_prop():
    """``Custom``'s arity comes from a registered property class: one that
    takes any attribute, with two arguments and two outputs."""
    from mxnet_tpu import operator as jop_mod
    from mxnet_tpu_torch import operator as top_mod
    for mod in (jop_mod, top_mod):
        @mod.register("signature_probe")
        class _Probe(mod.CustomOpProp):
            def __init__(self, **kwargs):
                super().__init__()

            def list_arguments(self):
                return ["data", "label"]

            def list_outputs(self):
                return ["output", "aux_output"]


_register_probe_prop()


@pytest.mark.parametrize("name", sorted(set(jreg.list_ops()) - DEFERRED))
def test_every_name_has_the_jax_signature(name):
    top, jop = treg.get_op(name), jreg.get_op(name)
    assert top.name == jop.name
    assert top.needs_rng == jop.needs_rng
    assert list(top.aux_names) == list(jop.aux_names)
    for attrs in ATTR_PROBES:
        if name == "Custom":
            attrs = dict(attrs, op_type="signature_probe")
        if name == "TorchModule":    # its arguments come from its module
            attrs = dict({"lua_string": "nn.Linear(4, 3)", "num_data": 1,
                          "num_params": 2, "num_outputs": 1}, **attrs)
        assert top.list_arguments(attrs) == jop.list_arguments(attrs), attrs
        assert top.num_outputs(attrs) == jop.num_outputs(attrs), attrs


# ---------------------------------------------------------------------------
# forward and input gradient against the JAX op
# ---------------------------------------------------------------------------
def _run_jax(name, attrs, ins, make_cots):
    """The JAX op's outputs, the head gradients ``make_cots(outputs)``
    and the input gradients under them."""
    op = jreg.get_op(name)
    attrs = jreg.parse_attrs(op, attrs)
    if not ins:
        return [np.asarray(o) for o in op.fcompute(
            attrs, [], jreg.OpContext(is_train=True))], [], []

    def f(*xs):
        return tuple(op.fcompute(attrs, list(xs),
                                 jreg.OpContext(is_train=True)))

    outs, vjp = jax.vjp(f, *[jnp.asarray(v) for v in ins])
    cots = make_cots([np.asarray(o).shape for o in outs])
    grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cots, outs)))
    return [np.asarray(o) for o in outs], cots, \
        [np.asarray(g) for g in grads]


def _run_torch(name, attrs, ins, cots):
    op = treg.get_op(name)
    attrs = treg.parse_attrs(op, attrs)
    ts = [torch.tensor(v, requires_grad=v.dtype == np.float32) for v in ins]
    outs = op.fcompute(attrs, ts, treg.OpContext(is_train=True))
    pairs = [(o, torch.tensor(c, dtype=o.dtype)) for o, c in zip(outs, cots)
             if o.requires_grad]
    need = [t for t in ts if t.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs], need,
                                [c for _, c in pairs], allow_unused=True) \
        if pairs and need else [None] * len(need)
    it = iter(grads)
    full = []
    for t in ts:
        g = next(it) if t.requires_grad else None
        full.append(np.zeros(t.shape, np.float32) if g is None
                    else g.numpy())
    return [o.detach().numpy() for o in outs], full


def _check(name, attrs, ins, rtol=RTOL, exact=False, seed=0, grads=True):
    rs = np.random.RandomState(seed + 1)
    jouts, cots, jgrads = _run_jax(
        name, attrs, ins,
        lambda shapes: [np.asarray(rs.randn(*s), np.float32)
                        for s in shapes])
    touts, tgrads = _run_torch(name, attrs, ins, cots)
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        assert j.shape == t.shape, (name, j.shape, t.shape)
        if exact:
            np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=name)
        else:
            np.testing.assert_allclose(t, j, rtol=rtol, atol=ATOL,
                                       err_msg=name)
    if not grads:
        return
    for x, j, t in zip(ins, jgrads, tgrads):
        if x.dtype != np.float32:
            continue
        np.testing.assert_allclose(t, j, rtol=rtol, atol=ATOL,
                                   err_msg=name + " grad")


RS = np.random.RandomState(7)
A = RS.rand(3, 4).astype(np.float32) + 0.5              # (0.5, 1.5)
B = RS.rand(3, 4).astype(np.float32) + 0.5
POSNEG = ((RS.rand(3, 4) - 0.5) * 1.8).astype(np.float32)  # (-0.9, 0.9)
COL = RS.rand(3, 1).astype(np.float32) + 0.5
PERM = (RS.permutation(24).reshape(2, 3, 4) / 7.0 - 1.5).astype(np.float32)

UNARY = [
    ("abs", POSNEG), ("sign", POSNEG), ("round", POSNEG * 3),
    ("rint", POSNEG * 3), ("ceil", POSNEG * 3), ("floor", POSNEG * 3),
    ("fix", POSNEG * 3), ("square", POSNEG), ("sqrt", A), ("rsqrt", A),
    ("exp", POSNEG), ("log", A), ("log10", A), ("log2", A), ("log1p", A),
    ("expm1", POSNEG), ("sin", POSNEG), ("cos", POSNEG), ("tan", POSNEG),
    ("arcsin", POSNEG), ("arccos", POSNEG), ("arctan", POSNEG),
    ("sinh", POSNEG), ("cosh", POSNEG), ("tanh", POSNEG),
    ("arcsinh", POSNEG), ("arccosh", A + 1.0), ("arctanh", POSNEG),
    ("sigmoid", POSNEG * 4), ("relu", POSNEG), ("softsign", POSNEG),
    ("reciprocal", A), ("negative", A), ("gamma", A + 0.5),
    ("gammaln", A + 0.5), ("erf", POSNEG), ("degrees", POSNEG),
    ("radians", POSNEG * 90), ("identity", POSNEG), ("_copy", POSNEG),
    ("BlockGrad", POSNEG), ("stop_gradient", POSNEG),
    ("_CrossDeviceCopy", POSNEG),
]
_LOOSE_OPS = {"gamma", "gammaln", "erf", "arcsin", "arccos", "arctan",
              "arcsinh", "arccosh", "arctanh"}


@pytest.mark.parametrize("op,x", UNARY, ids=[u[0] for u in UNARY])
def test_unary(op, x):
    _check(op, {}, [x], rtol=LOOSE if op in _LOOSE_OPS else RTOL,
           exact=op in ("sign", "round", "rint", "ceil", "floor", "fix"))


def test_gamma_has_no_sign():
    """``gamma`` is exp(gammaln(x)), so Γ(−0.5) = −2√π comes out
    positive, as in the JAX package."""
    x = np.array([-0.5, -1.5, 2.5], np.float32)
    _check("gamma", {}, [x], rtol=LOOSE)
    out = treg.get_op("gamma").fcompute({}, [torch.tensor(x)], None)[0]
    assert float(out[0]) > 0


_CMP = ("_equal", "_not_equal", "_greater", "_greater_equal", "_lesser",
        "_lesser_equal")
BINARY = ["_plus", "_minus", "_mul", "_div", "_mod", "_power", "pow",
          "_maximum", "_minimum", "_hypot", "elemwise_add", "elemwise_sub",
          "elemwise_mul", "elemwise_div", "_add", "_sub",
          "_grad_add"] + list(_CMP)


def _rtol(op):
    return LOOSE if "power" in op or op == "pow" else RTOL


@pytest.mark.parametrize("op", BINARY)
def test_binary(op):
    a, b = A * 3 - 2.0, B
    if op in _CMP:
        b = b.copy()
        b[0, :2] = a[0, :2]          # some equal pairs
    if "pow" in op or "power" in op:
        a = A
    _check(op, {}, [a, b], rtol=_rtol(op), exact=op in _CMP)


def test_mod_is_a_floor_mod():
    a = np.array([-3.5, 3.5, -1.25, 2.0], np.float32)
    b = np.array([2.0, -2.0, 0.5, 3.0], np.float32)
    _check("_mod", {}, [a, b])
    out = treg.get_op("_mod").fcompute(
        {}, [torch.tensor(a), torch.tensor(b)], None)[0]
    np.testing.assert_array_equal(out.numpy(), np.mod(a, b))


SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
          "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
          "_power_scalar", "_rpower_scalar", "_maximum_scalar",
          "_minimum_scalar", "_hypot_scalar", "_equal_scalar",
          "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
          "_lesser_scalar", "_lesser_equal_scalar"]


@pytest.mark.parametrize("op", SCALAR)
def test_scalar(op):
    x = A.copy()
    x[0, 0] = 0.7                     # one element equals the scalar
    _check(op, {"scalar": 0.7}, [x], rtol=_rtol(op),
           exact=op[:-len("_scalar")] in _CMP)


BROADCAST = ["broadcast_add", "broadcast_plus", "broadcast_sub",
             "broadcast_minus", "broadcast_mul", "broadcast_div",
             "broadcast_mod", "broadcast_power", "broadcast_maximum",
             "broadcast_minimum", "broadcast_hypot", "broadcast_equal",
             "broadcast_not_equal", "broadcast_greater",
             "broadcast_greater_equal", "broadcast_lesser",
             "broadcast_lesser_equal"]


@pytest.mark.parametrize("op", BROADCAST)
def test_broadcast(op):
    a = A * 3 - 1.0 if "power" not in op else A
    _check(op, {}, [a, COL], rtol=_rtol(op),
           exact=op.replace("broadcast", "") in _CMP)


def _ints(*shape, high):
    return RS.randint(0, high, shape).astype(np.float32)


MISC = {
    "clip": ("clip", {"a_min": -0.5, "a_max": 0.6}, [POSNEG]),
    "smooth_l1": ("smooth_l1", {"scalar": 1.0}, [POSNEG * 3]),
    "smooth_l1_sigma2": ("smooth_l1", {"scalar": 2.0}, [POSNEG * 3]),
    "add_n": ("add_n", {"num_args": 3}, [A, B, POSNEG]),
    "ElementWiseSum": ("ElementWiseSum", {"num_args": 2}, [A, B]),
    "_sum": ("_sum", {"num_args": 2}, [A, POSNEG]),
    "identity_like_rhs": ("_identity_with_attr_like_rhs", {}, [A, B]),
    "choose_element_0index": ("choose_element_0index", {},
                              [A, np.array([3, 0, 2], np.float32)]),
    "fill_element_0index": ("fill_element_0index", {},
                            [A, np.array([5., 6., 7.], np.float32),
                             np.array([1, 3, 0], np.float32)]),
    "broadcast_to": ("broadcast_to", {"shape": (3, 4)}, [COL]),
    "broadcast_to_keep": ("broadcast_to", {"shape": (0, 5)}, [COL]),
    "broadcast_axis": ("broadcast_axis", {"axis": 1, "size": 4}, [COL]),
    "broadcast_axes": ("broadcast_axes", {"axis": (0, 2), "size": (2, 3)},
                       [RS.rand(1, 3, 1).astype(np.float32)]),
    "sum": ("sum", {"axis": 1}, [PERM]),
    "sum_keep": ("sum", {"axis": (0, 2), "keepdims": True}, [PERM]),
    "mean_all": ("mean", {}, [PERM]),
    "prod": ("prod", {"axis": 1}, [A]),
    "prod_all_keep": ("prod", {"keepdims": True}, [A]),
    "prod_axes": ("prod", {"axis": (0, 2)}, [PERM + 2.0]),
    "nansum": ("nansum", {"axis": 0}, [A]),
    "nanprod": ("nanprod", {}, [A]),
    "max_axis": ("max_axis", {"axis": 0}, [PERM]),
    "min": ("min", {"axis": -1}, [PERM]),
    "argmin": ("argmin", {"axis": 1}, [PERM]),
    "argmin_keep": ("argmin", {"axis": 2, "keepdims": True}, [PERM]),
    "argmin_all": ("argmin", {}, [PERM]),
    "argmax": ("argmax", {"axis": 0}, [PERM]),
    "argmax_channel": ("argmax_channel", {}, [PERM]),
    "pick": ("pick", {"axis": 1}, [PERM, _ints(2, 4, high=3)]),
    "pick_keep_last": ("pick", {"axis": -1, "keepdims": True},
                       [PERM, _ints(2, 3, high=4)]),
    "zeros_like": ("zeros_like", {}, [A]),
    "ones_like": ("ones_like", {}, [A]),
    "dot": ("dot", {}, [A, RS.rand(4, 5).astype(np.float32)]),
    "dot_t": ("dot", {"transpose_a": True, "transpose_b": True},
              [A, RS.rand(5, 3).astype(np.float32)]),
    "dot_vec": ("dot", {}, [A[0], RS.rand(4).astype(np.float32)]),
    "dot_mat_vec": ("dot", {}, [A, RS.rand(4).astype(np.float32)]),
    "dot_3d": ("dot", {}, [PERM, RS.rand(4, 5).astype(np.float32)]),
    "dot_3d_3d": ("dot", {}, [PERM, RS.rand(2, 4, 5).astype(np.float32)]),
    "batch_dot": ("batch_dot", {}, [PERM, RS.rand(2, 4, 5).astype(
        np.float32)]),
    "batch_dot_t": ("batch_dot", {"transpose_a": True, "transpose_b": True},
                    [PERM, RS.rand(2, 5, 3).astype(np.float32)]),
    "linalg_gemm2": ("linalg_gemm2", {"alpha": 0.5}, [PERM, RS.rand(
        2, 4, 5).astype(np.float32)]),
    "linalg_gemm2_t": ("linalg_gemm2", {"transpose_a": True},
                       [RS.rand(2, 4, 3).astype(np.float32),
                        RS.rand(2, 4, 5).astype(np.float32)]),
    "slice": ("slice", {"begin": (0, 1), "end": (2, 3)}, [PERM]),
    "slice_none": ("slice", {"begin": (None, 1), "end": (None, None)},
                   [PERM]),
    "crop": ("crop", {"begin": (1,), "end": (2,)}, [PERM]),
    "slice_axis": ("slice_axis", {"axis": 2, "begin": 1, "end": 3}, [PERM]),
    "slice_axis_to_end": ("slice_axis", {"axis": -2, "begin": 1}, [PERM]),
    "slice_assign": ("_slice_assign", {"begin": (0, 1), "end": (1, 3)},
                     [PERM, RS.rand(1, 2, 4).astype(np.float32)]),
    "crop_assign": ("_crop_assign", {"begin": (1, 0), "end": (2, 1)},
                    [PERM, RS.rand(1, 1, 4).astype(np.float32)]),
    "crop_assign_scalar": ("_crop_assign_scalar",
                           {"begin": (0, 1), "end": (2, 2), "scalar": 3.5},
                           [PERM]),
    "take": ("take", {}, [A, np.array([[0, 2], [1, 5]], np.float32)]),
    "take_wrap_axis1": ("take", {"axis": 1, "mode": "wrap"},
                        [A, np.array([-1, 5, 2], np.float32)]),
    "batch_take": ("batch_take", {}, [A, np.array([3, 0, 2], np.float32)]),
    "one_hot": ("one_hot", {"depth": 5}, [_ints(2, 3, high=5)]),
    "one_hot_values": ("one_hot", {"depth": 4, "on_value": 2.5,
                                   "off_value": -1.0},
                       [_ints(3, high=4)]),
    "gather_nd": ("gather_nd", {}, [RS.rand(4, 5).astype(np.float32),
                                    np.array([[0, 2, 3], [1, 0, 4]],
                                             np.float32)]),
    "where": ("where", {}, [(A > 1).astype(np.float32), A, B]),
    "where_rows": ("where", {}, [np.array([1, 0, 1], np.float32), A, B]),
    "topk": ("topk", {"k": 2}, [PERM]),
    "topk_axis0_ascend": ("topk", {"k": 1, "axis": 0, "is_ascend": True},
                          [PERM]),
    "topk_value": ("topk", {"k": 3, "ret_typ": "value"}, [PERM]),
    "topk_both": ("topk", {"k": 2, "axis": 1, "ret_typ": "both"}, [PERM]),
    "topk_mask": ("topk", {"k": 2, "ret_typ": "mask"}, [PERM]),
    "sort": ("sort", {}, [PERM]),
    "sort_desc_axis0": ("sort", {"axis": 0, "is_ascend": False}, [PERM]),
    "argsort": ("argsort", {"axis": 1}, [PERM]),
    "argsort_desc": ("argsort", {"is_ascend": False}, [PERM]),
    "tile": ("tile", {"reps": (2, 1, 3)}, [PERM]),
    "repeat": ("repeat", {"repeats": 2, "axis": 1}, [PERM]),
    "repeat_flat": ("repeat", {"repeats": 3}, [A]),
    "reverse": ("reverse", {"axis": 1}, [PERM]),
    "flip_axes": ("flip", {"axis": (0, 2)}, [PERM]),
    "SequenceLast": ("SequenceLast", {}, [PERM]),
    "SequenceLast_len": ("SequenceLast", {"use_sequence_length": True},
                         [PERM, np.array([1, 2, 2], np.float32)]),
    "SequenceMask": ("SequenceMask", {}, [PERM]),
    "SequenceMask_len": ("SequenceMask", {"use_sequence_length": True,
                                          "value": -1.0},
                         [PERM, np.array([1, 2, 0], np.float32)]),
    "SequenceReverse": ("SequenceReverse", {}, [PERM]),
    "SequenceReverse_len": ("SequenceReverse",
                            {"use_sequence_length": True},
                            [RS.rand(4, 2, 3).astype(np.float32),
                             np.array([2, 4], np.float32)]),
    "onehot_encode": ("_onehot_encode", {},
                      [np.array([2, 0, 3], np.float32),
                       np.zeros((3, 5), np.float32)]),
    "rmsprop_update": ("rmsprop_update",
                       {"lr": 0.1, "gamma1": 0.9, "epsilon": 1e-8,
                        "wd": 0.01, "rescale_grad": 0.5,
                        "clip_gradient": 0.4, "clip_weights": 1.2},
                       [POSNEG, A - 1.0, A]),
    "rmspropalex_update": ("rmspropalex_update",
                           {"lr": 0.1, "gamma1": 0.9, "gamma2": 0.8,
                            "epsilon": 1e-8, "wd": 0.01},
                           [POSNEG, A - 1.0, A + 1.0, B * 0.1, POSNEG]),
}
# integer-valued outputs: held exactly
_EXACT = {"argmin", "argmin_keep", "argmin_all", "argmax", "argmax_channel",
          "one_hot", "one_hot_values", "topk", "topk_axis0_ascend",
          "topk_mask", "argsort", "argsort_desc", "onehot_encode"}


@pytest.mark.parametrize("case", sorted(MISC))
def test_misc(case):
    name, attrs, ins = MISC[case]
    _check(name, attrs, ins, exact=case in _EXACT)


# the vision, detection and sequence-loss operators (ops/conv.py,
# contrib.py, detection.py, sequence_loss.py, plugin/warpctc.py): each
# name's forward and input gradient; the detection ops forward only (they
# run without a gradient; in the JAX graphs none reaches a parameter)
IMG = RS.rand(2, 3, 5, 6).astype(np.float32)
RELU_MAP = np.maximum(RS.randn(2, 3, 9, 11), 0).astype(np.float32)
ROIS = np.array([[0, 0, 0, 8, 8], [1, 2.5, 3.5, 10, 7], [0, 1, 1, 1, 1],
                 [1, 0, 0, 20, 20], [0, 3, 2, 6, 8]], np.float32)
THETA = np.array([[0.9, 0.1, 0.05, -0.1, 1.1, -0.05],
                  [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], np.float32)
CTC_DATA = RS.randn(6, 3, 5).astype(np.float32)          # (T, N, C)
CTC_LABEL = np.array([[1, 2, 2], [3, 0, 0], [4, 1, 0]], np.float32)
SSD_ANCHORS = np.array([[[0.0, 0.0, 0.4, 0.4], [0.5, 0.5, 1.0, 1.0],
                         [0.0, 0.6, 0.3, 1.0], [0.3, 0.3, 0.7, 0.7]]],
                       np.float32)
SSD_LABEL = np.array([[[2, 0.55, 0.55, 0.95, 0.95], [0, 0.0, 0.0, 0.35,
                                                      0.45],
                       [-1, 0, 0, 0, 0]],
                      [[1, 0.3, 0.35, 0.72, 0.7], [-1, 0, 0, 0, 0],
                       [-1, 0, 0, 0, 0]]], np.float32)
SSD_PROB = np.array(RS.dirichlet(np.ones(3), (2, 4)).transpose(0, 2, 1),
                    np.float32)                              # (B, C, A)


def _softmax_np(x, axis):
    e = np.exp(x - x.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


VISION = {
    "Deconvolution": ("Deconvolution", {"kernel": (3, 3), "stride": (2, 2),
                                        "pad": (1, 1), "adj": (1, 1),
                                        "num_filter": 4},
                      [IMG, RS.randn(3, 4, 3, 3).astype(np.float32)]),
    "Deconvolution_bias_groups": (
        "Deconvolution", {"kernel": (2, 2), "stride": (2, 2),
                          "num_filter": 4, "num_group": 2,
                          "no_bias": False},
        [RS.randn(2, 4, 3, 3).astype(np.float32),
         RS.randn(4, 2, 2, 2).astype(np.float32),
         RS.randn(4).astype(np.float32)]),
    "UpSampling": ("UpSampling", {"scale": 2, "sample_type": "nearest"},
                   [IMG]),
    "UpSampling_bilinear_sum": ("UpSampling", {
        "scale": 2, "sample_type": "bilinear", "num_args": 2,
        "multi_input_mode": "sum"}, [IMG, IMG * 0.5]),
    "UpSampling_concat": ("UpSampling", {"scale": 3, "num_args": 2},
                          [IMG, IMG[:, :1]]),
    "Pad": ("Pad", {"mode": "constant", "constant_value": 1.5,
                    "pad_width": (0, 0, 1, 0, 2, 1, 0, 3)}, [IMG]),
    "pad_edge": ("pad", {"mode": "edge",
                         "pad_width": (0, 0, 0, 1, 2, 3, 1, 4)}, [IMG]),
    "pad_reflect": ("pad", {"mode": "reflect",
                            "pad_width": (1, 0, 2, 1, 4, 9, 5, 1)}, [IMG]),
    "Crop": ("Crop", {"h_w": (3, 4), "offset": (1, 2)}, [IMG]),
    "Crop_like_centre": ("Crop", {"num_args": 2, "center_crop": True},
                         [IMG, IMG[:, :, :3, :3]]),
    "ROIPooling": ("ROIPooling", {"pooled_size": (3, 2),
                                  "spatial_scale": 1.0}, [RELU_MAP, ROIS]),
    "ROIPooling_scaled": ("ROIPooling", {"pooled_size": (2, 4),
                                         "spatial_scale": 0.5},
                          [RELU_MAP, ROIS * np.float32([1, 2, 2, 2, 2])]),
    "GridGenerator": ("GridGenerator", {"transform_type": "affine",
                                        "target_shape": (4, 5)}, [THETA]),
    "GridGenerator_warp": ("GridGenerator", {"transform_type": "warp"},
                           [RS.randn(2, 2, 4, 5).astype(np.float32)]),
    "BilinearSampler": ("BilinearSampler", {},
                        [IMG, (RS.rand(2, 2, 4, 3) * 2.4 - 1.2)
                         .astype(np.float32)]),
    "SpatialTransformer": ("SpatialTransformer", {
        "target_shape": (4, 4), "transform_type": "affine",
        "sampler_type": "bilinear"}, [IMG, THETA]),
    "_contrib_fft": ("_contrib_fft", {}, [RS.randn(3, 8).astype(
        np.float32)]),
    "fft": ("fft", {}, [RS.randn(2, 3, 5).astype(np.float32)]),
    "_contrib_ifft": ("_contrib_ifft", {}, [RS.randn(3, 16).astype(
        np.float32)]),
    "ifft": ("ifft", {}, [RS.randn(2, 10).astype(np.float32)]),
    "_contrib_count_sketch": ("_contrib_count_sketch", {"out_dim": 4}, [
        RS.randn(3, 6).astype(np.float32),
        np.array([0, 3, 1, 3, 2, 0], np.float32),
        np.array([1, -1, -1, 1, 1, -1], np.float32)]),
    "_contrib_MultiBoxPrior": ("_contrib_MultiBoxPrior", {
        "sizes": (0.5, 0.25), "ratios": (1.0, 2.0, 0.5), "clip": True},
        [IMG]),
    "_contrib_MultiBoxPrior_steps": ("_contrib_MultiBoxPrior", {
        "sizes": (0.3,), "steps": (0.2, 0.25), "offsets": (0.4, 0.6)},
        [IMG]),
    "_contrib_dequantize": ("_contrib_dequantize", {}, [
        RS.randint(0, 256, (3, 4)).astype(np.uint8),
        np.array([-1.5], np.float32), np.array([2.5], np.float32)]),
    "dequantize_int8": ("dequantize", {}, [
        RS.randint(-128, 128, (3, 4)).astype(np.int8),
        np.array([-1.0], np.float32), np.array([3.0], np.float32)]),
    "CTCLoss": ("CTCLoss", {}, [CTC_DATA, CTC_LABEL]),
    "ctc_loss": ("ctc_loss", {}, [CTC_DATA * 2, CTC_LABEL]),
    "_contrib_CTCLoss": ("_contrib_CTCLoss", {},
                         [CTC_DATA[:4], CTC_LABEL]),
    "Correlation": ("Correlation", {"max_displacement": 1},
                    [IMG, IMG[::-1].copy()]),
    "Correlation_absdiff_stride": ("Correlation", {
        "max_displacement": 2, "stride2": 2, "is_multiply": False},
        [IMG, IMG[::-1].copy()]),
    "WarpCTC": ("WarpCTC", {"input_length": 6, "label_length": 3},
                [CTC_DATA.reshape(18, 5), CTC_LABEL.reshape(-1)]),
}
FORWARD_ONLY = {
    "_contrib_MultiBoxTarget": ("_contrib_MultiBoxTarget",
                                {"overlap_threshold": 0.5},
                                [SSD_ANCHORS, SSD_LABEL,
                                 np.zeros((2, 3, 4), np.float32)]),
    "_contrib_MultiBoxDetection": ("_contrib_MultiBoxDetection",
                                   {"threshold": 0.2, "nms_threshold": 0.3},
                                   [SSD_PROB, RS.randn(2, 16).astype(
                                       np.float32) * 0.5, SSD_ANCHORS]),
    "_contrib_Proposal": ("_contrib_Proposal", {
        "feature_stride": 4, "scales": (2.0, 4.0), "ratios": (0.5, 1.0),
        "rpn_pre_nms_top_n": 40, "rpn_post_nms_top_n": 12,
        "threshold": 0.6}, [
            _softmax_np(RS.randn(2, 2, 4, 5, 6), 1).reshape(2, 8, 5, 6),
            RS.randn(2, 16, 5, 6).astype(np.float32) * 0.2,
            np.array([[20, 24, 1], [18, 21, 1]], np.float32)]),
    "Proposal": ("Proposal", {"feature_stride": 8, "scales": (1.0,),
                              "ratios": (1.0,), "rpn_post_nms_top_n": 5},
                 [_softmax_np(RS.randn(1, 2, 1, 3, 3), 1).reshape(1, 2, 3, 3),
                  RS.randn(1, 4, 3, 3).astype(np.float32) * 0.2,
                  np.array([[24, 24, 1]], np.float32)]),
    "_contrib_quantize": ("_contrib_quantize", {}, [
        RS.randn(3, 4).astype(np.float32), np.array([-1.5], np.float32),
        np.array([2.0], np.float32)]),
    "quantize_int8": ("quantize", {"out_type": "int8"}, [
        RS.randn(3, 4).astype(np.float32), np.array([-1.0], np.float32),
        np.array([1.0], np.float32)]),
}


# SpatialTransformer's affine parameters' gradients sum h·w·c products of
# both signs, in another order in each package: rtol 1e-4 there
_LOOSE_VISION = {"SpatialTransformer"}


@pytest.mark.parametrize("case", sorted(VISION))
def test_vision_ops(case):
    name, attrs, ins = VISION[case]
    _check(name, attrs, ins, rtol=LOOSE if case in _LOOSE_VISION else RTOL)


@pytest.mark.parametrize("case", sorted(FORWARD_ONLY))
def test_vision_ops_forward(case):
    """Forward only: exact where the outputs are integers, class targets
    or masks, else within the tolerance."""
    name, attrs, ins = FORWARD_ONLY[case]
    jop, top = jreg.get_op(name), treg.get_op(name)
    jouts = jop.fcompute(jreg.parse_attrs(jop, attrs),
                         [jnp.asarray(v) for v in ins], None)
    touts = top.fcompute(treg.parse_attrs(top, attrs),
                         [torch.tensor(v) for v in ins], None)
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, t.shape)
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=name)


def test_every_new_name_has_a_case():
    covered = {c[0] for c in VISION.values()} | \
        {c[0] for c in FORWARD_ONLY.values()}
    new = {"BilinearSampler", "Crop", "Deconvolution", "GridGenerator",
           "Pad", "ROIPooling", "SpatialTransformer", "UpSampling", "pad",
           "_contrib_MultiBoxPrior", "_contrib_count_sketch",
           "_contrib_dequantize", "_contrib_fft", "_contrib_ifft",
           "_contrib_quantize", "dequantize", "fft", "ifft", "quantize",
           "Proposal", "_contrib_MultiBoxDetection",
           "_contrib_MultiBoxTarget", "_contrib_Proposal", "CTCLoss",
           "Correlation", "_contrib_CTCLoss", "ctc_loss", "WarpCTC"}
    assert len(new) == 28 and covered == new, sorted(covered ^ new)


INIT = {
    "_zeros": {"shape": (2, 3)}, "zeros": {"shape": (4,)},
    "_ones": {"shape": (2, 3)}, "ones": {"shape": (3,), "dtype": "int32"},
    "_full": {"shape": (2, 2), "value": 1.5},
    "_arange": {"start": 1, "stop": 7, "step": 2},
    "arange_op": {"start": 5, "repeat": 2},
    "_NoGradient": {},
}


@pytest.mark.parametrize("name", sorted(INIT))
def test_init_ops(name):
    attrs = INIT[name]
    jout, _, _ = _run_jax(name, attrs, [], None)
    op = treg.get_op(name)
    tout = op.fcompute(treg.parse_attrs(op, attrs), [],
                       treg.OpContext(device=torch.device("cpu")))
    for j, t in zip(jout, tout):
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)
    _, jshape, _ = jreg.get_op(name).infer_shape(
        jreg.parse_attrs(jreg.get_op(name), attrs), [])
    _, tshape, _ = op.infer_shape(treg.parse_attrs(op, attrs), [])
    assert [tuple(s) for s in tshape] == [tuple(s) for s in jshape]


# ---------------------------------------------------------------------------
# the nd and sym surfaces
# ---------------------------------------------------------------------------
def test_nd_functions_match_the_jax_package():
    cpu_t, cpu_j = tmx.cpu(), jmx.cpu()
    for name, args in (("empty", ((2, 3),)), ("full", ((2, 3), 2.5)),
                       ("arange", (1, 7, 2)), ("arange", (5,))):
        j = getattr(jmx.nd, name)(*args, ctx=cpu_j).asnumpy()
        t = getattr(tmx.nd, name)(*args, ctx=cpu_t).asnumpy()
        np.testing.assert_array_equal(t, j)
        assert t.dtype == j.dtype
    t = tmx.nd.arange(0, 3, repeat=2, ctx=cpu_t).asnumpy()
    np.testing.assert_array_equal(t, [0, 0, 1, 1, 2, 2])
    idx = np.array([2, 0, 3], np.float32)
    outs = []
    for pkg, ctx in ((jmx, cpu_j), (tmx, cpu_t)):
        out = pkg.nd.zeros((3, 5), ctx=ctx)
        pkg.nd.onehot_encode(pkg.nd.array(idx, ctx=ctx), out)
        lhs = pkg.nd.array(A, ctx=ctx)
        rhs = pkg.nd.array([3, 0, 2], ctx=ctx)
        chosen = pkg.nd.choose_element_0index(lhs, rhs)
        filled = pkg.nd.fill_element_0index(
            lhs, pkg.nd.array([5, 6, 7], ctx=ctx), rhs)
        outs.append([out.asnumpy(), chosen.asnumpy(), filled.asnumpy()])
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, j)


def test_nd_ops_take_named_inputs_scalars_and_ctx():
    a = tmx.nd.array(A, ctx=tmx.cpu())
    b = tmx.nd.array(B, ctx=tmx.cpu())
    np.testing.assert_allclose(tmx.nd.dot(lhs=a, rhs=b.T).asnumpy(),
                               A @ B.T, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tmx.nd._maximum_scalar(a, 1.0).asnumpy(),
                               np.maximum(A, 1.0))
    np.testing.assert_allclose(
        tmx.nd.broadcast_mul(a, tmx.nd.array(COL, ctx=tmx.cpu())).asnumpy(),
        A * COL, rtol=RTOL)
    ones = tmx.nd.ones_like(a)
    assert ones.context == tmx.cpu() and float(ones.asnumpy().sum()) == 12
    full = tmx.nd._full(shape=(2, 2), value=3.0, ctx=tmx.cpu())
    np.testing.assert_array_equal(full.asnumpy(), np.full((2, 2), 3.0))
    assert tmx.nd.add_n(a, b, a).shape == (3, 4)


def test_block_grad_through_a_bound_executor():
    """Only the unblocked path carries a gradient (as
    ``test_operator_parity.test_grad_control_ops``)."""
    x = tmx.sym.Variable("x")
    for opname in ("stop_gradient", "BlockGrad"):
        y = getattr(tmx.sym, opname)(x * 2.0) + x
        loss = tmx.sym.MakeLoss(tmx.sym.sum(y))
        ex = loss.simple_bind(tmx.cpu(), x=(2, 2))
        ex.arg_dict["x"][:] = np.ones((2, 2), np.float32)
        ex.forward(is_train=True)
        ex.backward()
        np.testing.assert_allclose(ex.grad_dict["x"].asnumpy(),
                                   np.ones((2, 2)), rtol=1e-6)


# ---------------------------------------------------------------------------
# sampling: semantics and moments, and the public mx.random samplers
# ---------------------------------------------------------------------------
N = 20000


def _sample(name, key=5, **attrs):
    op = treg.get_op(name)
    attrs = treg.parse_attrs(op, dict(attrs, shape=(N,)))
    return op.fcompute(attrs, [], treg.OpContext(
        is_train=True, device=torch.device("cpu"), key=key))[0].numpy()


def test_sampler_moments():
    """The moments of ``test_operator_parity.test_random_ops_statistics``
    and of the binomials, each within 5σ of the estimate."""
    u = _sample("_random_uniform", low=-1.0, high=3.0)
    assert -1.0 <= u.min() and u.max() < 3.0
    assert abs(u.mean() - 1.0) < 5 * (16 / 12 / N) ** 0.5
    g = _sample("_random_normal", loc=2.0, scale=0.5)
    assert abs(g.mean() - 2.0) < 5 * 0.5 / N ** 0.5
    assert abs(g.std() - 0.5) < 0.02
    e = _sample("_random_exponential", lam=2.0)
    assert e.min() >= 0 and abs(e.mean() - 0.5) < 5 * 0.5 / N ** 0.5
    p = _sample("_random_poisson", lam=3.0)
    assert abs(p.mean() - 3.0) < 5 * (3.0 / N) ** 0.5
    assert np.array_equal(p, np.round(p))
    gm = _sample("_random_gamma", alpha=2.0, beta=1.5)
    assert abs(gm.mean() - 3.0) < 5 * (2 * 1.5 ** 2 / N) ** 0.5
    nb = _sample("_random_negative_binomial", k=4, p=0.5)
    assert abs(nb.mean() - 4.0) < 5 * (8.0 / N) ** 0.5     # var k(1-p)/p²
    gnb = _sample("_random_generalized_negative_binomial", mu=2.0,
                  alpha=0.5)
    assert abs(gnb.mean() - 2.0) < 5 * ((2.0 + 0.5 * 4.0) / N) ** 0.5
    r = _sample("random_randint", low=-2, high=3)
    assert set(np.unique(r)) == {-2, -1, 0, 1, 2}


@pytest.mark.parametrize("name", ["_random_uniform", "_random_normal",
                                  "_random_gamma", "_random_exponential",
                                  "_random_poisson",
                                  "_random_negative_binomial",
                                  "_random_generalized_negative_binomial",
                                  "random_randint"])
def test_samplers_repeat_from_one_key(name):
    a, b, c = _sample(name, key=11), _sample(name, key=11), \
        _sample(name, key=12)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.dtype == np.float32


def test_sampler_aliases_and_key_path():
    for alias, canon in (("uniform", "_random_uniform"),
                         ("_sample_normal", "_random_normal"),
                         ("random_gamma", "_random_gamma"),
                         ("_sample_negbinomial", "_random_negative_binomial"),
                         ("_sample_gennegbinomial",
                          "_random_generalized_negative_binomial")):
        assert treg.get_op(alias) is treg.get_op(canon)
        assert treg.get_op(alias).needs_rng
    # the counter draws are pure functions of the key and the index
    u = _sample("_random_uniform", key=9)
    np.testing.assert_array_equal(
        u, mxr.key_uniform(9, (N,), torch.device("cpu")).numpy())
    # an imperative call draws one key from next_key
    tmx.random.seed(3)
    drawn = mxr.get_state()["keys_drawn"]
    tmx.nd.normal(shape=(4,), ctx=tmx.cpu())
    assert mxr.get_state()["keys_drawn"] == drawn + 1
    tmx.random.seed(3)
    x = tmx.nd.uniform(shape=(5,), ctx=tmx.cpu()).asnumpy()
    tmx.random.seed(3)
    np.testing.assert_array_equal(
        tmx.nd.uniform(shape=(5,), ctx=tmx.cpu()).asnumpy(), x)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_public_random_samplers_take_the_jax_signatures(pkg):
    mx = jmx if pkg == "jax" else tmx
    ctx = mx.cpu()
    mx.random.seed(1)
    u = mx.random.uniform(-1, 2, shape=(50, 40), ctx=ctx)
    assert u.shape == (50, 40) and u.dtype == np.float32
    v = u.asnumpy()
    assert v.min() >= -1 and v.max() < 2 and abs(v.mean() - 0.5) < 0.1
    g = mx.random.normal(1.0, 2.0, shape=(2000,), ctx=ctx)
    assert g.shape == (2000,) and g.dtype == np.float32
    assert abs(g.asnumpy().mean() - 1.0) < 0.3
    r = mx.random.randint(0, 5, shape=(3, 7), ctx=ctx)
    assert r.shape == (3, 7) and r.dtype == np.int32
    assert set(np.unique(r.asnumpy())) <= set(range(5))
    out = mx.nd.zeros((4, 3), ctx=ctx)
    mx.random.uniform(0, 1, shape=(4, 3), ctx=ctx, out=out)
    assert 0 <= out.asnumpy().min() and out.asnumpy().max() < 1
