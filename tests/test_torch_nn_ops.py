"""The operators of ``mxnet_tpu/ops/nn.py`` in the PyTorch port
(mxnet_tpu_torch ``ops/nn.py``) against the JAX package's, on the CPU.

Every name (and alias) the JAX module registers is registered in the port
with the same arguments and ``needs_rng`` flag. Each operator's forward
and input gradient equals the JAX op's on small float32 shapes made by
numpy from a seed (rtol 1e-5, atol 1e-6); for the ops whose JAX backward
ignores the head gradient (the regression outputs, SVMOutput, MakeLoss)
the gradient under a random head is the backward's seed, held to the JAX
op's under the same head. The cases of ``tests/test_operator_parity.py``
(LRN against its loop reference, MAERegressionOutput's gradient through a
bound executor) run on the port too. Dropout and ``rrelu`` cannot share
random streams with JAX, so their semantics are held instead: identity in
eval and at p = 0, kept values x / (1 − p), the gradient mask · g /
(1 − p), and the kept fraction within 4σ of 1 − p.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx  # noqa: F401  (registers the JAX ops)
from mxnet_tpu import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import random as mxr
from mxnet_tpu_torch import registry as treg

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _jax_nn_names():
    """{name: (canonical name, needs_rng)} of every registry entry whose op
    ``mxnet_tpu/ops/nn.py`` defines."""
    out = {}
    for name in jreg.list_ops():
        op = jreg.get_op(name)
        if op.fcompute.__module__ == "mxnet_tpu.ops.nn":
            out[name] = (op.name, op.needs_rng)
    return out


JAX_NN = _jax_nn_names()


def test_every_nn_op_is_registered_with_its_aliases():
    assert len(JAX_NN) == 22     # 19 operators, 3 aliases
    ported = set(treg.list_ops())
    missing = sorted(n for n in JAX_NN if n not in ported)
    assert not missing, missing
    for name, (canon, needs_rng) in JAX_NN.items():
        top = treg.get_op(name)
        assert top.name == canon, name
        assert top.needs_rng == needs_rng, name
        jop = jreg.get_op(name)
        for attrs in ({}, {"act_type": "prelu"}, {"no_bias": True}):
            assert top.list_arguments(attrs) == jop.list_arguments(attrs), \
                (name, attrs)
        assert list(top.aux_names) == list(jop.aux_names), name


def _run_jax(name, attrs, ins, cots, is_train):
    op = jreg.get_op(name)
    attrs = jreg.parse_attrs(op, attrs)

    def f(*xs):
        return tuple(op.fcompute(attrs, list(xs),
                                 jreg.OpContext(is_train=is_train)))

    outs, vjp = jax.vjp(f, *[jnp.asarray(v) for v in ins])
    grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cots, outs)))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _run_torch(name, attrs, ins, cots, is_train, key=None):
    op = treg.get_op(name)
    attrs = treg.parse_attrs(op, attrs)
    ts = [torch.tensor(v, requires_grad=True) for v in ins]
    outs = op.fcompute(attrs, ts, treg.OpContext(is_train=is_train, key=key))
    pairs = [(o, torch.tensor(c)) for o, c in zip(outs, cots)
             if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs], ts,
                                [c for _, c in pairs], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, ts)]
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _labels(rs, n, classes):
    return rs.randint(0, classes, (n,)).astype(np.float32)


# case -> (op name, attrs, inputs(rs)); the last input of a loss is its
# label, which takes no gradient
CASES = {
    "leaky": ("LeakyReLU", {"act_type": "leaky", "slope": 0.1},
              lambda rs: [_rand(rs, 3, 4, 5)]),
    "elu": ("LeakyReLU", {"act_type": "elu", "slope": 0.7},
            lambda rs: [_rand(rs, 3, 4, 5)]),
    "prelu": ("LeakyReLU", {"act_type": "prelu"},
              lambda rs: [_rand(rs, 2, 4, 3, 3), _rand(rs, 4, scale=0.3)]),
    "rrelu_eval": ("LeakyReLU", {"act_type": "rrelu", "lower_bound": 0.1,
                                 "upper_bound": 0.3},
                   lambda rs: [_rand(rs, 3, 6)]),
    "softmax": ("softmax", {}, lambda rs: [_rand(rs, 4, 7)]),
    "softmax_axis1_temp": ("softmax", {"axis": 1, "temperature": 2.0},
                           lambda rs: [_rand(rs, 2, 5, 3)]),
    "log_softmax": ("log_softmax", {"axis": -1},
                    lambda rs: [_rand(rs, 4, 7)]),
    "log_softmax_axis0": ("log_softmax", {"axis": 0},
                          lambda rs: [_rand(rs, 4, 7)]),
    "softmax_activation": ("SoftmaxActivation", {},
                           lambda rs: [_rand(rs, 3, 2, 4)]),
    "softmax_activation_channel": ("SoftmaxActivation", {"mode": "channel"},
                                   lambda rs: [_rand(rs, 2, 5, 3, 3)]),
    "instance_norm": ("InstanceNorm", {"eps": 1e-3},
                      lambda rs: [_rand(rs, 2, 3, 4, 5),
                                  _rand(rs, 3) + 1.0, _rand(rs, 3)]),
    "l2norm_instance": ("L2Normalization", {},
                        lambda rs: [_rand(rs, 3, 4, 2)]),
    "l2norm_channel": ("L2Normalization", {"mode": "channel"},
                       lambda rs: [_rand(rs, 2, 4, 3, 3)]),
    "l2norm_spatial": ("L2Normalization", {"mode": "spatial", "eps": 1e-6},
                       lambda rs: [_rand(rs, 2, 4, 3, 3)]),
    "lrn": ("LRN", {"alpha": 1e-4, "beta": 0.75, "knorm": 2.0, "nsize": 5},
            lambda rs: [_rand(rs, 2, 7, 4, 4, scale=3.0)]),
    "lrn_nsize3_strong": ("LRN", {"alpha": 0.5, "beta": 0.5, "knorm": 1.0,
                                  "nsize": 3},
                          lambda rs: [_rand(rs, 2, 4, 3, 3)]),
    "kl_sparse_identity": ("IdentityAttachKLSparseReg",
                           {"sparseness_target": 0.1},
                           lambda rs: [_rand(rs, 3, 5)]),
    "softmax_cross_entropy": ("softmax_cross_entropy", {},
                              lambda rs: [_rand(rs, 4, 6),
                                          _labels(rs, 4, 6)]),
    "dropout_eval": ("Dropout", {"p": 0.5}, lambda rs: [_rand(rs, 3, 5)]),
    # backward seeds: the head gradient is ignored
    "linear_regression": ("LinearRegressionOutput", {"grad_scale": 2.0},
                          lambda rs: [_rand(rs, 4, 3), _rand(rs, 4, 3)]),
    "logistic_regression": ("LogisticRegressionOutput", {},
                            lambda rs: [_rand(rs, 4, 3),
                                        rs.rand(4, 3).astype(np.float32)]),
    "mae_regression": ("MAERegressionOutput", {"grad_scale": 0.5},
                       lambda rs: [_rand(rs, 4, 3), _rand(rs, 4, 3)]),
    "linear_regression_flat_label": ("LinearRegressionOutput", {},
                                     lambda rs: [_rand(rs, 5, 1),
                                                 _rand(rs, 5)]),
    "svm": ("SVMOutput", {"margin": 1.0, "regularization_coefficient": 0.5},
            lambda rs: [_rand(rs, 5, 4), _labels(rs, 5, 4)]),
    "svm_linear": ("SVMOutput", {"margin": 0.5, "use_linear": True},
                   lambda rs: [_rand(rs, 5, 4), _labels(rs, 5, 4)]),
    "make_loss": ("MakeLoss", {"grad_scale": 0.25},
                  lambda rs: [_rand(rs, 3, 4)]),
    "make_loss_batch": ("make_loss", {"normalization": "batch"},
                        lambda rs: [_rand(rs, 3, 4)]),
}
# (cases whose gradient the label does not take)
WITH_LABEL = {"softmax_cross_entropy", "linear_regression",
              "logistic_regression", "mae_regression",
              "linear_regression_flat_label", "svm", "svm_linear"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    name, attrs, make = CASES[case]
    rs = np.random.RandomState(sorted(CASES).index(case))
    ins = make(rs)
    op = jreg.get_op(name)
    jouts = op.fcompute(jreg.parse_attrs(op, attrs),
                        [jnp.asarray(v) for v in ins],
                        jreg.OpContext(is_train=False))
    cots = [_rand(rs, *o.shape) for o in jouts]
    # eval forward; the training forward (no draws in these cases)
    for is_train in (False, True):
        if case in ("rrelu_eval", "dropout_eval") and is_train:
            continue    # draws: held below
        jo, jg = _run_jax(name, attrs, ins, cots, is_train)
        to, tg = _run_torch(name, attrs, ins, cots, is_train)
        assert len(to) == len(jo)
        for a, b in zip(to, jo):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        n_grad = len(ins) - (1 if case in WITH_LABEL else 0)
        for i in range(n_grad):
            np.testing.assert_allclose(tg[i], jg[i], rtol=RTOL, atol=ATOL,
                                       err_msg="grad of input %d" % i)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_infers_the_jax_shapes(case):
    name, attrs, make = CASES[case]
    ins = make(np.random.RandomState(0))
    shapes = [tuple(v.shape) for v in ins]
    jop, top = jreg.get_op(name), treg.get_op(name)
    known = [shapes[0]] + [None] * (len(shapes) - 1)
    if name in ("LeakyReLU", "InstanceNorm", "softmax_cross_entropy"):
        known = list(shapes)     # the JAX op infers from every input
    if case == "linear_regression_flat_label":
        known = list(shapes)
    j = jop.infer_shape(jreg.parse_attrs(jop, attrs), list(known), [])
    t = top.infer_shape(treg.parse_attrs(top, attrs), list(known), [])
    assert [tuple(s) for s in t[0]] == [tuple(s) for s in j[0]]
    assert [tuple(s) for s in t[1]] == [tuple(s) for s in j[1]]


# ---------------------------------------------------------------------------
# the cases of tests/test_operator_parity.py, through the port
# ---------------------------------------------------------------------------
RNG = np.random.RandomState(0)
POSNEG = np.array([[-1.5, -0.5, 0.0, 0.5, 1.5],
                   [2.0, -2.0, 0.25, -0.25, 1.0],
                   [0.1, 0.2, -0.3, 0.4, -0.5]], dtype=np.float32)


def test_lrn_forward_against_the_loop_reference():
    X = RNG.rand(2, 4, 3, 3).astype(np.float32)
    alpha, beta, knorm, nsize = 1e-4, 0.75, 2.0, 3
    out = tmx.nd.LRN(tmx.nd.array(X, ctx=tmx.cpu()), alpha=alpha, beta=beta,
                     knorm=knorm, nsize=nsize).asnumpy()
    ref = np.empty_like(X)
    half = nsize // 2
    for c in range(4):
        lo, hi = max(0, c - half), min(4, c + half + 1)
        sq = (X[:, lo:hi] ** 2).sum(axis=1)
        ref[:, c] = X[:, c] / (knorm + alpha / nsize * sq) ** beta
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_mae_regression_output_grad_through_an_executor():
    data = tmx.sym.Variable("data")
    net = tmx.sym.MAERegressionOutput(data, name="mae")
    ex = net.simple_bind(tmx.cpu(), data=(2, 3), mae_label=(2, 3))
    x = POSNEG[:2, :3].copy()
    ex.arg_dict["data"][:] = x
    ex.arg_dict["mae_label"][:] = np.zeros((2, 3), np.float32)
    ex.forward(is_train=True)
    np.testing.assert_allclose(ex.outputs[0].asnumpy(), x)
    ex.backward()
    # grad_scale / outputs per row · sign(pred − label)
    np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(),
                               np.sign(x) / 3.0, rtol=1e-5)


def test_kl_sparse_reg_and_softmax_activation_forward():
    x1 = RNG.rand(2, 3).astype(np.float32)
    out = tmx.nd.IdentityAttachKLSparseReg(tmx.nd.array(x1, ctx=tmx.cpu()))
    np.testing.assert_allclose(out.asnumpy(), x1)
    out = tmx.nd.SoftmaxActivation(tmx.nd.array(POSNEG, ctx=tmx.cpu()))
    e = np.exp(POSNEG - POSNEG.max(axis=1, keepdims=True))
    np.testing.assert_allclose(out.asnumpy(), e / e.sum(axis=1,
                                                        keepdims=True),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Dropout and rrelu: semantics (their streams are the port's own)
# ---------------------------------------------------------------------------
def _dropout(x, p, is_train, key=None, g=None):
    xt = torch.tensor(x, requires_grad=True)
    out = treg.get_op("Dropout").fcompute(
        {"p": p}, [xt], treg.OpContext(is_train=is_train, key=key))[0]
    grad = None
    if g is not None:
        grad = torch.autograd.grad(out, xt, torch.tensor(g))[0].numpy()
    return out.detach().numpy(), grad


@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_keeps_scales_and_masks_the_gradient(p):
    rs = np.random.RandomState(3)
    x = (rs.rand(64, 512) + 0.5).astype(np.float32)   # no zeros
    g = _rand(rs, 64, 512)
    key = mxr.fold_in(17, 0)
    out, grad = _dropout(x, p, True, key, g)
    mask = out != 0
    keep = np.float32(1.0 - p)
    np.testing.assert_array_equal(out[mask], x[mask] / keep)
    np.testing.assert_array_equal(grad, np.where(mask, g / keep, 0.0))
    n = x.size
    frac = mask.mean()
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(frac - (1 - p)) < 4 * sigma, frac
    again, _ = _dropout(x, p, True, key)
    np.testing.assert_array_equal(again, out)
    other, _ = _dropout(x, p, True, mxr.fold_in(17, 1))
    assert not np.array_equal(other != 0, mask)


def test_dropout_is_identity_in_eval_and_at_p_zero():
    x = _rand(np.random.RandomState(0), 4, 6)
    g = _rand(np.random.RandomState(1), 4, 6)
    for p, is_train in ((0.5, False), (0.0, True)):
        out, grad = _dropout(x, p, is_train, key=None, g=g)
        np.testing.assert_array_equal(out, x)
        np.testing.assert_array_equal(grad, g)


def test_rrelu_draws_slopes_in_training():
    rs = np.random.RandomState(5)
    x = _rand(rs, 128, 64)
    g = _rand(rs, 128, 64)
    lo, hi = 0.125, 0.334
    xt = torch.tensor(x, requires_grad=True)
    op = treg.get_op("LeakyReLU")
    attrs = {"act_type": "rrelu", "lower_bound": lo, "upper_bound": hi}
    out = op.fcompute(attrs, [xt], treg.OpContext(is_train=True, key=9))[0]
    grad = torch.autograd.grad(out, xt, torch.tensor(g))[0].numpy()
    out = out.detach().numpy()
    neg = x < 0
    np.testing.assert_array_equal(out[~neg], x[~neg])
    a = out[neg] / x[neg]
    assert a.min() >= lo - 1e-6 and a.max() < hi + 1e-6
    n = a.size
    sigma = (hi - lo) / np.sqrt(12.0 * n)
    assert abs(a.mean() - (lo + hi) / 2) < 4 * sigma
    np.testing.assert_allclose(grad[neg], g[neg] * a, rtol=1e-6)
    np.testing.assert_array_equal(grad[~neg], g[~neg])
    with pytest.raises(tmx.MXNetError, match="key"):
        op.fcompute(attrs, [xt], treg.OpContext(is_train=True))
