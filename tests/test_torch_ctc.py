"""The sequence-loss slice of the PyTorch port (mxnet_tpu_torch
``ops/sequence_loss.py``, ``plugin/warpctc.py`` and the ``ctc_train`` and
``deepspeech_mini`` twins) against the JAX package, on the CPU.

CTCLoss forward and input gradient against the JAX op (rtol 1e-5, atol
1e-6) on feasible alignments and on infeasible ones (a label longer
than the frames allow), where both cost ~1e30 (the finite NEG_INF) and
back-propagate alike; against brute-force enumeration of the
alignments (``tests/test_sequence_loss.py``'s, within 1e-3). WarpCTC's
softmax output and injected gradient against the JAX plugin's, and the
plugin's namespaces. The two twins at their defaults pass their JAX
scripts' asserts.
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu.plugin  # noqa: F401  (registers the JAX WarpCTC op)
from mxnet_tpu import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import registry as treg
from mxnet_tpu_torch.examples import ctc_train, deepspeech_mini

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _both(name, attrs, data, label, g):
    """(JAX outputs, data gradient), (port outputs, data gradient)."""
    jop, top = jreg.get_op(name), treg.get_op(name)
    ja = jreg.parse_attrs(jop, attrs)
    out, vjp = jax.vjp(lambda d: jop.fcompute(ja, [d, jnp.asarray(label)],
                                              None)[0], jnp.asarray(data))
    jg = vjp(jnp.asarray(g))[0]
    d = torch.tensor(data, requires_grad=True)
    t = top.fcompute(treg.parse_attrs(top, attrs),
                     [d, torch.tensor(label)], None)[0]
    t.backward(torch.tensor(g))
    return (np.asarray(out), np.asarray(jg)), (t.detach().numpy(),
                                               d.grad.numpy())


def _ctc_brute(logits, labels, blank=0):
    T, C = logits.shape
    m = logits.max(-1, keepdims=True)
    lp = logits - np.log(np.exp(logits - m).sum(-1, keepdims=True)) - m
    target = [l for l in labels if l > 0]

    def collapse(path):
        out, prev = [], None
        for p in path:
            if p != prev and p != blank:
                out.append(p)
            prev = p
        return out

    total = -np.inf
    for path in itertools.product(range(C), repeat=T):
        if collapse(path) == target:
            total = np.logaddexp(total, sum(lp[t, path[t]]
                                            for t in range(T)))
    return -total


@pytest.mark.parametrize("T,labels", [
    (7, [[1, 2, 2], [3, 0, 0], [4, 1, 0]]),
    (5, [[1, 1, 1], [2, 2, 0], [0, 0, 0]]),
    (12, [[2, 3, 4], [1, 0, 0], [4, 4, 1]])])
def test_ctc_feasible(T, labels):
    rs = np.random.RandomState(T)
    data = rs.randn(T, 3, 5).astype(np.float32)
    label = np.array(labels, np.float32)
    g = rs.rand(3).astype(np.float32)
    (jo, jg), (to, tg) = _both("CTCLoss", {}, data, label, g)
    assert (jo < 1e3).all()
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


def test_ctc_infeasible_costs_1e30_in_both():
    """Three repeated labels need 5 frames (a blank between repeats);
    with 2 frames no alignment exists."""
    rs = np.random.RandomState(1)
    data = rs.randn(2, 2, 4).astype(np.float32)
    label = np.array([[1, 1, 1], [2, 0, 0]], np.float32)
    g = np.ones(2, np.float32)
    (jo, jg), (to, tg) = _both("ctc_loss", {}, data, label, g)
    assert jo[0] > 1e29 and to[0] > 1e29 and jo[1] < 1e3
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)
    assert np.isfinite(tg).all()


def test_ctc_equals_brute_force():
    rs = np.random.RandomState(0)
    data = rs.randn(4, 2, 3).astype(np.float32)
    labels = np.array([[1, 2], [2, 0]], np.float32)
    loss = tmx.nd.CTCLoss(tmx.nd.array(data, ctx=tmx.cpu()),
                          tmx.nd.array(labels, ctx=tmx.cpu())).asnumpy()
    for n in range(2):
        assert abs(loss[n] - _ctc_brute(data[:, n],
                                        labels[n].astype(int))) < 1e-3


def test_ctc_gradient_through_a_bound_executor():
    """``tests/test_sequence_loss.py``'s executor case."""
    data = tmx.sym.Variable("data")
    label = tmx.sym.Variable("label")
    loss = tmx.sym.MakeLoss(tmx.sym._contrib_CTCLoss(data, label,
                                                     name="ctc"))
    e = loss.simple_bind(tmx.cpu(), data=(5, 2, 4), label=(2, 2))
    e.arg_dict["data"][:] = np.random.RandomState(2).randn(5, 2, 4)
    e.arg_dict["label"][:] = np.array([[1, 2], [3, 0]])
    e.forward(is_train=True)
    e.backward()
    g = e.grad_dict["data"].asnumpy()
    assert np.abs(g).sum() > 0 and not np.isnan(g).any()


def test_warpctc_softmax_and_injected_gradient():
    rs = np.random.RandomState(3)
    T, N, C, L = 6, 3, 5, 2
    data = rs.randn(T * N, C).astype(np.float32)
    label = np.array([1, 2, 3, 3, 4, 0], np.float32)
    g = rs.randn(T * N, C).astype(np.float32)     # ignored by the backward
    attrs = {"input_length": T, "label_length": L}
    (jo, jg), (to, tg) = _both("WarpCTC", attrs, data, label, g)
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)
    # the injected gradient is d(sum CTC)/d(logits) of CTCLoss
    d = torch.tensor(data.reshape(T, N, C), requires_grad=True)
    treg.get_op("CTCLoss").fcompute(
        {}, [d, torch.tensor(label.reshape(N, L))], None)[0].sum().backward()
    np.testing.assert_allclose(tg, d.grad.numpy().reshape(T * N, C),
                               rtol=RTOL, atol=ATOL)


def test_warpctc_plugin_namespaces():
    assert hasattr(tmx.sym, "WarpCTC") and hasattr(tmx.nd, "WarpCTC")
    assert tmx.plugin.warpctc is not None
    sym = tmx.sym.WarpCTC(tmx.sym.Variable("data"),
                          tmx.sym.Variable("label"), input_length=4,
                          label_length=2)
    args, outs, _ = sym.infer_shape(data=(12, 5))
    assert args == [(12, 5), (6,)] and outs == [(12, 5)]


@pytest.mark.parametrize("twin", [ctc_train, deepspeech_mini],
                         ids=["ctc_train", "deepspeech_mini"])
def test_twin_passes_its_jax_script_assert(twin):
    res = twin.main(["--cpu"])
    assert res["accuracy"] > (0.8 if twin is ctc_train else 0.7)
    assert res["ms_per_step"] > 0 and res["steps"] > 0
