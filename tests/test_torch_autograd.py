"""``mx.autograd`` of the PyTorch port (mxnet_tpu_torch) against the JAX
package's, on the CPU.

The seven cases of ``tests/test_autograd.py`` run through both packages
on the same inputs (numpy, seeded): the gradients written by
``mark_variables`` + ``compute_gradient`` and those of
``grad_and_loss`` agree within rtol 1e-5, atol 1e-6 (float32), and each
also meets the analytic value the JAX test holds it to. The repair of
``ndarray.invoke``: an op runs in training mode under ``train_section``
(``nd.Dropout`` drops, with a mask that its replay on the tape repeats)
and is recorded; outside it, it is the identity and nothing is recorded.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import ndarray as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import ndarray as tnd

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
CPU = tmx.cpu()


def _both(fn_jax, fn_torch):
    """Run one case in each package; the gradients as numpy lists."""
    return fn_jax(), fn_torch()


def _close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["mul2", "exp", "log"])
def test_unary_func_grads(case):
    v = np.random.RandomState(0).rand(3, 3).astype(np.float32) + 0.5
    fns = {"mul2": (lambda nd: lambda x: x * 2, lambda a: 2 * np.ones_like(a)),
           "exp": (lambda nd: lambda x: nd.exp(x), np.exp),
           "log": (lambda nd: lambda x: nd.log(x), lambda a: 1.0 / a)}
    make, want = fns[case]

    def run(ag, nd, ctx):
        grads, loss = ag.grad_and_loss(make(nd))(nd.array(v, ctx=ctx))
        return [grads[0].asnumpy(), np.asarray(loss.asnumpy())]

    j = run(jag, jnd, jmx.cpu())
    t = run(tag, tnd, CPU)
    _close(j, t)
    np.testing.assert_allclose(t[0], want(v), rtol=1e-4)


def _mark_run(ag, nd, ctx, x_val, g_init, req, body):
    x = nd.array(x_val, ctx=ctx)
    gx = nd.array(g_init, ctx=ctx)
    ag.mark_variables([x], [gx], grad_reqs=req)
    with ag.train_section():
        outs = body(nd, x)
    ag.compute_gradient(outs)
    return gx.asnumpy()


CASES = {
    # name: (x, initial gradient, grad_req, body, analytic gradient)
    "mark_variables_backward": (
        np.array([[1.0, 2.0], [3.0, 4.0]], np.float32),
        np.zeros((2, 2), np.float32), "write",
        lambda nd, x: [nd.sum(x * x)], lambda x: 2 * x),
    "chain_of_ops": (
        np.random.RandomState(1).rand(4).astype(np.float32) + 0.1,
        np.zeros(4, np.float32), "write",
        lambda nd, x: [nd.exp(nd.log(x) * 2)], lambda x: 2 * x),
    "grad_req_add": (
        np.array([1.0, 2.0], np.float32), np.ones(2, np.float32), "add",
        lambda nd, x: [x * 3], lambda x: 1 + 3 * np.ones(2)),
    "multiple_outputs": (
        np.array([2.0], np.float32), np.zeros(1, np.float32), "write",
        lambda nd, x: [x * 2, x * x], lambda x: 2 + 2 * x),
    # beyond the JAX test: subtraction, division, negation and a
    # broadcast on the tape
    "arith_mix": (
        np.random.RandomState(2).rand(2, 3).astype(np.float32) + 0.5,
        np.zeros((2, 3), np.float32), "write",
        lambda nd, x: [nd.sum((1.0 - x) / (x + 2.0) - (-x))],
        lambda x: -3.0 / (x + 2.0) ** 2 + 1.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_marked_variables_match_the_jax_tape(name):
    x, g0, req, body, want = CASES[name]
    j = _mark_run(jag, jnd, jmx.cpu(), x, g0, req, body)
    t = _mark_run(tag, tnd, CPU, x, g0, req, body)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t, want(x), rtol=1e-4)


def test_training_flag():
    for ag in (jag, tag):
        assert not ag.is_training()
        with ag.train_section():
            assert ag.is_training() and ag.is_recording()
            with ag.test_section():
                assert not ag.is_training()
            assert ag.is_training()
        assert not ag.is_training()


def test_dropout_respects_training_mode():
    x = tnd.ones((50, 50), ctx=CPU)
    out_eval = tnd.Dropout(x, p=0.5)
    assert np.array_equal(out_eval.asnumpy(), x.asnumpy())
    with tag.train_section():
        out_train = tnd.Dropout(x, p=0.5)
    assert (out_train.asnumpy() == 0).mean() > 0.2
    with tag.test_section():
        assert np.array_equal(tnd.Dropout(x, p=0.5).asnumpy(), x.asnumpy())


def test_invoke_records_and_the_replay_repeats_the_mask():
    """Under train_section invoke records each op (none outside it), and
    the tape's replay draws Dropout's mask of the recorded call: the
    gradient of sum(Dropout(x) * w) w.r.t. w is exactly the output."""
    rng = np.random.RandomState(3)
    x = tnd.array(rng.rand(20, 20).astype(np.float32), ctx=CPU)
    w = tnd.array(rng.rand(20, 20).astype(np.float32), ctx=CPU)
    gw = tnd.zeros((20, 20), ctx=CPU)
    tnd.exp(x)
    assert tag._st().tape == []
    tag.mark_variables([w], [gw])
    with tag.train_section():
        d = tnd.Dropout(x, p=0.5)
        y = tnd.sum(d * w)
        assert [n.op.name for n in tag._st().tape] == \
            ["Dropout", "broadcast_mul", "sum"]
    tag.compute_gradient([y])
    np.testing.assert_array_equal(gw.asnumpy(), d.asnumpy())
    assert tag._st().tape == []


def test_retain_graph_and_out_grads():
    """retain_graph keeps the tape for a second backward; out_grads seed
    the heads (the JAX package's contract)."""
    v = np.random.RandomState(4).rand(5).astype(np.float32)
    head = np.random.RandomState(5).rand(5).astype(np.float32)
    res = []
    for ag, nd, ctx in ((jag, jnd, jmx.cpu()), (tag, tnd, CPU)):
        x = nd.array(v, ctx=ctx)
        gx = nd.zeros(5, ctx=ctx)
        ag.mark_variables([x], [gx])
        with ag.train_section():
            y = x * x
        ag.compute_gradient([y], out_grads=[nd.array(head, ctx=ctx)],
                            retain_graph=True)
        first = gx.asnumpy()
        ag.compute_gradient([y])
        res.append((first, gx.asnumpy()))
        ag.set_is_training(False)
    _close(res[0], res[1])
    np.testing.assert_allclose(res[1][0], 2 * v * head, rtol=1e-5)
