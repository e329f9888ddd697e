"""``mx.operator`` and the ``Custom`` op of the PyTorch port
(mxnet_tpu_torch) against the JAX package's, on the CPU.

The cases of ``tests/test_custom_op.py`` run through both packages on
the same numpy-seeded inputs, each property class registered in each
package: the imperative ``nd.Custom``, a bound ``sym.Custom`` forward
and backward, the op in the middle of a graph, the legacy ``NumpyOp``
alias, and the custom softmax trained through ``Module.fit`` (the JAX
test's accuracy assert) with its parameters after 3 SGD steps from the
same start held to the JAX package's (float32: rtol 1e-5, atol 1e-6).
Within the port, the custom-softmax net gives the same parameters bit
for bit on the fused and classic routes and under ``remat="full"``
(whose backward calls the user's forward again); under ``bf16`` the
host edge runs in float32 and the outputs come back in bfloat16.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import operator as jop

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import operator as top

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
CPU = tmx.cpu()


def _register(op_mod, prefix):
    """The JAX test's property classes, registered under ``prefix``."""

    class Sqr(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0].asnumpy() ** 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        2 * in_data[0].asnumpy() * out_grad[0].asnumpy())

    @op_mod.register(prefix + "sqr")
    class SqrProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    class Softmax(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(int)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], y)

    @op_mod.register(prefix + "softmax")
    class SoftmaxProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class LegacySqr(op_mod.NumpyOp):
        forward = Sqr.forward
        backward = Sqr.backward

    @op_mod.register(prefix + "legacy_sqr")
    class LegacyProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return LegacySqr()


_register(jop, "ptest_")
_register(top, "ptest_")
PKGS = ((jmx, jmx.cpu()), (tmx, CPU))


def test_custom_op_imperative():
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    j, t = [mx.nd.Custom(mx.nd.array(x, ctx=c), op_type="ptest_sqr")
            .asnumpy() for mx, c in PKGS]
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t, x ** 2, rtol=1e-6)


def _bound(mx, ctx, sym, x):
    e = sym.simple_bind(ctx, data=x.shape)
    e.arg_dict["data"][:] = x
    e.forward(is_train=True)
    out = e.outputs[0].asnumpy()
    e.backward()
    return out, e.grad_dict["data"].asnumpy()


@pytest.mark.parametrize("case", ["alone", "middle", "legacy"])
def test_custom_op_symbolic_forward_backward(case):
    x = np.random.RandomState(1).rand(3, 4).astype(np.float32) + 0.5
    res = []
    for mx, ctx in PKGS:
        s = mx.sym.Variable("data")
        if case == "alone":
            s = mx.sym.Custom(s, op_type="ptest_sqr", name="sqr0")
        elif case == "middle":
            s = mx.sym.sum(mx.sym.Custom(s, op_type="ptest_sqr", name="sq"))
        else:
            s = mx.sym.sum(mx.sym.Custom(s, op_type="ptest_legacy_sqr"))
        res.append(_bound(mx, ctx, s, x))
    (jo, jg), (to, tg) = res
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, 2 * x, rtol=1e-5)
    assert top.NumpyOp is top.CustomOp and top.NDArrayOp is top.CustomOp


def _softmax_net(mx, op_type="ptest_softmax"):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
    return mx.sym.Custom(net, mx.sym.Variable("softmax_label"),
                         op_type=op_type, name="softmax")


def _toy():
    rng = np.random.RandomState(0)
    X = rng.randn(64, 6).astype(np.float32)
    w = rng.randn(6, 4)
    y = X.dot(w).argmax(axis=1).astype(np.float32)
    return X, y


def _start_params():
    rng = np.random.RandomState(9)
    return {"fc_weight": (rng.randn(4, 6) * 0.1).astype(np.float32),
            "fc_bias": np.zeros(4, np.float32)}


def test_custom_softmax_trains_and_matches_the_jax_steps():
    X, y = _toy()
    start = _start_params()
    got = []
    for mx, ctx in PKGS:
        it = mx.io.NDArrayIter(X, y, batch_size=16)
        mod = mx.mod.Module(_softmax_net(mx), context=ctx)
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.5},
                arg_params={k: mx.nd.array(v, ctx=ctx)
                            for k, v in start.items()},
                aux_params={}, force_init=True, eval_metric="acc")
        mod.fit(it, num_epoch=9, begin_epoch=1,
                optimizer_params={"learning_rate": 0.5})
        got.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
        assert mod.score(it, "acc")[0][1] > 0.8
    for k in got[0]:
        np.testing.assert_allclose(got[1][k], got[0][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_three_steps_match_the_jax_package():
    X, y = _toy()
    start = _start_params()
    got = []
    for mx, ctx in PKGS:
        mod = mx.mod.Module(_softmax_net(mx), context=ctx)
        mod.bind(data_shapes=[("data", (16, 6))],
                 label_shapes=[("softmax_label", (16,))])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                    for k, v in start.items()})
        mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
        for i in range(3):
            b = mx.io.DataBatch(
                data=[mx.nd.array(X[16 * i:16 * (i + 1)], ctx=ctx)],
                label=[mx.nd.array(y[16 * i:16 * (i + 1)], ctx=ctx)])
            mod.forward_backward(b)
            mod.update()
        got.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in got[0]:
        np.testing.assert_allclose(got[1][k], got[0][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _port_steps(**kw):
    X, y = _toy()
    mod = tmx.mod.Module(_softmax_net(tmx), context=CPU, **kw)
    mod.bind(data_shapes=[("data", (16, 6))],
             label_shapes=[("softmax_label", (16,))])
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=CPU)
                                for k, v in _start_params().items()})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.5,
                                         "momentum": 0.9})
    for i in range(3):
        b = tmx.io.DataBatch(
            data=[tmx.nd.array(X[16 * i:16 * (i + 1)], ctx=CPU)],
            label=[tmx.nd.array(y[16 * i:16 * (i + 1)], ctx=CPU)])
        mod.forward_backward(b)
        mod.update()
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_fused_classic_and_remat_bit_for_bit():
    fused_mod, fused = _port_steps()
    assert type(fused_mod._exec_group).__name__ == "MeshExecutorGroup"
    _, classic = _port_steps(_allow_fused=False)
    _, remat = _port_steps(remat="full")
    for k in fused:
        np.testing.assert_array_equal(fused[k], classic[k], err_msg=k)
        np.testing.assert_array_equal(fused[k], remat[k], err_msg=k)


def test_bf16_mode_casts_at_the_host_edge():
    mod, params = _port_steps(precision="bf16")
    assert mod._exec_group.execs[0].outputs[0]._read().dtype in (
        torch.float32, torch.bfloat16)
    x = tmx.nd.array(np.random.RandomState(2).rand(2, 3), ctx=CPU,
                     dtype="bfloat16")
    out = tmx.nd.Custom(x, op_type="ptest_sqr")
    assert out._read().dtype == torch.bfloat16
    np.testing.assert_allclose(out.asnumpy(), x.asnumpy() ** 2, rtol=1e-2)
    assert all(np.isfinite(v).all() for v in params.values())


def test_unregistered_op_type_raises():
    with pytest.raises(tmx.MXNetError):
        tmx.nd.Custom(tmx.nd.ones((2, 2), ctx=CPU), op_type="ptest_nope")
