"""``SequentialModule``, ``PythonModule``/``PythonLossModule`` and
``model.FeedForward`` of the PyTorch port (mxnet_tpu_torch) against the
JAX package's, on the CPU, mirroring ``tests/test_module.py:188–242``.

Both packages start from the same parameters (numpy, seeded, passed as
``arg_params``) and take the same batches (``NDArrayIter`` without
shuffle); the parameters after the same steps agree within rtol 1e-5,
atol 1e-6 (float32). The JAX tests' own asserts hold in the port
(accuracy above 0.5 after 4 epochs of the chain, above 0.85 for
FeedForward, the loss brick's gradient). Within the port: the chain's
first stage stays on the fused route and the second takes the classic
one, no stage re-binds (each stage's parameter ``data_ptr``s are those
of its first bind after 3 steps), and an eval batch shorter than the
bound one runs padded and is scored on its real rows only.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.io import DataBatch as JBatch
from mxnet_tpu.module.python_module import PythonLossModule as JLoss

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.io import DataBatch as TBatch
from mxnet_tpu_torch.module.python_module import PythonLossModule as TLoss

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
CPU = tmx.cpu()
PKGS = ((jmx, jmx.cpu()), (tmx, CPU))


def _toy_data(n=160, dim=8, nclass=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, dim).astype(np.float32)
    w = rng.randn(dim, nclass)
    y = np.argmax(X.dot(w), axis=1).astype(np.float32)
    return X, y


def _start(shapes, seed=5):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * 0.3).astype(np.float32)
            for k, s in sorted(shapes.items())}


SEQ_SHAPES = {"fc1_weight": (8, 8), "fc1_bias": (8,),
              "fc2_weight": (3, 8), "fc2_bias": (3,)}


def _seq(mx, ctx):
    net1 = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                                 name="fc1")
    net2 = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("fc1_output"), num_hidden=3, name="fc2"),
        name="softmax")
    smod = mx.mod.SequentialModule()
    smod.add(mx.mod.Module(net1, label_names=[], context=ctx))
    smod.add(mx.mod.Module(net2, data_names=["fc1_output"], context=ctx),
             take_labels=True, auto_wiring=True)
    return smod


def _train_seq(mx, ctx, epochs=4):
    X, y = _toy_data(nclass=3)
    train = mx.io.NDArrayIter(X, y, batch_size=16)
    smod = _seq(mx, ctx)
    smod.bind(data_shapes=train.provide_data,
              label_shapes=train.provide_label)
    smod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx) for k, v
                                 in _start(SEQ_SHAPES).items()})
    smod.init_optimizer(optimizer_params={"learning_rate": 0.5})
    metric = mx.metric.Accuracy()
    for _ in range(epochs):
        train.reset()
        for batch in train:
            smod.forward_backward(batch)
            smod.update()
            smod.update_metric(metric, batch.label)
    return smod, metric.get()[1], \
        {k: v.asnumpy() for k, v in smod.get_params()[0].items()}


def test_sequential_module_matches_the_jax_chain():
    _, jacc, jp = _train_seq(jmx, jmx.cpu())
    smod, tacc, tp = _train_seq(tmx, CPU)
    assert tacc > 0.5
    np.testing.assert_allclose(tacc, jacc, rtol=1e-6)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _params_ptr(mod):
    ex = mod._exec_group.execs[0]
    return {n: ex.arg_dict[n]._read().data_ptr()
            for n in mod._param_names}


def test_stages_keep_their_bind_and_routes():
    X, y = _toy_data(nclass=3)
    train = tmx.io.NDArrayIter(X, y, batch_size=16)
    smod = _seq(tmx, CPU)
    smod.bind(data_shapes=train.provide_data,
              label_shapes=train.provide_label)
    smod.init_params(arg_params={k: tmx.nd.array(v, ctx=CPU) for k, v
                                 in _start(SEQ_SHAPES).items()})
    smod.init_optimizer(optimizer_params={"learning_rate": 0.5})
    first, second = smod._modules
    assert type(first._exec_group).__name__ == "MeshExecutorGroup"
    assert type(second._exec_group).__name__ == "DataParallelExecutorGroup"
    groups = [m._exec_group for m in smod._modules]
    ptrs = [_params_ptr(m) for m in smod._modules]
    for _, batch in zip(range(3), train):
        smod.forward_backward(batch)
        smod.update()
    assert [m._exec_group for m in smod._modules] == groups
    assert [_params_ptr(m) for m in smod._modules] == ptrs
    assert first._optimizer.num_update == 3


def test_sequential_equals_one_module():
    """Two stages train as the one symbol does, bit for bit: the first
    stage's backward takes the gradients from the graph of the forward
    the second stage read."""
    X, y = _toy_data(nclass=3)
    _, _, seq = _train_seq(tmx, CPU, epochs=2)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=8,
                               name="fc1"), num_hidden=3, name="fc2"),
        name="softmax")
    mod = tmx.mod.Module(net, context=CPU, _allow_fused=False)
    train = tmx.io.NDArrayIter(X, y, batch_size=16)
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=CPU) for k, v
                                in _start(SEQ_SHAPES).items()})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
    for _ in range(2):
        train.reset()
        for batch in train:
            mod.forward_backward(batch)
            mod.update()
    for k, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(seq[k], v.asnumpy(), err_msg=k)


def test_eval_tail_pad_marker_reaches_the_metric():
    X, y = _toy_data(nclass=3)
    smod, _, _ = _train_seq(tmx, CPU, epochs=1)
    short = TBatch(data=[tmx.nd.array(X[:10], ctx=CPU)],
                   label=[tmx.nd.array(y[:10], ctx=CPU)])
    smod.forward(short, is_train=False)
    assert smod._eval_pad_extra == 6
    assert smod._modules[1]._eval_pad_extra == 6
    metric = tmx.metric.Accuracy()
    smod.update_metric(metric, short.label)
    assert metric.num_inst == 10
    full = TBatch(data=[tmx.nd.array(X[:16], ctx=CPU)],
                  label=[tmx.nd.array(y[:16], ctx=CPU)])
    smod.forward(full, is_train=False)
    want = smod.get_outputs()[0].asnumpy()[:10]
    smod.forward(short, is_train=False)
    np.testing.assert_array_equal(
        smod._unpadded_outputs(short)[0].asnumpy(), want)


def test_sequential_rejects_duplicate_names_and_bad_meta():
    with pytest.raises(ValueError):
        tmx.mod.SequentialModule().add(
            tmx.mod.Module(tmx.sym.Variable("data"), context=CPU),
            bogus=True)
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=4,
                                 name="fc")
    smod = tmx.mod.SequentialModule()
    smod.add(tmx.mod.Module(net, label_names=[], context=CPU))
    smod.add(tmx.mod.Module(net, label_names=[], context=CPU),
             auto_wiring=True)
    smod.bind(data_shapes=[("data", (2, 4))], for_training=False)
    with pytest.raises(ValueError, match="duplicated"):
        smod.init_params()


# ---------------------------------------------------------------------------
# PythonLossModule
# ---------------------------------------------------------------------------
def _grad_func(scores, labels):
    return scores.asnumpy() - np.eye(4)[labels.asnumpy().astype(int)]


def test_python_loss_module_contract():
    for mx, Loss, Batch, ctx in ((jmx, JLoss, JBatch, jmx.cpu()),
                                 (tmx, TLoss, TBatch, CPU)):
        mod = Loss(grad_func=_grad_func)
        mod.bind(data_shapes=[("data", (2, 4))],
                 label_shapes=[("softmax_label", (2,))])
        mod.init_params()
        mod.init_optimizer()
        assert mod.output_shapes == [("pyloss_output", (2, 4))]
        scores = mx.nd.array(np.full((2, 4), 0.25, np.float32), ctx=ctx)
        labels = mx.nd.array(np.array([1, 3], np.float32), ctx=ctx)
        mod.forward(Batch([scores], [labels]), is_train=True)
        np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), 0.25)
        mod.backward()
        np.testing.assert_allclose(mod.get_input_grads()[0].asnumpy(),
                                   np.full((2, 4), 0.25) -
                                   np.eye(4)[[1, 3]], rtol=1e-6)
        metric = mx.metric.Loss()
        mod.update_metric(metric, [labels])
        assert metric.num_inst > 0
        with pytest.raises(ValueError):
            mod.backward(out_grads=[scores])
        assert mod.get_params() == ({}, {})


def _softmax_grad(scores, labels):
    s = scores.asnumpy()
    e = np.exp(s - s.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    return (p - np.eye(4)[labels.asnumpy().astype(int)]) / s.shape[0]


def _loss_chain(mx, Loss, ctx, steps=6):
    X, y = _toy_data()
    it = mx.io.NDArrayIter(X, y, batch_size=16)
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                name="fc")
    smod = mx.mod.SequentialModule()
    smod.add(mx.mod.Module(net, label_names=[], context=ctx))
    smod.add(Loss(grad_func=_softmax_grad), take_labels=True,
             auto_wiring=True)
    smod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    smod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx) for k, v in
                                 _start({"fc_weight": (4, 8),
                                         "fc_bias": (4,)}).items()})
    smod.init_optimizer(optimizer_params={"learning_rate": 1.0,
                                          "rescale_grad": 1.0})
    for _, batch in zip(range(steps), it):
        smod.forward_backward(batch)
        smod.update()
    return {k: v.asnumpy() for k, v in smod.get_params()[0].items()}


def test_python_loss_module_in_a_chain_matches_the_jax_package():
    jp = _loss_chain(jmx, JLoss, jmx.cpu())
    tp = _loss_chain(tmx, TLoss, CPU)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# FeedForward
# ---------------------------------------------------------------------------
FF_SHAPES = {"fc1_weight": (16, 8), "fc1_bias": (16,),
             "fc2_weight": (4, 16), "fc2_bias": (4,)}


def _softmax_mlp(mx):
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def test_feedforward_api():
    X, y = _toy_data()
    tmx.random.seed(13)
    model = tmx.model.FeedForward(_softmax_mlp(tmx), ctx=CPU, num_epoch=6,
                                  numpy_batch_size=16, learning_rate=0.5)
    model.fit(X, y)
    assert model.score(X, y) > 0.85
    assert model.predict(X).shape == (160, 4)
    assert tmx.FeedForward is tmx.model.FeedForward


def test_feedforward_matches_the_jax_package(tmp_path):
    X, y = _toy_data()
    got = []
    for mx, ctx in PKGS:
        start = {k: mx.nd.array(v, ctx=ctx)
                 for k, v in _start(FF_SHAPES).items()}
        model = mx.model.FeedForward(_softmax_mlp(mx), ctx=ctx, num_epoch=3,
                                     numpy_batch_size=16, arg_params=start,
                                     aux_params={}, learning_rate=0.5)
        model.fit(mx.io.NDArrayIter(X, y, batch_size=16))
        got.append(({k: v.asnumpy() for k, v in model.arg_params.items()},
                    model.predict(X), model.score(X, y)))
    (jp, jpred, jacc), (tp, tpred, tacc) = got
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(tpred, jpred, rtol=1e-4, atol=1e-6)
    assert tacc == jacc
    # save and load: the same predictions from the files
    prefix = str(tmp_path / "ff")
    model = tmx.model.FeedForward(_softmax_mlp(tmx), ctx=CPU, num_epoch=3,
                                  numpy_batch_size=16,
                                  arg_params={k: tmx.nd.array(v, ctx=CPU)
                                              for k, v in tp.items()},
                                  aux_params={})
    model.save(prefix)
    loaded = tmx.model.FeedForward.load(prefix, 3, ctx=CPU,
                                        numpy_batch_size=16)
    np.testing.assert_array_equal(loaded.predict(X), model.predict(X))
