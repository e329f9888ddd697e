"""The fused one-program training route of the PyTorch port
(mxnet_tpu_torch ``MeshExecutorGroup``), held to
``tests/test_module_fused.py``'s single-device contracts on the CPU: the
fused group is the default bind and ``_allow_fused=False`` /
``MXNET_MODULE_FUSED=0`` / input gradients give the classic one; a fused
step equals the classic step bit for bit (SGD and Adam, parameters and
optimizer state); reading gradients before ``update()`` falls back to a
materialised backward; the outputs after ``update()`` are the step's; the
BatchNorm EMA moves once a step; no batch is dropped; ``remat`` equals the
plain step and its replays never apply the EMA twice;
``predict(batch_group=)`` equals the per-batch loop. Against the JAX
package's fused route, from the same numpy-seeded parameters: parameters
and outputs after 3 steps within rtol 1e-5, plain and under remat.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.module.executor_group import DataParallelExecutorGroup
from mxnet_tpu_torch.module.mesh_executor_group import MeshExecutorGroup
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

CPU = mx.cpu()
BATCH = 8
OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        "adam": {"learning_rate": 0.05}}


def _conv_bn_net(pkg=mx, names=TNameManager):
    with names():
        s = pkg.sym
        net = s.Variable("data")
        net = s.Convolution(net, kernel=(3, 3), num_filter=8, pad=(1, 1),
                            name="conv1")
        net = s.BatchNorm(net, name="bn1", fix_gamma=False)
        net = s.Activation(net, act_type="relu")
        net = s.Convolution(net, kernel=(3, 3), num_filter=8, pad=(1, 1),
                            name="conv2")
        net = s.BatchNorm(net, name="bn2")
        net = s.Activation(net, act_type="relu")
        net = s.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
        net = s.Flatten(net)
        net = s.FullyConnected(net, num_hidden=10, name="fc1")
        return s.SoftmaxOutput(net, name="softmax")


def _bn_mlp():
    s = mx.sym
    net = s.Variable("data")
    net = s.FullyConnected(net, num_hidden=8, name="fc1")
    net = s.BatchNorm(net, name="bn", fix_gamma=False)
    net = s.FullyConnected(net, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


SHAPE = (BATCH, 3, 8, 8)


def _module(net=None, opt="sgd", shape=SHAPE, **kw):
    mx.random.seed(7)
    mod = mx.mod.Module(net or _conv_bn_net(), context=CPU, **kw)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer=opt, optimizer_params=OPTS[opt])
    return mod


def _batches(n, shape=SHAPE, seed=0):
    rng = np.random.RandomState(seed)
    return [mx.io.DataBatch(
        [mx.nd.array(rng.rand(*shape).astype(np.float32), ctx=CPU)],
        [mx.nd.array(rng.randint(0, 10, shape[0]).astype(np.float32),
                     ctx=CPU)]) for _ in range(n)]


def _run(mod, batches):
    for b in batches:
        mod.forward_backward(b)
        mod.update()
    return mod


def _state(mod):
    """Parameters, aux and optimizer-state leaves as numpy, by name."""
    a, x = mod.get_params()
    out = {k: v.asnumpy() for k, v in list(a.items()) + list(x.items())}

    def flat(st):
        if st is None:
            return []
        if isinstance(st, (tuple, list)):
            return [y for s in st for y in flat(s)]
        return [st.asnumpy()]

    for k, st in mod._updater.states.items():
        for i, leaf in enumerate(flat(st)):
            out["state%d_%d" % (k, i)] = leaf
    return out


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fused_group_selected(monkeypatch):
    mod = mx.mod.Module(_conv_bn_net(), context=CPU)
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (BATCH,))])
    assert isinstance(mod._exec_group, MeshExecutorGroup)
    for kw, env in (({"_allow_fused": False}, None),
                    ({}, "0")):
        if env is not None:
            monkeypatch.setenv("MXNET_MODULE_FUSED", env)
        mod = mx.mod.Module(_conv_bn_net(), context=CPU, **kw)
        mod.bind(data_shapes=[("data", SHAPE)],
                 label_shapes=[("softmax_label", (BATCH,))])
        assert type(mod._exec_group) is DataParallelExecutorGroup
    monkeypatch.delenv("MXNET_MODULE_FUSED")
    mod = mx.mod.Module(_conv_bn_net(), context=CPU)
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (BATCH,))],
             inputs_need_grad=True)
    assert type(mod._exec_group) is DataParallelExecutorGroup


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fused_step_matches_classic_bit_for_bit(opt):
    """Three fused steps equal three classic steps bit for bit on the
    CPU: parameters, aux and optimizer state (the same operations in the
    same order)."""
    batches = _batches(3)
    fused = _run(_module(opt=opt), batches)
    classic = _run(_module(opt=opt, _allow_fused=False), batches)
    assert fused._exec_group.fused and not classic._exec_group.__dict__.get(
        "fused", False)
    _assert_bitwise(_state(fused), _state(classic))
    np.testing.assert_array_equal(fused.get_outputs()[0].asnumpy(),
                                  classic.get_outputs()[0].asnumpy())


def test_fused_fit_matches_classic_fit():
    """Module.fit through both routes: the same parameters, bit for bit,
    and the same training metric (device tally against host update)."""
    rng = np.random.RandomState(3)
    X = rng.rand(4 * BATCH, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 10, 4 * BATCH).astype(np.float32)
    res = []
    for kw in ({}, {"_allow_fused": False}):
        mx.random.seed(5)
        mod = mx.mod.Module(_conv_bn_net(), context=CPU, **kw)
        metric = mx.metric.Accuracy()
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=2,
                eval_metric=metric, optimizer_params=OPTS["sgd"],
                initializer=mx.init.Xavier())
        res.append((mod, metric.get()[1]))
    _assert_bitwise(_state(res[0][0]), _state(res[1][0]))
    assert res[0][1] == res[1][1]


def test_one_program_step_early_grad_read_falls_back():
    """Reading gradients between backward() and update() runs the
    deferred forward + backward (parameters still before the update),
    and update() takes the classic route: the numbers are the same."""
    batch = _batches(1)[0]
    ref = _run(_module(), [batch] * 3)
    mod = _module()
    for _ in range(3):
        mod.forward_backward(batch)
        g = mod._exec_group._grad_dict["conv1_weight"].asnumpy()
        assert np.isfinite(g).all() and np.abs(g).sum() > 0
        assert not mod._exec_group._pending_bwd
        mod.update()
    _assert_bitwise(_state(ref), _state(mod))


def test_one_program_step_outputs_and_metric():
    """get_outputs()/update_metric after update() see the step's
    outputs."""
    mod = _module()
    batches = _batches(2)
    _run(mod, batches)
    out = mod.get_outputs()[0].asnumpy()
    assert out.shape == (BATCH, 10)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
    ref = _module()
    ref._exec_group._step_enabled = False
    _run(ref, batches)
    np.testing.assert_array_equal(out, ref.get_outputs()[0].asnumpy())
    metric = mx.metric.Accuracy()
    mod.update_metric(metric, batches[-1].label)
    assert 0.0 <= metric.get()[1] <= 1.0


def _bn_aux(mod):
    return {n: b.asnumpy() for n, b in mod._exec_group._aux_dict.items()}


def test_one_program_step_no_double_bn_ema():
    """Outputs read between forward and update materialise the forward
    (EMA once); the step re-runs from the aux it started from."""
    batch = _batches(1, shape=(BATCH, 6))[0]
    auxes = []
    for enabled in (False, True):
        mod = _module(_bn_mlp(), shape=(BATCH, 6))
        mod._exec_group._step_enabled = enabled
        mod.forward(batch, is_train=True)
        mod.get_outputs()[0].asnumpy()
        mod.backward()
        mod.update()
        auxes.append(_bn_aux(mod))
    _assert_bitwise(*auxes)


def test_one_program_step_no_dropped_batch():
    """Two forward_backward calls before one update: the first batch's
    deferred forward + backward (its EMA too) still runs."""
    batches = _batches(2, shape=(BATCH, 6))
    auxes = []
    for enabled in (False, True):
        mod = _module(_bn_mlp(), shape=(BATCH, 6))
        mod._exec_group._step_enabled = enabled
        mod.forward_backward(batches[0])
        mod.forward_backward(batches[1])
        mod.update()
        auxes.append(_state(mod))
    _assert_bitwise(*auxes)


def test_backward_with_head_gradients_matches_classic():
    """backward(out_grads) runs at once on the fused route, as on the
    classic one."""
    batch = _batches(1)[0]
    heads = mx.nd.array(np.random.RandomState(1).rand(BATCH, 10)
                        .astype(np.float32), ctx=CPU)
    grads = []
    for kw in ({}, {"_allow_fused": False}):
        mod = _module(**kw)
        mod.forward(batch, is_train=True)
        mod.backward(out_grads=[heads])
        grads.append({n: g[0].asnumpy() for n, g in zip(
            mod._param_names, mod._exec_group.grad_arrays)})
    _assert_bitwise(*grads)
    with pytest.raises(MXNetError):
        _module().get_input_grads()


@pytest.mark.parametrize("mode", ["full", "dots", "bn_stats"])
def test_remat_matches_baseline(mode, monkeypatch):
    """remat changes memory, not numbers: 3 steps equal the plain fused
    steps within rtol 1e-5 (bit for bit here), and the BatchNorm
    forwards the backward replays never move the moving stats again."""
    from mxnet_tpu_torch.ops import nn as nn_ops
    calls = []
    real = nn_ops.bn_fwd

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    batches = _batches(3)
    base = _state(_run(_module(), batches))
    monkeypatch.setattr(nn_ops, "bn_fwd", counting)
    mod = _module(remat=mode)
    assert mod._exec_group._remat_eval_fn is not None
    del calls[:]
    _run(mod, batches)
    got = _state(mod)
    for k in base:
        np.testing.assert_allclose(got[k], base[k], rtol=1e-5, atol=0,
                                   err_msg="%s/%s" % (mode, k))
    # 2 BatchNorms a step, each replayed once by the backward
    assert len(calls) == 3 * 2 * 2
    with pytest.raises(ValueError):
        mx.mod.Module(_conv_bn_net(), context=CPU, remat="dot")


def test_remat_segments_follow_sqrt_n():
    """The segment plan: about √N contiguous segments of the op nodes,
    every op in exactly one; a symbol without ops evaluates plainly."""
    from mxnet_tpu_torch.executor import _build_eval_segmented, fuse_bn_relu
    sym = fuse_bn_relu(_conv_bn_net())
    ops = [n.name for n in sym._topo() if n.op is not None]
    fn = _build_eval_segmented(sym, "full")
    assert [n for seg in fn.segments for n in seg] == ops
    assert len(fn.segments) == int(np.ceil(np.sqrt(len(ops))))
    trivial = _build_eval_segmented(mx.sym.Group([mx.sym.Variable("d")]),
                                    "full")
    x = torch.ones(2, 3)
    outs, _ = trivial([x], [], True)
    assert outs[0] is x


def test_backward_do_mirror_env_selects_full_remat(monkeypatch):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    assert mx.mod.Module(_conv_bn_net(), context=CPU)._remat == "full"


def test_predict_batch_group_matches_per_batch():
    """predict(batch_group=K) equals the per-batch loop, including the
    pad trimming of a ragged last batch."""
    rng = np.random.RandomState(0)
    X = rng.rand(52, 3, 8, 8).astype(np.float32)   # 6 batches + pad 4
    it = mx.io.NDArrayIter(X, None, batch_size=BATCH)
    mod = mx.mod.Module(_conv_bn_net(), context=CPU)
    mod.bind(data_shapes=it.provide_data, for_training=False)
    mx.random.seed(11)
    mod.init_params(mx.init.Xavier())
    ref = mod.predict(it).asnumpy()
    grouped = mod.predict(it, batch_group=3).asnumpy()
    assert ref.shape[0] == 52
    np.testing.assert_array_equal(ref, grouped)


def test_predict_batch_group_warns_on_classic_group(caplog):
    rng = np.random.RandomState(0)
    X = rng.rand(16, 3, 8, 8).astype(np.float32)
    mod = mx.mod.Module(_conv_bn_net(), context=CPU, _allow_fused=False)
    it = mx.io.NDArrayIter(X, None, batch_size=BATCH)
    mod.bind(data_shapes=it.provide_data, for_training=False)
    mod.init_params(mx.init.Xavier())
    with caplog.at_level(logging.WARNING):
        out = mod.predict(it, batch_group=4).asnumpy()
    assert out.shape[0] == 16
    assert any("batch_group" in r.message for r in caplog.records)


def test_monitor_moves_to_the_classic_route():
    """A monitor needs per-op taps: the fused module moves to the classic
    group, keeping its parameters and optimizer state."""
    mod = _run(_module(), _batches(1))
    before = _state(mod)
    mon = mx.monitor.Monitor(1, pattern="fc1.*")
    mod.install_monitor(mon)
    assert type(mod._exec_group) is DataParallelExecutorGroup
    _assert_bitwise(before, _state(mod))


@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_fused_steps_match_jax(remat):
    """Three fused steps of the port against the JAX package's fused
    route from the same numpy-seeded parameters: parameters, aux and the
    last outputs within rtol 1e-5."""
    rs = np.random.RandomState(3)
    jsym, tsym = _conv_bn_net(jmx, JNameManager), _conv_bn_net()
    shapes = dict(zip(jsym.list_arguments(), jsym.infer_shape(
        data=SHAPE, softmax_label=(BATCH,))[0]))
    args = {k: (0.3 * rs.randn(*v)).astype(np.float32)
            for k, v in shapes.items() if k not in ("data", "softmax_label")}
    aux = {k: (np.ones if "var" in k else np.zeros)(8, np.float32)
           for k in jsym.list_auxiliary_states()}
    data = [(rs.rand(*SHAPE).astype(np.float32),
             rs.randint(0, 10, BATCH).astype(np.float32)) for _ in range(3)]
    got = {}
    for pkg, sym in ((jmx, jsym), (mx, tsym)):
        ctx = pkg.cpu()
        mod = pkg.mod.Module(sym, context=ctx, remat=remat)
        mod.bind(data_shapes=[("data", SHAPE)],
                 label_shapes=[("softmax_label", (BATCH,))])
        if pkg is jmx:
            mod.init_params(
                arg_params={k: jmx.nd.array(v) for k, v in args.items()},
                aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
        else:
            a, x = mx.convert.params_from_numpy(args, aux, ctx)
            mod.init_params(arg_params=a, aux_params=x)
        mod.init_optimizer(optimizer="sgd", optimizer_params=OPTS["sgd"])
        for x, y in data:
            kw = {"ctx": ctx} if pkg is mx else {}
            mod.forward_backward(pkg.io.DataBatch(
                [pkg.nd.array(x, **kw)], [pkg.nd.array(y, **kw)]))
            mod.update()
        a, x = mod.get_params()
        res = {k: v.asnumpy() for k, v in list(a.items()) + list(x.items())}
        res["out"] = mod.get_outputs()[0].asnumpy()
        got[pkg.__name__] = res
    want, mine = got["mxnet_tpu"], got["mxnet_tpu_torch"]
    assert sorted(want) == sorted(mine)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_optimizer_that_overrides_update_takes_the_classic_update():
    """A subclass whose update() overrides the class that defines
    _fused_apply has no pure apply (its numbers would differ): the fused
    step declines and update() takes the classic route, which runs the
    subclass's own update."""
    calls = []

    class Traced(mx.optimizer.SGD):
        def update(self, index, weight, grad, state):
            calls.append(index)
            super().update(index, weight, grad, state)

        def _apply(self, weight, grad, state, lr, wd):
            calls.append("apply")
            super()._apply(weight, grad, state, lr, wd)

    mod = _module()
    mod.init_optimizer(optimizer=Traced(momentum=0.9, learning_rate=0.1,
                                        rescale_grad=1.0 / BATCH),
                       force_init=True)
    assert mod._updater.fused_apply_or_none() is None
    _run(mod, _batches(1))
    assert calls and not mod._exec_group._pending_bwd
    assert mod._optimizer.num_update == 1


def test_rebind_keeps_the_step_of_an_attached_optimizer():
    """bind(force_rebind=True) after init_optimizer keeps the
    one-function step (init_optimizer does not run again)."""
    mod = _module()
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (BATCH,))], force_rebind=True)
    assert mod._exec_group._step_enabled
    mod.forward_backward(_batches(1)[0])
    assert mod._exec_group._pending_bwd
    mod.update()
    assert not mod._exec_group._pending_bwd
