"""``fit(batch_group=K)`` in the PyTorch port (mxnet_tpu_torch): K batches
staged with one copy per input and run as K whole steps in one call
(``MeshExecutorGroup.step_update_grouped``). The contracts of
``tests/test_module_grouped.py``, on one CPU device: grouped training is
bit for bit K sequential steps — parameters, optimizer state, BN aux,
last gradients and outputs, metric values — with SGD and Adam, with an
epoch tail, with an lr schedule that changes mid-group and through a
checkpoint resume; the Speedometer counts the stride; a bind that cannot
group warns and trains per batch. Against the JAX package's grouped
step, from the same numpy-seeded parameters: parameters after 3 steps
within rtol 1e-5 (the two frameworks reduce in different orders).
"""
import logging
from collections import namedtuple

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

CPU = mx.cpu()
BATCH = 8
OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        "adam": {"learning_rate": 0.05}}


def _bn_mlp(pkg=mx, names=TNameManager):
    with names():
        s = pkg.sym
        net = s.Variable("data")
        net = s.FullyConnected(net, num_hidden=16, name="fc1")
        net = s.BatchNorm(net, name="bn", fix_gamma=False)
        net = s.Activation(net, act_type="relu")
        net = s.FullyConnected(net, num_hidden=10, name="fc2")
        return s.SoftmaxOutput(net, name="softmax")


def _module(opt="sgd", opt_kw=None, **kw):
    mx.random.seed(42)
    mod = mx.mod.Module(_bn_mlp(), context=CPU, **kw)
    mod.bind(data_shapes=[("data", (BATCH, 6))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(mx.init.Uniform(0.07))
    mod.init_optimizer(optimizer=opt, optimizer_params=opt_kw or OPTS[opt])
    return mod


def _batches(n, seed=0, pkg=mx, ctx=CPU):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.rand(BATCH, 6).astype(np.float32)
        y = rng.randint(0, 10, BATCH).astype(np.float32)
        kw = {"ctx": ctx} if pkg is mx else {}
        out.append(pkg.io.DataBatch([pkg.nd.array(x, **kw)],
                                    [pkg.nd.array(y, **kw)]))
    return out


def _stack(batches):
    return {"data": np.stack([b.data[0].asnumpy() for b in batches]),
            "softmax_label": np.stack([b.label[0].asnumpy()
                                       for b in batches])}


def _flat_states(updater):
    def flat(st):
        if st is None:
            return []
        if isinstance(st, (tuple, list)):
            return [x for s in st for x in flat(s)]
        return [st.asnumpy()]

    return {k: flat(st) for k, st in updater.states.items()}


def _assert_same_training_state(a, b):
    """Parameters, aux and optimizer states bit for bit equal."""
    ga, gb = a._exec_group, b._exec_group
    for d in ("_param_dict", "_aux_dict"):
        da, db = getattr(ga, d), getattr(gb, d)
        assert sorted(da) == sorted(db)
        for n in da:
            np.testing.assert_array_equal(da[n].asnumpy(), db[n].asnumpy(),
                                          err_msg=n)
    sa, sb = _flat_states(a._updater), _flat_states(b._updater)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        for xa, xb in zip(sa[k], sb[k]):
            np.testing.assert_array_equal(xa, xb, err_msg=str(k))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_grouped_step_matches_sequential(opt):
    """One grouped step over K batches equals K sequential one-function
    steps, bit for bit, the last step's gradients and outputs too."""
    batches = _batches(3)
    seq = _module(opt)
    for b in batches:
        seq.forward_backward(b)
        seq.update()
    grp = _module(opt)
    eg = grp._exec_group
    assert eg.step_update_grouped(grp._updater, _stack(batches))
    _assert_same_training_state(seq, grp)
    for n in eg._grad_names:
        np.testing.assert_array_equal(
            seq._exec_group._grad_dict[n].asnumpy(),
            eg._grad_dict[n].asnumpy(), err_msg="%s/%s" % (opt, n))
    np.testing.assert_array_equal(seq.get_outputs()[0].asnumpy(),
                                  grp.get_outputs()[0].asnumpy())
    assert grp._optimizer.num_update == len(batches)


def test_fit_batch_group_matches_per_batch_with_tail():
    """fit(batch_group=3) over 7 batches an epoch (groups 3+3+1) for 2
    epochs equals the per-batch fit bit for bit, metric values too."""
    n = BATCH * 7
    rng = np.random.RandomState(1)
    X = rng.rand(n, 6).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    mods, values = [], []
    for bg in (None, 3):
        mod = mx.mod.Module(_bn_mlp(), context=CPU)
        mx.random.seed(42)
        metric = mx.metric.Accuracy()
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=2,
                eval_metric=metric, optimizer_params=OPTS["sgd"],
                initializer=mx.init.Uniform(0.07), batch_group=bg)
        mods.append(mod)
        values.append(metric.get_name_value())
    assert values[0] == values[1], values
    _assert_same_training_state(mods[0], mods[1])
    assert mods[1].grouped_train_engaged()
    assert not mods[0].grouped_train_engaged()
    assert mods[0]._optimizer.num_update == \
        mods[1]._optimizer.num_update == 14


def test_grouped_lr_schedule_changes_mid_group():
    """The scheduler is read at every per-batch update count inside the
    group: a FactorScheduler halving every 2 updates with K=4 changes
    the lr mid-group, and the trajectory still matches, bit for bit."""
    def kw():
        return {"learning_rate": 0.2,
                "lr_scheduler": mx.lr_scheduler.FactorScheduler(
                    step=2, factor=0.5)}

    batches = _batches(4, seed=5)
    seq = _module("sgd", kw())
    for b in batches:
        seq.forward_backward(b)
        seq.update()
    grp = _module("sgd", kw())
    assert grp._exec_group.step_update_grouped(grp._updater,
                                               _stack(batches))
    _assert_same_training_state(seq, grp)
    assert grp._optimizer.num_update == seq._optimizer.num_update == 4
    assert grp._optimizer.lr_scheduler.base_lr == \
        seq._optimizer.lr_scheduler.base_lr < 0.2


def test_stage_stacked_helper():
    """One (K, B, ...) block per provided input, zero-fill for bound
    inputs the block omits; NDArray, numpy and tensor blocks alike."""
    eg = _module()._exec_group
    block = np.random.RandomState(0).rand(2, BATCH, 6).astype(np.float32)
    inputs = eg.stage_stacked({"data": mx.nd.array(block, ctx=CPU)})
    assert set(inputs) == {"data", "softmax_label"}
    np.testing.assert_array_equal(inputs["data"].numpy(), block)
    assert tuple(inputs["softmax_label"].shape) == (2, BATCH)
    assert not inputs["softmax_label"].numpy().any()
    for raw in (block, torch.from_numpy(block)):
        np.testing.assert_array_equal(
            eg.stage_stacked({"data": raw})["data"].numpy(), block)


def test_speedometer_group_stride(caplog):
    """The Speedometer counts the batches a group covers: nbatch moves by
    K a callback, and stride 1 behaves as before."""
    P = namedtuple("P", ["epoch", "nbatch", "eval_metric", "locals"])
    with caplog.at_level(logging.INFO):
        sp = mx.callback.Speedometer(batch_size=8, frequent=4)
        for nbatch in (2, 5, 8, 11):
            sp(P(0, nbatch, None, None))
    logs = [r.message for r in caplog.records if "samples/sec" in r.message]
    assert len(logs) == 1 and "Batch [8]" in logs[0], logs
    caplog.clear()
    with caplog.at_level(logging.INFO):
        sp = mx.callback.Speedometer(batch_size=8, frequent=4)
        for nbatch in range(9):
            sp(P(0, nbatch, None, None))
    logs = [r.message for r in caplog.records if "samples/sec" in r.message]
    assert len(logs) == 2
    assert "Batch [4]" in logs[0] and "Batch [8]" in logs[1], logs


def test_fit_batch_group_falls_back_with_warning(caplog):
    """A classic bind cannot group: fit warns and trains per batch."""
    rng = np.random.RandomState(0)
    X = rng.rand(32, 6).astype(np.float32)
    y = rng.randint(0, 10, 32).astype(np.float32)
    mod = mx.mod.Module(_bn_mlp(), context=CPU, _allow_fused=False)
    with caplog.at_level(logging.WARNING):
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=1,
                batch_group=4, optimizer_params={"learning_rate": 0.1},
                initializer=mx.init.Uniform(0.07))
    assert any("batch_group" in r.message for r in caplog.records)
    assert not mod.grouped_train_engaged()
    assert mod._optimizer.num_update == 4


def test_fit_batch_group_resume_from_checkpoint(tmp_path):
    """A grouped fit checkpointed per epoch, stopped after epoch 0 and
    resumed with fit(resume_from=manager), ends where the uninterrupted
    grouped fit ends, bit for bit."""
    n = BATCH * 5
    rng = np.random.RandomState(2)
    X = rng.rand(n, 6).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)

    def fresh():
        mx.random.seed(42)
        return mx.mod.Module(_bn_mlp(), context=CPU)

    def fit(mod, num_epoch, manager=None, resume=None):
        cb = None if manager is None else mx.callback.module_checkpoint(
            mod, save_optimizer_states=True, manager=manager,
            async_save=False)
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=BATCH),
                num_epoch=num_epoch, batch_group=2,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Uniform(0.07), epoch_end_callback=cb,
                resume_from=resume)
        return mod

    straight = fit(fresh(), 2)
    manager = mx.checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    fit(fresh(), 1, manager=manager)
    resumed = fit(fresh(), 2, resume=manager)
    _assert_same_training_state(straight, resumed)
    assert straight._optimizer.num_update == 10


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_grouped_step_matches_jax(opt):
    """The port's grouped step against the JAX package's, from the same
    numpy-seeded parameters: 3 steps in one group, parameters and BN aux
    within rtol 1e-5."""
    rs = np.random.RandomState(4)
    jsym, tsym = _bn_mlp(jmx, JNameManager), _bn_mlp()
    shapes = dict(zip(jsym.list_arguments(), jsym.infer_shape(
        data=(BATCH, 6), softmax_label=(BATCH,))[0]))
    args = {k: (0.3 * rs.randn(*v)).astype(np.float32)
            for k, v in shapes.items() if k not in ("data", "softmax_label")}
    aux = {"bn_moving_mean": np.zeros(16, np.float32),
           "bn_moving_var": np.ones(16, np.float32)}
    stacked = _stack(_batches(3, seed=9))
    got = {}
    for pkg, sym in ((jmx, jsym), (mx, tsym)):
        ctx = pkg.cpu()
        mod = pkg.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", (BATCH, 6))],
                 label_shapes=[("softmax_label", (BATCH,))])
        if pkg is jmx:
            mod.init_params(
                arg_params={k: jmx.nd.array(v) for k, v in args.items()},
                aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
        else:
            a, x = mx.convert.params_from_numpy(args, aux, ctx)
            mod.init_params(arg_params=a, aux_params=x)
        mod.init_optimizer(optimizer=opt, optimizer_params=OPTS[opt])
        assert mod._exec_group.step_update_grouped(mod._updater, stacked)
        a, x = mod.get_params()
        got[pkg.__name__] = {k: v.asnumpy()
                             for k, v in list(a.items()) + list(x.items())}
    want, mine = got["mxnet_tpu"], got["mxnet_tpu_torch"]
    assert sorted(want) == sorted(mine)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_grouped_loss_scale_rides_the_steps():
    """Under a policy with a dynamic loss scale, the scale state is
    carried from step to step inside the group exactly as sequential
    steps carry it: parameters, state and the scale bit for bit."""
    pol = mx.precision.PrecisionPolicy(compute_dtype="bf16",
                                       loss_scale=256, loss_scale_window=2)
    batches = _batches(5, seed=3)
    seq = _module(precision=pol)
    for b in batches:
        seq.forward_backward(b)
        seq.update()
    grp = _module(precision=pol)
    assert grp._exec_group.step_update_grouped(grp._updater,
                                               _stack(batches))
    _assert_same_training_state(seq, grp)
    assert grp._exec_group.loss_scale() == seq._exec_group.loss_scale() \
        == 1024.0
    assert grp._exec_group.scale_skips() == 0
