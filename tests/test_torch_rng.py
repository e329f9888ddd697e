"""The PyTorch port's RNG path (mxnet_tpu_torch ``random.next_key``, the
executors' per-node keys, ``Dropout``/``rrelu`` draws), held to the
contracts the JAX package pins within itself: one key per training
forward or step, drawn from ``mx.random.seed``'s state; the segmented
(remat) evaluator draws the plain evaluator's masks
(``tests/test_remat.py::test_segmented_dropout_stream_matches_plain``),
its backward replays included; the fused route equals the classic route
bit for bit on a Dropout net; remat and grouped ``fit`` repeat; eval,
``predict``, ``score`` and ``score_stacked`` draw nothing; a checkpoint
taken mid-run resumes to the uninterrupted run's parameters bit for bit;
and a net without Dropout draws no key. Torch and JAX draw different
streams, so nothing here compares masks across the packages
(``test_torch_nn_ops.py`` holds Dropout's semantics).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import random as mxr
from mxnet_tpu_torch.checkpoint import CheckpointManager, serialize
from mxnet_tpu_torch.executor import (_build_eval, _build_eval_segmented,
                                      fuse_bn_relu)

torch.set_num_threads(2)

CPU = mx.cpu()
BATCH = 8
SHAPE = (BATCH, 3, 8, 8)
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _dropout_net(p=0.5):
    s = mx.sym
    net = s.Variable("data")
    net = s.Convolution(net, kernel=(3, 3), num_filter=8, pad=(1, 1),
                        name="conv1")
    net = s.BatchNorm(net, fix_gamma=False, name="bn1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.Dropout(net, p=p, name="drop1")
    net = s.Flatten(net)
    net = s.FullyConnected(net, num_hidden=16, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu2")
    net = s.Dropout(net, p=p, name="drop2")
    net = s.FullyConnected(net, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _plain_net():
    s = mx.sym
    net = s.Variable("data")
    net = s.Convolution(net, kernel=(3, 3), num_filter=8, pad=(1, 1),
                        name="conv1")
    net = s.BatchNorm(net, fix_gamma=False, name="bn1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.Flatten(net)
    net = s.FullyConnected(net, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _data(n=48, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, *SHAPE[1:]).astype(np.float32),
            rs.randint(0, 10, n).astype(np.float32))


def _iter(shuffle=False):
    x, y = _data()
    return mx.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=shuffle)


def _state(mod):
    a, x = mod.get_params()
    return {k: v.asnumpy() for k, v in list(a.items()) + list(x.items())}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _fit(net=None, num_epoch=2, seed=3, **kw):
    np.random.seed(seed)
    mx.random.seed(seed)
    mod = mx.mod.Module(net or _dropout_net(), context=CPU,
                        **kw.pop("module", {}))
    mod.fit(_iter(kw.pop("shuffle", False)), num_epoch=num_epoch,
            initializer=mx.init.Xavier(), optimizer_params=OPT, **kw)
    return mod


def _bound(net=None, seed=3, **kw):
    mx.random.seed(seed)
    mod = mx.mod.Module(net or _dropout_net(), context=CPU, **kw)
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    return mod


def _batches(n=3):
    x, y = _data(n * BATCH, seed=5)
    return [mx.io.DataBatch(
        [mx.nd.array(x[i * BATCH:(i + 1) * BATCH], ctx=CPU)],
        [mx.nd.array(y[i * BATCH:(i + 1) * BATCH], ctx=CPU)])
        for i in range(n)]


# ---------------------------------------------------------------------------
# the key source
# ---------------------------------------------------------------------------
def test_keys_follow_the_seed_and_the_state():
    mx.random.seed(5)
    ks = [mxr.next_key() for _ in range(3)]
    assert len(set(ks)) == 3 and all(0 <= k < 1 << 64 for k in ks)
    mx.random.seed(5)
    assert mxr.next_key() == ks[0]
    st = mxr.get_state()
    assert st["keys_drawn"] == 1
    mx.random.seed(99)
    mxr.next_key()
    mxr.set_state(st)
    assert [mxr.next_key() for _ in range(2)] == ks[1:]
    mx.random.seed(6)
    assert mxr.next_key() not in ks
    subs = mxr.split(ks[0], 4)
    assert len(set(subs + ks)) == 7
    assert subs[2] == mxr.fold_in(ks[0], 2)


def test_uniform_is_a_pure_function_of_key_and_index():
    a = mxr.key_uniform(11, (64, 33), torch.device("cpu"))
    b = mxr.key_uniform(11, (64, 33), torch.device("cpu"))
    c = mxr.key_uniform(12, (64, 33), torch.device("cpu"))
    assert a.dtype == torch.float32 and a.shape == (64, 33)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    # element i depends on the key and i only, not on the shape
    flat = mxr.key_uniform(11, (64 * 33,), torch.device("cpu"))
    assert torch.equal(flat.reshape(64, 33), a)
    n = a.numel()
    assert abs(float(a.mean()) - 0.5) < 4 * (1 / 12.0 / n) ** 0.5
    # distinct counters within one key: no repeated 24-bit draw pattern
    assert torch.unique(mxr.key_uniform(3, (4096,), torch.device("cpu"))
                        ).numel() > 4000


def test_rng_file_keeps_the_keys_drawn(tmp_path):
    mx.random.seed(4)
    for _ in range(5):
        mxr.next_key()
    path = str(tmp_path / "rng.npz")
    serialize.dump_rng(path, mxr.get_state())
    want = mxr.next_key()
    mx.random.seed(0)
    st = serialize.load_rng(path)
    assert st["seed"] == 4 and st["keys_drawn"] == 5
    mxr.set_state(st)
    assert mxr.next_key() == want


# ---------------------------------------------------------------------------
# the evaluators
# ---------------------------------------------------------------------------
def _eval_args(net, shape):
    rng = np.random.RandomState(1)
    arg_shapes, _, aux_shapes = net.infer_shape(data=shape)
    args = [torch.tensor(rng.rand(*s).astype(np.float32) + 0.5)
            for s in arg_shapes]
    aux = [torch.tensor(rng.rand(*s).astype(np.float32) + 0.5)
           for s in aux_shapes]
    return args, aux


def test_segmented_dropout_stream_matches_plain():
    """The port's form of the JAX package's test: the segmented evaluator
    draws the plain one's masks, and its backward, which replays every
    segment under ``torch.utils.checkpoint``, draws them again: outputs
    and gradients bit for bit."""
    s = mx.sym
    net = s.Variable("data")
    net = s.Dropout(net, p=0.5, name="do1")
    net = s.FullyConnected(net, num_hidden=8, name="fc")
    net = s.Dropout(net, p=0.5, name="do2")
    net = s.FullyConnected(net, num_hidden=6, name="fc2")
    net = s.Dropout(net, p=0.3, name="do3")
    net = s.Group([net])
    plain = _build_eval(net)
    seg = _build_eval_segmented(net, "full", n_segments=2)
    assert plain.needs_rng and seg.needs_rng and len(seg.segments) == 2
    key = mxr.next_key()

    def run(fn):
        args, aux = _eval_args(net, (4, 8))
        leaves = [a.requires_grad_(True) for a in args]
        with torch.enable_grad():
            outs, _ = fn(args, aux, True, key=key)
            (outs[0] * outs[0]).sum().backward()
        return outs[0].detach(), [a.grad for a in leaves]

    p_out, p_grads = run(plain)
    s_out, s_grads = run(seg)
    assert torch.equal(p_out, s_out)
    for a, b in zip(p_grads, s_grads):
        assert torch.equal(a, b)
    # the three nodes draw three different masks
    assert float((p_out == 0).float().mean()) > 0.1
    other, _ = run(plain)
    assert torch.equal(other, p_out)
    args, aux = _eval_args(net, (4, 8))
    moved, _ = plain(args, aux, True, key=mxr.next_key())
    assert not torch.equal(moved[0], p_out)


def test_training_dropout_needs_a_key_and_eval_needs_none():
    net = mx.sym.Group([mx.sym.Dropout(mx.sym.Variable("data"), p=0.5)])
    fn = _build_eval(net)
    x = [torch.ones(4, 5)]
    outs, _ = fn(x, [], False)
    assert torch.equal(outs[0], x[0])
    with pytest.raises(mx.MXNetError, match="key"):
        fn(x, [], True)


# ---------------------------------------------------------------------------
# modules and fit
# ---------------------------------------------------------------------------
def test_repeat_runs_from_one_seed_are_bit_for_bit():
    a = _state(_fit(shuffle=True))
    b = _state(_fit(shuffle=True))
    _assert_same(a, b)
    c = _state(_fit(seed=4, shuffle=True))
    assert not np.array_equal(a["fc1_weight"], c["fc1_weight"])


def test_one_key_per_training_batch():
    mx.random.seed(3)
    mod = _bound()
    before = mxr.get_state()["keys_drawn"]
    for b in _batches(3):
        mod.forward_backward(b)
        mod.update()
    assert mxr.get_state()["keys_drawn"] == before + 3


def test_fused_equals_classic_on_a_dropout_net():
    res = {}
    for route, kw in (("fused", {}), ("classic", {"_allow_fused": False})):
        mod = _bound(**kw)
        for b in _batches(3):
            mod.forward_backward(b)
            mod.update()
        res[route] = (type(mod._exec_group).__name__, _state(mod),
                      mod.get_outputs()[0].asnumpy())
    assert res["fused"][0] == "MeshExecutorGroup"
    assert res["classic"][0] == "DataParallelExecutorGroup"
    _assert_same(res["fused"][1], res["classic"][1])
    np.testing.assert_array_equal(res["fused"][2], res["classic"][2])


def test_outputs_read_before_update_keep_the_step_mask():
    """A fused forward's outputs read before update() materialise the
    forward with the batch's key; the step then uses the same key, so the
    parameters equal those of the step that read nothing."""
    res = []
    for read in (False, True):
        mod = _bound()
        for b in _batches(2):
            mod.forward(b, is_train=True)
            if read:
                mod.get_outputs()[0].asnumpy()
            mod.backward()
            mod.update()
        res.append(_state(mod))
    _assert_same(res[0], res[1])


def test_remat_draws_the_plain_masks():
    plain = _state(_fit(num_epoch=1))
    full = _state(_fit(num_epoch=1, module={"remat": "full"}))
    _assert_same(plain, full)


def test_grouped_fit_repeats():
    a = _fit(batch_group=2)
    assert a.grouped_train_engaged()
    b = _fit(batch_group=2)
    _assert_same(_state(a), _state(b))
    per_batch = _state(_fit())
    # K independent keys from one draw: other masks than per-batch
    assert not np.array_equal(_state(a)["fc1_weight"],
                              per_batch["fc1_weight"])


def test_eval_draws_nothing():
    mod = _fit(num_epoch=1)
    it = _iter()
    drawn = mxr.get_state()["keys_drawn"]
    p1 = mod.predict(it).asnumpy()
    p2 = mod.predict(it).asnumpy()
    mod.predict(it, batch_group=2)
    mod.score(it, "acc")
    b = _batches(1)[0]
    mod.forward(b, is_train=False)
    mod.get_outputs()[0].asnumpy()
    mod._exec_group.score_stacked({"data": np.stack([_data()[0][:BATCH]])})
    assert mxr.get_state()["keys_drawn"] == drawn
    np.testing.assert_array_equal(p1, p2)


def test_checkpoint_resume_draws_the_uninterrupted_masks(tmp_path):
    def train(manager=None, stop_after=None, resume=False):
        np.random.seed(7)
        mx.random.seed(7)
        mod = mx.mod.Module(_dropout_net(), context=CPU)
        cb = None
        if manager is not None:
            cb = mx.callback.module_checkpoint(
                mod, save_optimizer_states=True, manager=manager)
        mod.fit(_iter(shuffle=True), num_epoch=stop_after or 4,
                resume_from=manager if resume else None,
                epoch_end_callback=cb, initializer=mx.init.Xavier(),
                optimizer_params=OPT)
        if manager is not None:
            manager.wait_until_finished()
        return mod

    ref = train()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    train(mgr, stop_after=2)
    assert mgr.restore().rng["keys_drawn"] > 0
    resumed = train(mgr, resume=True)
    _assert_same(_state(ref), _state(resumed))


def test_rng_free_net_draws_no_key_and_ignores_the_key_state():
    assert not _build_eval(fuse_bn_relu(_plain_net())).needs_rng
    mx.random.seed(3)
    drawn = mxr.get_state()["keys_drawn"]
    a = _state(_fit(_plain_net()))
    assert mxr.get_state()["keys_drawn"] == drawn
    np.random.seed(3)
    mx.random.seed(3)
    for _ in range(7):
        mxr.next_key()
    mod = mx.mod.Module(_plain_net(), context=CPU)
    mod.fit(_iter(), num_epoch=2, initializer=mx.init.Xavier(),
            optimizer_params=OPT)
    _assert_same(a, _state(mod))
