"""The device-side metric tally of the PyTorch port (mxnet_tpu_torch): each
metric's ``fused_stat`` and the fused route's tally
(``MeshExecutorGroup.enable_device_metric``, ``score_device``), held to
``tests/test_device_metric.py``'s contracts on one CPU device: every stat
equals the host ``update`` path (rtol 1e-5), a composite flattens its
leaves, ``fit`` with the tally equals the host path and never calls the
host update, a mid-epoch ``get`` drains without losing a batch,
``CustomMetric`` keeps the host path, a second fit with a host metric
detaches the first tally, ``score`` on the device equals the host loop
(a short tail batch too), a batch without labels raises and the
score-end callback sees the batch count. Against the JAX package: each
stat on the same inputs, and a fit's device-tallied training metric,
within rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

CPU = mx.cpu()
MAKERS = {
    "acc": lambda pkg: pkg.metric.Accuracy(),
    "top3": lambda pkg: pkg.metric.TopKAccuracy(top_k=3),
    "ce": lambda pkg: pkg.metric.CrossEntropy(),
    "ppl": lambda pkg: pkg.metric.Perplexity(ignore_label=None),
    "ppl_ignore0": lambda pkg: pkg.metric.Perplexity(ignore_label=0),
    "loss": lambda pkg: pkg.metric.Loss(),
}


def _host_value(metric, labels, preds):
    metric.reset()
    metric.update([mx.nd.array(lb, ctx=CPU) for lb in labels],
                  [mx.nd.array(p, ctx=CPU) for p in preds])
    return metric.get()[1]


def _rows(metric, labels, preds):
    stat = metric.fused_stat()
    assert stat is not None, type(metric).__name__
    rows = stat(torch, [torch.from_numpy(lb) for lb in labels],
                [torch.from_numpy(p) for p in preds])
    if isinstance(rows, tuple):
        rows = [rows]
    return np.array([[float(s), float(c)] for s, c in rows], np.float64)


def _device_value(metric, labels, preds):
    rows = _rows(metric, labels, preds)
    metric.reset()
    metric._fold_tally(rows)
    return metric.get()[1]


def _cls_batch(seed=3, n=32, c=10):
    rng = np.random.RandomState(seed)
    pred = rng.rand(n, c).astype(np.float32)
    pred /= pred.sum(axis=1, keepdims=True)
    label = rng.randint(0, c, n).astype(np.float32)
    return [label], [pred]


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_stat_matches_host_classification(name):
    labels, preds = _cls_batch()
    host = _host_value(MAKERS[name](mx), labels, preds)
    dev = _device_value(MAKERS[name](mx), labels, preds)
    np.testing.assert_allclose(dev, host, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_stat_matches_jax_stat(name):
    """The port's stat rows against the JAX package's fused_stat on the
    same batch."""
    import jax.numpy as jnp
    labels, preds = _cls_batch(seed=8)
    jrows = MAKERS[name](jmx).fused_stat()(
        jnp, [jnp.asarray(lb) for lb in labels],
        [jnp.asarray(p) for p in preds])
    if isinstance(jrows, tuple):
        jrows = [jrows]
    want = np.array([[float(s), float(c)] for s, c in jrows])
    np.testing.assert_allclose(_rows(MAKERS[name](mx), labels, preds), want,
                               rtol=1e-5)


def test_composite_stat_flattens_nested():
    labels, preds = _cls_batch()
    inner = mx.metric.CompositeEvalMetric(
        [mx.metric.Accuracy(), mx.metric.CrossEntropy()])
    outer = mx.metric.CompositeEvalMetric(
        [inner, mx.metric.TopKAccuracy(top_k=3)])
    stat = outer.fused_stat()
    assert stat.n_slots == 3 == outer._n_slots()
    rows = _rows(outer, labels, preds)
    assert rows.shape == (3, 2)
    outer.reset()
    outer._fold_tally(rows)
    want_acc = _host_value(mx.metric.Accuracy(), labels, preds)
    want_ce = _host_value(mx.metric.CrossEntropy(), labels, preds)
    want_topk = _host_value(mx.metric.TopKAccuracy(top_k=3), labels, preds)
    _, values = outer.get()
    np.testing.assert_allclose(values[0], [want_acc, want_ce], rtol=1e-5)
    np.testing.assert_allclose(values[1], want_topk, rtol=1e-5)


def _mlp(pkg=mx, names=TNameManager):
    with names():
        s = pkg.sym
        net = s.Variable("data")
        net = s.FullyConnected(net, num_hidden=16, name="fc1")
        net = s.Activation(net, act_type="tanh")
        net = s.FullyConnected(net, num_hidden=10, name="fc2")
        return s.SoftmaxOutput(net, name="softmax")


def _data():
    rng = np.random.RandomState(5)
    X = rng.rand(128, 8).astype(np.float32)
    y = rng.randint(0, 10, 128).astype(np.float32)
    return X, y


def _fit(eval_metric, monkeypatch=None, device_path=True, epochs=2):
    if monkeypatch is not None:
        monkeypatch.setenv("MXNET_DEVICE_METRIC",
                           "1" if device_path else "0")
    X, y = _data()
    mod = mx.mod.Module(_mlp(), context=CPU)
    mx.random.seed(42)
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=32), eval_metric=eval_metric,
            num_epoch=epochs, optimizer_params={"learning_rate": 0.05})
    return mod, eval_metric


def test_fit_device_metric_matches_host_path(monkeypatch):
    dev_mod, dev_metric = _fit(mx.metric.Accuracy(), monkeypatch, True)
    assert dev_mod._exec_group._metric_live is dev_metric
    host_mod, host_metric = _fit(mx.metric.Accuracy(), monkeypatch, False)
    assert host_mod._exec_group._metric_live is None
    np.testing.assert_allclose(dev_metric.get()[1], host_metric.get()[1],
                               rtol=1e-6)


def test_fit_device_metric_composite_matches_host(monkeypatch):
    def make():
        return mx.metric.CompositeEvalMetric(
            [mx.metric.Accuracy(), mx.metric.CrossEntropy()])

    _, dev_metric = _fit(make(), monkeypatch, True)
    _, host_metric = _fit(make(), monkeypatch, False)
    for (dn, dv), (hn, hv) in zip(dev_metric.get_name_value(),
                                  host_metric.get_name_value()):
        assert dn == hn
        np.testing.assert_allclose(dv, hv, rtol=1e-5)


def test_fit_never_touches_host_update(monkeypatch):
    """With the tally live, the per-batch host update (and its readback)
    never runs."""
    metric = mx.metric.Accuracy()

    def boom(*a, **k):
        raise AssertionError("host metric.update ran on the device path")

    monkeypatch.setattr(metric, "update", boom)
    _, got = _fit(metric, monkeypatch, True)
    assert 0.0 <= got.get()[1] <= 1.0


def test_mid_epoch_get_drains_and_continues(monkeypatch):
    """A Speedometer-style mid-epoch get() sees the running value and
    neither loses nor double-counts a batch."""
    seen = []

    def cb(param):
        if param.nbatch == 1:
            seen.append(dict(param.eval_metric.get_name_value()))

    X, y = _data()
    metric = mx.metric.Accuracy()
    mod = mx.mod.Module(_mlp(), context=CPU)
    mx.random.seed(42)
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=32), eval_metric=metric,
            num_epoch=1, batch_end_callback=cb,
            optimizer_params={"learning_rate": 0.05})
    assert seen and 0.0 <= seen[0]["accuracy"] <= 1.0
    host_metric = _fit(mx.metric.Accuracy(), monkeypatch, False,
                       epochs=1)[1]
    np.testing.assert_allclose(metric.get()[1], host_metric.get()[1],
                               rtol=1e-6)
    assert metric.num_inst == 128


def test_custom_metric_keeps_host_path():
    calls = []

    def feval(label, pred):
        calls.append(1)
        return float((pred.argmax(axis=1) == label).mean())

    mod, _ = _fit(mx.metric.np(feval), None, True, epochs=1)
    assert mod._exec_group._metric_live is None
    assert len(calls) == 4


def test_refit_with_host_metric_detaches_old_tally():
    X, y = _data()
    mod = mx.mod.Module(_mlp(), context=CPU)
    acc = mx.metric.Accuracy()
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=32), eval_metric=acc,
            num_epoch=1, optimizer_params={"learning_rate": 0.05})
    frozen, n_seen = acc.get()[1], acc.num_inst
    assert n_seen == 128
    custom = mx.metric.np(
        lambda label, pred: float((pred.argmax(1) == label).mean()))
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=32), eval_metric=custom,
            num_epoch=1, optimizer_params={"learning_rate": 0.05})
    grp = mod._exec_group
    assert grp._metric_live is None and grp._metric_stat is None
    assert acc.num_inst == n_seen
    np.testing.assert_allclose(acc.get()[1], frozen)


class _ShortTailIter(object):
    """Batches of 32 rows and a last one of what is left (a short tail,
    which ``NDArrayIter`` never yields)."""

    def __init__(self, X, y):
        self.X, self.y, self.at = X, y, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.at >= len(self.X):
            raise StopIteration
        sl = slice(self.at, self.at + 32)
        self.at += 32
        return mx.io.DataBatch([mx.nd.array(self.X[sl], ctx=CPU)],
                               [mx.nd.array(self.y[sl], ctx=CPU)], pad=0)

    def reset(self):
        self.at = 0


@pytest.mark.parametrize("n_rows", [128, 120])
def test_score_device_matches_host(monkeypatch, n_rows):
    """score() tallies on the device and equals the host loop; 120 rows
    end in a 24-row tail batch the device path pads and slices."""
    mod, _ = _fit(mx.metric.Accuracy(), monkeypatch, True, epochs=1)
    X, y = _data()
    it = _ShortTailIter(X[:n_rows], y[:n_rows])
    for make in (mx.metric.Accuracy, lambda: mx.metric.CompositeEvalMetric(
            [mx.metric.Accuracy(), mx.metric.CrossEntropy()])):
        monkeypatch.setenv("MXNET_DEVICE_METRIC", "1")
        dev = mod.score(it, make())
        monkeypatch.setenv("MXNET_DEVICE_METRIC", "0")
        host = mod.score(it, make())
        for (dn, dv), (hn, hv) in zip(dev, host):
            assert dn == hn
            np.testing.assert_allclose(dv, hv, rtol=1e-5)
    acc = mx.metric.Accuracy()
    monkeypatch.setenv("MXNET_DEVICE_METRIC", "1")
    mod.score(it, acc)
    assert acc.num_inst == n_rows
    custom = mx.metric.np(
        lambda label, pred: float((pred.argmax(1) == label).mean()))
    assert 0.0 <= mod.score(it, custom)[0][1] <= 1.0


def test_score_device_labelless_batch_raises(monkeypatch):
    from mxnet_tpu_torch.io import DataBatch
    mod, _ = _fit(mx.metric.Accuracy(), monkeypatch, True, epochs=1)

    class NoLabelIter(object):
        def __init__(self):
            self.done = False

        def __iter__(self):
            return self

        def __next__(self):
            if self.done:
                raise StopIteration
            self.done = True
            return DataBatch([mx.nd.array(np.zeros((32, 8), np.float32),
                                          ctx=CPU)], [])

        def reset(self):
            self.done = False

    with pytest.raises(MXNetError, match="labels"):
        mod.score(NoLabelIter(), mx.metric.Accuracy())


def test_score_end_callback_sees_batch_count(monkeypatch):
    seen = []
    mod, _ = _fit(mx.metric.Accuracy(), monkeypatch, True, epochs=1)
    X, y = _data()
    mod.score(mx.io.NDArrayIter(X, y, batch_size=32), mx.metric.Accuracy(),
              score_end_callback=lambda p: seen.append(p.nbatch))
    assert seen == [4], seen


def test_fit_device_metric_matches_jax():
    """A fit's device-tallied training metric (accuracy and
    cross-entropy) against the JAX package's fused fit from the same
    numpy-seeded parameters."""
    X, y = _data()
    rs = np.random.RandomState(12)
    jsym = _mlp(jmx, JNameManager)
    shapes = dict(zip(jsym.list_arguments(), jsym.infer_shape(
        data=(32, 8), softmax_label=(32,))[0]))
    args = {k: (0.3 * rs.randn(*v)).astype(np.float32)
            for k, v in shapes.items() if k not in ("data", "softmax_label")}
    got = []
    for pkg, sym in ((jmx, jsym), (mx, _mlp())):
        metric = pkg.metric.CompositeEvalMetric(
            [pkg.metric.Accuracy(), pkg.metric.CrossEntropy()])
        mod = pkg.mod.Module(sym, context=pkg.cpu())
        if pkg is jmx:
            arg_params = {k: jmx.nd.array(v) for k, v in args.items()}
        else:
            arg_params, _ = mx.convert.params_from_numpy(args, {}, CPU)
        mod.fit(pkg.io.NDArrayIter(X, y, batch_size=32),
                eval_metric=metric, num_epoch=2, arg_params=arg_params,
                optimizer_params={"learning_rate": 0.05})
        assert mod._exec_group._metric_live is metric
        got.append(metric.get_name_value())
    for (jn, jv), (tn, tv) in zip(*got):
        assert jn == tn
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
