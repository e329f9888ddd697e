"""Serving in the PyTorch port (mxnet_tpu_torch.serving) vs the JAX
package's (mxnet_tpu.serving), on the CPU.

The net is tests/test_serving.py's (FC 16 → BatchNorm → ReLU → FC 10 →
Softmax, 6 features), trained by the JAX package and carried into the
port with ``convert.py``. Held against the JAX package: served rows for
request sizes that fit a bucket, pad up to one and are chunked over the
top bucket (rtol 1e-5, atol 1e-6: the two frameworks round matrix
products differently); the bucket ladder and its errors; the params
digest; a prefilled ``DynamicBatcher``'s launches, buckets and fill; and
a resnet-8 (3×16×16, 10 classes) served by both (rtol 1e-4, atol 1e-6).
Held within the port, bit for bit: served rows against ``Module.predict``
through a module bound at the bucket's batch, the compile counter frozen
after warmup, concurrent clients' rows, one parameter set under every
bucket, the parameter snapshot, and the reference's queue-full, timeout,
shutdown and malformed-request behaviour. Every wait has a timeout.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
import mxnet_tpu.serving as jserving
from mxnet_tpu.checkpoint import params_digest as jax_params_digest
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.checkpoint import params_digest as torch_params_digest
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.serving import (DynamicBatcher, Predictor, QueueFull,
                                     RequestTimeout, ServerClosed)

torch.set_num_threads(2)

DIM = 6
RTOL, ATOL = 1e-5, 1e-6
WAIT = 60          # seconds any future may take before the test fails
CPU = tmx.cpu()


def _net(pkg, names):
    with names():
        s = pkg.sym
        net = s.Variable("data")
        net = s.FullyConnected(net, num_hidden=16, name="fc1")
        net = s.BatchNorm(net, name="bn", fix_gamma=False)
        net = s.Activation(net, act_type="relu")
        net = s.FullyConnected(net, num_hidden=10, name="fc2")
        return s.SoftmaxOutput(net, name="softmax")


def _data(n=96, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, DIM).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


class _Rows(tmx.io.DataIter):
    """Yields the given row counts, no iterator padding: a batch shorter
    than the bound shape reaches ``Module.forward`` as it is."""

    def __init__(self, X, sizes):
        super().__init__(batch_size=sizes[0])
        self.X, self.sizes = X, sizes
        self.reset()

    def reset(self):
        self._i, self._off = 0, 0

    def next(self):
        if self._i >= len(self.sizes):
            raise StopIteration
        n, o = self.sizes[self._i], self._off
        self._i += 1
        self._off += n
        return tmx.io.DataBatch(data=[tmx.nd.array(self.X[o:o + n],
                                                   ctx=CPU)],
                                label=None, pad=0)


def _port_module(tsym, args, aux, batch):
    mod = tmx.mod.Module(tsym, context=CPU)
    mod.bind(data_shapes=[("data", (batch,) + args["fc1_weight"].shape[1:])],
             for_training=False)
    targs, taux = tmx.convert.params_from_numpy(args, aux, CPU)
    mod.init_params(arg_params=targs, aux_params=taux)
    return mod


def _reference_rows(tsym, args, aux, X, buckets):
    """The rows ``X`` as the port serves them, from ``Module.predict``
    through a module bound at each launch's bucket: chunks of the top
    bucket, the rest in the smallest bucket that holds it."""
    top, out, start = buckets[-1], [], 0
    while start < len(X):
        take = min(len(X) - start, top)
        b = next(b for b in buckets if b >= take)
        mod = _port_module(tsym, args, aux, b)
        out.append(mod.predict(_Rows(X[start:start + take], [take]))
                   .asnumpy())
        start += take
    return np.concatenate(out)


@pytest.fixture(scope="module")
def trained():
    """A net trained by the JAX package, its numpy params, and both
    packages' symbols."""
    jmx.random.seed(7)
    jsym = _net(jmx, JNameManager)
    jmod = jmx.mod.Module(jsym, context=[jmx.cpu()])
    X, y = _data()
    jmod.fit(jmx.io.NDArrayIter(X[:64], y[:64], batch_size=8),
             num_epoch=2, optimizer="sgd",
             optimizer_params={"learning_rate": 0.1})
    a, x = jmod.get_params()
    args = {k: v.asnumpy() for k, v in a.items()}
    aux = {k: v.asnumpy() for k, v in x.items()}
    return jmod, jsym, _net(tmx, TNameManager), args, aux, X


@pytest.fixture(scope="module")
def served(trained):
    """Warmed predictors of both packages (top bucket 16) over the same
    parameters, and the port's source module."""
    jmod, _jsym, tsym, args, aux, X = trained
    tmod = _port_module(tsym, args, aux, 8)
    tpred = Predictor(tmod, max_batch_size=16)
    tpred.warmup()
    jpred = jserving.Predictor(jmod, max_batch_size=16)
    jpred.warmup()
    return tpred, jpred, tmod


# ---------------------------------------------------------------------
# rows against the JAX package and against Module.predict
# ---------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 3, 5, 16, 70])
def test_served_rows_match_jax(trained, served, n):
    _jmod, _jsym, tsym, args, aux, X = trained
    tpred, jpred, _ = served
    out = tpred.predict(X[:n])
    assert out.shape == (n, 10) and out.dtype == np.float32
    np.testing.assert_allclose(out, jpred.predict(X[:n]), rtol=RTOL,
                               atol=ATOL)
    # within the port, bit for bit: Module.predict at the bucket's batch
    want = _reference_rows(tsym, args, aux, X[:n], tpred.buckets)
    assert np.array_equal(out, want), "size %d not bitwise" % n


def test_direct_tensor_request_equals_host_request(served, trained):
    tpred = served[0]
    X = trained[5]
    host = tpred.predict(X[:5])
    assert np.array_equal(tpred.predict(torch.from_numpy(X[:5])), host)
    assert np.array_equal(tpred.predict(tmx.nd.array(X[:5], ctx=CPU)),
                          host)


@pytest.mark.parametrize("kwargs", [
    {"max_batch_size": 16}, {"max_batch_size": 5}, {"max_batch_size": 2},
    {"buckets": [4, 6, 12]}, {"buckets": [12, 4, 4]}, {"buckets": [0, 4]},
    {"max_batch_size": 0}, {"max_batch_size": 1}, {"buckets": []},
    {"buckets": [1, 8]}, {"buckets": [-2, 8]}])
def test_bucket_ladder_matches_jax(trained, served, kwargs):
    jmod = trained[0]
    tmod = served[2]
    try:
        want = jserving.Predictor(jmod, **kwargs).buckets
    except jmx.MXNetError:
        with pytest.raises(tmx.MXNetError):
            Predictor(tmod, **kwargs)
        return
    pred = Predictor(tmod, **kwargs)
    assert pred.buckets == want
    assert pred.max_batch_size == want[-1]
    for n in (1, 2, 3, 5, 9, 13, 40):
        assert pred.bucket_for(n) == jserving.Predictor.bucket_for(
            pred, n), n
    pred.release()


def test_custom_buckets_serve_bitwise(trained, served):
    _jmod, _jsym, tsym, args, aux, X = trained
    pred = Predictor(served[2], buckets=[4, 6, 12])
    out = pred.predict(X[:5])                       # pads to 6
    assert np.array_equal(out, _reference_rows(tsym, args, aux, X[:5],
                                               [4, 6, 12]))
    pred.release()


def test_params_digest_matches_jax(trained, served):
    _jmod, jsym, tsym, args, aux, _X = trained
    tpred, jpred, _ = served
    assert jsym.tojson() == tsym.tojson()
    assert tpred.params_digest == jpred.params_digest
    packed = {("arg:%s" % k): v for k, v in args.items()}
    packed.update({("aux:%s" % k): v for k, v in aux.items()})
    assert torch_params_digest(tsym.tojson(), packed) == \
        jax_params_digest(jsym.tojson(), packed)
    # tensors and NDArrays digest like the numpy arrays they hold
    as_nd = {k: tmx.nd.array(v, ctx=CPU) for k, v in packed.items()}
    assert torch_params_digest(tsym.tojson(), as_nd) == \
        jax_params_digest(jsym.tojson(), packed)
    # the digest is structural: widths change it, values do not
    moved = dict(packed, **{"arg:fc2_bias": packed["arg:fc2_bias"] + 1})
    assert torch_params_digest(tsym.tojson(), moved) == \
        torch_params_digest(tsym.tojson(), packed)
    wider = dict(packed, **{"arg:fc2_bias": np.zeros(11, np.float32)})
    assert torch_params_digest(tsym.tojson(), wider) != \
        torch_params_digest(tsym.tojson(), packed)


# ---------------------------------------------------------------------
# the compile counter, shared parameters, the snapshot
# ---------------------------------------------------------------------
def test_warmup_compiles_every_bucket_then_frozen(served, trained):
    X = trained[5]
    pred = Predictor(served[2], max_batch_size=16)
    try:
        assert pred.stats()["compiles"] == 0
        s = pred.warmup()
        assert s["compile_tracking"]
        assert s["compiles"] == len(pred.buckets) == 4
        assert sorted(s["warmup_ms"]) == pred.buckets
        assert {r["source"] for r in pred.warmup_report().values()} == \
            {"eager"}
        srv = DynamicBatcher(pred, max_queue=64, max_wait_ms=1)
        try:
            for i in range(30):
                n = 1 + (i * 5) % 16
                if i % 2:
                    pred.predict(X[:n])
                else:
                    srv.predict(X[:n], timeout=WAIT)
        finally:
            srv.shutdown()
        assert pred.stats()["compiles"] == len(pred.buckets)
    finally:
        pred.release()


def test_buckets_share_one_parameter_set(trained, served):
    _jmod, _jsym, tsym, args, aux, X = trained
    pred = Predictor(served[2], max_batch_size=16)
    try:
        base = pred._modules[16]._exec_group.execs[0]
        for b in pred.buckets:
            ex = pred._modules[b]._exec_group.execs[0]
            for name in list(args) + list(aux):
                arr, ref = ((ex.arg_dict[name], base.arg_dict[name])
                            if name in args else
                            (ex.aux_dict[name], base.aux_dict[name]))
                assert arr._read().data_ptr() == ref._read().data_ptr()
        # one set_params on the base reaches every bucket
        before = pred.predict(X[:3])
        a2 = {k: v * 0.5 if k == "fc2_weight" else v
              for k, v in args.items()}
        targs, taux = tmx.convert.params_from_numpy(a2, aux, CPU)
        pred._base.set_params(targs, taux)
        for n in (1, 3, 7, 16):
            want = _reference_rows(tsym, a2, aux, X[:n], pred.buckets)
            assert np.array_equal(pred.predict(X[:n]), want), n
        assert not np.array_equal(pred.predict(X[:3]), before)
    finally:
        pred.release()


def test_shared_module_bind_rules(served):
    tmod = served[2]
    other = tmx.mod.Module(tmod.symbol, context=CPU)
    with pytest.raises(tmx.MXNetError):
        other.bind(data_shapes=[("data", (4, DIM))], for_training=True,
                   shared_module=tmod)
    unbound = tmx.mod.Module(tmod.symbol, context=CPU)
    with pytest.raises(tmx.MXNetError):
        other.bind(data_shapes=[("data", (4, DIM))], for_training=False,
                   shared_module=unbound)


def test_snapshot_ignores_later_training(trained):
    """A Predictor copies the parameters out of a live training module:
    one more training step on the source leaves served rows as they
    were."""
    _jmod, _jsym, tsym, args, aux, X = trained
    _, y = _data()
    src = tmx.mod.Module(tsym, context=CPU)
    src.bind(data_shapes=[("data", (8, DIM))],
             label_shapes=[("softmax_label", (8,))])
    targs, taux = tmx.convert.params_from_numpy(args, aux, CPU)
    src.init_params(arg_params=targs, aux_params=taux)
    src.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    pred = Predictor(src, max_batch_size=8)
    try:
        before = pred.predict(X[:8])
        batch = tmx.io.DataBatch([tmx.nd.array(X[:8], ctx=CPU)],
                                 [tmx.nd.array(y[:8], ctx=CPU)])
        src.forward_backward(batch)
        src.update()
        moved = src.get_params()[0]["fc1_weight"].asnumpy()
        assert not np.array_equal(moved, args["fc1_weight"])
        assert np.array_equal(pred.predict(X[:8]), before)
    finally:
        pred.release()


def test_predict_tail_pads_to_the_bound_shape(trained, served):
    """Module.predict on a batch shorter than the bound shape pads it
    with zero rows (``pad_batch_rows``) and drops them again; score
    counts only the real rows."""
    _jmod, _jsym, tsym, args, aux, X = trained
    _, y = _data()
    mod = _port_module(tsym, args, aux, 8)
    out = mod.predict(_Rows(X[:21], [8, 8, 5])).asnumpy()
    full = mod.predict(_Rows(X[:24], [8, 8, 8])).asnumpy()
    assert np.array_equal(out, full[:21])

    class _Labelled(_Rows):
        def next(self):
            b = super().next()
            o = self._off - self.sizes[self._i - 1]
            b.label = [tmx.nd.array(y[o:o + len(b.data[0])], ctx=CPU)]
            return b

    score = dict(mod.score(_Labelled(X[:21], [8, 8, 5]), "acc"))
    want = float((full[:21].argmax(axis=1) == y[:21]).mean())
    assert score["accuracy"] == pytest.approx(want, abs=1e-12)


def test_pad_batch_rows_keeps_the_device(served):
    from mxnet_tpu_torch.module.base_module import pad_batch_rows
    host = np.ones((3, DIM), np.float32)
    padded = pad_batch_rows(host, 8)
    assert isinstance(padded, np.ndarray) and padded.shape == (8, DIM)
    assert padded[3:].sum() == 0 and padded[:3].sum() == 3 * DIM
    t = torch.ones(3, DIM)
    tp = pad_batch_rows(tmx.nd.NDArray(t), 4)
    assert isinstance(tp, torch.Tensor) and tp.device == t.device
    assert tp.shape == (4, DIM) and float(tp[3].abs().sum()) == 0.0
    assert pad_batch_rows(host, 3) is host


# ---------------------------------------------------------------------
# the dynamic batcher
# ---------------------------------------------------------------------
SIZES = [3, 5, 2, 7, 1, 9, 4, 16, 6, 2, 11, 3]


def _prefilled_run(pkg_serving, module, X):
    pred = pkg_serving.Predictor(module, max_batch_size=16)
    pred.warmup()
    srv = pkg_serving.DynamicBatcher(pred, max_queue=64, max_wait_ms=0,
                                     start=False)
    try:
        futs, off = [], 0
        for n in SIZES:
            futs.append(srv.submit(X[off:off + n]))
            off += n
        srv.start()
        outs = [f.result(timeout=WAIT) for f in futs]
    finally:
        srv.shutdown()
    s = pred.stats()
    counts = {k: s[k] for k in ("batches", "bucket_hits", "batch_fill",
                                "requests", "completed")}
    counts.update(real_rows=pred._stats.real_rows,
                  padded_rows=pred._stats.padded_rows)
    pred.release()
    return counts, outs


def test_prefilled_batcher_launches_match_jax(trained, served):
    jmod, X = trained[0], trained[5]
    tcounts, touts = _prefilled_run(tmx.serving, served[2], X)
    jcounts, jouts = _prefilled_run(jserving, jmod, X)
    assert tcounts == jcounts
    assert tcounts["real_rows"] == sum(SIZES)
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_concurrent_clients_get_their_own_rows(trained, served):
    _jmod, _jsym, tsym, args, aux, X = trained
    pred = served[0]
    # Module.predict of the same rows at every bucket: coalescing picks
    # the bucket a client's rows are served in
    full = {b: _port_module(tsym, args, aux, b).predict(
        _Rows(X[:64], [b] * (64 // b))).asnumpy() for b in pred.buckets}
    srv = DynamicBatcher(pred, max_queue=128, max_wait_ms=5)
    errs = []

    def client(i):
        n = 1 + (i % 7)
        lo = (i * 3) % 40
        try:
            out = srv.predict(X[lo:lo + n], timeout=WAIT)
            if not any(np.array_equal(out, full[b][lo:lo + n])
                       for b in pred.buckets if b >= n):
                errs.append("client %d got wrong rows" % i)
        except Exception as e:  # noqa: BLE001 — collected for assert
            errs.append("client %d: %r" % (i, e))

    before = pred.stats()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(32)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.shutdown()
    assert not errs, errs
    s = pred.stats()
    # coalescing happened: fewer launches than requests
    assert s["batches"] - before["batches"] < \
        s["requests"] - before["requests"] == 32
    assert 0 < s["batch_fill"] <= 1.0


def test_queue_full_rejection(served, trained):
    pred, X = served[0], trained[5]
    srv = DynamicBatcher(pred, max_queue=3, start=False)
    try:
        before = pred.stats()["rejected"]
        futs = [srv.submit(X[:2]) for _ in range(3)]
        with pytest.raises(QueueFull):
            srv.submit(X[:2])
        assert pred.stats()["rejected"] == before + 1
        srv.start()     # the queued three still complete
        for f in futs:
            assert f.result(timeout=WAIT).shape == (2, 10)
    finally:
        srv.shutdown()


def test_request_timeout(served, trained):
    pred, X = served[0], trained[5]
    srv = DynamicBatcher(pred, max_queue=8, timeout_ms=20, start=False)
    try:
        before = pred.stats()["timeouts"]
        fut = srv.submit(X[:2])
        time.sleep(0.1)      # expire while the worker is stopped
        srv.start()
        with pytest.raises(RequestTimeout):
            fut.result(timeout=WAIT)
        assert pred.stats()["timeouts"] == before + 1
    finally:
        srv.shutdown()


def test_shutdown_semantics(served, trained):
    pred, X = served[0], trained[5]
    srv = DynamicBatcher(pred, max_queue=8, start=False)
    try:
        fut = srv.submit(X[:3])
        srv.start()
        srv.shutdown(drain=True)
        assert fut.result(timeout=WAIT).shape == (3, 10)
        with pytest.raises(ServerClosed):
            srv.submit(X[:3])
    finally:
        srv.shutdown()
    srv2 = DynamicBatcher(pred, max_queue=8, start=False)
    try:
        fut2 = srv2.submit(X[:3])
        srv2.shutdown(drain=False)
        with pytest.raises(ServerClosed):
            fut2.result(timeout=WAIT)
    finally:
        srv2.shutdown()


def test_malformed_request_fails_at_submit(served):
    srv = DynamicBatcher(served[0], max_queue=8)
    try:
        with pytest.raises(ValueError):
            srv.submit(np.zeros((2, DIM + 1), np.float32))
        with pytest.raises(ValueError):
            srv.submit(np.zeros((0, DIM), np.float32))
        with pytest.raises(ValueError):
            srv.submit({"other": np.zeros((2, DIM), np.float32)})
    finally:
        srv.shutdown()


def test_worker_crash_fails_in_flight_and_restarts(served, trained):
    """An exception escaping a launch fails that launch's futures with
    WorkerCrashed (cause chained), counts a worker restart, and the
    worker goes on serving."""
    from mxnet_tpu_torch.serving import WorkerCrashed
    pred, X = served[0], trained[5]
    srv = DynamicBatcher(pred, max_queue=8, max_wait_ms=0, start=False)
    real, calls = srv._launch, []

    def crash_once(ten, reqs):
        calls.append(len(reqs))
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(ten, reqs)

    srv._launch = crash_once
    try:
        restarts = pred.stats()["worker_restarts"]
        fut = srv.submit(X[:2])
        srv.start()
        with pytest.raises(WorkerCrashed) as err:
            fut.result(timeout=WAIT)
        assert isinstance(err.value.__cause__, RuntimeError)
        assert pred.stats()["worker_restarts"] == restarts + 1
        assert srv.predict(X[:3], timeout=WAIT).shape == (3, 10)
    finally:
        srv.shutdown()


def test_latency_stats_fields(served, trained):
    pred, X = served[0], trained[5]
    pred.predict(X[:4])
    s = pred.stats()
    lat = s["latency_ms"]
    assert lat["count"] >= 1 and lat["p50"] is not None
    assert lat["p50"] <= lat["p99"] <= lat["max"]
    assert s["queue_depth"] == 0
    assert set(s["bucket_hits"]) <= set(pred.buckets)
    assert set(s) == set(served[1].stats())


# ---------------------------------------------------------------------
# the executable cache's entry points, what still refuses, and the
# legacy checkpoint route
# ---------------------------------------------------------------------
def test_later_slice_features_raise(served, trained, monkeypatch, tmp_path):
    """``warmup(cache_dir=)`` and ``MXNET_COMPILE_CACHE_DIR`` (refused
    before the executable cache was ported) now warm-start: the env
    replica loads what the explicit one committed, both serve the
    eager predictor's rows bit for bit. A calibration on an f32 module,
    an empty checkpoint directory and a legacy prefix with a mode still
    raise."""
    tpred, tmod, X = served[0], served[2], trained[5]
    pred = Predictor(tmod, max_batch_size=16)
    env = None
    try:
        s = pred.warmup(cache_dir=str(tmp_path / "c"))
        assert s["cache_misses"] == len(pred.buckets) == s["compiles"]
        assert {r["source"] for r in pred.warmup_report().values()} == \
            {"compiled"}
        monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "c"))
        env = Predictor(tmod, max_batch_size=16)
        s = env.warmup()
        assert s["cache_hits"] == len(env.buckets) and s["compiles"] == 0
        assert {r["source"] for r in env.warmup_report().values()} == \
            {"deserialized"}
        for n in (1, 3, 16, 21):
            want = tpred.predict(X[:n])
            assert np.array_equal(pred.predict(X[:n]), want), n
            assert np.array_equal(env.predict(X[:n]), want), n
    finally:
        pred.release()
        if env is not None:
            env.release()
    with pytest.raises(tmx.MXNetError):
        Predictor(tmod, calibration=object())
    with pytest.raises(tmx.MXNetError):
        Predictor.load(str(tmp_path / "empty"), data_shapes=[("data", (8, DIM))])
    with pytest.raises(tmx.MXNetError):
        Predictor.load(str(tmp_path / "m"), 1, precision="bf16",
                       data_shapes=[("data", (8, DIM))])


def test_legacy_prefix_from_jax_serves(trained, served, tmp_path):
    """A checkpoint the JAX package wrote serves through the port's
    ``Predictor.load`` like the JAX Predictor it came from."""
    jmod, X = trained[0], trained[5]
    prefix = str(tmp_path / "model")
    jmod.save_checkpoint(prefix, 1)
    pred = Predictor.load(prefix, 1, data_shapes=[("data", (8, DIM))],
                          max_batch_size=8, context=CPU)
    try:
        assert pred.buckets == [2, 4, 8]
        np.testing.assert_allclose(pred.predict(X[:7]),
                                   served[1].predict(X[:7]), rtol=RTOL,
                                   atol=ATOL)
        assert np.array_equal(pred.predict(X[:7]), served[0].predict(X[:7]))
    finally:
        pred.release()


# ---------------------------------------------------------------------
# the slice as a whole: a resnet-8 served by both packages
# ---------------------------------------------------------------------
def _resnet8(pkg, names):
    with names():
        return pkg.models.get_symbol("resnet-8", num_classes=10,
                                     image_shape=(3, 16, 16))


def test_resnet8_served_by_both_packages():
    jsym = _resnet8(jmx, JNameManager)
    tsym = _resnet8(tmx, TNameManager)
    rs = np.random.RandomState(5)
    arg_shapes, _, aux_shapes = jsym.infer_shape(data=(4, 3, 16, 16))
    args = {}
    for name, shape in zip(jsym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("gamma"):
            args[name] = (rs.rand(*shape) + 0.5).astype(np.float32)
        elif name.endswith(("beta", "bias")):
            args[name] = (rs.randn(*shape) * 0.1).astype(np.float32)
        else:
            fan = float(np.prod(shape[1:]))
            args[name] = (rs.randn(*shape)
                          * np.sqrt(2.0 / fan)).astype(np.float32)
    aux = {name: ((rs.randn(*shape) * 0.1) if name.endswith("mean")
                  else (rs.rand(*shape) + 0.5)).astype(np.float32)
           for name, shape in zip(jsym.list_auxiliary_states(), aux_shapes)}
    X = rs.randn(21, 3, 16, 16).astype(np.float32)

    jmod = jmx.mod.Module(jsym, context=[jmx.cpu()])
    jmod.bind(data_shapes=[("data", (4, 3, 16, 16))], for_training=False)
    jmod.init_params(arg_params={k: jmx.nd.array(v) for k, v in args.items()},
                     aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
    jpred = jserving.Predictor(jmod, max_batch_size=8)
    tmod = tmx.mod.Module(tsym, context=CPU)
    tmod.bind(data_shapes=[("data", (4, 3, 16, 16))], for_training=False)
    targs, taux = tmx.convert.params_from_numpy(args, aux, CPU)
    tmod.init_params(arg_params=targs, aux_params=taux)
    tpred = Predictor(tmod, max_batch_size=8)
    assert tpred.buckets == jpred.buckets == [2, 4, 8]
    assert tpred.params_digest == jpred.params_digest
    tpred.warmup()
    try:
        for n in (1, 5, 21):
            out = tpred.predict(X[:n])
            assert out.shape == (n, 10) and np.isfinite(out).all()
            np.testing.assert_allclose(out, jpred.predict(X[:n]),
                                       rtol=1e-4, atol=1e-6)
        with DynamicBatcher(tpred, max_queue=16, max_wait_ms=2) as srv:
            futs = [srv.submit(X[i:i + 3]) for i in range(0, 21, 3)]
            got = np.concatenate([f.result(timeout=WAIT) for f in futs])
        np.testing.assert_allclose(got, jpred.predict(X), rtol=1e-4,
                                   atol=1e-6)
        assert tpred.stats()["compiles"] == 3
    finally:
        tpred.release()
