"""The device-feed pipeline of the PyTorch port (``mxnet_tpu_torch.data``:
``TransformIter``, ``DeviceLoader``, ``PipelineStats``) and
``fit(prefetch_to_device=)``, held on the CPU to the contracts of
``tests/test_data_pipeline.py``: the transform stage is a pure
throughput knob (bitwise batch parity at 1/2/4 workers, seeding keyed on
(seed, epoch, batch)), the loader's ring backpressures instead of
buffering an epoch, shutdown mid-epoch joins every thread, grouped
blocks go through the bound group's ``stage_stacked``, and
``fit(prefetch_to_device=2)`` trains to parameters bit-equal to a plain
``fit``, alone, with ``batch_group`` and with a ``TransformIter`` stage.
Against the JAX package: the transform streams at 1, 2 and 4 workers
bit for bit. Every wait has a timeout; a loader bound to a gpu context
without CUDA raises.
"""
import logging
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.data import TransformIter as JTransformIter

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import sym, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.data import DeviceLoader, PipelineStats, TransformIter
from mxnet_tpu_torch.io import DataBatch, NDArrayIter

torch.set_num_threads(2)

CPU = mx.cpu()
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _bn_mlp():
    net = sym.Variable("data")
    net = sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = sym.BatchNorm(net, name="bn", fix_gamma=False)
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _data(n=56, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 6).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


def _augment(batch, rng):
    """Additive jitter drawn from the per-batch rng: bitwise
    reproducible iff the seeding is."""
    d = batch.data[0].asnumpy()
    d = d + rng.uniform(-0.1, 0.1, size=d.shape).astype(np.float32)
    return DataBatch([mx.nd.array(d, ctx=CPU)], batch.label, pad=batch.pad)


def _host(arr):
    v = arr._read() if hasattr(arr, "_read") else arr
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ----------------------------------------------------------------------
# TransformIter
# ----------------------------------------------------------------------
def test_transform_worker_count_invariance():
    X, y = _data()
    streams = {}
    for nw in (1, 2, 4):
        with TransformIter(NDArrayIter(X, y, batch_size=8),
                           transform=_augment, num_workers=nw,
                           seed=11) as it:
            streams[nw] = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                           for b in it]
    assert len(streams[1]) == 7
    for nw in (2, 4):
        for (d1, l1), (dn, ln) in zip(streams[1], streams[nw]):
            np.testing.assert_array_equal(d1, dn)
            np.testing.assert_array_equal(l1, ln)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_transform_stream_equals_jax(workers):
    """Two epochs of the same transform through the port's and the JAX
    package's TransformIter: the same bytes, whatever the worker count."""
    X, y = _data()

    def jaug(batch, rng):
        d = batch.data[0].asnumpy()
        d = d + rng.uniform(-0.1, 0.1, size=d.shape).astype(np.float32)
        return jmx.io.DataBatch([jmx.nd.array(d)], batch.label,
                                pad=batch.pad)

    got = {}
    for name, cls, src, fn in (
            ("port", TransformIter, NDArrayIter, _augment),
            ("jax", JTransformIter, jmx.io.NDArrayIter, jaug)):
        with cls(src(X, y, batch_size=8), transform=fn,
                 num_workers=workers, seed=5) as it:
            epochs = []
            for _ in range(2):
                epochs.append([b.data[0].asnumpy() for b in it])
                it.reset()
        got[name] = epochs
    for ep_a, ep_b in zip(got["port"], got["jax"]):
        assert len(ep_a) == len(ep_b) == 7
        for a, b in zip(ep_a, ep_b):
            np.testing.assert_array_equal(a, b)


def test_transform_deterministic_seeding_across_resets():
    X, y = _data()

    def epochs(nw, n_epochs=3):
        out = []
        with TransformIter(NDArrayIter(X, y, batch_size=8),
                           transform=_augment, num_workers=nw,
                           seed=5) as it:
            for _ in range(n_epochs):
                out.append([b.data[0].asnumpy() for b in it])
                it.reset()
        return out

    a, b = epochs(1), epochs(4)
    for ep_a, ep_b in zip(a, b):
        for d1, d2 in zip(ep_a, ep_b):
            np.testing.assert_array_equal(d1, d2)
    assert not np.array_equal(a[0][0], a[1][0])


def test_transform_identity_is_pure_prefetch():
    X, y = _data()
    plain = [b.data[0].asnumpy() for b in NDArrayIter(X, y, batch_size=8)]
    with TransformIter(NDArrayIter(X, y, batch_size=8),
                       num_workers=3) as it:
        pre = [b.data[0].asnumpy() for b in it]
    assert len(pre) == len(plain)
    for p, q in zip(plain, pre):
        np.testing.assert_array_equal(p, q)


def test_transform_error_propagates_in_order():
    X, y = _data()

    def bad(batch, rng):
        if float(batch.data[0].asnumpy()[0, 0]) == float(X[16, 0]):
            raise ValueError("boom on batch 2")
        return batch

    with TransformIter(NDArrayIter(X, y, batch_size=8),
                       transform=bad, num_workers=4) as it:
        assert next(it) is not None
        assert next(it) is not None
        with pytest.raises(ValueError, match="boom"):
            next(it)
        with pytest.raises(StopIteration):
            next(it)


def test_transform_stress_more_workers_than_cores():
    """16 workers, a thread switch every microsecond, two epochs through a
    DeviceLoader: the stream equals the one-worker stream, and every
    thread is joined (with a timeout) at the end."""
    import sys
    X, y = _data(n=200)

    def stream(workers):
        with TransformIter(NDArrayIter(X, y, batch_size=8),
                           transform=_augment, num_workers=workers,
                           depth=4, seed=2) as it:
            with DeviceLoader(it, depth=3, ctx=CPU) as dl:
                out = []
                for _ in range(2):
                    out.append([_host(b.data[0]) for b in dl])
                    dl.reset()
                stager = dl._stager
            pool_threads = list(it._pool._threads)
        return out, stager, pool_threads

    want, _, _ = stream(1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, stager, pool_threads = stream(16)
    finally:
        sys.setswitchinterval(old)
    for t in pool_threads + ([stager] if stager else []):
        t.join(timeout=10)
        assert not t.is_alive()
    for ep_a, ep_b in zip(want, got):
        assert len(ep_a) == len(ep_b) == 25
        for a, b in zip(ep_a, ep_b):
            np.testing.assert_array_equal(a, b)


def test_transform_mid_epoch_close_joins_threads():
    X, y = _data(n=512)

    def slow(batch, rng):
        time.sleep(0.01)
        return batch

    it = TransformIter(NDArrayIter(X, y, batch_size=8), transform=slow,
                       num_workers=4)
    next(it)
    seq = it._sequencer
    it.close()
    assert not seq.is_alive()
    assert it._pool._shutdown
    with pytest.raises(MXNetError):
        it.next()


# ----------------------------------------------------------------------
# DeviceLoader
# ----------------------------------------------------------------------
def _bound_module(batch=8):
    mod = mx.mod.Module(_bn_mlp(), context=CPU)
    mod.bind(data_shapes=[("data", (batch, 6))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(mx.init.Uniform(0.07))
    return mod


def test_device_loader_delivers_staged_batches():
    """Bound to a CPU module: every delivered input is a tensor on the
    module's device, a copy of the host rows bit for bit."""
    X, y = _data()
    mod = _bound_module()
    with DeviceLoader(NDArrayIter(X, y, batch_size=8), module=mod,
                      depth=2) as loader:
        batches = list(loader)
        assert len(batches) == 7
        for k, b in enumerate(batches):
            t = b.data[0]._read()
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), X[8 * k:8 * (k + 1)])
            np.testing.assert_array_equal(b.label[0]._read().numpy(),
                                          y[8 * k:8 * (k + 1)])
        snap = loader.pipeline_stats.snapshot()
        assert snap["batches_delivered"] == 7
        assert snap["images_delivered"] == 56
        assert snap["ring_high_water"] <= 2
        assert snap["staged_dtype"] == "float32"
        assert snap["staged_bytes_per_batch"] == 8 * 6 * 4 + 8 * 4


def test_device_loader_staged_batch_survives_ring_turns():
    """A staged batch held while the ring turns over twice still reads
    the bytes it was staged with (its buffer is never recycled under
    it)."""
    X, y = _data(n=80)
    with DeviceLoader(NDArrayIter(X, y, batch_size=8), depth=2,
                      ctx=CPU) as loader:
        first = next(loader)
        for _ in range(5):
            next(loader)
        np.testing.assert_array_equal(_host(first.data[0]), X[:8])


def test_device_loader_gpu_context_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    X, y = _data()
    with pytest.raises(MXNetError, match="CUDA"):
        DeviceLoader(NDArrayIter(X, y, batch_size=8), ctx=mx.gpu(0))
    with pytest.raises(MXNetError, match="CUDA"):
        DeviceLoader(NDArrayIter(X, y, batch_size=8))   # default gpu(0)


def test_device_loader_backpressure_bounds_ring():
    X, y = _data(n=400)
    stats = PipelineStats()
    with DeviceLoader(NDArrayIter(X, y, batch_size=8), depth=3,
                      stats=stats, ctx=CPU) as loader:
        seen = 0
        for _ in loader:
            time.sleep(0.005)
            assert len(loader._ring) <= 3
            seen += 1
        snap = stats.snapshot()
        assert seen == 50
        assert snap["ring_high_water"] <= 3
        assert snap["ring_full_waits"] >= 1
    stats.release()


def test_device_loader_reset_and_shutdown_mid_epoch():
    X, y = _data()
    loader = DeviceLoader(NDArrayIter(X, y, batch_size=8), depth=2,
                          ctx=CPU)
    first = next(loader)
    np.testing.assert_array_equal(_host(first.data[0]), X[:8])
    loader.reset()
    loader.reset()
    batches = list(loader)
    assert len(batches) == 7
    for k, b in enumerate(batches):
        np.testing.assert_array_equal(_host(b.data[0]),
                                      X[8 * k:8 * (k + 1)])
    loader.reset()
    next(loader)
    stager = loader._stager
    loader.close()
    assert not stager.is_alive()
    loader.close()
    with pytest.raises(MXNetError):
        loader.reset()
    with pytest.raises(MXNetError):
        loader.next()


def test_device_loader_grouped_blocks_via_stage_stacked():
    """batch_group=K: one (K, B, ...) block per K batches through the
    group's stage_stacked; the delivered views carry the block, which the
    grouped step takes as it is. The epoch tail forms its own block."""
    X, y = _data()
    mod = _bound_module()
    with DeviceLoader(NDArrayIter(X, y, batch_size=8), module=mod,
                      depth=2, batch_group=3) as loader:
        batches = list(loader)
    assert len(batches) == 7
    Module = mx.mod.Module
    blk = Module._staged_group_block(batches[:3])
    assert blk is not None and blk is batches[0]._staged_block
    np.testing.assert_array_equal(blk["data"].numpy(),
                                  X[:24].reshape(3, 8, 6))
    assert set(blk) == {"data", "softmax_label"}
    assert batches[6]._staged_size == 1
    assert Module._staged_group_block(batches[6:]) is \
        batches[6]._staged_block
    assert Module._staged_group_block(batches[1:4]) is None


def test_device_loader_passthrough_source():
    """A source that opts out of background pulls is pulled on the
    consumer thread: no stager, the same batches, the stats kept."""
    X, y = _data()
    src = NDArrayIter(X, y, batch_size=8)
    src.background_pull_safe = False
    with DeviceLoader(src, depth=2, ctx=CPU) as loader:
        assert loader._stager is None
        got = [_host(b.data[0]) for b in loader]
        assert loader._stager is None
        assert loader.pipeline_stats.snapshot()["batches_delivered"] == 7
    for k, d in enumerate(got):
        np.testing.assert_array_equal(d, X[8 * k:8 * (k + 1)])


def test_exhausted_iterators_keep_raising_stop_iteration():
    X, y = _data()
    with TransformIter(NDArrayIter(X, y, batch_size=8),
                       num_workers=2) as it:
        assert len(list(it)) == 7
        with pytest.raises(StopIteration):
            it.next()
        assert it.iter_next() is False
        it.reset()
        assert len(list(it)) == 7
    with DeviceLoader(NDArrayIter(X, y, batch_size=8), depth=2,
                      ctx=CPU) as dl:
        assert len(list(dl)) == 7
        with pytest.raises(StopIteration):
            dl.next()
        assert dl.iter_next() is False
        dl.reset()
        assert len(list(dl)) == 7


def test_device_loader_error_delivered_in_order():
    X, y = _data()

    class Failing(NDArrayIter):
        calls = 0

        def next(self):
            Failing.calls += 1
            if Failing.calls == 3:
                raise ValueError("source broke")
            return super().next()

    with DeviceLoader(Failing(X, y, batch_size=8), depth=2,
                      ctx=CPU) as dl:
        next(dl)
        next(dl)
        with pytest.raises(ValueError, match="source broke"):
            next(dl)
        with pytest.raises(StopIteration):
            next(dl)


def test_device_loader_threads_named_and_daemonized():
    X, y = _data()
    with DeviceLoader(NDArrayIter(X, y, batch_size=8), depth=2,
                      ctx=CPU) as dl:
        assert dl._stager.daemon
        assert dl._stager.name.startswith("mxtpu-device-stager")
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("mxtpu-device-stager")]
    assert not alive, alive


def test_pipeline_stats_scope_and_active_pipeline():
    """A loader's own stats claim a data.<i> registry scope and release
    it on close; fit publishes the loader's stats while it trains and
    clears them after."""
    X, y = _data()
    loader = DeviceLoader(NDArrayIter(X, y, batch_size=8), ctx=CPU)
    prefix = loader.pipeline_stats.scope.prefix
    list(loader)
    key = prefix + ".batches_delivered"
    assert telemetry.registry().snapshot()["counters"][key] == 7
    loader.close()
    assert key not in telemetry.registry().snapshot()["counters"]
    seen = []

    def probe(param):
        seen.append(telemetry.active_pipeline())

    mod = mx.mod.Module(_bn_mlp(), context=CPU)
    mod.fit(NDArrayIter(X, y, batch_size=8), num_epoch=1,
            prefetch_to_device=2, optimizer_params={"learning_rate": 0.1},
            initializer=mx.init.Uniform(0.07), batch_end_callback=probe)
    assert seen and all(isinstance(s, PipelineStats) for s in seen)
    assert telemetry.active_pipeline() is None


# ----------------------------------------------------------------------
# fit: bitwise parity
# ----------------------------------------------------------------------
def _fit_run(X, y, prefetch=None, batch_group=None, num_epoch=2,
             wrap=None):
    mod = mx.mod.Module(_bn_mlp(), context=CPU)
    mx.random.seed(42)
    metric = mx.metric.Accuracy()
    it = NDArrayIter(X, y, batch_size=8)
    if wrap is not None:
        it = wrap(it)
    mod.fit(it, num_epoch=num_epoch, eval_metric=metric,
            optimizer_params=OPT, initializer=mx.init.Uniform(0.07),
            batch_group=batch_group, prefetch_to_device=prefetch)
    if hasattr(it, "close"):
        it.close()
    return mod, metric.get_name_value()


def _assert_params_bit_equal(a, b):
    pa, xa = a.get_params()
    pb, xb = b.get_params()
    for n in list(pa) + list(xa):
        va = (pa.get(n) or xa.get(n)).asnumpy()
        vb = (pb.get(n) or xb.get(n)).asnumpy()
        np.testing.assert_array_equal(va, vb, err_msg=n)


def test_fit_prefetch_to_device_params_bit_equal():
    X, y = _data()
    plain, m0 = _fit_run(X, y)
    pre, m1 = _fit_run(X, y, prefetch=2)
    assert m0 == m1
    _assert_params_bit_equal(plain, pre)
    pre3, _ = _fit_run(X, y, prefetch=True)
    _assert_params_bit_equal(plain, pre3)


def test_fit_prefetch_composes_with_batch_group():
    """prefetch_to_device=2 + batch_group=3 (K-blocks through the ring,
    7-batch epochs as 3+3+1): bit-equal to the plain per-batch run, and
    the grouped step really ran."""
    X, y = _data()
    plain, m0 = _fit_run(X, y)
    grouped, m1 = _fit_run(X, y, prefetch=2, batch_group=3)
    assert m0 == m1
    _assert_params_bit_equal(plain, grouped)
    assert grouped.grouped_train_engaged()


def test_fit_prefetch_with_transform_stage_parity():
    """TransformIter workers feeding the DeviceLoader ring match a
    serial, unprefetched run of the same seeded augment bit for bit."""
    X, y = _data()

    class _SerialAugment(object):
        def __init__(self, it):
            self._it = it
            self._epoch = 0
            self._seq = 0
            self.provide_data = it.provide_data
            self.provide_label = it.provide_label
            self.batch_size = it.batch_size

        def __iter__(self):
            return self

        def __next__(self):
            batch = self._it.next()
            rng = np.random.RandomState(
                mx.data.fold_seed(0, self._epoch, self._seq))
            self._seq += 1
            return _augment(batch, rng)

        next = __next__

        def reset(self):
            self._it.reset()
            self._epoch += 1
            self._seq = 0

    def wrap_parallel(it):
        return TransformIter(it, transform=_augment, num_workers=4, seed=0)

    serial, m0 = _fit_run(X, y, wrap=_SerialAugment)
    piped, m1 = _fit_run(X, y, prefetch=2, wrap=wrap_parallel)
    assert m0 == m1
    _assert_params_bit_equal(serial, piped)


def test_fit_prefetch_logs_host_wait(caplog):
    X, y = _data()
    mod = mx.mod.Module(_bn_mlp(), context=CPU)
    it = NDArrayIter(X, y, batch_size=8)
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=1, prefetch_to_device=2,
                optimizer_params={"learning_rate": 0.1},
                initializer=mx.init.Uniform(0.07),
                batch_end_callback=mx.callback.Speedometer(8, 3))
    msgs = [r.getMessage() for r in caplog.records]
    assert any("Host-wait=" in m for m in msgs), msgs
    speedo = [m for m in msgs if "samples/sec" in m]
    assert speedo and all("host-wait=" in m for m in speedo), speedo


def test_predictor_accepts_prestaged_inputs():
    """A request already staged (the tensors a DeviceLoader delivers) is
    served without a host round trip, bit for bit the rows from host
    memory."""
    from mxnet_tpu_torch.serving import Predictor
    X, y = _data()
    mod = _bound_module()
    pred = Predictor(mod, max_batch_size=8)
    host = pred.predict(X[:5])
    staged = pred.predict(torch.from_numpy(X[:5].copy()))
    np.testing.assert_array_equal(host, staged)
    with DeviceLoader(NDArrayIter(X, y, batch_size=8), module=mod,
                      depth=2) as loader:
        batch = next(loader)
    np.testing.assert_array_equal(pred.predict(X[:8]),
                                  pred.predict(batch.data[0]))


def test_fit_prefetch_leaves_callers_iterator_usable():
    X, y = _data()
    mod = mx.mod.Module(_bn_mlp(), context=CPU)
    with TransformIter(NDArrayIter(X, y, batch_size=8),
                       num_workers=2) as it:
        for begin in (0, 1):
            mod.fit(it, num_epoch=begin + 1, begin_epoch=begin,
                    prefetch_to_device=2,
                    optimizer_params={"learning_rate": 0.1},
                    initializer=mx.init.Uniform(0.07))
        assert len(list(it)) == 7
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("mxtpu-device-stager")]
    assert not alive, alive


def test_fit_guardian_still_refused(tmp_path):
    """fit(guardian=) took a refusal until the guardian was ported; now a
    guardian armed over a prefetched fit (DeviceLoader batches) trains to
    the parameters of the unguarded prefetched fit, bit for bit."""
    X, y = _data()
    got = []
    for g in (None, str(tmp_path / "guardian")):
        mx.random.seed(4)
        np.random.seed(4)
        mod = mx.mod.Module(_bn_mlp(), context=CPU)
        mod.fit(NDArrayIter(X, y, batch_size=8), num_epoch=2,
                prefetch_to_device=2, guardian=g,
                optimizer_params={"learning_rate": 0.1},
                initializer=mx.init.Uniform(0.07))
        a, x = mod.get_params()
        got.append({k: v.asnumpy() for k, v in
                    list(a.items()) + list(x.items())})
    assert sorted(got[0]) == sorted(got[1])
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
