"""Device augmentation and the dataset cache of the PyTorch port
(``mxnet_tpu_torch.data``: ``DeviceAugment``, ``DeviceAugmentIter``,
``CachedDataset``; ``Module(device_augment=)``), held on the CPU to the
contracts of ``tests/test_device_augment.py``: ``apply`` (torch) equals
``apply_host`` (numpy) element for element; the u8 stream replays across
``reset()``/``set_epoch`` and worker counts; parameters are bit-identical
across augment placements (device vs the host reference) and dataset
modes (streaming vs device-cached vs host-cached), also composed with
``prefetch_to_device`` and ``batch_group``; the cache budget falls back
to the host tier. Against the JAX package: ``fold_seed``, the draws,
``apply_host`` and the port's ``apply`` bit for bit (``apply`` against
the JAX package's jitted ``apply`` too), ``global_shuffle_order`` and the
cached orders bit for bit, and three ``fit`` steps through
``DeviceAugmentIter`` against the JAX package's fused route within rtol
1e-5 / atol 1e-6, the tolerance of ``tests/test_torch_fused.py``.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import data as jdata
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.data import (CachedDataset, DeviceAugment,
                                  DeviceAugmentIter, DeviceLoader,
                                  TransformIter, fold_seed,
                                  global_shuffle_order)
from mxnet_tpu_torch.io import NDArrayIter
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

CPU = mx.cpu()
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
SPEC = dict(shape=(3, 8, 8), rand_crop=True, rand_mirror=True, pad=1,
            mean=(125.3, 123.0, 113.9), std=(51.6, 50.8, 51.3), scale=1.0,
            seed=3)


def _conv_net(pkg=mx, names=TNameManager):
    with names():
        s = pkg.sym
        n = s.Variable("data")
        n = s.Convolution(n, num_filter=4, kernel=(3, 3), pad=(1, 1),
                          name="c1")
        n = s.BatchNorm(n, name="bn", fix_gamma=False)
        n = s.Activation(n, act_type="relu")
        n = s.Pooling(n, kernel=(8, 8), pool_type="avg", name="pool")
        n = s.Flatten(n)
        n = s.FullyConnected(n, num_hidden=10, name="fc")
        return s.SoftmaxOutput(n, name="softmax")


def _data(n=36, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 8, 8, 3)).astype(np.uint8),
            rng.randint(0, 10, n).astype(np.float32))


def _spec(pkg=mx, **kw):
    args = dict(SPEC)
    args.update(kw)
    cls = DeviceAugment if pkg is mx else jdata.DeviceAugment
    return cls(**args)


def _src(Xu8, y, shuffle=False):
    return NDArrayIter(Xu8, y, batch_size=8, shuffle=shuffle)


def _fit(make_it, num_epoch=3, **fit_kw):
    mx.random.seed(42)
    np.random.seed(42)
    mod = mx.mod.Module(_conv_net(), context=CPU)
    it = make_it(mod)
    mod.fit(it, num_epoch=num_epoch, optimizer_params=OPT,
            initializer=mx.init.Uniform(0.07), **fit_kw)
    return mod, it


def _params(mod):
    a, x = mod.get_params()
    return {k: v.asnumpy() for k, v in list(a.items()) + list(x.items())}


def _assert_params_bit_equal(a, b, msg=""):
    pa, pb = _params(a), _params(b)
    assert sorted(pa) == sorted(pb)
    for n in pa:
        np.testing.assert_array_equal(pa[n], pb[n],
                                      err_msg="%s:%s" % (msg, n))


def _host(v):
    v = v._read() if hasattr(v, "_read") else v
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _collect_epoch(it):
    out = []
    while True:
        try:
            b = it.next()
        except StopIteration:
            return out
        out.append([_host(d) for d in b.data])


# ----------------------------------------------------------------------
# DeviceAugment: apply == apply_host, and both == the JAX package's
# ----------------------------------------------------------------------
CASES = [
    dict(rand_crop=False, rand_mirror=False, pad=0),
    dict(rand_crop=False, rand_mirror=True, pad=0),
    dict(rand_crop=True, rand_mirror=False, pad=1),
    dict(rand_crop=True, rand_mirror=True, pad=2),
    dict(rand_crop=True, rand_mirror=True, pad=0, in_shape=(12, 10)),
]
IDS = ["normalize", "mirror", "padcrop", "all", "cropdown"]


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_apply_matches_host_reference_elementwise(kw):
    spec = _spec(**kw)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (8,) + spec.wire_shape).astype(np.uint8)
    params = spec.draw("data", epoch=2, index=5, batch_size=8)
    crop = params.get("data.aug_crop")
    mirror = params.get("data.aug_mirror")
    for train in (True, False):
        dev = spec.apply(torch.from_numpy(x),
                         None if crop is None else torch.from_numpy(crop),
                         None if mirror is None else
                         torch.from_numpy(mirror), train=train)
        assert dev.dtype == torch.float32
        assert tuple(dev.shape) == spec.model_shape(8)
        np.testing.assert_array_equal(
            dev.numpy(), spec.apply_host(x, crop, mirror, train=train))


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_augment_bitwise_equal_jax(kw):
    """The draws, apply_host and the port's apply equal the JAX package's
    draws, apply_host and jitted apply bit for bit."""
    import jax
    mine, want = _spec(**kw), _spec(jmx, **kw)
    rng = np.random.RandomState(7)
    x = rng.randint(0, 256, (8,) + mine.wire_shape).astype(np.uint8)
    for epoch, index in ((0, 0), (2, 5), (9, 31)):
        pm = mine.draw("data", epoch, index, 8)
        pw = want.draw("data", epoch, index, 8)
        assert sorted(pm) == sorted(pw)
        for k in pm:
            np.testing.assert_array_equal(pm[k], pw[k])
        crop, mirror = pm.get("data.aug_crop"), pm.get("data.aug_mirror")
        host = mine.apply_host(x, crop, mirror)
        np.testing.assert_array_equal(host,
                                      want.apply_host(x, crop, mirror))
        jitted = np.asarray(jax.jit(
            lambda a, c, m: want.apply(a, c, m))(x, crop, mirror))
        np.testing.assert_array_equal(host, jitted)
        dev = mine.apply(torch.from_numpy(x),
                         None if crop is None else torch.from_numpy(crop),
                         None if mirror is None else
                         torch.from_numpy(mirror))
        np.testing.assert_array_equal(dev.numpy(), jitted)


def test_fold_seed_and_shuffle_order_equal_jax():
    for args in ((0, 0, 0), (3, 1, 7), (2 ** 40 + 5, 17, 123456)):
        assert fold_seed(*args) == jdata.fold_seed(*args)
    for seed, epoch in ((0, 1), (7, 3)):
        np.testing.assert_array_equal(
            global_shuffle_order(seed, epoch, 37),
            jdata.global_shuffle_order(seed, epoch, 37))


def test_model_view_passes_through():
    spec = _spec()
    x = np.random.RandomState(0).rand(4, 3, 8, 8).astype(np.float32)
    np.testing.assert_array_equal(spec.apply(torch.from_numpy(x)).numpy(), x)
    np.testing.assert_array_equal(spec.apply_host(x), x)
    with pytest.raises(MXNetError, match="larger"):
        DeviceAugment((3, 8, 8), in_shape=(4, 4))


def test_eval_variant_is_deterministic_center_crop():
    spec = _spec(pad=2)
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (4, 8, 8, 3)).astype(np.uint8)
    p1 = spec.draw("data", 0, 0, 4)
    p2 = spec.draw("data", 5, 7, 4)
    a = spec.apply_host(x, p1["data.aug_crop"], p1["data.aug_mirror"],
                        train=False)
    b = spec.apply_host(x, p2["data.aug_crop"], p2["data.aug_mirror"],
                        train=False)
    np.testing.assert_array_equal(a, b)


def test_draws_are_pure_functions_of_coordinates():
    spec = _spec()
    a = spec.draw("data", 3, 11, 8)
    b = spec.draw("data", 3, 11, 8)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    c = spec.draw("data", 3, 12, 8)
    assert any(not np.array_equal(a[k], c[k]) for k in a)


# ----------------------------------------------------------------------
# stream determinism
# ----------------------------------------------------------------------
def test_stream_bitwise_invariant_across_worker_counts():
    Xu8, y = _data()
    ref = None
    for workers in (1, 2, 4):
        it = TransformIter(DeviceAugmentIter(_src(Xu8, y), _spec()),
                           num_workers=workers)
        got = _collect_epoch(it)
        it.close()
        if ref is None:
            ref = got
            continue
        assert len(got) == len(ref)
        for ga, ra in zip(got, ref):
            for da, dr in zip(ga, ra):
                np.testing.assert_array_equal(da, dr)


def test_set_epoch_replays_the_uninterrupted_stream():
    Xu8, y = _data()
    it = DeviceAugmentIter(_src(Xu8, y), _spec())
    epochs = []
    for _ in range(3):
        epochs.append(_collect_epoch(it))
        it.reset()
    it2 = DeviceAugmentIter(_src(Xu8, y), _spec())
    it2.set_epoch(2)
    replay = _collect_epoch(it2)
    assert len(replay) == len(epochs[2])
    for ga, ra in zip(replay, epochs[2]):
        for da, dr in zip(ga, ra):
            np.testing.assert_array_equal(da, dr)
    assert any(not np.array_equal(a, b) for a, b in
               zip(epochs[0][0], epochs[1][0]))


def test_device_loader_epoch_rebase_replays_without_losing_batches():
    """The loader prefills at epoch 0; set_epoch(3) rewinds the source
    before pinning, so the rebased epoch is whole."""
    import time
    Xu8, y = _data()
    ref_it = DeviceAugmentIter(_src(Xu8, y), _spec())
    ref_it.set_epoch(3)
    ref = _collect_epoch(ref_it)
    loader = DeviceLoader(DeviceAugmentIter(_src(Xu8, y), _spec()),
                          depth=2, ctx=CPU)
    time.sleep(0.3)
    loader.set_epoch(3)
    got = _collect_epoch(loader)
    loader.close()
    assert len(got) == len(ref) == 5
    for ga, ra in zip(got, ref):
        for da, dr in zip(ga, ra):
            np.testing.assert_array_equal(da, dr)


def test_eval_iterator_identical_across_placements():
    Xu8, y = _data()
    spec = _spec(pad=2)
    dev = DeviceAugmentIter(_src(Xu8, y), spec, train=False)
    host = DeviceAugmentIter(_src(Xu8, y), spec, placement="host",
                             train=False)
    for bd, bh in zip(_collect_epoch(dev), _collect_epoch(host)):
        assert len(bd) == 1 and bd[0].dtype == np.uint8
        np.testing.assert_array_equal(
            spec.apply_host(bd[0], None, None, train=False), bh[0])


def test_augment_iter_refuses_wrong_wire_shape_and_placement():
    X = np.zeros((16, 3, 8, 8), np.float32)
    with pytest.raises(MXNetError, match="wire shape"):
        DeviceAugmentIter(NDArrayIter(X, np.zeros(16), batch_size=8),
                          _spec())
    Xu8, y = _data()
    with pytest.raises(MXNetError, match="placement"):
        DeviceAugmentIter(_src(Xu8, y), _spec(), placement="disk")


# ----------------------------------------------------------------------
# fit: placements and dataset modes, bit for bit
# ----------------------------------------------------------------------
def test_fit_device_placement_bit_equal_to_host_reference():
    Xu8, y = _data()
    dev, _ = _fit(lambda m: DeviceAugmentIter(_src(Xu8, y), _spec()))
    host, _ = _fit(lambda m: DeviceAugmentIter(_src(Xu8, y), _spec(),
                                               placement="host"))
    _assert_params_bit_equal(dev, host, "device-vs-host")
    assert dev._exec_group._device_augment
    assert not host._exec_group._device_augment
    assert [n for n, _ in dev.data_shapes] == \
        ["data", "data.aug_crop", "data.aug_mirror"]


def test_fit_cached_modes_bit_equal_to_streaming():
    Xu8, y = _data()
    stream, _ = _fit(lambda m: DeviceAugmentIter(_src(Xu8, y), _spec()))
    devc, itd = _fit(lambda m: CachedDataset(
        _src(Xu8, y), augment=_spec(), module=m, placement="device"))
    hostc, ith = _fit(lambda m: CachedDataset(
        _src(Xu8, y), augment=_spec(), module=m, placement="host"))
    _assert_params_bit_equal(stream, devc, "stream-vs-devcache")
    _assert_params_bit_equal(stream, hostc, "stream-vs-hostcache")
    assert itd.cache_info()["placement"] == "device"
    assert itd.cache_info()["tier"] == "hbm"
    assert itd.cache_info()["device"] == "cpu"
    assert ith.cache_info()["placement"] == "host"
    assert itd.cache_info()["rows"] == len(Xu8)


def test_fit_prefetch_bit_equal_to_streaming():
    Xu8, y = _data()
    plain, _ = _fit(lambda m: DeviceAugmentIter(_src(Xu8, y), _spec()))
    pre, _ = _fit(lambda m: DeviceAugmentIter(_src(Xu8, y), _spec()),
                  prefetch_to_device=2)
    _assert_params_bit_equal(plain, pre, "prefetch")


def test_fit_cache_composes_with_prefetch_and_batch_group():
    """Cache + prefetch + grouped steps against grouped streaming, and
    (the port's grouped step being K plain steps) against per-batch
    streaming too."""
    Xu8, y = _data()
    plain, _ = _fit(lambda m: DeviceAugmentIter(_src(Xu8, y), _spec()),
                    batch_group=2)
    comp, _ = _fit(lambda m: CachedDataset(
        _src(Xu8, y), augment=_spec(), module=m, placement="device"),
        prefetch_to_device=2, batch_group=2)
    _assert_params_bit_equal(plain, comp, "grouped-vs-composed")
    assert plain.grouped_train_engaged() and comp.grouped_train_engaged()
    per_batch, _ = _fit(lambda m: DeviceAugmentIter(_src(Xu8, y), _spec()))
    _assert_params_bit_equal(per_batch, comp, "per-batch-vs-composed")


def test_cache_budget_falls_back_to_host(caplog):
    Xu8, y = _data()
    with caplog.at_level(logging.INFO):
        mod, it = _fit(lambda m: CachedDataset(
            _src(Xu8, y), augment=_spec(), module=m, budget_mb=1e-6))
    assert it.cache_info()["placement"] == "host"
    msgs = [r.getMessage() for r in caplog.records]
    assert any("budget" in m for m in msgs)
    assert any("cached in host memory" in m for m in msgs)
    stream, _ = _fit(lambda m: DeviceAugmentIter(_src(Xu8, y), _spec()))
    _assert_params_bit_equal(stream, mod, "budget-fallback")


def test_cache_device_tier_logs_its_device(caplog, monkeypatch):
    monkeypatch.setenv("MXNET_DATA_CACHE_BUDGET_MB", "64")
    Xu8, y = _data()
    it = CachedDataset(_src(Xu8, y), augment=_spec(), ctx=CPU)
    with caplog.at_level(logging.INFO):
        _collect_epoch(it)
        it.reset()
    assert it.cache_info()["placement"] == "device"
    assert any("cached on cpu" in r.getMessage() for r in caplog.records)


def test_cache_placement_off_streams_forever():
    Xu8, y = _data()
    it = CachedDataset(_src(Xu8, y), augment=_spec(), placement="off")
    for _ in range(3):
        assert len(_collect_epoch(it)) == 5
        it.reset()
    assert it.cache_info()["placement"] is None


def test_cached_batches_bitwise_equal_host_vs_device():
    Xu8, y = _data()
    spec = _spec(rand_crop=False, rand_mirror=False, pad=0)
    streams = {}
    for placement in ("device", "host"):
        it = CachedDataset(_src(Xu8, y), augment=spec, placement=placement,
                           ctx=CPU)
        _collect_epoch(it)
        it.reset()
        streams[placement] = _collect_epoch(it)
    for ba, bb in zip(streams["device"], streams["host"]):
        np.testing.assert_array_equal(ba[0], bb[0])


def test_cached_orders_equal_jax():
    """A shuffled cache's epochs (capture order first, then
    global_shuffle_order) and their draws equal the JAX package's."""
    Xu8, y = _data()
    mine = CachedDataset(_src(Xu8, y), augment=_spec(), placement="host",
                         shuffle=True, seed=4)
    want = jdata.CachedDataset(jmx.io.NDArrayIter(Xu8, y, batch_size=8),
                               augment=_spec(jmx), placement="host",
                               shuffle=True, seed=4)
    for _ in range(3):
        a = _collect_epoch(mine)
        b = [[np.asarray(d) for d in batch.data] for batch in want]
        assert len(a) == len(b) == 5
        for x, z in zip(a, b):
            for u, v in zip(x, z):
                np.testing.assert_array_equal(u, v)
        mine.reset()
        want.reset()


def test_cached_dataset_refuses_extra_entries_and_bad_placement():
    Xu8, y = _data()
    two = NDArrayIter({"a": Xu8, "b": Xu8}, y, batch_size=8)
    with pytest.raises(MXNetError, match="ONE image"):
        CachedDataset(two)
    with pytest.raises(MXNetError, match="placement"):
        CachedDataset(_src(Xu8, y), placement="disk")


def test_pipeline_stats_record_u8_wire_and_placement():
    Xu8, y = _data()
    mx.random.seed(42)
    mod = mx.mod.Module(_conv_net(), context=CPU)
    mod.fit(DeviceAugmentIter(_src(Xu8, y), _spec()), num_epoch=1,
            prefetch_to_device=2, optimizer_params={"learning_rate": 0.1},
            initializer=mx.init.Uniform(0.07))
    with DeviceLoader(DeviceAugmentIter(_src(Xu8, y), _spec()),
                      module=mod, depth=2) as loader:
        list(loader)
        snap = loader.pipeline_stats.snapshot()
    assert snap["staged_dtype"] == "uint8"
    assert snap["augment_placement"] == "device"
    f32_equiv = 8 * 3 * 8 * 8 * 4
    assert 0 < snap["staged_bytes_per_batch"] < 0.45 * f32_equiv


# ----------------------------------------------------------------------
# Module(device_augment=)
# ----------------------------------------------------------------------
def test_module_device_augment_binds_and_refuses_classic():
    spec = _spec()
    descs = spec.data_descs("data", 8)
    mod = mx.mod.Module(_conv_net(), context=CPU,
                        device_augment={"data": spec})
    mod.bind(data_shapes=descs, label_shapes=[("softmax_label", (8,))])
    ex = mod._exec_group.execs[0]
    assert tuple(ex.arg_dict["data"].shape) == (8, 3, 8, 8)
    assert "data.aug_crop" not in ex.arg_dict
    with pytest.raises(ValueError, match="fused"):
        mx.mod.Module(_conv_net(), context=CPU, device_augment={
            "data": spec}, _allow_fused=False).bind(
                data_shapes=descs, label_shapes=[("softmax_label", (8,))])
    mod.init_params(mx.init.Uniform(0.07))
    with pytest.raises(MXNetError, match="device_augment"):
        mod.install_monitor(mx.monitor.Monitor(1))
    with pytest.raises(MXNetError, match="provides"):
        mx.mod.Module(_conv_net(), context=CPU, device_augment={
            "pixels": spec}).bind(data_shapes=descs,
                                  label_shapes=[("softmax_label", (8,))])


def test_augment_bound_module_scores_wire_and_model_view_batches():
    """An augment-bound module evaluates a u8 eval stream (center crop),
    a smaller u8 batch (re-bound at its size) and a float32 model-view
    batch, each equal to the host reference's forward."""
    Xu8, y = _data()
    spec = _spec(pad=2)
    mod, _ = _fit(lambda m: DeviceAugmentIter(_src(Xu8, y), spec),
                  num_epoch=1)
    val = DeviceAugmentIter(_src(Xu8, y), spec, train=False)
    host_val = DeviceAugmentIter(_src(Xu8, y), spec, placement="host",
                                 train=False)
    a = mod.score(val, "acc")
    b = mod.score(host_val, "acc")
    assert a == b
    x = Xu8[:5]
    mod.forward(mx.io.DataBatch([x], None), is_train=False)
    out_wire = mod.get_outputs()[0].asnumpy()[:5]
    ref = spec.apply_host(x, train=False)
    mod.forward(mx.io.DataBatch([ref], None), is_train=False)
    out_model = mod.get_outputs()[0].asnumpy()[:5]
    np.testing.assert_array_equal(out_wire, out_model)


def test_fit_steps_match_jax_fused_route():
    """Three steps through DeviceAugmentIter on the port against the JAX
    package's fused route with the same spec and numpy-seeded parameters:
    parameters and aux within rtol 1e-5 / atol 1e-6."""
    Xu8, y = _data(n=24)
    jsym, tsym = _conv_net(jmx, JNameManager), _conv_net()
    shapes = dict(zip(jsym.list_arguments(), jsym.infer_shape(
        data=(8, 3, 8, 8), softmax_label=(8,))[0]))
    rs = np.random.RandomState(3)
    args = {k: (0.3 * rs.randn(*v)).astype(np.float32)
            for k, v in shapes.items() if k not in ("data", "softmax_label")}
    aux = {"bn_moving_mean": np.zeros(4, np.float32),
           "bn_moving_var": np.ones(4, np.float32)}
    got = {}
    for pkg in (jmx, mx):
        spec = _spec(pkg)
        if pkg is mx:
            it = DeviceAugmentIter(NDArrayIter(Xu8, y, batch_size=8), spec)
            mod = mx.mod.Module(tsym, context=CPU,
                                device_augment={"data": spec})
        else:
            it = jdata.DeviceAugmentIter(
                jmx.io.NDArrayIter(Xu8, y, batch_size=8), spec)
            mod = jmx.mod.Module(jsym, context=jmx.cpu(),
                                 device_augment={"data": spec})
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        if pkg is mx:
            a, x = mx.convert.params_from_numpy(args, aux, CPU)
            mod.init_params(arg_params=a, aux_params=x)
        else:
            mod.init_params(
                arg_params={k: jmx.nd.array(v) for k, v in args.items()},
                aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
        a, x = mod.get_params()
        got[pkg.__name__] = {k: v.asnumpy() for k, v in
                             list(a.items()) + list(x.items())}
    want, mine = got["mxnet_tpu"], got["mxnet_tpu_torch"]
    assert sorted(want) == sorted(mine)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
