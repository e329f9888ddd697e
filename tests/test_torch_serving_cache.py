"""The PyTorch port's persistent serving compile cache
(mxnet_tpu_torch.serving.cache) and the serving fault seams, on the CPU.

The JAX package's ``tests/test_serving_cache.py`` is the spec: its
assertions are carried over here against the port (the reference's own
cache tests cannot serve as the oracle on the CPU). Held within the port,
bit for bit: a warm replica's rows against the cold replica's and the
eager Predictor's, with zero compiles and zero traces. Held against the
JAX package: rows of the port's cached path against the JAX package's
``Predictor.predict`` without a cache, from the same parameters (relative
L2 1e-5). Also: every key-mismatch path is a loud miss naming its field;
tampered, truncated and ``.tmp-*`` entries; the manifest digest and the
post-load parameter swap; two calibrations never share an entry; a net
``torch.export`` cannot trace raises naming its node; the build cache's
paths and ``nvcc`` counter; and the seven serving fault seams, each
firing as its plan says.
"""
import glob
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.serving as jserving

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.faults import InjectedFault
from mxnet_tpu_torch.kernels import build, rtc
from mxnet_tpu_torch.serving import (DynamicBatcher, Predictor, QueueFull,
                                     RequestAbandoned, WorkerCrashed)
from mxnet_tpu_torch.serving import cache as C
from mxnet_tpu_torch.serving.cache import (CacheMiss, ExecutableCache,
                                           cache_key)
from mxnet_tpu_torch.serving.decode import DecodeEngine, LSTMCharLM

torch.set_num_threads(2)

DIM = 6
CPU = mx.cpu()
WAIT = 60
ROWS_REL = 1e-5


def _net(pkg=mx, hidden=16):
    # every layer named: the params digest covers the symbol JSON
    s = pkg.sym
    net = s.Variable("data")
    net = s.FullyConnected(net, num_hidden=hidden, name="fc1")
    net = s.BatchNorm(net, name="bn", fix_gamma=False)
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, DIM).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


def _train_module(hidden=16, precision=None, seed=7, data_seed=0):
    mx.random.seed(seed)
    kwargs = {"precision": precision} if precision else {}
    mod = mx.mod.Module(_net(hidden=hidden), context=[CPU], **kwargs)
    X, y = _data(seed=data_seed)
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), num_epoch=1,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    return mod


@pytest.fixture(scope="module")
def trained():
    mod = _train_module()
    X, _ = _data()
    eager = Predictor(mod, max_batch_size=8)
    eager.warmup()
    ref = {n: eager.predict(X[:n]) for n in (1, 3, 5, 8, 13)}
    eager.release()
    return mod, X, ref


def _entries(cache_dir):
    return sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(cache_dir, "aot", "*.mxexec")))


def _one_entry(cache_dir):
    paths = sorted(glob.glob(os.path.join(cache_dir, "aot", "*.mxexec")))
    assert paths
    return paths[0]


# ---------------------------------------------------------------------
# warm start: zero compiles, zero traces, bitwise rows
# ---------------------------------------------------------------------
def test_cold_then_warm_bitwise_and_zero_compiles(tmp_path, trained):
    mod, X, ref = trained
    cache_dir = str(tmp_path / "cache")
    watch = mx.telemetry.compile_watch()

    cold = Predictor(mod, max_batch_size=8)
    retraces0, warm0 = watch.count, watch.warmup_compiles
    s1 = cold.warmup(cache_dir=cache_dir)
    assert s1["compiles"] == len(cold.buckets)
    assert s1["cache_misses"] == len(cold.buckets)
    assert s1["cache_hits"] == 0
    assert len(_entries(cache_dir)) == len(cold.buckets)
    # the traces are their own compile.* stream, never retraces
    assert watch.count == retraces0
    assert watch.warmup_compiles == warm0 + len(cold.buckets)
    cold_out = {n: cold.predict(X[:n]) for n in ref}
    for n, out in cold_out.items():
        assert np.array_equal(out, ref[n]), n

    warm = Predictor(mod, max_batch_size=8)
    retraces1, warmups1, traces1 = watch.count, watch.warmup_compiles, \
        C.traces
    s2 = warm.warmup(cache_dir=cache_dir)
    assert s2["compiles"] == 0
    assert s2["cache_hits"] == len(warm.buckets)
    assert s2["cache_misses"] == 0
    assert watch.count == retraces1
    assert watch.warmup_compiles == warmups1
    assert C.traces == traces1
    rep = warm.warmup_report()
    assert set(rep) == set(warm.buckets)
    assert all(r["source"] == "deserialized" for r in rep.values())
    for n, out in cold_out.items():
        assert np.array_equal(warm.predict(X[:n]), out), n
    for n in (2, 6, 11, 16):
        warm.predict(X[:n])
    assert warm.stats()["compiles"] == 0
    for p in (cold, warm):
        p.release()


def test_rows_match_jax_predictor(tmp_path, trained):
    """The cached path against the JAX package's cache-less Predictor on
    the same parameters (relative L2 1e-5: the two frameworks round
    matrix products differently)."""
    mod, X, _ = trained
    arg, aux = mod.get_params()
    jmod = jmx.mod.Module(_net(jmx), context=[jmx.cpu()])
    jmod.bind(data_shapes=[("data", (8, DIM))],
              label_shapes=[("softmax_label", (8,))], for_training=False)
    jmod.init_params(
        arg_params={k: jmx.nd.array(v.asnumpy()) for k, v in arg.items()},
        aux_params={k: jmx.nd.array(v.asnumpy()) for k, v in aux.items()})
    jpred = jserving.Predictor(jmod, max_batch_size=8)
    jpred.warmup()
    for cache_dir in (str(tmp_path), str(tmp_path)):   # cold, then warm
        pred = Predictor(mod, max_batch_size=8)
        pred.warmup(cache_dir=cache_dir)
        for n in (1, 3, 8, 13):
            got, want = pred.predict(X[:n]), jpred.predict(X[:n])
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= ROWS_REL, (n, rel)
        pred.release()


def test_rewarmup_after_eviction_recompiles(tmp_path, trained):
    import shutil
    mod, X, ref = trained
    cache_dir = str(tmp_path / "cache")
    Predictor(mod, max_batch_size=4).warmup(cache_dir=cache_dir)
    warm = Predictor(mod, max_batch_size=4)
    warm.warmup(cache_dir=cache_dir)
    assert all(r["source"] == "deserialized"
               for r in warm.warmup_report().values())
    shutil.rmtree(os.path.join(cache_dir, "aot"))
    s = warm.warmup(cache_dir=cache_dir)
    assert all(r["source"] == "compiled"
               for r in warm.warmup_report().values())
    assert s["cache_misses"] >= len(warm.buckets)
    assert len(_entries(cache_dir)) == len(warm.buckets)
    assert np.array_equal(warm.predict(X[:3]), ref[3])


def test_warmup_gauges_and_compile_scope_counters(tmp_path, trained):
    mod, _X, _ref = trained
    watch = mx.telemetry.compile_watch()
    hits0, misses0 = watch.cache_hits, watch.cache_misses
    cache_dir = str(tmp_path / "cache")
    pred = Predictor(mod, max_batch_size=4)
    s = pred.warmup(cache_dir=cache_dir)
    assert set(s["warmup_ms"]) == set(pred.buckets)
    assert all(ms > 0 for ms in s["warmup_ms"].values())
    gauges = mx.telemetry.registry().snapshot()["gauges"]
    scope = pred._stats.scope.prefix
    for b in pred.buckets:
        assert "%s.b%d.warmup_ms" % (scope, b) in gauges
    assert watch.cache_misses == misses0 + len(pred.buckets)
    warm = Predictor(mod, max_batch_size=4)
    warm.warmup(cache_dir=cache_dir)
    assert watch.cache_hits == hits0 + len(warm.buckets)
    counters = mx.telemetry.registry().snapshot()["counters"]
    assert counters.get("compile.cache_hits", 0) >= len(warm.buckets)


def test_classic_warmup_unchanged_without_cache_dir(trained, monkeypatch):
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    mod, X, ref = trained
    watch = mx.telemetry.compile_watch()
    retraces0, warm0 = watch.count, watch.warmup_compiles
    pred = Predictor(mod, max_batch_size=4)
    s = pred.warmup()
    assert s["compiles"] == len(pred.buckets)
    assert s["cache_hits"] == 0 and s["cache_misses"] == 0
    assert all(r["source"] == "eager"
               for r in pred.warmup_report().values())
    assert not pred._programs
    # the first forwards count as warmup compiles, never as retraces
    assert watch.warmup_compiles == warm0 + len(pred.buckets)
    assert watch.count == retraces0
    assert np.array_equal(pred.predict(X[:3]), ref[3])


# ---------------------------------------------------------------------
# key-mismatch refusals (the loud-fallback contract)
# ---------------------------------------------------------------------
def test_params_digest_drift_refuses_entries(tmp_path, trained, caplog):
    mod, _X, _ref = trained
    cache_dir = str(tmp_path / "cache")
    Predictor(mod, max_batch_size=4).warmup(cache_dir=cache_dir)
    n_before = len(_entries(cache_dir))
    other = _train_module(hidden=24)
    pred = Predictor(other, max_batch_size=4)
    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.serving"):
        s = pred.warmup(cache_dir=cache_dir)
    assert s["cache_hits"] == 0
    assert s["cache_misses"] == s["compiles"] == len(pred.buckets)
    assert len(_entries(cache_dir)) == n_before + len(pred.buckets)
    assert "params_digest" in caplog.text
    again = Predictor(other, max_batch_size=4)
    s2 = again.warmup(cache_dir=cache_dir)
    assert s2["cache_hits"] == len(again.buckets)
    assert s2["compiles"] == 0


def test_cross_precision_mode_refused(tmp_path, caplog):
    f32_mod = _train_module()
    cache_dir = str(tmp_path / "cache")
    Predictor(f32_mod, max_batch_size=4).warmup(cache_dir=cache_dir)
    bf16_mod = _train_module(precision="bf16")
    pred = Predictor(bf16_mod, max_batch_size=4)
    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.serving"):
        s = pred.warmup(cache_dir=cache_dir)
    assert s["cache_hits"] == 0
    assert s["cache_misses"] == len(pred.buckets)
    assert "precision_mode" in caplog.text
    s2 = Predictor(f32_mod, max_batch_size=4).warmup(cache_dir=cache_dir)
    assert s2["cache_hits"] == len(pred.buckets)


def test_backend_signature_mismatch_is_a_miss(tmp_path, trained):
    mod, _X, _ref = trained
    pred = Predictor(mod, max_batch_size=4)
    cache_dir = str(tmp_path / "cache")
    pred.warmup(cache_dir=cache_dir)
    store = ExecutableCache(os.path.join(cache_dir, "aot"))
    grp = pred._modules[pred.buckets[0]]._exec_group
    key = pred._bucket_cache_key(grp, pred.buckets[0])
    assert "platform=cpu" in key["backend_sig"]
    assert "torch=%s" % torch.__version__ in key["backend_sig"]
    store.load(key)  # the real key loads
    drifted = cache_key(key["params_digest"], key["precision_mode"],
                        key["bucket"], key["input_sig"],
                        key["backend_sig"] + ";torch=9.9.9")
    with pytest.raises(CacheMiss) as e:
        store.load(drifted)
    assert e.value.reason == "key-mismatch"
    assert "backend_sig" in e.value.detail


# ---------------------------------------------------------------------
# corrupt / truncated / .tmp-* entries
# ---------------------------------------------------------------------
def test_tampered_entry_recompiles_and_heals(tmp_path, trained, caplog):
    mod, X, ref = trained
    cache_dir = str(tmp_path / "cache")
    Predictor(mod, max_batch_size=4).warmup(cache_dir=cache_dir)
    path = _one_entry(cache_dir)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:      # flip a payload byte: crc fails
        f.write(blob[:-10] + bytes([blob[-10] ^ 0xFF]) + blob[-9:])
    pred = Predictor(mod, max_batch_size=4)
    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.serving"):
        s = pred.warmup(cache_dir=cache_dir)
    assert s["cache_misses"] == 1
    assert s["cache_hits"] == len(pred.buckets) - 1
    assert "crc32 mismatch" in caplog.text
    assert np.array_equal(pred.predict(X[:3]), ref[3])
    s2 = Predictor(mod, max_batch_size=4).warmup(cache_dir=cache_dir)
    assert s2["cache_hits"] == len(pred.buckets)


def test_truncated_entry_refused(tmp_path, trained):
    mod, _X, _ref = trained
    cache_dir = str(tmp_path / "cache")
    pred = Predictor(mod, max_batch_size=4)
    pred.warmup(cache_dir=cache_dir)
    path = _one_entry(cache_dir)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    store = ExecutableCache(os.path.join(cache_dir, "aot"))
    refused = 0
    for b in pred.buckets:
        key = pred._bucket_cache_key(pred._modules[b]._exec_group, b)
        try:
            store.load(key)
        except CacheMiss as e:
            assert e.reason == "corrupt", e
            assert "truncated" in e.detail
            refused += 1
    assert refused == 1
    s = Predictor(mod, max_batch_size=4).warmup(cache_dir=cache_dir)
    assert s["cache_misses"] == 1


def test_tmp_partials_never_loadable(tmp_path, trained):
    mod, _X, _ref = trained
    cache_dir = str(tmp_path / "cache")
    pred = Predictor(mod, max_batch_size=4)
    pred.warmup(cache_dir=cache_dir)
    aot = os.path.join(cache_dir, "aot")
    assert not glob.glob(os.path.join(aot, ".tmp-*"))
    path = _one_entry(cache_dir)
    os.rename(path, os.path.join(aot, ".tmp-%s-deadbeef"
                                 % os.path.basename(path)))
    store = ExecutableCache(aot)
    assert not any(n.startswith(".tmp-") for n in store.entries())
    missing = 0
    for b in pred.buckets:
        key = pred._bucket_cache_key(pred._modules[b]._exec_group, b)
        try:
            store.load(key)
        except CacheMiss as e:
            assert e.reason == "absent", e
            missing += 1
    assert missing == 1
    s = Predictor(mod, max_batch_size=4).warmup(cache_dir=cache_dir)
    assert s["cache_misses"] == 1
    assert s["cache_hits"] == len(pred.buckets) - 1
    store.sweep_partials()
    assert not glob.glob(os.path.join(aot, ".tmp-*"))


# ---------------------------------------------------------------------
# digest threading: checkpoint manifest <-> predictor
# ---------------------------------------------------------------------
def test_manifest_records_params_digest(tmp_path, trained):
    mod, X, ref = trained
    manager = mx.checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    mod.save_checkpoint(None, 1, manager=manager, async_save=False)
    extra = manager.step_metadata(1)
    pred = Predictor(mod, max_batch_size=4)
    assert extra["params_digest"] == pred.params_digest
    restored = Predictor.load(str(tmp_path / "ckpt"),
                              data_shapes=[("data", (8, DIM))],
                              max_batch_size=4, context=CPU)
    assert restored.params_digest == pred.params_digest
    restored.warmup(cache_dir=str(tmp_path / "cache"))
    assert np.array_equal(restored.predict(X[:3]), ref[3])
    # a manager object serves too, and a mismatching mode is refused
    again = Predictor.load(manager, data_shapes=[("data", (8, DIM))],
                           max_batch_size=4, context=CPU)
    again.warmup(cache_dir=str(tmp_path / "cache"))
    assert all(r["source"] == "deserialized"
               for r in again.warmup_report().values())
    assert np.array_equal(again.predict(X[:3]), ref[3])
    with pytest.raises(mx.MXNetError, match="precision mode"):
        Predictor.load(str(tmp_path / "ckpt"), precision="bf16",
                       data_shapes=[("data", (8, DIM))], context=CPU)


def test_post_load_param_swap_refused(tmp_path, trained):
    mod, _X, _ref = trained
    manager = mx.checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    mod.save_checkpoint(None, 1, manager=manager, async_save=False)
    loaded = mx.mod.Module.load(str(tmp_path / "ckpt"), context=[CPU])
    other = _train_module(hidden=24)
    arg, aux = other.get_params()
    loaded._arg_params, loaded._aux_params = arg, aux
    with pytest.raises(mx.MXNetError, match="params digest"):
        Predictor(loaded, data_shapes=[("data", (8, DIM))],
                  max_batch_size=4)


def test_cache_shared_across_checkpoints_of_one_architecture(
        tmp_path, trained):
    """Parameter VALUES are inputs of the program: two checkpoints of one
    architecture share entries, and each serves its own rows."""
    mod, _X, _ref = trained
    cache_dir = str(tmp_path / "cache")
    Predictor(mod, max_batch_size=4).warmup(cache_dir=cache_dir)
    retrained = _train_module(seed=11, data_seed=3)
    pred = Predictor(retrained, max_batch_size=4)
    s = pred.warmup(cache_dir=cache_dir)
    assert s["cache_hits"] == len(pred.buckets)
    assert s["compiles"] == 0
    X, _ = _data(seed=3)
    eager = Predictor(retrained, max_batch_size=4)
    eager.warmup()
    assert np.array_equal(pred.predict(X[:5]), eager.predict(X[:5]))
    assert not np.array_equal(pred.predict(X[:5]),
                              Predictor(mod, max_batch_size=4)
                              .predict(X[:5]))


# ---------------------------------------------------------------------
# what a trace freezes: calibrations, and nets it cannot capture
# ---------------------------------------------------------------------
def _quant_module(precision=None):
    from mxnet_tpu_torch import sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=10, name="fc2")
    m = mx.mod.Module(net, label_names=[], context=[CPU],
                      precision=precision)
    m.bind(data_shapes=[("data", (8, DIM))], for_training=False)
    rs = np.random.RandomState(3)
    args = {"fc1_weight": rs.randn(16, DIM), "fc1_bias": rs.randn(16),
            "fc2_weight": rs.randn(10, 16), "fc2_bias": rs.randn(10)}
    m.init_params(arg_params={k: mx.nd.array((v * 0.3).astype(np.float32),
                                             ctx=CPU)
                              for k, v in args.items()}, aux_params={})
    return m


def test_two_calibrations_never_share_an_entry(tmp_path):
    """The calibration's static scales become constants of the traced
    program, so the table's digest keys the entry: a predictor warmed
    from a second calibration of the same net serves its own scales."""
    from mxnet_tpu_torch.precision import quant
    xa = np.random.RandomState(1).randn(32, DIM).astype(np.float32)
    xb = (np.random.RandomState(2).randn(32, DIM) * 8).astype(np.float32)
    ta = quant.calibrate(_quant_module(), mx.io.NDArrayIter(
        xa, None, batch_size=8), num_batches=3)
    tb = quant.calibrate(_quant_module(), mx.io.NDArrayIter(
        xb, None, batch_size=8), num_batches=3)
    assert ta.digest() != tb.digest()
    cache_dir = str(tmp_path / "cache")
    pa = Predictor(_quant_module("int8_serve"), max_batch_size=8,
                   calibration=ta)
    pa.warmup(cache_dir=cache_dir)
    pb = Predictor(_quant_module("int8_serve"), max_batch_size=8,
                   calibration=tb)
    s = pb.warmup(cache_dir=cache_dir)
    assert s["cache_hits"] == 0 and s["cache_misses"] == len(pb.buckets)
    plain_b = Predictor(_quant_module("int8_serve"), max_batch_size=8,
                        calibration=tb)
    plain_b.warmup()
    x = xa[:8]
    assert not np.array_equal(pa.predict(x), pb.predict(x))
    assert np.array_equal(pb.predict(x), plain_b.predict(x))
    # each table's replica warm-starts from its own entries
    for table, want in ((ta, pa.predict(x)), (tb, pb.predict(x))):
        warm = Predictor(_quant_module("int8_serve"), max_batch_size=8,
                         calibration=table)
        s = warm.warmup(cache_dir=cache_dir)
        assert s["cache_hits"] == len(warm.buckets)
        assert np.array_equal(warm.predict(x), want)


def test_const_cache_never_keeps_a_trace_tensor():
    """A repair: ``precision.policy._const`` cached the fake tensor a
    trace made, so the next trace (or eager call) found it and failed."""
    from torch._subclasses.fake_tensor import is_fake
    from mxnet_tpu_torch.precision import policy
    policy._CONSTS.clear()
    ep = C.export_program(lambda x: [x * policy._const(3.5, x.device)],
                          (torch.ones(3),))
    assert not any(is_fake(t) for t in policy._CONSTS.values())
    assert torch.equal(ep.module()(torch.ones(3))[0], torch.full((3,), 3.5))
    assert torch.equal(policy._const(3.5, torch.device("cpu")),
                       torch.tensor(3.5))


def _custom_net():
    import mxnet_tpu_torch.operator as op_mod

    class Sqr(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0].asnumpy() ** 2)

    @op_mod.register("cache_test_sqr")
    class SqrProp(op_mod.CustomOpProp):
        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    s = mx.sym
    net = s.FullyConnected(s.Variable("data"), num_hidden=4, name="fc1")
    net = s.Custom(net, op_type="cache_test_sqr", name="sqr0")
    return s.FullyConnected(net, num_hidden=3, name="fc2")


def test_untraceable_net_raises_naming_the_node(tmp_path, monkeypatch):
    net = _custom_net()
    mod = mx.mod.Module(net, label_names=[], context=[CPU])
    mod.bind(data_shapes=[("data", (4, DIM))], for_training=False)
    mod.init_params(mx.init.Xavier())
    pred = Predictor(mod, max_batch_size=4)
    with pytest.raises(mx.MXNetError, match=r"'sqr0'.*A12"):
        pred.warmup(cache_dir=str(tmp_path))
    assert not _entries(str(tmp_path))
    # past the op table, the trace itself stops at the node and names it
    monkeypatch.setattr(C, "UNTRACEABLE_OPS", {})
    with pytest.raises(mx.MXNetError, match=r"at node 'sqr0'.*A12"):
        pred.warmup(cache_dir=str(tmp_path))
    pred.warmup()   # no cache: the eager path serves it
    assert pred.predict(np.ones((2, DIM), np.float32)).shape == (2, 3)


# ---------------------------------------------------------------------
# the process-wide build cache (layer 1): paths and the nvcc counter
# ---------------------------------------------------------------------
def test_build_cache_paths(tmp_path, monkeypatch):
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.setattr(build, "_ROOT", [None])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(mx.__file__)))
    assert build.library_path("x", "ab") == os.path.join(
        repo, "build", "cuda", "x", "libx-ab.so")
    assert rtc.rtc_dir("cd") == os.path.join(repo, "build", "rtc", "cd")
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert build.library_path("x", "ab") == str(
        tmp_path / "env" / "cuda" / "x" / "libx-ab.so")
    assert rtc.rtc_dir("cd") == str(tmp_path / "env" / "cuda" / "rtc" /
                                    "cd")
    assert C.enable_persistent_compile_cache(str(tmp_path / "api"))
    assert os.path.isdir(str(tmp_path / "api" / "cuda"))
    assert build.library_path("x", "ab") == str(
        tmp_path / "api" / "cuda" / "x" / "libx-ab.so")
    build.set_cache_root(None)
    assert build.cache_root() == str(tmp_path / "env")


def test_nvcc_runs_counted_once_per_library(tmp_path, monkeypatch):
    """``builds`` counts nvcc runs; a library on disk runs none (the
    second process's path). nvcc is stood in by a script here."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 1 ]; do\n"
                    "  if [ \"$1\" = -o ]; then out=$2; fi; shift\ndone\n"
                    "cp /bin/true \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda p: p)
    src = tmp_path / "k.cu"
    src.write_text("// kernel")
    lib = tmp_path / "cache" / "cuda" / "k" / "libk-1.so"
    n0 = build.builds
    assert build.nvcc_library(str(src), str(lib)) == str(lib)
    assert build.builds == n0 + 1 and lib.exists()
    build.nvcc_library(str(src), str(lib))
    assert build.builds == n0 + 1
    assert not list(lib.parent.glob("*.tmp"))


# ---------------------------------------------------------------------
# the serving fault seams: each fires as its plan says
# ---------------------------------------------------------------------
def _transcript(plan):
    return [(i["site"], i["kind"]) for i in plan.incidents()]


@pytest.fixture
def armed():
    yield
    faults.disarm()


def test_seam_table_lists_the_serving_seams():
    want = {"serving.worker": "check", "serving.device": "check",
            "serving.queue_flood": "fires", "serving.cache": "corrupt_file",
            "serving.decode_worker": "check", "serving.decode_step": "check",
            "serving.decode_abandon": "fires"}
    assert {k: v for k, v in faults.SITES.items()
            if k.startswith("serving.")} == want
    for site in want:
        assert "``%s``" % site in faults.__doc__


def test_serving_cache_seam_poisons_a_committed_entry(tmp_path, trained,
                                                      armed):
    mod, X, ref = trained
    cache_dir = str(tmp_path / "cache")
    plan = faults.arm("serving.cache:bitflip@nth=2", seed=5)
    Predictor(mod, max_batch_size=8).warmup(cache_dir=cache_dir)
    assert plan.unfired() == []
    assert _transcript(plan) == [("serving.cache", "bitflip")]
    assert plan.incidents()[0]["ctx"] == {"bucket": 4}
    faults.disarm()
    pred = Predictor(mod, max_batch_size=8)
    s = pred.warmup(cache_dir=cache_dir)
    assert s["cache_misses"] == 1 and s["cache_hits"] == 2
    assert pred.warmup_report()[4]["source"] == "compiled"
    assert np.array_equal(pred.predict(X[:3]), ref[3])


def test_serving_device_seam_delays_only(trained, armed):
    mod, X, ref = trained
    pred = Predictor(mod, max_batch_size=8)
    pred.warmup()
    plan = faults.arm("serving.device:delay@nth=2,ms=30", seed=1)
    slept = []
    plan.sleep = slept.append
    for n in (1, 3, 5):
        assert np.array_equal(pred.predict(X[:n]), ref[n])
    assert slept == [0.03] and plan.unfired() == []
    assert _transcript(plan) == [("serving.device", "delay")]
    assert plan.incidents()[0]["ctx"] == {"rows": 3}


def test_serving_worker_seam_crashes_and_restarts(trained, armed):
    mod, X, ref = trained
    pred = Predictor(mod, max_batch_size=8)
    pred.warmup()
    plan = faults.arm("serving.worker:error@nth=2", seed=1)
    srv = DynamicBatcher(pred, max_wait_ms=0)
    try:
        assert np.array_equal(srv.predict(X[:3], timeout=WAIT), ref[3])
        with pytest.raises(WorkerCrashed,
                           match="worker crashed while request") as e:
            srv.predict(X[:5], timeout=WAIT)
        assert isinstance(e.value.__cause__, InjectedFault)
        assert np.array_equal(srv.predict(X[:5], timeout=WAIT), ref[5])
    finally:
        srv.shutdown(drain=True)
    assert pred.stats()["worker_restarts"] == 1
    assert _transcript(plan) == [("serving.worker", "error")]
    assert plan.incidents()[0]["ctx"] == {"requests": 1, "rows": 5,
                                          "tenant": "default"}


def test_serving_queue_flood_seam_backpressures(trained, armed):
    mod, X, ref = trained
    pred = Predictor(mod, max_batch_size=8)
    pred.warmup()
    plan = faults.arm("serving.queue_flood:flood@nth=1", seed=1)
    srv = DynamicBatcher(pred, max_wait_ms=0)
    try:
        with pytest.raises(QueueFull):
            srv.predict(X[:3], timeout=WAIT)
        assert np.array_equal(srv.predict(X[:3], timeout=WAIT), ref[3])
    finally:
        srv.shutdown(drain=True)
    assert pred.stats()["rejected"] == 1
    assert _transcript(plan) == [("serving.queue_flood", "flood")]


VOCAB = 17


def _decode_engine(**kw):
    model = LSTMCharLM(vocab_size=VOCAB, num_hidden=16, num_embed=8)
    return DecodeEngine(model, model.init_params(seed=3), slots=4,
                        max_prefill_len=8, context=CPU, start=False, **kw)


def _decode_prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, VOCAB, size=rng.randint(2, 12)))
            for _ in range(n)]


def _decode(prompts, max_new, plan=None):
    eng = _decode_engine()
    eng.warmup()
    if plan is not None:
        plan = faults.arm(plan, seed=1)
    reqs = [eng.submit(p, max_new_tokens=max_new, seed=i)
            for i, p in enumerate(prompts)]
    eng.start()
    out = []
    for r in reqs:
        try:
            out.append(r.result(timeout=WAIT))
        except RequestAbandoned:
            out.append("abandoned")
    eng.shutdown(drain=True)
    st = eng.stats()
    eng.release()
    faults.disarm()
    return out, st, plan


def test_decode_worker_seam_restarts_and_streams_survive(armed):
    prompts = _decode_prompts(6, seed=9)
    ref, _, _ = _decode(prompts, 8)
    got, st, plan = _decode(prompts, 8, "serving.decode_worker:error@nth=3")
    assert got == ref
    assert st["worker_restarts"] == 1
    assert plan.unfired() == []
    assert _transcript(plan) == [("serving.decode_worker", "error")]


def test_decode_step_seam_delay_is_transparent(armed):
    prompts = _decode_prompts(4, seed=10)
    ref, _, _ = _decode(prompts, 6)
    got, _, plan = _decode(prompts, 6, "serving.decode_step:delay@nth=2,ms=5")
    assert got == ref
    assert _transcript(plan) == [("serving.decode_step", "delay")]
    assert plan.incidents()[0]["ctx"] == {"step": 1}


def test_decode_abandon_seam_resolves_the_oldest(armed):
    prompts = _decode_prompts(4, seed=11)
    ref, _, _ = _decode(prompts, 12)
    got, st, plan = _decode(prompts, 12,
                            "serving.decode_abandon:flood@nth=2")
    assert got.count("abandoned") == 1
    assert st["decode"]["abandoned"] == 1
    assert [g for g in got if g != "abandoned"] == \
        [r for r, g in zip(ref, got) if g != "abandoned"]
    assert _transcript(plan) == [("serving.decode_abandon", "flood")]


def test_classic_route_refuses_a_cache_dir(tmp_path):
    """The trace is of the fused route's eval forward: a module on the
    classic per-executor route refuses ``cache_dir=`` and serves without
    one."""
    mx.random.seed(7)
    mod = mx.mod.Module(_net(), context=[CPU], _allow_fused=False)
    mod.bind(data_shapes=[("data", (8, DIM))],
             label_shapes=[("softmax_label", (8,))], for_training=False)
    mod.init_params(mx.init.Xavier())
    pred = Predictor(mod, max_batch_size=4)
    with pytest.raises(mx.MXNetError, match="classic per-executor"):
        pred.warmup(cache_dir=str(tmp_path))
    pred.warmup()
    X, _ = _data()
    assert pred.predict(X[:3]).shape == (3, 10)
