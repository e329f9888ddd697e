"""The PyTorch port's telemetry (mxnet_tpu_torch.telemetry) vs the JAX
package's (mxnet_tpu.telemetry), on the CPU.

Held against the JAX package on the same recorded values: the
registry's snapshot and tree, the Prometheus text, ``ServingStats``'
snapshot, and the ``SLOTracker``'s burn rates and breach verdicts on
synthetic event streams under a fixed clock (equal dicts: the arithmetic
is the same host code). Within the port: the registry is exact under
concurrent writers, the JSONL sink and the ``/metrics`` endpoint
round-trip it, disabled mode is a no-op, and the serving stack's request
traces, deadline-miss accounting and SLO records hold the reference's
assertions (tests/test_telemetry_slo.py).
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry as tel
from mxnet_tpu_torch.name import NameManager
from mxnet_tpu_torch.serving import DynamicBatcher, Predictor, RequestTimeout

torch.set_num_threads(2)

WAIT = 60


@pytest.fixture(autouse=True)
def _clean():
    tel.disable()
    tel.clear_trace()
    yield
    tel.disable()
    tel.clear_trace()


def _record_same(reg):
    """The same instrument traffic into either package's registry."""
    reg.counter("serving.0.requests").add(5)
    reg.counter("serving.0.clock_ms").add(2.5)
    reg.gauge("q.depth").set(3)
    reg.gauge("q.live").set_fn(lambda: 7)
    h = reg.histogram("lat.ms", buckets=(1.0, 10.0))
    for v in (0.5, 2.0, 99.0, 10.0):
        h.observe(v)
    d = reg.histogram("serving.0.latency_ms")
    for v in (0.3, 4.0, 4.0, 250.0, 7e3):
        d.observe(v)
    return reg


# ----------------------------------------------------------------------
# registry and exporters against the JAX package
# ----------------------------------------------------------------------
def test_registry_and_prometheus_match_jax():
    treg = _record_same(tel.MetricsRegistry())
    jreg = _record_same(jtel.MetricsRegistry())
    assert treg.snapshot() == jreg.snapshot()
    assert treg.tree() == jreg.tree()
    assert treg.snapshot(prefix="serving.0") == \
        jreg.snapshot(prefix="serving.0")
    assert tel.render_prometheus(treg) == jtel.render_prometheus(jreg)
    text = tel.render_prometheus(treg)
    assert "# TYPE mxtpu_serving_0_requests counter" in text
    assert 'mxtpu_lat_ms_bucket{le="1.0"} 1' in text
    assert 'mxtpu_lat_ms_bucket{le="10.0"} 3' in text
    assert 'mxtpu_lat_ms_bucket{le="+Inf"} 4' in text
    assert tel.DEFAULT_MS_BUCKETS == jtel.DEFAULT_MS_BUCKETS


def test_histogram_bucketing():
    h = tel.MetricsRegistry().histogram("h", buckets=(1.0, 5.0, 10.0))
    for v in (0.5, 1.0, 2.0, 5.0, 7.5, 100.0, 1e6):
        h.observe(v)
    v = h.value
    assert v["buckets"] == [1.0, 5.0, 10.0]
    assert v["counts"] == [2, 2, 1, 2]
    assert v["count"] == 7 and v["sum"] == pytest.approx(1000116.0)
    with pytest.raises(ValueError):
        tel.MetricsRegistry().histogram("e", buckets=())


def test_registry_types_scopes_and_drop():
    reg = tel.MetricsRegistry()
    reg.counter("a.b.c").add(3)
    reg.gauge("a.g").set_fn(lambda: 42)
    reg.gauge("a.dead").set_fn(lambda: 1 / 0)   # a dead probe reads 0
    assert reg.tree()["a"]["b"]["c"] == 3
    assert reg.tree()["a"]["g"] == 42 and reg.tree()["a"]["dead"] == 0
    with pytest.raises(TypeError):
        reg.gauge("a.b.c")
    s0, s1 = reg.unique_scope("fam"), reg.unique_scope("fam")
    assert (s0.prefix, s1.prefix) == ("fam.0", "fam.1")
    c = s0.counter("x")
    c.add()
    assert s0.snapshot()["counters"]["x"] == 1
    s0.release()
    assert "fam.0.x" not in reg.snapshot()["counters"]
    c.add()                                     # the object keeps working
    assert c.value == 2
    reg.reset()
    assert reg.snapshot()["counters"]["a.b.c"] == 0
    assert reg.snapshot()["gauges"]["a.g"] == 42   # live probes survive


def test_registry_concurrent_writers():
    reg = tel.MetricsRegistry()
    shared = reg.counter("t.shared")
    hist = reg.histogram("t.lat_ms", buckets=(1.0, 10.0))
    n_threads, n_iter = 8, 400

    def work(i):
        mine = reg.counter("t.worker.%d" % i)
        for k in range(n_iter):
            shared.add()
            mine.add(2)
            hist.observe(float(k % 20))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    snap = reg.snapshot()
    assert snap["counters"]["t.shared"] == n_threads * n_iter
    for i in range(n_threads):
        assert snap["counters"]["t.worker.%d" % i] == 2 * n_iter
    h = snap["histograms"]["t.lat_ms"]
    assert h["count"] == n_threads * n_iter == sum(h["counts"])


def test_metrics_endpoint_and_jsonl(tmp_path):
    reg = _record_same(tel.MetricsRegistry())
    with tel.MetricsServer(reg, port=0) as srv:
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            assert resp.status == 200
            assert resp.read().decode() == tel.render_prometheus(reg)
        health = srv.url.replace("/metrics", "/healthz")
        with urllib.request.urlopen(health, timeout=10) as resp:
            assert resp.read() == b"ok\n"
    path = str(tmp_path / "events.jsonl")
    tel.enable(jsonl=path)
    tel.registry().counter("t.jsonl_probe").add(7)
    tel.flush_metrics("unit test")
    tel.registry().counter("t.jsonl_probe").add(1)
    tel.flush_metrics()
    tel.disable()
    tel.flush_metrics()                    # no sink: swallowed
    lines = [json.loads(line) for line in open(path)]
    assert [ln["kind"] for ln in lines] == ["metrics", "metrics"]
    assert all("ts" in ln for ln in lines)
    assert lines[0]["metrics"]["counters"]["t.jsonl_probe"] == 7
    assert lines[1]["metrics"]["counters"]["t.jsonl_probe"] == 8
    assert lines[0]["reason"] == "unit test" and "reason" not in lines[1]


def test_spans_and_disabled_mode():
    assert not tel.enabled()
    assert tel.span("x") is tel.NOOP_SPAN
    with tel.span("x"):
        pass
    assert tel.trace_events() == []
    tel.enable()
    with tel.span("outer", k=1):
        with tel.span("inner"):
            pass
    evs = tel.trace_events()
    assert [e["name"] for e in evs] == ["inner", "outer"]
    assert all(e["ph"] == "X" and e["tid"] == threading.get_ident()
               for e in evs)
    inner, outer = evs
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1.0
    assert outer["args"] == {"k": 1}


def test_serving_stats_snapshot_matches_jax():
    def drive(stats_cls, registry_cls):
        s = stats_cls(latency_window=8,
                      scope=registry_cls().scope("serving.9"))
        s.note_request(3)
        s.note_compile()
        s.note_batch(4, 3)
        s.note_batch(8, 5, warmup=True)
        s.note_completed(2.0)
        s.note_completed(4.0)
        s.note_reject()
        s.note_timeout(12.0)
        s.note_shed(3.0)
        s.note_error()
        s.note_worker_restart()
        s.set_queue_probe(lambda: 6)
        return s.snapshot(), s.scope.snapshot()

    tsnap, tscope = drive(mx.serving.ServingStats, tel.MetricsRegistry)
    jsnap, jscope = drive(jserving.ServingStats, jtel.MetricsRegistry)
    assert tsnap == jsnap
    assert tscope == jscope
    assert tsnap["batch_fill"] == 0.75 and tsnap["bucket_hits"] == {4: 1}
    assert tsnap["latency_ms"]["count"] == 4


# ----------------------------------------------------------------------
# SLOTracker burn rates and breach against the JAX package
# ----------------------------------------------------------------------
def _both(**kw):
    return (tel.SLOTracker(registry=tel.MetricsRegistry(), **kw),
            jtel.SLOTracker(registry=jtel.MetricsRegistry(), **kw))


def test_slo_objective_parsing():
    reg = tel.MetricsRegistry()
    t = tel.SLOTracker(name="t", registry=reg, p99_ms=50.0,
                       error_rate=1e-3, availability=0.999)
    kinds = {o["key"]: o for o in t._objectives}
    assert kinds["p99_ms"]["budget"] == pytest.approx(0.01)
    assert kinds["error_rate"]["budget"] == pytest.approx(1e-3)
    assert kinds["availability"]["budget"] == pytest.approx(0.001)
    for bad in ({}, {"p0_ms": 1.0}, {"frobnicate": 1.0},
                {"availability": 1.5}, {"error_rate": 0.0}):
        with pytest.raises(ValueError):
            tel.SLOTracker(name="t2", registry=reg, **bad)
    with pytest.raises(ValueError):
        tel.SLOTracker(name="t3", registry=reg, error_rate=0.1,
                       fast_window_s=10, slow_window_s=5)
    with pytest.raises(ValueError):
        t.record(outcome="lost")


def test_slo_burn_rate_math_matches_jax():
    t, j = _both(name="m", error_rate=0.01, fast_window_s=60.0,
                 slow_window_s=600.0)
    t0 = 10_000.0
    for tr in (t, j):
        for i in range(200):
            tr.record(1.0, "ok", ts=t0 + i * 2.5)
        tr.record(outcome="error", ts=t0 + 495.0)
        tr.record(outcome="error", ts=t0 + 498.0)
    s = t.evaluate(now=t0 + 500.0)
    assert s == j.evaluate(now=t0 + 500.0)
    er = s["error_rate"]
    assert er["n_fast"] == 26 and er["bad_fast"] == 2
    assert er["burn_rate_fast"] == pytest.approx(2 / 26 / 0.01, abs=1e-3)
    assert er["n_slow"] == 202 and er["bad_slow"] == 2
    assert er["burn_rate_slow"] == pytest.approx(2 / 202 / 0.01, abs=1e-3)
    s2 = t.evaluate(now=t0 + 10_000.0)
    assert s2 == j.evaluate(now=t0 + 10_000.0)
    assert s2["error_rate"]["burn_rate_fast"] == 0.0
    assert s2["error_rate"]["breach"] is False


def test_slo_multiwindow_breach_matches_jax():
    """A short spike trips the fast window but not the slow one: no
    breach; a sustained burn trips both: breach, gauges published."""
    t, j = _both(name="w", error_rate=0.01, fast_window_s=60.0,
                 slow_window_s=1800.0)
    t0 = 50_000.0
    now = t0 + 1650.0
    for tr in (t, j):
        for i in range(3000):
            tr.record(1.0, "ok", ts=t0 + i * 0.55)
        for i in range(30):
            tr.record(outcome="error", ts=now - 30.0 + i)
    s = t.evaluate(now=now)
    assert s == j.evaluate(now=now)
    assert s["error_rate"]["burn_rate_fast"] > 1.0
    assert s["error_rate"]["burn_rate_slow"] < 1.0
    assert s["breach"] is False
    for tr in (t, j):
        for i in range(60):
            tr.record(outcome="error", ts=t0 + i * 27.0)
    s = t.evaluate(now=now)
    assert s == j.evaluate(now=now)
    assert s["error_rate"]["breach"] is True and s["breach"] is True
    assert t.breached(now=now) is True and t.breach_epochs == 1
    assert t.burn_state(now=now) == j.burn_state(now=now)
    g = t.scope.snapshot()["gauges"]
    assert g["error_rate.breach"] == 1 and g["breach"] == 1
    assert t.report(now=now) == j.report(now=now)


def test_slo_latency_objective_counts_misses():
    t, j = _both(name="l", p95_ms=10.0, fast_window_s=60.0,
                 slow_window_s=60.0)
    t0 = 1000.0
    for tr in (t, j):
        for i in range(90):
            tr.record(2.0, "ok", ts=t0 + i * 0.1)
        for i in range(6):
            tr.record(50.0, "ok", ts=t0 + 10 + i * 0.1)
        tr.record(outcome="timeout", ts=t0 + 12.0)
    s = t.evaluate(now=t0 + 13.0)
    assert s == j.evaluate(now=t0 + 13.0)
    lat = s["p95_ms"]
    assert lat["bad_fast"] == 7
    assert lat["burn_rate_fast"] == pytest.approx(7 / 97 / 0.05, abs=1e-2)
    assert lat["breach"] is True


# ----------------------------------------------------------------------
# request traces and SLO records through the port's serving stack
# ----------------------------------------------------------------------
def _mlp():
    with NameManager():
        s = mx.sym
        net = s.Variable("data")
        net = s.FullyConnected(net, num_hidden=16, name="fc1")
        net = s.Activation(net, act_type="relu")
        net = s.FullyConnected(net, num_hidden=10, name="fc2")
        return s.SoftmaxOutput(net, name="softmax")


@pytest.fixture(scope="module")
def served():
    rng = np.random.RandomState(1)
    X = rng.rand(64, 6).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.float32)
    mx.random.seed(3)
    mod = mx.mod.Module(_mlp(), context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=16), num_epoch=1,
            optimizer_params={"learning_rate": 0.1},
            initializer=mx.init.Uniform(0.07))
    pred = Predictor(mod, max_batch_size=8)
    pred.warmup()
    return pred, X


def test_timeout_age_reaches_p99(served):
    pred, X = served
    slo = tel.SLOTracker(name="to", registry=tel.MetricsRegistry(),
                         error_rate=0.01, availability=0.9)
    srv = DynamicBatcher(pred, max_queue=8, timeout_ms=20, start=False,
                         slo=slo)
    try:
        before = pred.stats()["latency_ms"]["count"]
        futs = [srv.submit(X[:2]) for _ in range(3)]
        time.sleep(0.12)            # expire in queue while worker is down
        srv.start()
        for f in futs:
            with pytest.raises(RequestTimeout):
                f.result(timeout=WAIT)
    finally:
        srv.shutdown()
    s = pred.stats()
    assert s["latency_ms"]["count"] == before + 3
    assert s["latency_ms"]["p99"] >= 100.0
    h = pred._stats.scope.snapshot()["histograms"]
    assert h["timeout_age_ms"]["count"] >= 3
    st = slo.evaluate()
    assert st["error_rate"]["bad_fast"] == 3
    assert st["availability"]["bad_fast"] == 3


def test_cancelled_expired_request_does_not_kill_worker(served):
    pred, X = served
    srv = DynamicBatcher(pred, max_queue=8, timeout_ms=10, start=False)
    try:
        fut = srv.submit(X[:2])
        assert fut.cancel()
        time.sleep(0.05)
        srv.start()
        assert srv.predict(X[:3], timeout=WAIT).shape == (3, 10)
    finally:
        srv.shutdown()


def test_request_trace_phase_sum(served):
    pred, X = served
    tel.enable()
    srv = DynamicBatcher(pred, max_queue=64, max_wait_ms=2)
    try:
        t0 = time.perf_counter()
        out = srv.predict(X[:3], timeout=WAIT)
        e2e_ms = (time.perf_counter() - t0) * 1000.0
    finally:
        srv.shutdown()
    assert out.shape == (3, 10)
    tr = pred._stats.request_traces()[-1]
    assert tr["outcome"] == "ok" and tr["rows"] == 3
    assert tr["bucket"] == 4 and tr["id"].startswith("r")
    phases = tr["phases"]
    assert set(phases) == {"queue_wait_ms", "coalesce_wait_ms", "pad_ms",
                           "device_ms", "resolve_ms"}
    assert tr["total_ms"] == pytest.approx(sum(phases.values()), abs=0.01)
    assert tr["total_ms"] <= e2e_ms + 1.0
    assert tr["total_ms"] >= phases["device_ms"] > 0.0
    h = pred._stats.scope.snapshot()["histograms"]
    assert h["b4.phase_device_ms"]["count"] >= 1
    assert h["b4.phase_queue_wait_ms"]["count"] >= 1
    evs = [e for e in tel.trace_events()
           if e["name"].startswith("serving.req.")]
    assert evs and all(e["ph"] == "X" for e in evs)
    assert any(e["args"]["id"] == tr["id"] for e in evs)
    assert any(e["name"] == "serving.launch" for e in tel.trace_events())


def test_request_trace_direct_predict_and_disabled(served):
    pred, X = served
    before = len(pred._stats.request_traces())
    pred.predict(X[:2])                         # telemetry off: nothing
    assert len(pred._stats.request_traces()) == before
    assert not tel.trace_events()
    tel.enable()
    pred.predict(X[:5])
    traces = pred._stats.request_traces()
    assert len(traces) == before + 1
    tr = traces[-1]
    assert tr["phases"]["queue_wait_ms"] == 0.0
    assert tr["phases"]["coalesce_wait_ms"] == 0.0
    assert tr["phases"]["device_ms"] > 0.0
    assert tr["bucket"] == 8 and tr["rows"] == 5


def test_slo_through_batcher_clean_traffic(served):
    pred, X = served
    slo = tel.SLOTracker(name="torch_srv_t", p99_ms=60_000.0,
                         error_rate=1e-3, availability=0.99)
    srv = DynamicBatcher(pred, max_queue=64, max_wait_ms=1, slo=slo)
    try:
        for i in range(6):
            srv.predict(X[i:i + 2], timeout=WAIT)
        assert srv.slo_breached() is False and srv.slo is slo
    finally:
        srv.shutdown()
    st = slo.evaluate()
    assert st["availability"]["n_fast"] >= 6
    assert st["availability"]["bad_fast"] == 0
    g = tel.registry().snapshot()["gauges"]
    assert g["slo.torch_srv_t.availability.budget_remaining"] == 1.0
    assert g["slo.torch_srv_t.breach"] == 0


def test_batcher_metrics_port_serves_serving_counters(served):
    pred, X = served
    srv = DynamicBatcher(pred, max_queue=8, metrics_port=0)
    try:
        srv.predict(X[:2], timeout=WAIT)
        with urllib.request.urlopen(srv.metrics_server.url,
                                    timeout=10) as resp:
            text = resp.read().decode()
    finally:
        srv.shutdown()
    assert srv.metrics_server is None
    name = "mxtpu_%s_completed" % pred._stats.scope.prefix.replace(".", "_")
    assert name in text
