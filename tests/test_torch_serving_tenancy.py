"""Multi-model tenancy and SLO-driven admission in the PyTorch port
(mxnet_tpu_torch.serving), on the CPU: the assertions of
tests/test_serving_tenancy.py, run against the port.

* Several named Predictors serve behind ONE DynamicBatcher queue;
  requests route by tenant and each tenant's rows come back from ITS
  model (bit for bit against that model's ``Module.predict`` through a
  module bound at the bucket the rows were served in; coalescing picks
  the bucket).
* A burn-rate breach on one tenant sheds ONLY that tenant — submits
  raise :class:`TenantShed`, queued requests drop with their queue age
  traced, the co-hosted tenant keeps serving — and the tenant readmits
  itself once the bad events age out of its windows.
* Protected tenants (priority >= 1 / ``protected=True`` /
  ``MXNET_SERVE_TENANT_PROTECTED``) keep serving through their own
  breach; ``MXNET_SERVE_TENANT_SHED=0`` disables shedding.
* The worker serves the higher-priority backlog first; malformed
  configurations are refused; a closed batcher answers ServerClosed.

Every wait has a timeout and every batcher is shut down in ``finally``.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.name import NameManager
from mxnet_tpu_torch.serving import (DynamicBatcher, Predictor, QueueFull,
                                     ServerClosed, Tenant, TenantShed)

torch.set_num_threads(2)

DIM = 6
WAIT = 60


def _net(hidden):
    with NameManager():
        s = mx.sym
        net = s.Variable("data")
        net = s.FullyConnected(net, num_hidden=hidden, name="fc1")
        net = s.Activation(net, act_type="relu", name="relu1")
        net = s.FullyConnected(net, num_hidden=10, name="fc2")
        return s.SoftmaxOutput(net, name="softmax")


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, DIM).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


def _predictor(hidden, max_batch_size=8):
    """A warmed Predictor over a freshly fit model, and the model's
    ``Module.predict`` rows at each of the Predictor's buckets."""
    mx.random.seed(7)
    sym = _net(hidden)
    mod = mx.mod.Module(sym, context=mx.cpu())
    X, y = _data()
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), num_epoch=1,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    pred = Predictor(mod, max_batch_size=max_batch_size)
    pred.warmup()
    refs = {}
    for b in pred.buckets:
        m = mx.mod.Module(sym, context=mx.cpu())
        m.bind(data_shapes=[("data", (b, DIM))], for_training=False)
        m.set_params(*mod.get_params())
        refs[b] = m.predict(mx.io.NDArrayIter(X, None, batch_size=b)) \
            .asnumpy()
    return pred, X, refs


def _served(out, refs, lo=0):
    """Whether ``out`` are rows ``lo:lo+len(out)`` of the model, bit for
    bit, as a bucket that holds them computes them."""
    n = len(out)
    return any(np.array_equal(out, r[lo:lo + n])
               for b, r in refs.items() if b >= n)


@pytest.fixture(scope="module")
def two_models():
    pA, X, refA = _predictor(16)
    pB, _, refB = _predictor(24)
    return pA, refA, pB, refB, X


def _slo(name, **objectives):
    objectives.setdefault("error_rate", 1e-3)
    return mx.telemetry.SLOTracker(name, refresh_s=0.0, **objectives)


def _breach(tracker, n=50):
    """Drive the tracker into multi-window breach with real-time error
    events (both windows cover 'now')."""
    for _ in range(n):
        tracker.record(outcome="error")
    assert tracker.breached()


# ---------------------------------------------------------------------
# routing + per-tenant parity
# ---------------------------------------------------------------------
def test_tenants_route_to_their_own_model(two_models):
    pA, refA, pB, refB, X = two_models
    with DynamicBatcher(tenants={"a": pA, "b": pB},
                        max_wait_ms=2) as srv:
        assert srv.tenants() == ["a", "b"]
        before = srv.stats("a")["completed"], srv.stats("b")["completed"]
        errs = []

        def client(i):
            n = 1 + (i % 5)
            lo = (i * 3) % 40
            name, ref = (("a", refA) if i % 2 else ("b", refB))
            try:
                out = srv.predict(X[lo:lo + n], timeout=WAIT, tenant=name)
                if not _served(out, ref, lo):
                    errs.append("client %d got wrong tenant rows" % i)
            except Exception as e:  # noqa: BLE001 — collected
                errs.append("client %d: %r" % (i, e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs
        sa, sb = srv.stats("a"), srv.stats("b")
        assert sa["completed"] - before[0] == 12
        assert sb["completed"] - before[1] == 12
        # multi-tenant submit must name a tenant
        with pytest.raises(ValueError):
            srv.submit(X[:2])
        assert set(srv.stats()) == {"a", "b"}


def test_single_tenant_spelling_unchanged(two_models):
    pA, refA, _pB, _refB, X = two_models
    with DynamicBatcher(pA, max_queue=16) as srv:
        assert srv.tenants() == ["default"]
        out = srv.predict(X[:3], timeout=WAIT)
        assert _served(out, refA)
        assert srv.stats()["completed"] >= 1


# ---------------------------------------------------------------------
# SLO-driven admission: breach on one sheds only that tenant
# ---------------------------------------------------------------------
def test_breach_sheds_only_that_tenant(two_models):
    pA, refA, pB, refB, X = two_models
    sloA = _slo("torch_tenancy_a")
    sloB = _slo("torch_tenancy_b")
    srv = DynamicBatcher(tenants={
        "a": Tenant("a", pA, slo=sloA),
        "b": Tenant("b", pB, slo=sloB)})
    try:
        assert _served(srv.predict(X[:3], timeout=WAIT, tenant="a"), refA)
        sheds0 = srv.stats("a")["sheds"]
        sheds_b = srv.stats("b")["sheds"]
        _breach(sloA)
        assert srv.slo_breached("a") and not srv.slo_breached("b")
        assert srv.slo_breached()
        with pytest.raises(TenantShed):
            srv.submit(X[:2], tenant="a")
        assert srv.stats("a")["sheds"] == sheds0 + 1
        # the co-hosted tenant is untouched: serves, sheds nothing
        assert _served(srv.predict(X[:4], timeout=WAIT, tenant="b"), refB)
        assert srv.stats("b")["sheds"] == sheds_b
        # TenantShed is a QueueFull: generic backoff handlers catch it
        assert issubclass(TenantShed, QueueFull)
    finally:
        srv.shutdown()


def test_worker_side_shed_traces_queue_age(two_models):
    pA, _refA, _pB, _refB, X = two_models
    mx.telemetry.enable()
    srv = None
    try:
        slo = _slo("torch_tenancy_worker_shed")
        srv = DynamicBatcher(tenants={"a": Tenant("a", pA, slo=slo)},
                             start=False)
        sheds0 = srv.stats("a")["sheds"]
        fut = srv.submit(X[:2], tenant="a")   # admitted while healthy
        _breach(slo)                          # breach begins after
        srv.start()
        with pytest.raises(TenantShed):
            fut.result(timeout=WAIT)
        s = srv.stats("a")
        assert s["sheds"] == sheds0 + 1
        # the shed is attributable: a trace with outcome=shed carrying
        # the request's queue age, which also reached the latency
        # reservoir
        traces = pA._stats.request_traces()
        shed = [t for t in traces if t["outcome"] == "shed"]
        assert shed and shed[-1]["phases"]["queue_wait_ms"] > 0
        assert shed[-1]["bucket"] is None
        hists = mx.telemetry.registry().snapshot()["histograms"]
        name = "%s.phase_queue_wait_ms" % pA._stats.scope.prefix
        assert hists[name]["count"] >= 1
        assert hists["%s.shed_age_ms" % pA._stats.scope.prefix]["count"] >= 1
    finally:
        if srv is not None:
            srv.shutdown()
        mx.telemetry.disable()


def test_tenant_readmits_after_burn_decays(two_models):
    pA, refA, _pB, _refB, X = two_models
    # a short fast window so the breach decays within the test: bad
    # events age out -> burn 0 -> admission reopens
    slo = mx.telemetry.SLOTracker("torch_tenancy_readmit", error_rate=1e-3,
                                  fast_window_s=0.3, slow_window_s=0.3,
                                  refresh_s=0.0)
    srv = DynamicBatcher(tenants={"a": Tenant("a", pA, slo=slo)})
    try:
        _breach(slo, n=10)
        with pytest.raises(TenantShed):
            srv.submit(X[:2], tenant="a")
        time.sleep(0.4)           # the error burst ages out
        assert not slo.breached()
        out = srv.predict(X[:3], timeout=WAIT, tenant="a")
        assert _served(out, refA)
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------
# protection knobs
# ---------------------------------------------------------------------
def test_protected_tenant_serves_through_breach(two_models):
    pA, refA, _pB, _refB, X = two_models
    slo = _slo("torch_tenancy_protected")
    srv = DynamicBatcher(tenants={
        "prod": Tenant("prod", pA, slo=slo, priority=1)})
    try:
        sheds0 = srv.stats("prod")["sheds"]
        _breach(slo)
        assert srv.slo_breached("prod")   # breach reported...
        out = srv.predict(X[:3], timeout=WAIT, tenant="prod")
        assert _served(out, refA)   # ...but never shed
        assert srv.stats("prod")["sheds"] == sheds0
        assert Tenant("x", pA, protected=True).protected
        assert not Tenant("x", pA).protected
    finally:
        srv.shutdown()


def test_env_protected_and_master_switch(two_models, monkeypatch):
    pA, refA, _pB, _refB, X = two_models
    slo = _slo("torch_tenancy_env")
    _breach(slo)
    monkeypatch.setenv("MXNET_SERVE_TENANT_PROTECTED", "x, canary")
    srv = DynamicBatcher(tenants={
        "canary": Tenant("canary", pA, slo=slo)})
    try:
        assert srv.tenant("canary").protected
        assert _served(
            srv.predict(X[:2], timeout=WAIT, tenant="canary"), refA)
    finally:
        srv.shutdown()
    monkeypatch.delenv("MXNET_SERVE_TENANT_PROTECTED")
    monkeypatch.setenv("MXNET_SERVE_TENANT_SHED", "0")
    srv = DynamicBatcher(tenants={
        "canary": Tenant("canary", pA, slo=slo)})
    try:
        sheds0 = srv.stats("canary")["sheds"]
        assert not srv.tenant("canary").protected
        assert _served(
            srv.predict(X[:2], timeout=WAIT, tenant="canary"), refA)
        assert srv.stats("canary")["sheds"] == sheds0
    finally:
        srv.shutdown()


def test_priority_orders_service(two_models):
    """Both tenants have a backlog; the worker serves the
    higher-priority tenant's requests first."""
    pA, refA, pB, refB, X = two_models
    srv = DynamicBatcher(tenants={
        "low": Tenant("low", pA, priority=0),
        "high": Tenant("high", pB, priority=1)}, start=False)
    order = []
    futs = []
    try:
        for _ in range(3):
            f = srv.submit(X[:2], tenant="low")
            f.add_done_callback(lambda _f: order.append("low"))
            futs.append((f, refA))
            g = srv.submit(X[:2], tenant="high")
            g.add_done_callback(lambda _f: order.append("high"))
            futs.append((g, refB))
        srv.start()
        for f, ref in futs:
            assert _served(f.result(timeout=WAIT), ref)
    finally:
        srv.shutdown()
    assert order[:3] == ["high", "high", "high"], order


def test_tenant_validation(two_models):
    pA, _refA, pB, _refB, _X = two_models
    with pytest.raises(ValueError):
        DynamicBatcher(pA, tenants={"a": pB})   # both spellings
    with pytest.raises(ValueError):
        DynamicBatcher(tenants={"a": Tenant("b", pA)})  # name clash
    with pytest.raises(ValueError):
        # one Predictor under two tenants would merge their stats
        DynamicBatcher(tenants={"a": pA, "b": pA})
    with pytest.raises(TypeError):
        Tenant("a", "not a predictor")
    with pytest.raises(ValueError):
        Tenant("", pA)
    with pytest.raises(ValueError):
        DynamicBatcher()
    srv = DynamicBatcher(tenants={"a": pA}, start=False)
    try:
        with pytest.raises(ValueError):
            srv.submit(np.zeros((2, DIM), np.float32), tenant="nope")
    finally:
        srv.shutdown()


def test_runtime_tenant_changes(two_models):
    """add_tenant / replace_tenant / remove_tenant: a removed tenant's
    queued requests fail with ServerClosed, a replaced route serves
    through the new Predictor."""
    pA, refA, pB, refB, X = two_models
    srv = DynamicBatcher(tenants={"a": pA}, start=False)
    try:
        srv.add_tenant(Tenant("b", pB))
        assert srv.tenants() == ["a", "b"]
        with pytest.raises(ValueError):
            srv.add_tenant(Tenant("c", pA))     # shares a's Predictor
        queued = srv.submit(X[:2], tenant="b")
        srv.remove_tenant("b")
        with pytest.raises(ServerClosed):
            queued.result(timeout=WAIT)
        srv.replace_tenant("a", Tenant("a", pB))
        srv.start()
        assert _served(srv.predict(X[:2], timeout=WAIT), refB)
    finally:
        srv.shutdown()


def test_closed_batcher_answers_server_closed_not_shed(two_models):
    """A dead server answers ServerClosed (stop), never TenantShed (back
    off and retry), and does not touch the shed stats."""
    pA, _refA, _pB, _refB, X = two_models
    slo = _slo("torch_tenancy_closed")
    _breach(slo)
    srv = DynamicBatcher(tenants={"a": Tenant("a", pA, slo=slo)})
    srv.shutdown()
    sheds0 = srv.stats("a")["sheds"]
    with pytest.raises(ServerClosed):
        srv.submit(X[:2], tenant="a")
    assert srv.stats("a")["sheds"] == sheds0
