"""The PyTorch port's fleet autopilot (mxnet_tpu_torch.autopilot) on the
CPU, held to the asserts of the JAX package's ``tests/test_autopilot.py``.

* The controller over stub sensors and actuators: a both-window breach
  scales out, cooldown freezes, sustained idle scales in, a failed
  actuator is recorded and the loop keeps ticking, the background loop
  runs only under ``MXNET_AUTOPILOT=1``, and every transcript replays.
* The ``autopilot.poll`` and ``autopilot.scale`` seams fire as planned
  and the unarmed process never evaluates a rule.
* ``ReplicaPool``: a scale-out under breach comes up warm from the
  executable cache (every bucket deserialized, zero compiles) and serves
  the first replica's rows bit for bit; a spin-up whose warmup raises
  never joins the pool.
* ``DynamicBatcher`` tenant lifecycle (add, remove, replace), whose JAX
  tests fail in the JAX package's own runs: the port gives the behaviour
  they assert.
* ``CanaryController``: a clean generation is promoted after its soak; a
  NaN-poisoned one is rolled back on its first probe, never re-admitted,
  and the stable route keeps serving its rows.
* ``PeerCheckpointStore``: ring layout (factor 2) survives any single
  host death and restores bit for bit against the disk manager and
  against the JAX package's store on the same arrays; two ring-adjacent
  deaths are unrestorable and the resume falls back to disk;
  ``ElasticTrainer(peer_store=)`` over a ``VirtualCluster`` and
  ``MXNET_AUTOPILOT_PEER_CKPT=1`` train and resume from peer memory.

Every pool, batcher and autopilot is closed by a fixture finaliser,
environment variables are set through ``monkeypatch`` only, and no
fault plan outlives its test.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu.autopilot as jautopilot

import mxnet_tpu_torch as mx
import mxnet_tpu_torch.symbol as sym
from mxnet_tpu_torch import autopilot, faults
from mxnet_tpu_torch.autopilot import (AutopilotConfig, CanaryController,
                                       PeerCheckpointStore, ReplicaPool,
                                       decide_canary, finite_probe, replay)
from mxnet_tpu_torch.serving import DynamicBatcher, Predictor, Tenant

torch.set_num_threads(2)

CPU = mx.cpu()
DIM = 6
WAIT = 30


def _net(hidden):
    net = sym.Variable("data")
    net = sym.FullyConnected(net, num_hidden=hidden, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, DIM).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


def _fit_module(hidden=16):
    mx.random.seed(7)
    mod = mx.mod.Module(_net(hidden), context=[CPU])
    X, y = _data()
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), num_epoch=1,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    return mod, X


def _close(obj):
    stop = getattr(obj, "shutdown", None) or getattr(obj, "close", None) \
        or getattr(obj, "stop", None)
    if stop is not None:
        stop()
    if hasattr(obj, "release"):
        obj.release()


@pytest.fixture
def own():
    """Registers what a test starts; the finaliser closes it, newest
    first, whatever the test's outcome."""
    held = []
    yield lambda obj: held.append(obj) or obj
    for obj in reversed(held):
        _close(obj)


@pytest.fixture
def armed():
    yield faults
    faults.disarm()


@pytest.fixture(scope="module")
def serving_ckpt(tmp_path_factory):
    """A trained module committed to a CheckpointManager (step 1) plus a
    warmed executable cache: the generation replicas and canaries load."""
    root = tmp_path_factory.mktemp("autopilot")
    mod, X = _fit_module()
    mgr = mx.checkpoint.CheckpointManager(str(root / "ckpt"))
    mod.save_checkpoint(None, 1, manager=mgr, async_save=False)
    cache = str(root / "cache")
    shapes = [("data", (8, DIM))]
    pred = Predictor.load(mgr, 1, data_shapes=shapes, context=CPU,
                          max_batch_size=8)
    pred.warmup(cache_dir=cache)   # populates the executable cache
    ref = pred.predict(X[:8])
    pred.release()
    return {"manager": mgr, "cache": cache, "shapes": shapes,
            "X": X, "ref": ref, "symbol": mod.symbol.tojson()}


def _load(c):
    return Predictor.load(c["manager"], 1, data_shapes=c["shapes"],
                          context=CPU, max_batch_size=8)


def _slo(name, **objectives):
    objectives.setdefault("error_rate", 1e-3)
    return mx.telemetry.SLOTracker(name, refresh_s=0.0, **objectives)


class _StubSLO(object):
    """A burn_state()-shaped sensor the controller tests script."""

    def __init__(self):
        self.breach = False
        self.epochs = 0
        self.n_fast = 0

    def burn_state(self, now=None):
        return {"breach": self.breach, "breach_epochs": self.epochs,
                "burn_fast": {}, "burn_slow": {},
                "n_fast": self.n_fast, "n_slow": self.n_fast,
                "n_events": self.n_fast}


class _StubPool(object):
    def __init__(self, size=1):
        self.size = size
        self.calls = []

    def scale_to(self, n):
        self.calls.append(int(n))
        self.size = int(n)


class _FakeReplica(object):
    released = False

    def predict(self, data, **kw):
        return np.asarray(data)

    def release(self):
        self.released = True


# =====================================================================
# the controller over stub sensors/actuators
# =====================================================================
def test_config_from_env(monkeypatch):
    monkeypatch.setenv("MXNET_AUTOPILOT_MIN_REPLICAS", "2")
    monkeypatch.setenv("MXNET_AUTOPILOT_MAX_REPLICAS", "5")
    monkeypatch.setenv("MXNET_AUTOPILOT_COOLDOWN_S", "10")
    cfg = AutopilotConfig.from_env(poll_interval_s=2.0)
    assert (cfg.min_replicas, cfg.max_replicas) == (2, 5)
    assert cfg.cooldown_ticks == 5       # ceil(10 s / 2 s a tick)
    monkeypatch.setenv("MXNET_AUTOPILOT_MAX_REPLICAS", "1")
    with pytest.raises(ValueError):
        AutopilotConfig.from_env()       # min 2 > max 1


def test_burn_state_feeds_the_controller():
    t = _slo("tap_burn", fast_window_s=0.3, slow_window_s=0.3)
    for _ in range(20):
        t.record(outcome="error")
    s = t.burn_state()
    assert set(s) == {"breach", "breach_epochs", "burn_fast",
                      "burn_slow", "n_fast", "n_slow", "n_events"}
    assert s["breach"] and s["breach_epochs"] == 1 and s["n_fast"] == 20


def test_autopilot_scale_out_cooldown_scale_in(own):
    slo, pool = _StubSLO(), _StubPool()
    ap = own(autopilot.Autopilot(
        config=AutopilotConfig(min_replicas=1, max_replicas=2,
                               cooldown_ticks=2, idle_ticks=2),
        slo=slo, pool=pool))
    slo.breach, slo.epochs, slo.n_fast = True, 1, 10
    ap.step(now=100.0)
    assert pool.calls == [2]             # breach -> scale out
    ap.step(now=101.0)                   # cooldown tick 1: frozen
    assert pool.calls == [2]
    assert ap.transcript[-1]["decision"]["reason"] == "cooldown"
    slo.breach, slo.n_fast = False, 0    # traffic stops
    for i in range(5):
        ap.step(now=102.0 + i)
    assert pool.calls == [2, 1]          # idle soak -> one scale-in
    assert ap.replay() == []
    # the port's transcript replays through the JAX package's kernel
    assert jautopilot.replay(jautopilot.AutopilotConfig(
        *ap.config), ap.transcript) == []


def test_autopilot_actuator_failure_is_recorded_not_fatal(own):
    class _Boom(_StubPool):
        def scale_to(self, n):
            raise RuntimeError("spin-up exploded")

    slo = _StubSLO()
    slo.breach, slo.n_fast = True, 5
    ap = own(autopilot.Autopilot(config=AutopilotConfig(cooldown_ticks=1),
                                 slo=slo, pool=_Boom()))
    entry = ap.step()[0]
    assert "spin-up exploded" in entry["actuate_error"]
    assert ap.replay() == []             # the DECISION still replays
    ap.step()                            # and the loop keeps ticking
    assert ap.transcript[-1]["decision"]["reason"] == "cooldown"


def test_background_loop_gated_by_env(monkeypatch, own):
    ap = own(autopilot.Autopilot(config=AutopilotConfig(),
                                 slo=_StubSLO(), pool=_StubPool()))
    monkeypatch.delenv("MXNET_AUTOPILOT", raising=False)
    assert not autopilot.enabled()
    assert ap.start() is None            # off: never self-actuates
    assert ap._thread is None
    monkeypatch.setenv("MXNET_AUTOPILOT", "1")
    ap2 = own(autopilot.Autopilot(
        config=AutopilotConfig(poll_interval_s=0.02),
        slo=_StubSLO(), pool=_StubPool()))
    assert ap2.start() is ap2
    deadline = time.time() + 5
    while not ap2.transcript and time.time() < deadline:
        time.sleep(0.02)
    thread = ap2._thread
    ap2.stop()
    assert not thread.is_alive()
    assert ap2.transcript and ap2.replay() == []


# =====================================================================
# fault seams
# =====================================================================
def test_poll_fault_skips_tick_and_transcribes(own, armed):
    armed.arm("autopilot.poll:error@nth=1", seed=3)
    slo, pool = _StubSLO(), _StubPool()
    slo.breach, slo.n_fast = True, 5
    ap = own(autopilot.Autopilot(config=AutopilotConfig(), slo=slo,
                                 pool=pool))
    entries = ap.step()
    assert entries[0]["plane"] == "poll" and "error" in entries[0]
    assert pool.calls == []              # the blinded tick never acted
    assert [i["site"] for i in armed.incidents()] == ["autopilot.poll"]
    ap.step()                            # the next poll works
    assert pool.calls == [2]
    assert ap.replay() == []             # poll entries are skipped


def test_poll_delay_fault_fires_without_skipping(own, armed):
    armed.arm("autopilot.poll:delay@nth=1,ms=1", seed=0)
    ap = own(autopilot.Autopilot(config=AutopilotConfig(),
                                 slo=_StubSLO(), pool=_StubPool()))
    entries = ap.step()
    assert entries[0]["plane"] == "scale"    # delayed, not skipped
    assert armed.incidents()[0]["kind"] == "delay"


def test_scale_fault_leaves_pool_at_previous_size(armed):
    def mk():
        raise AssertionError("factory must not run on a fired seam")

    armed.arm("autopilot.scale:error@nth=1", seed=0)
    snap0 = mx.telemetry.registry().snapshot()["counters"].get(
        "autopilot.scale_errors", 0)
    with pytest.raises(faults.FaultError):
        ReplicaPool(mk, min_replicas=1, max_replicas=2, warm=False)
    snap = mx.telemetry.registry().snapshot()["counters"]
    assert snap["autopilot.scale_errors"] == snap0 + 1


def test_scale_fault_through_controller_keeps_loop_alive(own, armed):
    built = []

    def mk():
        built.append(1)
        return _FakeReplica()

    pool = own(ReplicaPool(mk, min_replicas=1, max_replicas=2,
                           warm=False))
    slo = _StubSLO()
    slo.breach, slo.n_fast = True, 5
    ap = own(autopilot.Autopilot(config=AutopilotConfig(cooldown_ticks=1),
                                 slo=slo, pool=pool))
    armed.arm("autopilot.scale:error@nth=1", seed=0)
    entry = ap.step()[0]
    assert "actuate_error" in entry and pool.size == 1
    ap.step()                                     # cooldown
    entry = ap.step()[0]                          # the retry succeeds
    assert "actuate_error" not in entry and pool.size == 2
    assert built == [1, 1]


def test_unarmed_seams_are_noops(own):
    assert not faults.armed()
    pool = own(ReplicaPool(lambda: _FakeReplica(), min_replicas=1,
                           max_replicas=3, warm=False))
    assert pool.scale_to(3) == 3 and pool.scale_to(0) == 1  # clamped
    pool.close()
    assert faults.incidents() == []


def test_the_five_plane_seams_are_registered():
    want = {"autopilot.poll": "check", "autopilot.scale": "check",
            "gateway.accept": "fires", "gateway.route": "check",
            "gateway.stream": "check"}
    assert {k: faults.SITES[k] for k in want} == want
    for site in want:
        assert "``%s``" % site in faults.__doc__


# =====================================================================
# the replica pool: warm spin-up, no cold replica
# =====================================================================
def test_pool_scales_out_warm_and_bitwise(own, serving_ckpt):
    c = serving_ckpt
    slo = mx.telemetry.SLOTracker("tap_pool", error_rate=1e-3,
                                  fast_window_s=0.5, slow_window_s=0.5,
                                  refresh_s=0.0)
    pool = own(ReplicaPool(lambda: _load(c), min_replicas=1,
                           max_replicas=2, cache_dir=c["cache"]))
    ap = own(autopilot.Autopilot(
        config=AutopilotConfig(min_replicas=1, max_replicas=2,
                               cooldown_ticks=1, idle_ticks=2),
        slo=slo, pool=pool))
    for _ in range(50):
        slo.record(outcome="error")
    ap.step()
    assert pool.size == 2
    assert ap.transcript[-1]["decision"]["reason"] == "slo_breach"
    # the scaled-out replica came up WARM: every bucket's program loaded
    # from the executable cache, zero compiles
    rep = pool.replicas[-1]
    assert {r["source"] for r in rep.warmup_report().values()} \
        == {"deserialized"}
    assert rep.stats()["compiles"] == 0
    assert pool.spinup_reports[-1]["sources"] == ["deserialized"]
    a = pool.replicas[0].predict(c["X"][:8])
    b = rep.predict(c["X"][:8])
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(b), c["ref"])
    ap.step()                            # cooldown
    deadline = time.time() + 10
    while slo.burn_state()["n_fast"] > 0 and time.time() < deadline:
        time.sleep(0.1)                  # errors age out of the window
    for _ in range(4):
        ap.step()
    assert pool.size == 1
    assert ap.replay() == []


def test_pool_never_joins_a_replica_whose_warmup_failed(own):
    class _ColdReplica(object):
        released = False

        def warmup(self, cache_dir=None):
            raise RuntimeError("warmup failed")

        def release(self):
            self.released = True

    built = []

    def mk():
        built.append(_ColdReplica())
        return built[-1]

    pool = own(ReplicaPool(lambda: _FakeReplica(), min_replicas=1,
                           max_replicas=2))
    pool._factory = mk
    with pytest.raises(RuntimeError, match="warmup failed"):
        pool.scale_to(2)
    assert pool.size == 1 and built[0].released
    assert all(not isinstance(r, _ColdReplica) for r in pool.replicas)


def test_pool_lease_snapshot_and_serials(own):
    pool = own(ReplicaPool(lambda: _FakeReplica(), min_replicas=2,
                           max_replicas=2, warm=False))
    seen = []

    def pick(snap):
        seen.append([(o, s) for _r, o, s in snap])
        return snap[-1][0]

    with pool.lease(pick=pick) as rep:
        assert pool.outstanding(rep) == 1 and pool.outstanding() == 1
        assert pool.serial(rep) == 1
    assert seen == [[(0, 0), (0, 1)]]
    assert pool.outstanding() == 0
    with pytest.raises(RuntimeError, match="non-live"):
        with pool.lease(pick=lambda snap: object()):
            pass


# =====================================================================
# batcher tenant lifecycle (add/remove/replace)
# =====================================================================
@pytest.fixture(scope="module")
def two_preds(serving_ckpt):
    c = serving_ckpt
    pA, pB = _load(c), _load(c)
    pA.warmup(cache_dir=c["cache"])
    pB.warmup(cache_dir=c["cache"])
    yield pA, pB
    pA.release()
    pB.release()


def test_batcher_add_remove_tenant(own, two_preds, serving_ckpt):
    pA, pB = two_preds
    X, ref = serving_ckpt["X"], serving_ckpt["ref"]
    srv = own(DynamicBatcher(tenants={"stable": Tenant("stable", pA)},
                             max_wait_ms=2))
    # the single-tenant default route survives an added canary
    assert np.array_equal(srv.predict(X[:3], timeout=WAIT), ref[:3])
    srv.add_tenant(Tenant("canary", pB, priority=0))
    assert set(srv.tenants()) == {"canary", "stable"}
    out = srv.predict(X[:4], timeout=WAIT, tenant="canary")
    assert np.array_equal(out, ref[:4])
    with pytest.raises(ValueError):
        srv.add_tenant(Tenant("canary", pB))     # duplicate name
    with pytest.raises(ValueError):
        srv.add_tenant(Tenant("other", pA))      # shared Predictor
    srv.remove_tenant("canary")
    assert srv.tenants() == ["stable"]
    # back to one tenant: an un-named submit still routes
    assert np.array_equal(srv.predict(X[:2], timeout=WAIT), ref[:2])
    with pytest.raises(ValueError):
        srv.remove_tenant("canary")


def test_batcher_replace_tenant_swaps_route(own, two_preds, serving_ckpt):
    pA, pB = two_preds
    X, ref = serving_ckpt["X"], serving_ckpt["ref"]
    srv = own(DynamicBatcher(tenants={"stable": Tenant("stable", pA)},
                             max_wait_ms=2))
    old = srv.replace_tenant("stable", Tenant(
        "stable", pB, priority=1, protected=True))
    assert old.predictor is pA
    assert srv.tenant("stable").protected
    out = srv.predict(X[:3], timeout=WAIT, tenant="stable")
    assert np.array_equal(out, ref[:3])          # the new route serves
    with pytest.raises(ValueError):
        srv.replace_tenant("stable", Tenant("renamed", pA))


# =====================================================================
# continuous delivery: clean promotes, poisoned never does
# =====================================================================
def _commit_generation(c, step, poison=False):
    """Commit the trained params again as generation ``step``, NaN-
    poisoned if asked, with full serving metadata."""
    from mxnet_tpu_torch.checkpoint import params_digest
    mgr = c["manager"]
    base = mgr.restore(1)
    arrays = {k: np.array(np.asarray(v)) for k, v in base.params.items()}
    if poison:
        name = sorted(arrays)[0]
        arrays[name] = arrays[name].copy()
        arrays[name].reshape(-1)[0] = np.nan
    extra = dict(mgr.step_metadata(1))
    extra["epoch"] = step
    extra["params_digest"] = params_digest(c["symbol"], arrays)
    mgr.save(step, arrays, extra=extra, async_save=False)
    return step


def _drive_canary(ctrl, cfg, ticks):
    """Run the canary plane the way Autopilot.step does, standalone."""
    entries = []
    for tick in ticks:
        obs = ctrl.observe(tick=tick)
        decision = decide_canary(cfg, obs)
        ctrl.apply(decision, tick=tick)
        entries.append({"tick": tick, "plane": "canary", "obs": obs,
                        "decision": decision})
    return entries


def _stable_batcher(own, c):
    stable = _load(c)
    stable.warmup(cache_dir=c["cache"])
    srv = own(DynamicBatcher(tenants={"stable": Tenant(
        "stable", stable, priority=1, protected=True)}, max_wait_ms=2))
    own(_TenantReleaser(srv))
    return srv


class _TenantReleaser(object):
    """Releases whatever Predictor the stable route holds at teardown."""

    def __init__(self, srv):
        self.srv = srv

    def release(self):
        self.srv.tenant("stable").predictor.release()


def test_canary_promotes_clean_generation(own, serving_ckpt):
    c = serving_ckpt
    srv = _stable_batcher(own, c)
    step = _commit_generation(c, 2, poison=False)
    ctrl = CanaryController(c["manager"], srv, stable_step=1,
                            data_shapes=c["shapes"], cache_dir=c["cache"],
                            slo_factory=_slo, context=CPU)
    cfg = AutopilotConfig(canary_soak_ticks=2)
    entries = _drive_canary(ctrl, cfg, range(4))
    acts = [e["decision"]["action"] for e in entries]
    assert acts == ["admit", "hold", "promote", "hold"]
    assert ctrl.stable_step == step and ctrl.canary_step is None
    ten = srv.tenant("stable")
    assert ten.protected and ten.priority >= 1
    out = srv.predict(c["X"][:4], timeout=WAIT, tenant="stable")
    assert np.array_equal(out, c["ref"][:4])
    assert replay(cfg, entries) == []


def test_poisoned_canary_rolls_back_never_promotes(own, serving_ckpt):
    c = serving_ckpt
    srv = _stable_batcher(own, c)
    before = srv.predict(c["X"][:4], timeout=WAIT, tenant="stable")
    step = _commit_generation(c, 3, poison=True)
    ctrl = CanaryController(c["manager"], srv, stable_step=1,
                            data_shapes=c["shapes"], cache_dir=c["cache"],
                            context=CPU)
    cfg = AutopilotConfig(canary_soak_ticks=2)
    entries = _drive_canary(ctrl, cfg, range(4))
    acts = [e["decision"]["action"] for e in entries]
    # admitted once, the probe fails on the FIRST live poll, rolled back,
    # and the rejected generation is never re-admitted
    assert acts == ["admit", "rollback", "hold", "hold"]
    assert entries[1]["decision"]["reason"] == "probe_failed"
    assert ctrl.rejected_steps == [step]
    assert ctrl.stable_step == 1            # the protected route intact
    assert srv.tenants() == ["stable"]
    out = srv.predict(c["X"][:4], timeout=WAIT, tenant="stable")
    assert np.array_equal(out, c["ref"][:4])
    assert out.tobytes() == before.tobytes()
    assert np.isfinite(np.asarray(out)).all()
    assert replay(cfg, entries) == []


def test_finite_probe_flags_nonfinite_outputs():
    class _NaNPred(object):
        buckets = [2]
        _data_descs = [("data", (2, DIM))]

        def predict(self, feed):
            return np.full((2, 10), np.nan, np.float32)

    class _OkPred(_NaNPred):
        def predict(self, feed):
            return np.zeros((2, 10), np.float32)

    probe = finite_probe()
    assert probe(_OkPred()) is True
    assert probe(_NaNPred()) is False


def test_a_probe_that_raises_never_passes(own, serving_ckpt):
    class _Raises(object):
        buckets = [2]
        _data_descs = [("data", (2, DIM))]

        def predict(self, feed):
            raise RuntimeError("device lost")

    with pytest.raises(RuntimeError):
        finite_probe()(_Raises())
    c = serving_ckpt
    srv = _stable_batcher(own, c)
    ctrl = CanaryController(c["manager"], srv, stable_step=1,
                            probe=finite_probe(), context=CPU)
    assert ctrl._run_probe(_Raises()) is False


# =====================================================================
# peer-replicated in-memory checkpoints
# =====================================================================
def _arrays():
    rng = np.random.RandomState(11)
    return {"arg:w": rng.rand(8, 4).astype(np.float32),
            "arg:b": rng.rand(3).astype(np.float32),   # replicated
            "aux:s": np.float32(2.5).reshape(())}      # scalar


def test_peer_store_bitwise_roundtrip_and_single_death():
    store = PeerCheckpointStore(4)
    arrays = _arrays()
    store.capture(10, arrays, optimizer_state=b"opt-bytes",
                  extra={"epoch": 3, "nbatch": 7}, rng_state=None)
    store.drop_hosts([2])                # any SINGLE death survives
    assert store.restorable(10) and store.latest() == 10
    ck = store.restore()
    assert ck.step == 10 and ck.optimizer_state == b"opt-bytes"
    assert ck.extra == {"epoch": 3, "nbatch": 7}
    for name, ref in arrays.items():
        got = np.asarray(ck.params[name])
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref)


def test_peer_store_adjacent_deaths_lose_a_block():
    store = PeerCheckpointStore(4)
    store.capture(1, _arrays(), rng_state=None)
    store.drop_hosts([1, 2])             # block 1's holders are 1 and 2
    assert not store.restorable(1) and store.latest() is None
    with pytest.raises(KeyError):
        store.restore()
    store2 = PeerCheckpointStore(4)
    store2.capture(1, _arrays(), rng_state=None)
    store2.drop_hosts([0, 2])            # non-adjacent: every block lives
    assert store2.restorable(1)


def test_peer_store_keep_evicts_oldest():
    store = PeerCheckpointStore(2, keep=2)
    for step in (1, 2, 3):
        store.capture(step, _arrays(), rng_state=None)
    assert store.stats()["steps"] == [2, 3]
    assert not store.restorable(1) and store.latest() == 3


def test_peer_resume_decision_and_transcript():
    store = PeerCheckpointStore(3)
    store.capture(5, _arrays(), rng_state=None)
    assert store.resume_checkpoint(disk_step=5).step == 5
    # disk moved ahead of memory -> the peer copy is stale -> disk
    assert store.resume_checkpoint(disk_step=6) is None
    planes = [e["decision"]["action"] for e in store.transcript]
    assert planes == ["peer_restore", "disk_restore"]
    assert replay(AutopilotConfig(), store.transcript) == []


@pytest.mark.parametrize("n_hosts,dead", [(4, [2]), (4, [0, 2]), (3, [1]),
                                          (2, [0])])
def test_peer_store_matches_the_jax_store(n_hosts, dead):
    """The same arrays through both packages' stores: the same ring
    placement (bytes per host), the same survivors, the same restored
    arrays bit for bit."""
    rng = np.random.RandomState(n_hosts)
    arrays = {"arg:w": rng.rand(12, 5).astype(np.float32),
              "arg:v": rng.rand(7, 2).astype(np.float32),
              "aux:m": rng.rand(4).astype(np.float32)}
    ours, theirs = PeerCheckpointStore(n_hosts), \
        jautopilot.PeerCheckpointStore(n_hosts)
    for store in (ours, theirs):
        store.capture(3, arrays, optimizer_state=b"o", extra={"epoch": 1},
                      rng_state=None)
    assert ours.stats() == theirs.stats()
    ours.drop_hosts(dead)
    theirs.drop_hosts(dead)
    assert ours.restorable(3) == theirs.restorable(3)
    a, b = ours.restore(3), theirs.restore(3)
    for name in arrays:
        assert np.asarray(a.params[name]).tobytes() == \
            np.asarray(b.params[name]).tobytes()
    assert ours.stats() == theirs.stats()


def test_peer_store_matches_disk_restore_bitwise(tmp_path):
    """The peer path assembles the SAME Checkpoint the manager's disk
    path does, bit for bit."""
    mod, _X = _fit_module(hidden=8)
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path / "ck"))
    store = PeerCheckpointStore(2)
    arrays = mod._checkpoint_arrays()
    mgr.save(4, arrays, optimizer_state=mod._optimizer_state_bytes(),
             extra={"epoch": 1}, async_save=False)
    store.capture(4, arrays, optimizer_state=mod._optimizer_state_bytes(),
                  extra={"epoch": 1})
    disk = mgr.restore(4)
    store.drop_hosts([0])
    peer = store.restore(4)
    assert set(disk.params) == set(peer.params)
    for name in disk.params:
        assert np.array_equal(np.asarray(disk.params[name]),
                              np.asarray(peer.params[name])), name
    assert disk.optimizer_state == peer.optimizer_state
    assert peer.rng is not None


@pytest.fixture
def recorder():
    yield
    from mxnet_tpu_torch import telemetry
    telemetry.flight_recorder().disarm()
    telemetry.flight_recorder().pop_last_dump()


def test_elastic_trainer_env_creates_peer_store(monkeypatch, tmp_path,
                                                recorder):
    from mxnet_tpu_torch.dist import ElasticTrainer, VirtualCluster
    world = VirtualCluster(2, context=CPU)
    monkeypatch.setenv("MXNET_AUTOPILOT_PEER_CKPT", "1")
    tr = ElasticTrainer(world, lambda w: None, lambda w: None,
                        str(tmp_path / "a"))
    assert tr.peer_store is not None and tr.peer_store.n_hosts == 2
    monkeypatch.setenv("MXNET_AUTOPILOT_PEER_CKPT", "0")
    tr2 = ElasticTrainer(world, lambda w: None, lambda w: None,
                         str(tmp_path / "b"))
    assert tr2.peer_store is None


def _elastic_run(tmp_path, name, peer_store, dead):
    from mxnet_tpu_torch.dist import ElasticTrainer, VirtualCluster
    X, y = _data(n=256, seed=3)

    def mk_mod(world):
        net = sym.Variable("data")
        net = sym.FullyConnected(net, num_hidden=32, name="fc1")
        net = sym.Activation(net, act_type="relu")
        net = sym.FullyConnected(net, num_hidden=10, name="fc2")
        return mx.mod.Module(sym.SoftmaxOutput(net, name="softmax"),
                             context=world.contexts())

    def mk_data(world):
        return world.feed(mx.io.NDArrayIter(X, y, batch_size=32))

    mx.random.seed(3)
    np.random.seed(3)
    tr = ElasticTrainer(VirtualCluster(4, context=CPU), mk_mod, mk_data,
                        str(tmp_path / name), checkpoint_every_steps=4,
                        peer_store=peer_store)
    mod = tr.fit(num_epoch=3, inject_fault=(14, dead), optimizer="sgd",
                 optimizer_params={"learning_rate": 0.1},
                 initializer=mx.initializer.Xavier())
    tr.manager.wait_until_finished()
    return tr, mod


def _digest(mod):
    args, auxs = mod.get_params()
    return [args[k].asnumpy().tobytes() for k in sorted(args)]


def test_elastic_shrink_resumes_from_peer_memory(tmp_path, recorder):
    store = PeerCheckpointStore(4)
    # NON-ring-adjacent deaths (1, 3): every block keeps a holder, so the
    # resume comes from memory
    tr, mod = _elastic_run(tmp_path, "peer", store, (1, 3))
    done = [e for e in tr.transcript if e["event"] == "finished"]
    assert done and done[0]["resume_source"] == "peer"
    assert done[0]["resume_step"] == 12
    assert mod._optimizer.num_update == 24
    assert [e["decision"]["action"] for e in store.transcript] \
        == ["peer_restore"]
    assert replay(AutopilotConfig(), store.transcript) == []
    # the peer resume trains to the disk resume's parameters bit for bit
    tr_d, mod_d = _elastic_run(tmp_path, "disk", None, (1, 3))
    assert [e["resume_source"] for e in tr_d.transcript] == \
        ["disk", "disk"]
    assert _digest(mod) == _digest(mod_d)


def test_elastic_env_store_trains_and_restores(monkeypatch, tmp_path,
                                               recorder):
    """``MXNET_AUTOPILOT_PEER_CKPT=1`` alone: the trainer builds its
    store over the cluster's 4 hosts, captures every commit and resumes
    from peer memory."""
    monkeypatch.setenv("MXNET_AUTOPILOT_PEER_CKPT", "1")
    tr, mod = _elastic_run(tmp_path, "env", None, (0, 2))
    assert tr.peer_store is not None and tr.peer_store.n_hosts == 4
    done = [e for e in tr.transcript if e["event"] == "finished"]
    assert done and done[0]["resume_source"] == "peer"
    assert mod._optimizer.num_update == 24
    last = tr.peer_store.latest()
    peer, disk = tr.peer_store.restore(last), tr.manager.restore(last)
    for name in disk.params:
        assert np.asarray(peer.params[name]).tobytes() == \
            np.asarray(disk.params[name]).tobytes(), name
    assert peer.optimizer_state == disk.optimizer_state


def test_elastic_adjacent_deaths_fall_back_to_disk(tmp_path, recorder):
    store = PeerCheckpointStore(4)
    tr, mod = _elastic_run(tmp_path, "adj", store, (1, 2))
    done = [e for e in tr.transcript if e["event"] == "finished"]
    assert done and done[0]["resume_source"] == "disk"
    # the lost block leaves no restorable step in memory
    assert [e["decision"] for e in store.transcript] == [
        {"action": "disk_restore", "step": 12,
         "reason": "no_peer_snapshot"}]
    assert mod._optimizer.num_update == 24
