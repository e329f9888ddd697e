"""The PyTorch port's network serving plane (mxnet_tpu_torch.gateway) on
the CPU.

Against the JAX package: one set of parameters, trained by the JAX
package and carried into the port through ``convert.params_from_numpy``,
serves the same rows through a JAX ``Predictor`` and through the port's
``GatewayServer`` on ``mx.cpu()``, within relative L2 1e-5.

Within the port, the asserts of the JAX package's ``tests/test_gateway.py``:
the predict reply bit for bit with a direct ``Predictor`` call (float32
survives the JSON round trip exactly), a streamed generate byte for byte
the engine's own stream, 429 + Retry-After with a retry schedule that is
a pure function of the client's seed, 504 on an expired deadline and
the deadline carried into ``submit(timeout_ms=)``, ``/readyz`` flipping
to 503 while the request in flight completes, hedged predict deduped
server-side, the three ``gateway.*`` fault seams, a replica killed in
mid-stream re-routed by affinity onto the exact stream, and
``ReplicaPool.scale_to`` never landing a request on a closed replica.

Every server, pool and engine is closed by the ``own`` fixture's
finaliser, servers bind 127.0.0.1 on port 0, and no fault plan outlives
its test.
"""
import threading
import time
from concurrent.futures import Future
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.serving as jserving

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.autopilot import ReplicaPool
from mxnet_tpu_torch.gateway import (GatewayBusy, GatewayClient,
                                     GatewayError, GatewayServer,
                                     GatewayStreamError)
from mxnet_tpu_torch.serving import DynamicBatcher, Predictor
from mxnet_tpu_torch.serving.decode import DecodeEngine, LSTMCharLM
from mxnet_tpu_torch.serving.errors import RequestTimeout

torch.set_num_threads(2)

CPU = mx.cpu()
DIM = 6
VOCAB = 17
ROWS_REL = 1e-5      # served rows against the JAX package (ROADMAP C)


def _net(pkg):
    s = pkg.sym
    net = s.Variable("data")
    net = s.FullyConnected(net, num_hidden=16, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, DIM).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(obj):
    stop = getattr(obj, "shutdown", None) or getattr(obj, "close", None)
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
def carried():
    """A net trained by the JAX package, and the same parameters in the
    port's module (bound at batch 8 on the CPU)."""
    jmx.random.seed(7)
    jmod = jmx.mod.Module(_net(jmx), context=[jmx.cpu()])
    X, y = _data()
    jmod.fit(jmx.io.NDArrayIter(X, y, batch_size=8), num_epoch=1,
             optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    a, x = jmod.get_params()
    args = {k: v.asnumpy() for k, v in a.items()}
    aux = {k: v.asnumpy() for k, v in x.items()}
    mod = mx.mod.Module(_net(mx), context=CPU)
    mod.bind(data_shapes=[("data", (8, DIM))], for_training=False)
    targs, taux = mx.convert.params_from_numpy(args, aux, CPU)
    mod.init_params(arg_params=targs, aux_params=taux)
    return jmod, mod


@pytest.fixture(scope="module")
def predictor(carried):
    pred = Predictor(carried[1], max_batch_size=16)
    pred.warmup()
    yield pred
    pred.release()


@pytest.fixture(scope="module")
def model():
    return LSTMCharLM(vocab_size=VOCAB, num_hidden=16, num_embed=8)


@pytest.fixture(scope="module")
def params(model):
    return model.init_params(seed=3)


def _engine(own, model, params, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_prefill_len", 8)
    return own(DecodeEngine(model, params, context=CPU, **kw))


def _server(own, **kw):
    kw.setdefault("port", 0)
    return own(GatewayServer(host="127.0.0.1", **kw))


def _client(srv, **kw):
    return GatewayClient("127.0.0.1", srv.port, **kw)


def _thread(target, name):
    t = threading.Thread(target=target, name=name, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# stub backends (admission / lifecycle tests: no device work needed)
# ---------------------------------------------------------------------------
class _Echo(object):
    def __init__(self, delay=0.0):
        self.delay = delay
        self.calls = 0

    def predict(self, rows):
        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        return np.asarray(rows, dtype=np.float32) * 2.0


class _CaptureBatcher(object):
    def __init__(self):
        self.seen = {}

    def submit(self, data, timeout_ms=None, tenant=None):
        self.seen.update(timeout_ms=timeout_ms, tenant=tenant)
        f = Future()
        f.set_result(np.asarray(data, dtype=np.float32))
        return f


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def test_gateway_rows_match_jax_predictor(own, carried, predictor):
    jmod = carried[0]
    jpred = jserving.Predictor(jmod, max_batch_size=16)
    jpred.warmup()
    srv = _server(own, predict_backend=predictor)
    cli = _client(srv)
    for n in (1, 5, 8, 13):
        X, _ = _data(n, seed=20 + n)
        ref = np.asarray(jpred.predict(X))
        out = cli.predict(X)
        assert out.shape == ref.shape and out.dtype == np.float32
        assert _rel_l2(out, ref) <= ROWS_REL, n


def test_predict_rows_become_tensors_on_the_backend_device(predictor):
    rows = np.ones((3, DIM), np.float32)
    on = GatewayServer._on_device(predictor, rows, None)
    assert isinstance(on, torch.Tensor) and on.device == CPU.torch_device()
    assert predictor.device == torch.device("cpu")
    # a stub names no device: it takes the numpy rows
    assert GatewayServer._on_device(_Echo(), rows, None) is rows


def test_predict_through_batcher_tenant_routes_to_its_device(own,
                                                              predictor):
    bat = own(DynamicBatcher(predictor, max_wait_ms=2))
    srv = _server(own, predict_backend=bat)
    X, _ = _data(5, seed=31)
    out = _client(srv).predict(X)
    assert out.tobytes() == predictor.predict(X).tobytes()


# ---------------------------------------------------------------------------
# route parity within the port
# ---------------------------------------------------------------------------
def test_predict_http_bitwise(own, predictor):
    X, _ = _data(5, seed=11)
    ref = predictor.predict(X)
    srv = _server(own, predict_backend=predictor)
    out = _client(srv).predict(X)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert out.tobytes() == ref.tobytes()


def test_generate_stream_byte_identical(own, model, params):
    prompt = [1, 2, 3, 4, 5]
    eng = _engine(own, model, params)
    ref = eng.generate(prompt, max_new_tokens=12, seed=5, timeout=60)
    srv = _server(own, decode_backend=eng)
    toks = list(_client(srv).generate(prompt, max_new_tokens=12, seed=5))
    assert toks == ref
    # the raw wire bytes: one ASCII decimal token per line
    conn = HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        conn.request(
            "POST", "/v1/generate",
            b'{"prompt": [1, 2, 3, 4, 5], "max_new_tokens": 12,'
            b' "seed": 5}',
            {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200
        body = r.read()
    finally:
        conn.close()
    assert body == b"".join(b"%d\n" % t for t in ref)


# ---------------------------------------------------------------------------
# edge admission + retry determinism
# ---------------------------------------------------------------------------
def test_429_backpressure_and_deterministic_retry_schedule(own):
    srv = _server(own, predict_backend=_Echo(), max_inflight=0)
    X = np.ones((2, 3), np.float32)
    schedules = []
    for _ in range(2):
        sleeps = []
        cli = _client(srv, retries=3, backoff_s=0.05, seed=11,
                      sleep=sleeps.append)
        with pytest.raises(GatewayBusy) as ei:
            cli.predict(X)
        assert ei.value.retry_after == 1.0
        schedules.append(sleeps)
    assert len(schedules[0]) == 3
    assert schedules[0] == schedules[1]
    assert srv.stats()["rejected"] >= 8


def test_deadline_propagates_and_expired_deadline_is_504(own):
    cap = _CaptureBatcher()
    srv = _server(own, predict_backend=cap)
    cli = _client(srv, retries=0)
    X = np.ones((2, 3), np.float32)
    cli.predict(X, tenant="canary", deadline_ms=250.0)
    assert cap.seen == {"timeout_ms": 250.0, "tenant": "canary"}
    with pytest.raises(GatewayError) as ei:
        cli.predict(X, deadline_ms=-5.0)
    assert ei.value.status == 504


def test_decode_submit_timeout_ms_fails_future(own, model, params):
    eng = _engine(own, model, params, start=False)
    req = eng.submit([1, 2, 3], max_new_tokens=4, timeout_ms=1.0)
    time.sleep(0.05)
    eng.start()
    with pytest.raises(RequestTimeout):
        req.result(timeout=30)
    assert req.outcome == "timeout"
    assert eng.stats()["timeouts"] == 1


def test_decode_deadline_through_gateway(own, model, params):
    eng = _engine(own, model, params, start=False)
    srv = _server(own, decode_backend=eng)
    eng.start()
    toks = list(_client(srv).generate([1, 2, 3], max_new_tokens=4, seed=0,
                                      deadline_ms=5000.0))
    assert len(toks) == 4


def test_no_backend_and_unknown_route(own):
    with pytest.raises(ValueError):
        GatewayServer()
    srv = _server(own, predict_backend=_Echo())
    cli = _client(srv, retries=0)
    with pytest.raises(GatewayError) as ei:
        list(cli.generate([1, 2], max_new_tokens=2))
    assert ei.value.status == 503
    assert cli.stats()["requests"] == 0


# ---------------------------------------------------------------------------
# lifecycle: readiness + drain
# ---------------------------------------------------------------------------
def test_readyz_flips_during_drain_and_inflight_completes(own):
    stub = _Echo(delay=0.4)
    srv = _server(own, predict_backend=stub, drain_timeout_s=10)
    cli = _client(srv, retries=0)
    assert cli.healthy() and cli.ready()
    X = np.ones((1, 3), np.float32)
    res = {}
    t = _thread(lambda: res.update(out=cli.predict(X)), "gw-test-inflight")
    for _ in range(200):
        if srv.inflight() == 1:
            break
        time.sleep(0.005)
    assert srv.inflight() == 1
    dt = _thread(srv.drain, "gw-test-drain")
    for _ in range(200):
        if srv.draining:
            break
        time.sleep(0.005)
    assert srv.draining
    assert cli.healthy() and not cli.ready()     # 503 readiness
    dt.join(10)
    t.join(10)
    assert not dt.is_alive() and not t.is_alive()
    assert "out" in res                          # never dropped
    assert np.array_equal(res["out"], X * 2.0)
    with pytest.raises(GatewayError) as ei:      # post-drain: 503
        cli.predict(X)
    assert ei.value.status == 503


def test_ready_check_hook_holds_readiness(own):
    state = {"warm": False}
    srv = _server(own, predict_backend=_Echo(),
                  ready_check=lambda: state["warm"])
    cli = _client(srv)
    assert cli.healthy() and not cli.ready()
    state["warm"] = True
    assert cli.ready()


# ---------------------------------------------------------------------------
# hedging
# ---------------------------------------------------------------------------
def test_hedged_predict_dedupes_server_side(own):
    stub = _Echo(delay=0.3)
    srv = _server(own, predict_backend=stub)
    cli = _client(srv, hedge_ms=40.0, timeout=10)
    X = np.ones((2, 3), np.float32)
    out = cli.predict(X)
    assert np.array_equal(out, X * 2.0)
    srv.shutdown()
    assert stub.calls == 1            # the backend computed exactly once
    assert srv.hedge_dedup_hits == 1  # ... and the twin replayed


def test_hedge_from_env(monkeypatch, own):
    monkeypatch.setenv("MXNET_GATEWAY_HEDGE_MS", "25")
    assert GatewayClient("127.0.0.1", 1)._hedge_ms == 25.0
    monkeypatch.setenv("MXNET_GATEWAY_MAX_INFLIGHT", "3")
    monkeypatch.setenv("MXNET_GATEWAY_DRAIN_TIMEOUT_S", "7")
    srv = _server(own, predict_backend=_Echo())
    assert (srv.max_inflight, srv.drain_timeout_s) == (3, 7.0)


# ---------------------------------------------------------------------------
# chaos seams
# ---------------------------------------------------------------------------
def test_accept_flood_seam_heals_by_client_retry(own, armed):
    srv = _server(own, predict_backend=_Echo())
    armed.arm("gateway.accept:flood@nth=1", seed=5)
    cli = _client(srv, retries=2, backoff_s=0.001, sleep=lambda s: None)
    out = cli.predict(np.ones((1, 3), np.float32))
    assert out.shape == (1, 3)
    assert [i["site"] for i in armed.incidents()] == ["gateway.accept"]


def test_route_seam_error_maps_to_503(own, armed):
    srv = _server(own, predict_backend=_Echo())
    armed.arm("gateway.route:error@nth=1", seed=5)
    cli = _client(srv, retries=0)
    with pytest.raises(GatewayError) as ei:
        cli.predict(np.ones((1, 3), np.float32))
    assert ei.value.status == 503
    assert [i["site"] for i in armed.incidents()] == ["gateway.route"]


def test_stream_transient_seam_heals_with_exact_stream(own, armed, model,
                                                       params):
    prompt = [2, 4, 6]
    eng = _engine(own, model, params)
    ref = eng.generate(prompt, max_new_tokens=10, seed=3, timeout=60)
    srv = _server(own, decode_backend=eng)
    plan = armed.arm("gateway.stream:transient@nth=3", seed=9)
    toks = list(_client(srv).generate(prompt, max_new_tokens=10, seed=3))
    assert toks == ref   # replayed prefix skipped, stream exact
    assert plan.unfired() == []
    assert [i["site"] for i in plan.incidents()] == ["gateway.stream"]


def test_stream_terminal_error_is_loud_not_truncated(own, armed, model,
                                                     params):
    eng = _engine(own, model, params)
    srv = _server(own, decode_backend=eng)
    # error on every flush: the first attempt and the fallback both die
    armed.arm("gateway.stream:error@nth=1,count=0", seed=2)
    with pytest.raises(GatewayStreamError):
        list(_client(srv).generate([1, 2], max_new_tokens=6, seed=0))


def test_killed_replica_midstream_reroutes_exactly(own, armed, model,
                                                   params):
    prompt = [3, 1, 4, 1, 5]
    ref = _engine(own, model, params).generate(prompt, max_new_tokens=20,
                                               seed=9, timeout=60)
    # every decode step 20 ms late: the stream is still in flight on its
    # replica when the client holds 3 tokens (the CPU engine would
    # otherwise finish all 20 before the kill)
    armed.arm("serving.decode_step:delay@count=0,ms=20", seed=0)
    pool = own(ReplicaPool(
        lambda: DecodeEngine(model, params, slots=2, max_prefill_len=8,
                             context=CPU),
        min_replicas=2, max_replicas=2, warm=False))
    srv = _server(own, decode_backend=pool, drain_timeout_s=10)
    it = _client(srv).generate(prompt, max_new_tokens=20, seed=9)
    got = [next(it) for _ in range(3)]
    victim = max(pool.replicas, key=pool.outstanding)
    assert pool.outstanding(victim) == 1
    victim.shutdown(drain=False)   # the replica dies mid-stream
    got += list(it)
    assert got == ref   # the affinity re-route replayed exactly


def test_affinity_is_a_pure_function_of_seed_serial_and_id(own):
    from mxnet_tpu_torch.gateway import Router
    pool = own(ReplicaPool(_Echo, min_replicas=3, max_replicas=3,
                           warm=False))
    picks = []
    for seed in (0, 0, 1):
        r = Router(pool, seed=seed)
        with r.lease_decode("req-7") as rep:
            picks.append(r.serial(rep))
    assert picks[0] == picks[1]
    r = Router(pool, seed=0)
    with r.lease_decode("req-7", exclude={picks[0]}) as rep:
        assert r.serial(rep) != picks[0]


# ---------------------------------------------------------------------------
# ReplicaPool scale oscillation vs in-flight predict (regression)
# ---------------------------------------------------------------------------
class _FakeReplica(object):
    def __init__(self, violations):
        self._violations = violations
        self.closed = False

    def predict(self, data):
        if self.closed:
            self._violations.append("entered closed replica")
        time.sleep(0.002)
        if self.closed:
            self._violations.append("closed during predict")
        return data

    def shutdown(self, drain=True):
        self.closed = True

    def release(self):
        self.closed = True


def test_scale_to_oscillation_never_lands_on_closed_replica(own):
    violations, errors = [], []
    pool = own(ReplicaPool(lambda: _FakeReplica(violations),
                           min_replicas=1, max_replicas=3, warm=False))
    stop = threading.Event()

    def hammer():
        X = np.zeros((1,), np.float32)
        while not stop.is_set():
            try:
                pool.predict(X)
            except Exception as e:  # noqa: BLE001 - recorded, asserted
                errors.append(e)

    threads = [_thread(hammer, "gw-test-hammer-%d" % i) for i in range(4)]
    try:
        for i in range(40):
            pool.scale_to(3 if i % 2 else 1)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert violations == []
    assert errors == []


def test_rejections_of_large_bodies_carry_their_status(own):
    """A body far larger than the socket buffers still gets its 503 (the
    server reads it before answering) rather than a reset connection."""
    srv = _server(own, predict_backend=_Echo())
    cli = _client(srv, retries=0)
    X = np.ones((64, 4096), np.float32)      # ~6 MB of JSON
    assert cli.predict(X[:1]).shape == (1, 4096)
    srv.drain()
    with pytest.raises(GatewayError) as ei:
        cli.predict(X)
    assert ei.value.status == 503
    busy = _server(own, predict_backend=_Echo(), max_inflight=0)
    with pytest.raises(GatewayBusy):
        _client(busy, retries=0).predict(X)
