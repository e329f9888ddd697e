"""GatewayServer — the HTTP front door of the serving plane (the port's
counterpart of ``mxnet_tpu/gateway/server.py``, the same routes, codes
and bytes on the wire).

Stdlib ``http.server`` threading model (the ``MetricsServer``
discipline: daemon ``ThreadingHTTPServer``, port 0 = ephemeral, clean
``shutdown``), speaking a deliberately small JSON protocol:

======================  =============================================
route                   behavior
======================  =============================================
``POST /v1/predict``    JSON rows -> Predictor / DynamicBatcher
                        (least-outstanding replica; per-tenant via
                        ``X-Tenant``); the rows become a tensor on
                        the backend's device (``gpu(0)`` unless it
                        was built on ``mx.cpu()``) before the call;
                        bitwise row parity with the in-process call
                        (float32 survives the JSON round trip
                        exactly)
``POST /v1/generate``   chunked token stream off ``DecodeEngine
                        .submit`` — one ASCII decimal token per
                        line, flushed as each token resolves, so
                        TTFT is observable at the client; session
                        affinity keeps a stream's slot state on one
                        replica, and a replica death mid-stream
                        re-routes and replays the deterministic
                        stream, skipping the tokens already sent
``GET /readyz``         drain-/warmup-aware readiness (503 while
                        draining or the ``ready_check`` hook says
                        not yet) — distinct from liveness
``GET /healthz``        liveness (200 while the process serves)
``GET /stats``          gateway counters as JSON
======================  =============================================

Edge admission converts backpressure into HTTP before the device
pays anything: ``QueueFull``/``TenantShed`` and an SLO burn breach
answer **429 + Retry-After**, an expired ``X-Deadline-Ms`` answers
**504**, drain answers **503** — and the deadline that survives
admission propagates into ``DynamicBatcher.submit(timeout_ms=)`` /
``DecodeEngine.submit(timeout_ms=)`` so the backends' SLO trackers
see the same budget the client holds.

Fault seams: ``gateway.accept`` (fires → synthetic 429 flood),
``gateway.route`` (check, inside replica selection) and
``gateway.stream`` (check, at token-flush time) wire the front door
into the chaos plane; unarmed, each costs one branch.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as onp
import torch

from .. import faults as _faults
from .. import telemetry
from ..base import MXNetError
from ..faults.plan import FaultError, TransientFault
from ..serving.errors import (QueueFull, RequestTimeout, ServerClosed,
                              TenantShed, WorkerCrashed)
from ..serving.stats import ServingStats
from ..telemetry.slo import SLOTracker
from .router import Router

__all__ = ["GatewayServer", "GATEWAY_TRACE_PHASES"]

logger = logging.getLogger("mxnet_tpu_torch.gateway")

# per-route phase decomposition (ServingStats trace ring):
# accept (parse+admission) -> route (lease) -> upstream (backend
# compute; a generate's full token wait) -> stream (chunk writes) ->
# resolve (serialize + final flush)
GATEWAY_TRACE_PHASES = ("accept_ms", "route_ms", "upstream_ms",
                        "stream_ms", "resolve_ms")

_IDEM_CAPACITY = 256


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return int(default)


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


class GatewayServer(object):
    """The network serving plane's front door.

    Parameters
    ----------
    predict_backend : optional
        ``Predictor``, ``DynamicBatcher``, or a ``ReplicaPool`` of
        either — serves ``/v1/predict``. At least one backend is
        required.
    decode_backend : optional
        ``DecodeEngine`` or a ``ReplicaPool`` of engines — serves
        ``/v1/generate``.
    host / port
        Bind address. ``port=None`` reads ``MXNET_GATEWAY_PORT``
        (default 0 = ephemeral; the bound port is ``self.port``).
    max_inflight : int
        Edge concurrency cap; requests beyond it answer 429
        (``MXNET_GATEWAY_MAX_INFLIGHT``, default 64).
    drain_timeout_s : float
        Longest :meth:`drain` waits for in-flight requests/streams
        (``MXNET_GATEWAY_DRAIN_TIMEOUT_S``, default 30).
    predict_slo_ms / ttft_slo_ms : float
        p95 objectives for the ``slo.gateway.predict`` /
        ``slo.gateway.ttft`` burn trackers (0 disables one).
    ready_check : callable, optional
        Extra ``() -> bool`` readiness probe (e.g. "warmup finished")
        folded into ``/readyz`` — the warmup-aware half of readiness.
    route_seed : int
        Seeds the decode-affinity rendezvous hash.
    start : bool
        Bind and serve at construction (default).
    """

    def __init__(self, predict_backend=None, decode_backend=None,
                 host="127.0.0.1", port=None, max_inflight=None,
                 drain_timeout_s=None, predict_slo_ms=0.0,
                 ttft_slo_ms=0.0, ready_check=None, route_seed=0,
                 logger_=None, start=True):
        if predict_backend is None and decode_backend is None:
            raise ValueError("gateway needs at least one backend")
        self._router_p = (None if predict_backend is None
                          else Router(predict_backend, seed=route_seed))
        self._router_d = (None if decode_backend is None
                          else Router(decode_backend, seed=route_seed))
        if port is None:
            port = _env_int("MXNET_GATEWAY_PORT", 0)
        if max_inflight is None:
            max_inflight = _env_int("MXNET_GATEWAY_MAX_INFLIGHT", 64)
        if drain_timeout_s is None:
            drain_timeout_s = _env_float(
                "MXNET_GATEWAY_DRAIN_TIMEOUT_S", 30.0)
        self._host = host
        self._port_arg = int(port)
        self.max_inflight = int(max_inflight)
        self.drain_timeout_s = float(drain_timeout_s)
        self._ready_check = ready_check
        self._logger = logger_ or logger
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight = 0
        self._draining = False
        self._closed = False
        self._stats = ServingStats(
            scope=telemetry.registry().unique_scope("gateway"),
            phases=GATEWAY_TRACE_PHASES)
        self.slo_predict = (SLOTracker(name="gateway.predict",
                                       p95_ms=float(predict_slo_ms))
                            if predict_slo_ms else None)
        self.slo_ttft = (SLOTracker(name="gateway.ttft",
                                    p95_ms=float(ttft_slo_ms))
                         if ttft_slo_ms else None)
        # hedged-predict dedupe: X-Idempotency-Key -> finished response
        # (bounded), plus in-progress events so the hedge twin waits
        # for the primary instead of re-invoking the backend
        self._idem_done = collections.OrderedDict()
        self._idem_pending = {}
        self.hedge_dedup_hits = 0
        self._httpd = None
        self._thread = None
        self.port = None
        if start:
            self.start()

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._httpd is not None:
            return self
        srv = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet; telemetry has it
                pass

            def do_GET(self):
                srv._handle_get(self)

            def do_POST(self):
                srv._handle_post(self)

        self._httpd = ThreadingHTTPServer(
            (self._host, self._port_arg), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mxtorch-gateway", daemon=True)
        self._thread.start()
        self._logger.info("gateway: serving on %s:%d",
                          self._host, self.port)
        return self

    def drain(self, timeout=None):
        """Stop accepting (readyz flips 503, new requests answer 503)
        and wait for in-flight requests AND streams to finish, bounded
        by ``drain_timeout_s``. Returns True when the gateway went
        idle inside the bound."""
        if timeout is None:
            timeout = self.drain_timeout_s
        deadline = time.monotonic() + float(timeout)
        with self._lock:
            self._draining = True
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._logger.warning(
                        "gateway: drain timed out with %d request(s) "
                        "in flight", self._inflight)
                    return False
                self._idle.wait(min(left, 0.5))
        return True

    def shutdown(self, drain=True, timeout=None):
        """Graceful stop: drain (unless ``drain=False``), then close
        the listener. Idempotent."""
        if self._closed:
            return
        if drain:
            self.drain(timeout=timeout)
        with self._lock:
            self._draining = True
            self._closed = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5)

    close = shutdown

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- introspection ----------------------------------------------------
    @property
    def draining(self):
        return self._draining

    def inflight(self):
        with self._lock:
            return self._inflight

    def ready(self):
        if self._draining or self._closed:
            return False
        if self._ready_check is not None and not self._ready_check():
            return False
        return True

    def stats(self):
        """Gateway-edge counters (JSON-safe)."""
        return {
            "inflight": self.inflight(),
            "draining": bool(self._draining),
            "requests": self._stats.requests,
            "completed": self._stats.completed,
            "rejected": self._stats.rejected,
            "timeouts": self._stats.timeouts,
            "errors": self._stats.errors,
            "hedge_dedup_hits": self.hedge_dedup_hits,
        }

    # -- HTTP plumbing ----------------------------------------------------
    @staticmethod
    def _send_json(h, status, obj, headers=()):
        body = (json.dumps(obj, sort_keys=True) + "\n").encode()
        h.send_response(status)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            h.send_header(k, v)
        h.end_headers()
        h.wfile.write(body)
        return body

    @staticmethod
    def _chunk(h, data):
        h.wfile.write(b"%x\r\n" % len(data))
        h.wfile.write(data)
        h.wfile.write(b"\r\n")
        h.wfile.flush()

    @staticmethod
    def _end_chunks(h):
        h.wfile.write(b"0\r\n\r\n")
        h.wfile.flush()

    @staticmethod
    def _status_for(e):
        if isinstance(e, (QueueFull, TenantShed)):
            return 429
        if isinstance(e, (RequestTimeout, TimeoutError)):
            return 504
        if isinstance(e, (ServerClosed, WorkerCrashed, FaultError,
                          RuntimeError)):
            return 503
        if isinstance(e, (ValueError, MXNetError)):
            return 400
        return 500

    def _reject(self, h, rid, status, msg, retry_after=None):
        headers = [("X-Request-Id", rid)]
        if retry_after is not None:
            headers.append(("Retry-After", str(retry_after)))
        if status == 429:
            self._stats.note_reject()
        elif status == 504:
            self._stats.note_timeout()
        elif status >= 500 and status != 503:
            self._stats.note_error()
        self._send_json(h, status, {"error": msg, "id": rid}, headers)

    # -- GET routes -------------------------------------------------------
    def _handle_get(self, h):
        if h.path == "/healthz":
            h.send_response(200)
            h.send_header("Content-Type", "text/plain")
            h.send_header("Content-Length", "3")
            h.end_headers()
            h.wfile.write(b"ok\n")
        elif h.path == "/readyz":
            if self.ready():
                h.send_response(200)
                h.send_header("Content-Type", "text/plain")
                h.send_header("Content-Length", "6")
                h.end_headers()
                h.wfile.write(b"ready\n")
            else:
                why = "draining" if (self._draining or self._closed) \
                    else "warming"
                self._send_json(h, 503, {"error": why})
        elif h.path == "/stats":
            self._send_json(h, 200, self.stats())
        else:
            self._send_json(h, 404, {"error": "no such route"})

    # -- edge admission ---------------------------------------------------
    def _admit(self, h, rid, route):
        """Runs the edge checks and bumps the in-flight count; returns
        an (ok, deadline_abs, deadline_ms) triple. On rejection the
        response has already been written and ok is False."""
        if _faults.armed() and _faults.fires("gateway.accept",
                                             route=route):
            # synthetic admission flood: the chaos plane's stand-in
            # for an edge under more traffic than the cap admits
            self._reject(h, rid, 429, "admission flood (injected)",
                         retry_after=1)
            return False, None, None
        deadline_ms = None
        raw = h.headers.get("X-Deadline-Ms")
        if raw is not None:
            try:
                deadline_ms = float(raw)
            except ValueError:
                self._reject(h, rid, 400, "bad X-Deadline-Ms %r" % raw)
                return False, None, None
            if deadline_ms <= 0:
                self._reject(h, rid, 504, "deadline already expired")
                return False, None, None
        with self._lock:
            if self._draining or self._closed:
                self._send_json(h, 503,
                                {"error": "draining", "id": rid},
                                [("X-Request-Id", rid)])
                return False, None, None
            if self._inflight >= self.max_inflight:
                pass  # rejected below, outside the lock
            else:
                self._inflight += 1
                deadline = (None if deadline_ms is None
                            else time.monotonic() + deadline_ms / 1e3)
                return True, deadline, deadline_ms
        self._reject(h, rid, 429,
                     "gateway at max_inflight=%d" % self.max_inflight,
                     retry_after=1)
        return False, None, None

    def _done(self):
        with self._lock:
            self._inflight -= 1
            self._idle.notify_all()

    @staticmethod
    def _edge_breached(router):
        for rep in getattr(router.pool, "replicas", []):
            fn = getattr(rep, "slo_breached", None)
            if fn is not None and fn():
                return True
        return False

    # -- POST routes ------------------------------------------------------
    def _handle_post(self, h):
        rid = self._stats.new_request_id()
        t0 = time.perf_counter()
        # the body is read before any answer, a rejection included: a
        # reply over an unread body resets the connection, and a client
        # still writing a large request (one 224² float32 row is ~3 MB
        # of JSON) would see a broken pipe instead of its status code
        raw = h.rfile.read(int(h.headers.get("Content-Length", 0)))
        if h.path == "/v1/predict":
            handler, router = self._predict, self._router_p
        elif h.path == "/v1/generate":
            handler, router = self._generate, self._router_d
        else:
            self._send_json(h, 404, {"error": "no such route"})
            return
        if router is None:
            self._reject(h, rid, 503,
                         "no backend mounted for %s" % h.path)
            return
        ok, deadline, deadline_ms = self._admit(
            h, rid, h.path.rsplit("/", 1)[-1])
        if not ok:
            return
        try:
            try:
                body = json.loads(raw or b"{}")
            except ValueError:
                self._reject(h, rid, 400, "request body is not JSON")
                return
            self._stats.note_request()
            handler(h, rid, router, body, t0, deadline, deadline_ms)
        except (ConnectionError, BrokenPipeError):
            # client went away mid-response; the request was served as
            # far as the socket allowed — never silently re-raised
            # into the handler thread's lap
            self._stats.note_error()
        finally:
            self._done()

    # -- /v1/predict ------------------------------------------------------
    def _predict(self, h, rid, router, body, t0, deadline, deadline_ms):
        tenant = h.headers.get("X-Tenant")
        idem = h.headers.get("X-Idempotency-Key")
        if idem:
            replay = self._idem_wait(idem, deadline)
            if replay is not None:
                status, payload = replay
                with self._lock:
                    self.hedge_dedup_hits += 1
                self._send_json(h, status, payload,
                                [("X-Request-Id", rid),
                                 ("X-Hedge-Dedup", "1")])
                return
        t_accept = time.perf_counter()
        status, payload = 500, {"error": "unreachable"}
        try:
            if self._edge_breached(router):
                if self.slo_predict is not None:
                    self.slo_predict.record(outcome="reject")
                self._reject(h, rid, 429,
                             "SLO burn in breach — shed at the edge",
                             retry_after=1)
                status, payload = 429, None
                return
            try:
                rows = onp.asarray(body.get("rows"), dtype=onp.float32)
            except (TypeError, ValueError):
                self._reject(h, rid, 400, "rows must be a numeric "
                                          "array")
                status, payload = 400, None
                return
            try:
                with router.lease_predict() as rep:
                    t_route = time.perf_counter()
                    out = self._call_predict(rep, rows, tenant,
                                             deadline_ms, deadline)
                t_up = time.perf_counter()
            except BaseException as e:  # noqa: BLE001 - edge maps it
                status = self._status_for(e)
                if status == 429 and self.slo_predict is not None:
                    self.slo_predict.record(outcome="reject")
                elif status == 504 and self.slo_predict is not None:
                    self.slo_predict.record(outcome="timeout")
                elif self.slo_predict is not None:
                    self.slo_predict.record(outcome="error")
                self._reject(h, rid, status, "%s: %s"
                             % (type(e).__name__, e),
                             retry_after=1 if status == 429 else None)
                payload = None
                return
            outs = out if isinstance(out, (list, tuple)) else [out]
            payload = {
                "id": rid,
                "outputs": [onp.asarray(o).tolist() for o in outs],
                "dtypes": [str(onp.asarray(o).dtype) for o in outs],
                "single": not isinstance(out, (list, tuple)),
            }
            status = 200
            self._send_json(h, 200, payload, [("X-Request-Id", rid)])
            lat = (time.perf_counter() - t0) * 1000.0
            self._stats.note_completed(lat)
            if self.slo_predict is not None:
                self.slo_predict.record(lat, "ok")
            if telemetry.enabled():
                now = time.perf_counter()
                self._stats.note_trace(
                    rid, rows=int(rows.shape[0]) if rows.ndim else 1,
                    bucket=0,
                    phases={
                        "accept_ms": (t_accept - t0) * 1e3,
                        "route_ms": (t_route - t_accept) * 1e3,
                        "upstream_ms": (t_up - t_route) * 1e3,
                        "stream_ms": 0.0,
                        "resolve_ms": (now - t_up) * 1e3,
                    },
                    outcome="ok")
        finally:
            if idem:
                self._idem_finish(
                    idem, (status, payload) if status == 200 else None)

    @staticmethod
    def _on_device(rep, rows, tenant):
        """The request rows as a tensor on the device the backend serves
        on: a Predictor's, or the routed tenant's under a
        DynamicBatcher. The copy never falls back: a backend on a card
        this process cannot reach raises here, and the edge answers with
        an error. A backend that names no device (a stub) takes the
        numpy rows."""
        pred = rep
        if hasattr(rep, "submit") and hasattr(rep, "_resolve"):
            pred = rep._resolve(tenant).predictor
        device = getattr(pred, "device", None)
        if device is None:
            return rows
        return torch.from_numpy(rows).to(device)

    @classmethod
    def _call_predict(cls, rep, rows, tenant, deadline_ms, deadline):
        rows = cls._on_device(rep, rows, tenant)
        if hasattr(rep, "submit"):       # DynamicBatcher (tenancy path)
            fut = rep.submit(rows, timeout_ms=deadline_ms,
                             tenant=tenant)
            budget = None
            if deadline is not None:
                budget = max(deadline - time.monotonic(), 0.0) + 5.0
            return fut.result(timeout=budget)
        return rep.predict(rows)         # bare Predictor

    # hedged-predict dedupe ------------------------------------------------
    def _idem_wait(self, key, deadline):
        """Returns a finished (status, payload) to replay, or None if
        this caller owns the execution. A concurrent twin blocks here
        until the owner finishes (bounded by the request deadline /
        drain budget) and replays its response."""
        while True:
            with self._lock:
                hit = self._idem_done.get(key)
                if hit is not None:
                    return hit
                ev = self._idem_pending.get(key)
                if ev is None:
                    self._idem_pending[key] = threading.Event()
                    return None
            budget = self.drain_timeout_s
            if deadline is not None:
                budget = max(deadline - time.monotonic(), 0.0)
            if not ev.wait(budget):
                return None     # owner wedged — execute independently
            # loop: owner finished; replay from the done cache (or own
            # the retry if the owner failed and cached nothing)

    def _idem_finish(self, key, entry):
        with self._lock:
            ev = self._idem_pending.pop(key, None)
            if entry is not None:
                self._idem_done[key] = entry
                while len(self._idem_done) > _IDEM_CAPACITY:
                    self._idem_done.popitem(last=False)
        if ev is not None:
            ev.set()

    # -- /v1/generate -----------------------------------------------------
    def _generate(self, h, rid, router, body, t0, deadline,
                  deadline_ms):
        try:
            prompt = [int(t) for t in body.get("prompt") or []]
        except (TypeError, ValueError):
            self._reject(h, rid, 400, "prompt must be a token list")
            return
        max_new = int(body.get("max_new_tokens", 32))
        seed = int(body.get("seed", 0))
        t_accept = time.perf_counter()
        snap = getattr(router.pool, "replicas", [None])
        n_replicas = max(len(snap), 1)
        sent = [0]               # tokens already on the wire (mutable:
        #                          progress must survive a mid-stream
        #                          exception so the re-route replay
        #                          skips exactly what was flushed)
        exclude = set()          # serials of replicas that died on us
        headers_out = False
        t_route = t_accept
        tfirst = [None]          # perf_counter of the first flush
        done = False
        for attempt in range(n_replicas + 1):
            serial = None
            try:
                with router.lease_decode(rid, exclude=exclude) as rep:
                    serial = router.serial(rep)
                    req = rep.submit(prompt, max_new_tokens=max_new,
                                     seed=seed, timeout_ms=deadline_ms)
                    if not headers_out:
                        h.send_response(200)
                        h.send_header("Content-Type", "text/plain")
                        h.send_header("Transfer-Encoding", "chunked")
                        h.send_header("X-Request-Id", rid)
                        h.end_headers()
                        headers_out = True
                        t_route = time.perf_counter()
                    self._stream(h, req, sent, tfirst)
                    req.result(0)   # surface the resolution error
                done = True
                break
            except (ServerClosed, WorkerCrashed, TransientFault) as e:
                # the affine replica died (or the stream seam fired
                # transiently) — determinism makes the re-routed
                # stream replay an identical prefix, so we skip the
                # `sent` tokens already on the wire and continue
                if serial is not None:
                    exclude.add(serial)
                if attempt >= n_replicas:
                    self._stream_fail(h, rid, headers_out, e)
                    return
                self._logger.warning(
                    "gateway: stream %s re-routing around replica "
                    "serial %s after %d token(s): %s", rid, serial,
                    sent[0], e)
                continue
            except BaseException as e:  # noqa: BLE001 - edge maps it
                self._stream_fail(h, rid, headers_out, e)
                return
        if not done:
            self._stream_fail(h, rid, headers_out, ServerClosed(
                "no replica could finish stream %s" % rid))
            return
        t_first = tfirst[0] if tfirst[0] is not None else t_route
        self._end_chunks(h)
        lat = (time.perf_counter() - t0) * 1000.0
        self._stats.note_completed(lat)
        if self.slo_ttft is not None:
            self.slo_ttft.record((t_first - t0) * 1000.0, "ok")
        if telemetry.enabled():
            now = time.perf_counter()
            self._stats.note_trace(
                rid, rows=1, bucket=0,
                phases={
                    "accept_ms": (t_accept - t0) * 1e3,
                    "route_ms": (t_route - t_accept) * 1e3,
                    "upstream_ms": (t_first - t_route) * 1e3,
                    "stream_ms": (now - t_first) * 1e3,
                    "resolve_ms": 0.0,
                },
                outcome="ok")

    def _stream(self, h, req, sent, tfirst):
        """Pump ``req``'s token stream onto the wire, skipping the
        first ``sent[0]`` tokens (the re-route replay discipline —
        ``sent`` is mutated as each token flushes, so progress
        survives a mid-stream exception). Flushes per token so TTFT
        is a wire fact, not a server claim."""
        while True:
            finished = req.done()   # read BEFORE the token snapshot
            toks = req.tokens()
            while sent[0] < len(toks):
                if _faults.armed():
                    _faults.check("gateway.stream", sent=sent[0])
                self._chunk(h, b"%d\n" % toks[sent[0]])
                sent[0] += 1
                if tfirst[0] is None:
                    tfirst[0] = time.perf_counter()
            if finished:
                return sent[0]
            time.sleep(0.001)

    def _stream_fail(self, h, rid, headers_out, e):
        """Terminal stream failure. Before headers: a proper status
        code. After: an in-band ``#error`` sentinel line (token lines
        are pure digits, so it is unambiguous) then a clean chunk
        terminator — an accepted stream always ends loudly, never by
        silent truncation."""
        status = self._status_for(e)
        if status == 504:
            self._stats.note_timeout()
            if self.slo_ttft is not None:
                self.slo_ttft.record(outcome="timeout")
        elif status == 429:
            self._stats.note_reject()
            if self.slo_ttft is not None:
                self.slo_ttft.record(outcome="reject")
        else:
            self._stats.note_error()
            if self.slo_ttft is not None:
                self.slo_ttft.record(outcome="error")
        if not headers_out:
            self._send_json(
                h, status, {"error": "%s: %s" % (type(e).__name__, e),
                            "id": rid},
                [("X-Request-Id", rid)]
                + ([("Retry-After", "1")] if status == 429 else []))
            return
        self._chunk(h, b"#error %s %s\n"
                    % (type(e).__name__.encode(),
                       str(e).replace("\n", " ")[:200].encode()))
        self._end_chunks(h)
