"""DynamicBatcher — coalesce concurrent requests into full device
launches, with backpressure, multi-model tenancy, and SLO-driven
admission (the port's copy of ``mxnet_tpu/serving/batcher.py``).

A device serving one request at a time runs at batch-1 utilization; a
device serving whenever "enough" requests arrive runs near its training
throughput. The batcher sits between the two: client threads ``submit``
requests into a **bounded** queue and get a future back; a background
worker coalesces whatever is queued — up to the tenant Predictor's top
bucket — within a ``max_wait_ms`` window measured from the first queued
request, launches ONE bucket-padded device call through that tenant's
Predictor, and routes each slice of the output back to its caller's
future.

One batcher can host SEVERAL named models (:class:`Tenant` — or
several checkpoint generations of one model, for canary rollout)
behind the same queue: requests route by tenant name, launches
coalesce within a tenant, the worker serves the highest-priority
backlog first, and every tenant keeps its own ``serving.<i>.*`` stats
scope and ``slo.<name>.*`` burn-rate gauges so a p99 regression stays
attributable per tenant.

Overload degrades instead of OOMing:

* queue full -> ``submit`` raises :class:`QueueFull` synchronously
  (backpressure; the request is never enqueued);
* a request older than ``timeout_ms`` is dropped at launch time and its
  future carries :class:`RequestTimeout`;
* a tenant whose own SLO fast+slow burn windows are in breach is SHED
  (unless protected): new submits raise :class:`TenantShed`, queued
  requests drop at dequeue time with their queue age traced — only the
  breached tenant; co-hosted tenants keep serving
  (tenancy module docstring has the full admission policy);
* ``shutdown(drain=True)`` stops intake, serves out the queue, and
  joins the worker; ``drain=False`` fails pending futures with
  :class:`ServerClosed`.

The single-tenant spelling is unchanged: ``DynamicBatcher(pred,
slo=...)`` hosts one default tenant and ``stats()`` returns its
Predictor's snapshot — percentiles that INCLUDE deadline-missed and
worker-shed requests (their queue age is a latency sample, so p99 does
not under-report exactly under overload).

Judgment-layer hooks:

* every request carries a stable id; with telemetry enabled its life
  is recorded as a phase-decomposed trace (queue-wait, coalesce-wait,
  pad, device, resolve) into the tenant's stats trace ring, the
  per-bucket phase histograms, and the Chrome-trace span timeline —
  never-launched outcomes (timeout, shed) land their queue age in the
  bucket-free ``phase_queue_wait_ms`` histogram;
* ``slo=`` / per-tenant trackers record every outcome (ok / error /
  timeout / queue-full reject) against the declared objectives;
  ``slo_breached()`` surfaces the burn-rate breach state the admission
  policy above consumes.

The worker is one Python thread. It launches through the tenant's
Predictor, whose modules name their device explicitly, so the worker
never relies on another thread's current CUDA device; each launch ends
in the outputs' readback, its one synchronisation with the card.
"""
from __future__ import annotations

import collections
import logging
import os
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as onp
import torch

from .. import faults as _faults
from .. import telemetry
from .errors import (QueueFull, RequestTimeout, ServerClosed, TenantShed,
                     WorkerCrashed)
from .tenancy import Tenant

__all__ = ["DynamicBatcher"]


def _concat_rows(parts):
    """Join requests' rows along axis 0: numpy on the host; on the card
    when any part is a tensor there."""
    if all(isinstance(p, onp.ndarray) for p in parts):
        return onp.concatenate(parts)
    dev = next(p.device for p in parts if isinstance(p, torch.Tensor))
    return torch.cat([torch.as_tensor(p, device=dev) for p in parts])


class _Request:
    __slots__ = ("arrays", "rows", "future", "deadline", "t_submit",
                 "id", "t_popped")

    def __init__(self, arrays, rows, future, deadline, t_submit,
                 req_id=None):
        self.arrays = arrays
        self.rows = rows
        self.future = future
        self.deadline = deadline
        self.t_submit = t_submit
        self.id = req_id
        self.t_popped = t_submit   # set when the worker dequeues it


class DynamicBatcher:
    """Bounded request queue + coalescing worker over one or more
    tenant Predictors.

    Parameters
    ----------
    predictor : Predictor, optional
        Single-tenant spelling: hosts one ``"default"`` tenant.
        Mutually exclusive with ``tenants=``.
    max_queue : int
        Queue capacity in requests, shared across tenants; beyond it
        ``submit`` rejects (:class:`QueueFull`).
    max_wait_ms : float
        Coalescing window measured from the FIRST queued request of a
        launch: the worker launches as soon as the tenant's top bucket
        is full or the window closes, whichever comes first. 0 serves
        whatever is queued immediately (lowest latency, lowest fill).
    timeout_ms : float, optional
        Per-request deadline; requests still queued past it fail with
        :class:`RequestTimeout` instead of occupying a launch.
    start : bool
        Start the worker thread immediately (default). ``start=False``
        lets tests (and staged deployments) fill the queue first.
    metrics_port : int, optional
        Serve the process-wide telemetry registry as a Prometheus
        ``GET /metrics`` endpoint (stdlib ``http.server``) for the
        batcher's lifetime — ``0`` picks a free port, readable as
        ``.metrics_server.port``. Every tenant's serving counters live
        in the registry, so a scraper pointed here sees queue depth,
        latency histograms, batch fill, and compiles per tenant.
    slo : mxnet_tpu_torch.telemetry.SLOTracker, optional
        Single-tenant spelling: objectives for the default tenant
        (every outcome recorded; breach drives admission).
    tenants : dict, optional
        ``name -> Predictor | Tenant`` — the multi-model spelling.
        Plain Predictors wrap as ``Tenant(name, predictor)``; pass
        :class:`Tenant` objects to attach per-tenant SLOs, priorities,
        and shed protection. Mutually exclusive with ``predictor``.
    """

    def __init__(self, predictor=None, max_queue=256, max_wait_ms=2.0,
                 timeout_ms=None, start=True, metrics_port=None,
                 slo=None, tenants=None):
        if tenants:
            if predictor is not None or slo is not None:
                raise ValueError(
                    "pass either a single predictor (+ slo) or "
                    "tenants=, not both")
            resolved = collections.OrderedDict()
            for name, spec in tenants.items():
                if isinstance(spec, Tenant):
                    if spec.name != str(name):
                        raise ValueError(
                            "tenant key %r names a Tenant(%r) — keys "
                            "and Tenant names must agree"
                            % (name, spec.name))
                    resolved[str(name)] = spec
                else:
                    resolved[str(name)] = Tenant(name, spec)
            seen = {}
            for name, ten in resolved.items():
                prev = seen.setdefault(id(ten.predictor), name)
                if prev != name:
                    raise ValueError(
                        "tenants %r and %r share one Predictor "
                        "instance — their stats scopes and queue "
                        "gauge would silently merge; build one "
                        "Predictor per tenant (two Predictors over "
                        "one module share device params)"
                        % (prev, name))
            self._tenants = resolved
        else:
            if predictor is None:
                raise ValueError(
                    "DynamicBatcher needs a predictor (or tenants=)")
            self._tenants = collections.OrderedDict(
                [("default", Tenant("default", predictor, slo=slo))])
        self._default = next(iter(self._tenants)) \
            if len(self._tenants) == 1 else None
        # single-tenant back-compat surface
        self._pred = self._tenants[self._default].predictor \
            if self._default else None
        self.metrics_server = None
        if metrics_port is not None:
            self.metrics_server = telemetry.MetricsServer(
                telemetry.registry(), port=int(metrics_port))
        self._max_queue = int(max_queue)
        self._max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        self._timeout = (float(timeout_ms) / 1000.0
                         if timeout_ms is not None else None)
        self._queues = {name: collections.deque()
                        for name in self._tenants}
        self._n_queued = 0
        self._cond = threading.Condition()
        self._closed = False
        self._thread = None
        # worker supervision: requests the worker has popped for the
        # CURRENT gather/launch cycle (worker thread only) — on an
        # escaped exception these are the futures that would otherwise
        # hang forever, so the supervisor fails them loudly and
        # restarts the loop (bounded by MXNET_SERVE_MAX_WORKER_RESTARTS)
        self._popped = []
        self._popped_tenant = None
        self._max_worker_restarts = int(os.environ.get(
            "MXNET_SERVE_MAX_WORKER_RESTARTS", "100"))
        self._logger = logging.getLogger("mxnet_tpu_torch.serving")
        for name, ten in self._tenants.items():
            ten.stats.set_queue_probe(
                lambda q=self._queues[name]: len(q))
        if start:
            self.start()

    # ------------------------------------------------------------------
    @property
    def slo(self):
        """The default tenant's SLOTracker (single-tenant back-compat;
        None in multi-tenant mode — read per-tenant via
        :meth:`tenant`)."""
        return self._tenants[self._default].slo if self._default \
            else None

    def tenants(self):
        """The hosted tenant names, in registration order."""
        return list(self._tenants)

    def tenant(self, name):
        """The named :class:`Tenant` (KeyError for unknown names)."""
        return self._tenants[name]

    def add_tenant(self, tenant):
        """Admit a new :class:`Tenant` at RUNTIME (the canary-rollout
        hook): the tenant gets its own
        queue and joins the priority schedule on the next gather.
        Admission never disturbs existing clients — a single-tenant
        batcher's default route keeps pointing at the ORIGINAL tenant,
        so un-named ``submit()`` calls are unaffected by a canary
        joining. Rejects duplicate names and a Predictor instance
        another tenant already serves (their stats scopes would
        silently merge). Returns the tenant."""
        if not isinstance(tenant, Tenant):
            raise TypeError("add_tenant needs a Tenant (got %s)"
                            % type(tenant).__name__)
        with self._cond:
            if self._closed:
                raise ServerClosed("batcher is shut down")
            if tenant.name in self._tenants:
                raise ValueError("tenant %r is already hosted"
                                 % tenant.name)
            for name, ten in self._tenants.items():
                if ten.predictor is tenant.predictor:
                    raise ValueError(
                        "tenant %r would share tenant %r's Predictor "
                        "instance — build one Predictor per tenant"
                        % (tenant.name, name))
            self._tenants[tenant.name] = tenant
            self._queues[tenant.name] = collections.deque()
            tenant.stats.set_queue_probe(
                lambda q=self._queues[tenant.name]: len(q))
            self._cond.notify_all()
        return tenant

    def remove_tenant(self, name):
        """Stop hosting the named tenant (the canary-rollback hook):
        its queue is detached and still-queued requests fail with
        :class:`ServerClosed` — a rolled-back canary's backlog must
        never launch. In-flight requests the worker already popped
        complete normally. The default route re-resolves when the
        removal leaves ONE tenant. Returns the removed tenant."""
        with self._cond:
            if name not in self._tenants:
                raise ValueError("unknown tenant %r (hosted: %r)"
                                 % (name, list(self._tenants)))
            ten = self._tenants.pop(name)
            q = self._queues.pop(name)
            while q:
                req = q.popleft()
                self._n_queued -= 1
                ten.stats.note_error()
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(ServerClosed(
                        "tenant %r removed before request %s launched"
                        % (name, req.id)))
            if self._default == name or self._default is None:
                self._default = next(iter(self._tenants)) \
                    if len(self._tenants) == 1 else None
                self._pred = self._tenants[self._default].predictor \
                    if self._default else None
            self._cond.notify_all()
        return ten

    def replace_tenant(self, name, tenant):
        """ATOMICALLY swap the named route to a new :class:`Tenant`
        (the canary-promotion hook): requests already queued under the
        name stay queued and launch through the NEW tenant's Predictor
        — there is no window where the route doesn't resolve. The new
        tenant must carry the same name; the caller owns shape
        compatibility (a promotion serves the same model family).
        Returns the replaced tenant."""
        if not isinstance(tenant, Tenant):
            raise TypeError("replace_tenant needs a Tenant (got %s)"
                            % type(tenant).__name__)
        if tenant.name != str(name):
            raise ValueError(
                "replace_tenant(%r) got a Tenant named %r — the route "
                "name is the identity" % (name, tenant.name))
        with self._cond:
            if name not in self._tenants:
                raise ValueError("unknown tenant %r (hosted: %r)"
                                 % (name, list(self._tenants)))
            for other, ten in self._tenants.items():
                if other != name and ten.predictor is tenant.predictor:
                    raise ValueError(
                        "tenant %r would share tenant %r's Predictor "
                        "instance — remove that tenant first"
                        % (name, other))
            old = self._tenants[name]
            self._tenants[name] = tenant
            tenant.stats.set_queue_probe(
                lambda q=self._queues[name]: len(q))
            if self._default == name:
                self._pred = tenant.predictor
            self._cond.notify_all()
        return old

    def _resolve(self, tenant):
        if tenant is None:
            if self._default is None:
                raise ValueError(
                    "this batcher hosts tenants %r — submit(..., "
                    "tenant=<name>) must name one" % list(self._tenants))
            return self._tenants[self._default]
        try:
            return self._tenants[tenant]
        except KeyError:
            raise ValueError("unknown tenant %r (hosted: %r)"
                             % (tenant, list(self._tenants))) from None

    # ------------------------------------------------------------------
    def start(self):
        """Start (or restart after ``start=False``) the worker thread."""
        with self._cond:
            if self._closed:
                raise ServerClosed("batcher is shut down")
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._worker, name="mxnet-torch-serving-batcher",
                daemon=True)
            self._thread.start()

    def submit(self, data, timeout_ms=None, tenant=None):
        """Enqueue one request for ``tenant`` (the sole tenant when
        omitted); returns a ``concurrent.futures.Future`` resolving to
        the request's outputs (single array for single-output nets,
        else a list). Raises :class:`ServerClosed` after shutdown,
        :class:`QueueFull` when the bounded queue is at capacity (the
        backpressure signal), and :class:`TenantShed` while the
        tenant's own SLO burn windows are in breach (admission sheds
        the breached tenant only). Malformed requests raise
        ``ValueError`` here, on the caller's thread."""
        ten = self._resolve(tenant)
        arrays, rows = ten.predictor._normalize(data)
        if self._closed:
            # fast-path spelling of the locked check below: a dead
            # server must answer ServerClosed (stop), never TenantShed
            # (back off and retry), and must not mutate shed stats
            raise ServerClosed("batcher is shut down")
        if ten.shed_active():
            # admission shed: decided before the queue, so the request
            # costs the device nothing; the decision is still recorded
            # (counter + trace) so a shed spike is attributable
            ten.stats.note_shed()
            if telemetry.enabled():
                ten.stats.note_trace(ten.stats.new_request_id(), rows,
                                     None, {}, outcome="shed")
            raise TenantShed(
                "tenant %r shed: its SLO fast+slow burn windows are in "
                "breach — back off, or route to a protected tenant"
                % ten.name)
        t = time.perf_counter()
        limit = self._timeout if timeout_ms is None else \
            float(timeout_ms) / 1000.0
        req = _Request(arrays, rows, Future(),
                       t + limit if limit is not None else None, t,
                       req_id=ten.stats.new_request_id())
        # queue-flood seam: a fired rule makes THIS submit see the queue
        # at capacity, the deterministic stand-in for a burst arriving
        # faster than the worker drains (clients see the same QueueFull)
        flood = _faults.armed() and _faults.fires("serving.queue_flood",
                                                  tenant=ten.name)
        with self._cond:
            if self._closed:
                raise ServerClosed("batcher is shut down")
            full = flood or self._n_queued >= self._max_queue
            if not full:
                self._queues[ten.name].append(req)
                self._n_queued += 1
                ten.stats.note_request()
                self._cond.notify_all()
        if full:
            # accounting OUTSIDE the condition lock: the SLO record can
            # trigger a bounded window scan, and overload — when rejects
            # fire — is exactly when the worker must not stall behind it
            ten.stats.note_reject()
            if ten.slo is not None:
                ten.slo.record(outcome="reject")
            raise QueueFull(
                "serving queue at capacity (%d requests) — shed "
                "load or retry with backoff" % self._max_queue)
        return req.future

    def predict(self, data, timeout=None, timeout_ms=None, tenant=None):
        """Blocking convenience: ``submit`` + ``Future.result``.
        ``timeout`` (seconds) bounds the caller-side wait; ``timeout_ms``
        overrides the batcher's per-request deadline."""
        return self.submit(data, timeout_ms=timeout_ms,
                           tenant=tenant).result(timeout)

    def stats(self, tenant=None):
        """The named tenant's stats snapshot; with one tenant and no
        name, its snapshot (the historical single-tenant shape); with
        several and no name, ``{tenant: snapshot}``."""
        if tenant is not None:
            return self._resolve(tenant).predictor.stats()
        if self._default is not None:
            return self._pred.stats()
        return {name: ten.predictor.stats()
                for name, ten in self._tenants.items()}

    # ------------------------------------------------------------------
    def shutdown(self, drain=True, timeout=None):
        """Stop intake and end the worker. ``drain=True`` serves every
        already-queued request first (graceful); ``drain=False`` fails
        them with :class:`ServerClosed`. Idempotent."""
        with self._cond:
            already = self._closed
            self._closed = True
            if not drain or self._thread is None:
                # nobody will serve these — fail them out loud
                for name, q in self._queues.items():
                    ten = self._tenants[name]
                    while q:
                        req = q.popleft()
                        self._n_queued -= 1
                        ten.stats.note_error()
                        req.future.set_exception(ServerClosed(
                            "batcher shut down before launch"))
            self._cond.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None and not already and \
                thread is not threading.current_thread():
            # the give-up path calls shutdown FROM the worker thread;
            # a thread cannot join itself
            thread.join(timeout)
        server, self.metrics_server = self.metrics_server, None
        if server is not None:
            server.close()

    def close(self):
        self.shutdown(drain=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)

    # ------------------------------------------------------------------
    def _worker(self):
        """The supervised worker loop. Device/model errors are handled
        INSIDE :meth:`_launch` (each future gets the exception); this
        loop guards against everything else — an exception escaping the
        gather/launch path would otherwise kill the thread and leave
        every queued future hanging forever. Instead the implicated
        in-flight requests fail loudly with
        :class:`WorkerCrashed`, the tenant's ``worker_restarts``
        counter increments, and the loop restarts to serve the rest of
        the queue; only after ``MXNET_SERVE_MAX_WORKER_RESTARTS``
        consecutive crash cycles does the batcher give up and close."""
        restarts = 0
        while True:
            self._popped = []
            self._popped_tenant = None
            try:
                gathered = self._gather()
                if gathered is None:
                    return
                ten, reqs = gathered
                if reqs:
                    self._launch(ten, reqs)
                restarts = 0
            except BaseException as exc:  # noqa: BLE001 — supervised
                if isinstance(exc, (SystemExit, KeyboardInterrupt)):
                    raise
                restarts += 1
                self._on_worker_crash(exc, restarts)
                if restarts >= self._max_worker_restarts:
                    self._logger.critical(
                        "serving worker crashed %d times; closing the "
                        "batcher", restarts)
                    self.shutdown(drain=False, timeout=0)
                    return

    def _on_worker_crash(self, exc, restarts):
        """Fail the crash cycle's in-flight futures with a descriptive
        error and count the restart — nothing a client holds may hang."""
        ten = self._popped_tenant
        self._logger.exception(
            "serving worker crashed (restart %d, tenant %r, %d "
            "in-flight request(s)): %r", restarts,
            ten.name if ten is not None else None, len(self._popped),
            exc)
        if ten is not None:
            ten.stats.note_worker_restart()
        for r in self._popped:
            fut = r.future
            if not fut.done():
                # queued-popped futures still need the PENDING->RUNNING
                # transition; ones already RUNNING (the _gather live
                # path did it) take set_exception directly. A
                # concurrently cancelled/resolved future raises
                # InvalidStateError below — it no longer hangs anyone.
                if not fut.running():
                    try:
                        fut.set_running_or_notify_cancel()
                    except (InvalidStateError, RuntimeError):
                        pass
                err = WorkerCrashed(
                    "serving worker crashed while request %s was "
                    "in flight (%r); the worker restarted — "
                    "resubmit" % (r.id, exc))
                err.__cause__ = exc   # the documented retryability probe
                try:
                    fut.set_exception(err)
                except InvalidStateError:
                    continue
                if ten is not None:
                    ten.stats.note_error()
                    if ten.slo is not None:
                        ten.slo.record(outcome="error")

    def _pick_tenant(self):
        """Name of the tenant to serve next: highest priority wins,
        oldest head request breaks ties — priority orders service,
        FIFO holds within a tenant. None when every queue is empty.
        Caller holds the condition lock."""
        best, best_key = None, None
        for name, q in self._queues.items():
            if not q:
                continue
            key = (-self._tenants[name].priority, q[0].t_submit)
            if best_key is None or key < best_key:
                best, best_key = name, key
        return best

    def _gather(self):
        """Block for the first request, pick its tenant, then coalesce
        more of THAT tenant's requests until its top bucket is full,
        the ``max_wait_ms`` window (from the first request) closes, or
        the next request would overflow the bucket. Returns ``(tenant,
        live requests)`` — live excludes expired, cancelled, and (for
        a breached tenant) shed requests — or None when shut down with
        an empty queue."""
        with self._cond:
            while True:
                name = self._pick_tenant()
                if name is not None:
                    break
                if self._closed:
                    return None
                # untimed: submit() and shutdown() both notify, so an
                # idle server parks instead of polling
                self._cond.wait()
            ten = self._tenants[name]
            q = self._queues[name]
            first = q.popleft()
            self._n_queued -= 1
            first.t_popped = time.perf_counter()
            # once popped, only this worker can resolve the future —
            # the supervision list is what the crash handler fails
            self._popped_tenant = ten
            self._popped.append(first)
            reqs, rows = [first], first.rows
            max_rows = ten.predictor.max_batch_size
            window_end = first.t_submit + self._max_wait
            while rows < max_rows:
                if q:
                    if rows + q[0].rows > max_rows:
                        break
                    nxt = q.popleft()
                    self._n_queued -= 1
                    nxt.t_popped = time.perf_counter()
                    self._popped.append(nxt)
                    reqs.append(nxt)
                    rows += nxt.rows
                    continue
                remaining = window_end - time.perf_counter()
                if remaining <= 0 or self._closed:
                    break
                self._cond.wait(remaining)
        tracing = telemetry.enabled()
        now = time.perf_counter()
        if ten.shed_active():
            # worker-side shed: the breach began (or was detected)
            # after these queued; dropping them now keeps a breached
            # tenant's backlog from occupying launches the healthy
            # tenants need. The queue age is a latency outcome the
            # client experienced — reservoir + shed histogram + trace.
            for r in reqs:
                age_ms = (now - r.t_submit) * 1000.0
                ten.stats.note_shed(age_ms)
                if tracing:
                    ten.stats.note_trace(
                        r.id, r.rows, None,
                        {"queue_wait_ms": age_ms}, outcome="shed")
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(TenantShed(
                        "request %s shed after %.1f ms in queue: "
                        "tenant %r is in SLO breach"
                        % (r.id, age_ms, ten.name)))
            return ten, []
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                age_ms = (now - r.t_submit) * 1000.0
                # the miss IS a latency outcome: its age reaches the
                # reservoir/histogram (p99 must reflect overload) and
                # spends SLO error budget
                ten.stats.note_timeout(age_ms)
                if ten.slo is not None:
                    ten.slo.record(age_ms, "timeout")
                if tracing:
                    ten.stats.note_trace(
                        r.id, r.rows, None,
                        {"queue_wait_ms": age_ms}, outcome="timeout")
                if r.future.set_running_or_notify_cancel():
                    # guard like the live path: set_exception on a
                    # caller-CANCELLED future raises InvalidStateError
                    # and would kill the worker thread for good
                    r.future.set_exception(RequestTimeout(
                        "request %s expired after %.1f ms in queue"
                        % (r.id, age_ms)))
            elif r.future.set_running_or_notify_cancel():
                live.append(r)
        return ten, live

    def _launch(self, ten, reqs):
        tracing = telemetry.enabled()
        total = sum(r.rows for r in reqs)
        if _faults.armed():
            # worker-death seam: raises OUTSIDE the launch's error
            # handling below, so the exception reaches the supervisor as
            # an unexpected bug would (WorkerCrashed, restart budget)
            _faults.check("serving.worker", tenant=ten.name,
                          rows=total, requests=len(reqs))
        t_launch = time.perf_counter()
        timing = {} if tracing else None
        try:
            if len(reqs) == 1:
                arrays = reqs[0].arrays
            else:
                names = list(reqs[0].arrays)
                arrays = {k: _concat_rows([r.arrays[k] for r in reqs])
                          for k in names}
            outs = ten.predictor._predict_rows(arrays, total,
                                               timing=timing)
        except BaseException as e:  # noqa: B036 — futures must resolve
            for r in reqs:
                ten.stats.note_error()
                if ten.slo is not None:
                    ten.slo.record(outcome="error")
                if tracing:
                    self._trace(ten, r, None, timing, t_launch,
                                time.perf_counter(), outcome="error")
                r.future.set_exception(e)
            return
        t_outs = time.perf_counter()
        off = 0
        for r in reqs:
            res = [o[off:off + r.rows] for o in outs]
            off += r.rows
            r.future.set_result(res[0] if len(res) == 1 else res)
            now = time.perf_counter()
            lat_ms = (now - r.t_submit) * 1000.0
            ten.stats.note_completed(lat_ms)
            if ten.slo is not None:
                ten.slo.record(lat_ms, "ok")
            if tracing:
                self._trace(ten, r, ten.predictor.bucket_for(total),
                            timing, t_launch, t_outs, t_done=now)

    def _trace(self, ten, r, bucket, timing, t_launch, t_outs,
               t_done=None, outcome="ok"):
        """One request's phase decomposition. The shared launch phases
        (pad, device) are what every coalesced request experienced;
        queue/coalesce/resolve are the request's own clocks — so each
        trace's phase sum tracks ITS end-to-end latency."""
        timing = timing or {}
        t_done = t_outs if t_done is None else t_done
        phases = {
            "queue_wait_ms": (r.t_popped - r.t_submit) * 1000.0,
            "coalesce_wait_ms": (t_launch - r.t_popped) * 1000.0,
            "pad_ms": timing.get("pad_ms", 0.0),
            "device_ms": timing.get("device_ms", 0.0),
            # normalize/concat overhead before the pad plus the
            # slice-and-resolve after the outputs landed
            "resolve_ms": max(
                (t_done - t_launch) * 1000.0
                - timing.get("pad_ms", 0.0)
                - timing.get("device_ms", 0.0), 0.0),
        }
        ten.stats.note_trace(r.id, r.rows, bucket, phases,
                             outcome=outcome)

    def slo_breached(self, tenant=None):
        """Whether the named tenant's :class:`SLOTracker` reports an
        active multi-window burn-rate breach — or, with no name,
        whether ANY hosted tenant's does (False without trackers).
        This is the state the admission policy sheds on."""
        if tenant is not None:
            ten = self._resolve(tenant)
            return ten.slo is not None and ten.slo.breached()
        return any(t.slo is not None and t.slo.breached()
                   for t in self._tenants.values())
