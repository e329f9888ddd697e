"""ReplicaPool — the serving-autoscale actuator (the port's counterpart
of ``mxnet_tpu/autopilot/pool.py``).

Holds N live replicas (``Predictor`` or ``DecodeEngine`` — anything
the caller's ``factory()`` builds) and moves N toward whatever target
the autopilot decides, inside ``[min_replicas, max_replicas]``. Every
spin-up warms the fresh replica through the persistent executable
cache (``warmup(cache_dir=...)``: every bucket's ``torch.export``
program loaded, none traced), so a scale-out under an SLO breach serves
with zero compiles and bitwise-identical rows — the warm-start contract
is what makes autoscaling safe to automate. A spin-up whose warmup
raises releases the fresh replica and re-raises: a cold replica never
joins.
Scale-in releases the newest replica (drain first for engines that
queue).

Every dispatch runs under a :meth:`lease`: the replica is picked and
its in-flight count bumped atomically, and scale-in *waits for the
count to reach zero* before releasing the replica — a request can
never land on (or still be running inside) a closed replica, no
matter how ``scale_to`` oscillates underneath the traffic. Leases
also expose per-replica outstanding counts and stable serial numbers,
which is what the gateway router keys least-outstanding routing and
decode session affinity on.

The spin-up path carries the ``autopilot.scale`` fault seam
(kind=error): a chaos plan can make a spin-up fail exactly when the
controller needs it, and the pool must stay at its previous size with
the failure counted (``autopilot.scale_errors``) — never half-built.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time

from .. import faults as _faults

__all__ = ["ReplicaPool"]


class ReplicaPool(object):
    """A bounded pool of warm serving replicas.

    Parameters
    ----------
    factory : callable
        ``factory() -> replica`` building ONE fresh replica (its own
        Predictor/DecodeEngine — replicas never share stats scopes).
    min_replicas / max_replicas : int
        The pool's hard bounds; ``scale_to`` clamps into them.
    cache_dir : str, optional
        Persistent executable-cache root handed to each spin-up's
        ``warmup(cache_dir=...)``; None warms without the cache (every
        spin-up then compiles — the cold baseline the bench measures).
    warm : bool
        Warm each new replica before it joins (default). ``False``
        skips warmup for factories that warm internally.
    start : bool
        Spin up to ``min_replicas`` at construction (default).
    drain_timeout_s : float
        Longest a scale-in will wait for a retiring replica's leased
        requests to finish before releasing it anyway (with a
        warning). Leases normally last one request, so the bound only
        bites on a wedged replica.
    """

    def __init__(self, factory, min_replicas=1, max_replicas=2,
                 cache_dir=None, warm=True, start=True, logger=None,
                 drain_timeout_s=30.0):
        if min_replicas < 0 or max_replicas < min_replicas:
            raise ValueError(
                "need 0 <= min_replicas <= max_replicas (got %d..%d)"
                % (min_replicas, max_replicas))
        self._factory = factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self._cache_dir = cache_dir
        self._warm = bool(warm)
        self._drain_timeout_s = float(drain_timeout_s)
        self._replicas = []
        self._rr = 0
        self._inflight = {}    # id(rep) -> outstanding leased requests
        self._serials = {}     # id(rep) -> stable spin-up serial
        self._next_serial = 0
        self._lock = threading.RLock()
        self._drain_cond = threading.Condition(self._lock)
        self._logger = logger or logging.getLogger(
            "mxnet_tpu_torch.autopilot")
        from .. import telemetry
        scope = telemetry.registry().scope("autopilot")
        self._g_replicas = scope.gauge("replicas")
        self._c_out = scope.counter("scale_outs")
        self._c_in = scope.counter("scale_ins")
        self._c_err = scope.counter("scale_errors")
        self.spinup_reports = []
        if start:
            self.scale_to(self.min_replicas)

    # ------------------------------------------------------------------
    @property
    def size(self):
        with self._lock:
            return len(self._replicas)

    @property
    def replicas(self):
        """The live replicas, oldest first (a copy)."""
        with self._lock:
            return list(self._replicas)

    # ------------------------------------------------------------------
    def scale_to(self, n):
        """Move the pool to ``n`` replicas (clamped into the bounds).
        Spin-ups warm through the executable cache; a spin-up failure
        (including a fired ``autopilot.scale`` fault) leaves the pool
        at its current size, counts into ``autopilot.scale_errors``,
        and re-raises — the controller's tick records the miss and the
        cooldown paces the retry. Returns the resulting size."""
        n = max(self.min_replicas, min(self.max_replicas, int(n)))
        victims = []
        with self._lock:
            while len(self._replicas) < n:
                try:
                    self._spin_up()
                except BaseException:
                    self._c_err.add()
                    raise
            while len(self._replicas) > n:
                # pop under the lock so no NEW lease can pick the
                # victim; drain + release happen outside so in-flight
                # requests (and other leases) keep making progress
                victims.append(self._replicas.pop())
            self._g_replicas.set(len(self._replicas))
            size = len(self._replicas)
        for rep in victims:
            self._retire(rep)
        return size

    def _spin_up(self):
        from .. import telemetry
        if _faults.armed():
            # spin-up seam (kind=error): the deterministic stand-in
            # for a replica that fails to come up (OOM, dead host) —
            # the pool must absorb it without going half-built
            _faults.check("autopilot.scale",
                          replicas=len(self._replicas))
        t0 = time.perf_counter()
        rep = self._factory()
        report = None
        if self._warm and hasattr(rep, "warmup"):
            try:
                rep.warmup(cache_dir=self._cache_dir)
            except BaseException:
                self._release(rep)
                raise
            if hasattr(rep, "warmup_report"):
                report = rep.warmup_report()
        ms = (time.perf_counter() - t0) * 1000.0
        self._replicas.append(rep)
        self._serials[id(rep)] = self._next_serial
        self._next_serial += 1
        self._c_out.add()
        sources = sorted({r.get("source") for r in (report or {}).values()})
        self.spinup_reports.append(
            {"spinup_ms": round(ms, 3), "sources": sources,
             "replicas": len(self._replicas)})
        telemetry.flight_recorder().note(
            "autopilot_replica_up", replicas=len(self._replicas),
            spinup_ms=round(ms, 3), sources=sources)
        self._logger.info(
            "autopilot: replica %d up in %.1f ms (warm sources: %s)",
            len(self._replicas), ms, sources or "n/a")

    def _retire(self, rep):
        """Drain a popped replica's leased requests, then release it.

        Called with the replica already removed from ``_replicas`` (so
        no new lease can reach it) and WITHOUT the pool lock held —
        waiting happens on ``_drain_cond`` so lease holders finishing
        their requests wake us."""
        from .. import telemetry
        deadline = time.monotonic() + self._drain_timeout_s
        with self._lock:
            while self._inflight.get(id(rep), 0) > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._logger.warning(
                        "autopilot: replica drain timed out with %d "
                        "request(s) still leased; releasing anyway",
                        self._inflight.get(id(rep), 0))
                    break
                self._drain_cond.wait(min(left, 0.5))
            self._inflight.pop(id(rep), None)
            self._serials.pop(id(rep), None)
        self._release(rep)
        self._c_in.add()
        telemetry.flight_recorder().note(
            "autopilot_replica_down", replicas=len(self._replicas))
        self._logger.info("autopilot: replica released (%d remain)",
                          len(self._replicas))

    @staticmethod
    def _release(rep):
        if hasattr(rep, "shutdown"):
            try:
                rep.shutdown(drain=True)
            except TypeError:
                rep.shutdown()
        if hasattr(rep, "release"):
            rep.release()

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def lease(self, pick=None):
        """Check a replica out for one request.

        Picks a live replica (round-robin by default), bumps its
        in-flight count, yields it, and decrements on the way out —
        waking any scale-in waiting to drain it. ``pick`` overrides
        the choice: it receives a snapshot ``[(replica, outstanding,
        serial), ...]`` (oldest replica first) and returns the chosen
        replica — the hook the gateway router uses for
        least-outstanding predict routing and serial-keyed decode
        affinity."""
        with self._lock:
            if not self._replicas:
                raise RuntimeError("replica pool is empty")
            if pick is not None:
                snap = [(r, self._inflight.get(id(r), 0),
                         self._serials.get(id(r), -1))
                        for r in self._replicas]
                rep = pick(snap)
                if rep is None or id(rep) not in self._serials:
                    raise RuntimeError(
                        "lease pick returned a non-live replica")
            else:
                rep = self._replicas[self._rr % len(self._replicas)]
                self._rr += 1
            key = id(rep)
            self._inflight[key] = self._inflight.get(key, 0) + 1
        try:
            yield rep
        finally:
            with self._lock:
                n = self._inflight.get(key, 1) - 1
                if n > 0:
                    self._inflight[key] = n
                else:
                    self._inflight.pop(key, None)
                self._drain_cond.notify_all()

    def outstanding(self, rep=None):
        """Leased-request count for one replica (or the pool total)."""
        with self._lock:
            if rep is not None:
                return self._inflight.get(id(rep), 0)
            return sum(self._inflight.values())

    def serial(self, rep):
        """The replica's stable spin-up serial (-1 if not live)."""
        with self._lock:
            return self._serials.get(id(rep), -1)

    def predict(self, data, **kwargs):
        """Round-robin one request over the live replicas (the pool's
        minimal load-balancer; production traffic normally fronts each
        replica with its own :class:`~mxnet_tpu_torch.serving
        .DynamicBatcher`). Runs under a :meth:`lease`, so a concurrent
        scale-in waits for this request instead of closing the replica
        underneath it."""
        with self.lease() as rep:
            return rep.predict(data, **kwargs)

    def close(self):
        """Release every replica (idempotent)."""
        victims = []
        with self._lock:
            while self._replicas:
                victims.append(self._replicas.pop())
            self._g_replicas.set(0)
        for rep in victims:
            self._retire(rep)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
