"""Replica routing for the gateway front door (the port's counterpart
of ``mxnet_tpu/gateway/router.py``).

Two policies over one lease surface (``ReplicaPool.lease`` — or a
:class:`_StaticPool` shim giving a bare ``Predictor`` /
``DynamicBatcher`` / ``DecodeEngine`` the same contract):

* **least-outstanding** for stateless ``/v1/predict`` — the replica
  with the fewest leased requests wins (serial breaks ties, so the
  choice is deterministic for a given load snapshot);
* **session affinity** for ``/v1/generate`` — a seeded rendezvous
  (highest-random-weight) hash of ``(seed, replica serial, request
  id)`` pins a stream to one replica so its slot state never
  migrates, while ``exclude=`` re-routes deterministically around a
  replica that died mid-stream (every surviving client of the dead
  replica agrees on the fallback, no coordination).

Selection runs inside the pool's lease (under its lock), so the pick
and the in-flight bump are atomic — a concurrent ``scale_to`` either
sees the lease and drains, or the victim was already gone and the
pick never offered it. The ``gateway.route`` fault seam (kind=error /
delay) fires at selection time: a chaos plan can kill routing itself
and the server must answer 503, never hang.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading

from .. import faults as _faults

__all__ = ["Router"]


class _StaticPool(object):
    """Lease/serial surface over ONE backend object, so the router
    (and the pool-drain discipline) is identical whether the gateway
    fronts a ReplicaPool or a single engine."""

    def __init__(self, backend):
        self._backend = backend
        self._inflight = 0
        self._lock = threading.Lock()

    @property
    def replicas(self):
        return [self._backend]

    @contextlib.contextmanager
    def lease(self, pick=None):
        with self._lock:
            if pick is not None:
                pick([(self._backend, self._inflight, 0)])
            self._inflight += 1
        try:
            yield self._backend
        finally:
            with self._lock:
                self._inflight -= 1

    def outstanding(self, rep=None):
        return self._inflight

    def serial(self, rep):
        return 0


class Router(object):
    """Routing policy over a replica pool (or one bare backend).

    Parameters
    ----------
    pool : ReplicaPool or backend object
        Anything with the pool lease surface is used directly; a bare
        Predictor/DynamicBatcher/DecodeEngine is wrapped in a
        single-replica shim.
    seed : int
        Keys the rendezvous hash — two gateways with the same seed
        and replica serials agree on every affinity decision.
    """

    def __init__(self, pool, seed=0):
        if not hasattr(pool, "lease"):
            pool = _StaticPool(pool)
        self.pool = pool
        self.seed = int(seed) & 0xFFFFFFFF

    # ------------------------------------------------------------------
    @staticmethod
    def _weight(seed, serial, request_id):
        h = hashlib.sha256(
            b"%d|%d|%s" % (seed, serial, request_id.encode())).digest()
        return int.from_bytes(h[:8], "big")

    def _pick_least(self, snap):
        if _faults.armed():
            _faults.check("gateway.route", route="predict",
                          replicas=len(snap))
        return min(snap, key=lambda e: (e[1], e[2]))[0]

    def _pick_affine(self, snap, request_id, exclude):
        if _faults.armed():
            _faults.check("gateway.route", route="generate",
                          replicas=len(snap))
        live = [e for e in snap if e[2] not in exclude] or snap
        return max(live, key=lambda e: self._weight(
            self.seed, e[2], request_id))[0]

    # ------------------------------------------------------------------
    def lease_predict(self):
        """Lease the least-outstanding replica for one stateless
        request (context manager yielding the replica)."""
        return self.pool.lease(pick=self._pick_least)

    def lease_decode(self, request_id, exclude=()):
        """Lease the session-affine replica for ``request_id``
        (context manager). ``exclude`` is a set of replica serials to
        route around — the mid-stream re-route path after a replica
        death."""
        exclude = frozenset(exclude)
        return self.pool.lease(
            pick=lambda snap: self._pick_affine(
                snap, request_id, exclude))

    def serial(self, rep):
        """The pool serial of a leased replica (for ``exclude=``)."""
        return self.pool.serial(rep)

    def outstanding(self):
        return self.pool.outstanding()
