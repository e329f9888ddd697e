"""DistRuntime — one process's view of the multi-process job (PyTorch
counterpart of ``mxnet_tpu/dist/runtime.py``).

The JAX package joins peer JAX processes through the coordination
service and reduces with an XLA ``psum`` over a global mesh. Here the job
is a ``torch.distributed`` process group (``nccl`` with a card per rank,
``gloo`` otherwise, see :func:`~mxnet_tpu_torch.dist.initialize`) beside
a ``TCPStore`` held by rank 0, which plays the coordination service:

* collectives are ``all_reduce`` (always a SUM) and ``broadcast`` only,
  the two that ``gloo`` runs on CUDA tensors. A tensor goes to the
  backend as it lies: nothing is moved to the CPU for a backend that
  cannot take it, the backend raises;
* the rendezvous :meth:`barrier` counts arrivals in the store with a
  deadline (not a collective that could wait forever on a dead peer) and
  is clocked into ``dist.barrier_wait_ms``;
* liveness: every rank's heartbeat thread adds one to its counter in the
  store every interval; :meth:`num_dead_nodes` counts peers whose counter
  has not moved for ``heartbeat_timeout`` seconds of this process's own
  clock (no clock is compared across hosts). A store that no longer
  answers means rank 0, which holds it, is gone: every peer counts dead;
* at exit every rank checks out through the store and rank 0 (the
  store's host) leaves last, within a bounded wait.

The runtime publishes ``dist.rank``, ``dist.world_size`` and the device
counts into the telemetry registry when it is made.
"""
from __future__ import annotations

import atexit
import os
import threading
import time

import torch

from ..base import MXNetError

__all__ = ["DistRuntime", "get_runtime", "reset_runtime", "active_runtime",
           "dp_runtime"]

_RUNTIME = None
EXIT_WAIT_S = 30.0   # rank 0's wait for the others to check out


class DistRuntime:
    """rank/size, collectives, rendezvous and liveness over a process
    group. A world of one (``size == 1``, no group) makes every
    collective the identity and every barrier free."""

    def __init__(self, rank=0, size=1, backend=None, store=None,
                 device=None, heartbeat_timeout=100.0):
        self.rank = int(rank)
        self.size = int(size)
        self.backend = backend
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._store = store
        self._barrier_n = 0
        self.heartbeat_timeout = float(heartbeat_timeout)
        # beat several times within the timeout, at most once a second
        self._hb_interval = min(1.0, self.heartbeat_timeout / 4.0)
        self._seen = {}
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._closed = False
        from .. import telemetry
        self._clock = telemetry.registry().scope("dist")
        self._publish_metadata()
        if store is not None and self.size > 1:
            self._beat()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name="dist-heartbeat-r%d" % self.rank, daemon=True)
            self._hb_thread.start()

    # ------------------------------------------------------------ meta
    def _publish_metadata(self):
        from .. import telemetry
        scope = telemetry.registry().scope("dist")
        scope.gauge("rank").set(self.rank)
        scope.gauge("world_size").set(self.size)
        scope.gauge("local_device_count").set(1)
        scope.gauge("global_device_count").set(self.size)

    @property
    def grouped(self):
        """Whether a process group is up (a world of one may have one,
        when a backend was named)."""
        return self.backend is not None

    @property
    def global_devices(self):
        """One ``(rank, device)`` entry per rank, in rank order: the dp
        axis of the data-parallel mesh."""
        return [(r, self.device if r == self.rank else None)
                for r in range(self.size)]

    # ----------------------------------------------------- collectives
    def allreduce_(self, tensor):
        """Sum ``tensor`` over the ranks, in place; returns it. The
        host's wait is clocked into ``dist.allreduce_ms`` (a blocking
        collective: the wait is the collective's time as the host sees
        it) and counted in ``dist.allreduces``."""
        if self.grouped:
            t0 = time.perf_counter()
            torch.distributed.all_reduce(tensor)
            self._clock.counter("allreduce_ms").add(
                (time.perf_counter() - t0) * 1000.0)
            self._clock.counter("allreduces").add()
        return tensor

    def broadcast_(self, tensor, src=0):
        """Overwrite ``tensor`` with rank ``src``'s, in place."""
        if self.grouped:
            torch.distributed.broadcast(tensor, src)
        return tensor

    def broadcast_tensors_(self, tensors, src=0):
        """Broadcast a list of tensors from ``src`` in place, one
        collective per dtype (the tensors flattened into one buffer)."""
        if not self.grouped or self.size == 1:
            return tensors
        for group in _by_dtype(tensors):
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            self.broadcast_(flat, src)
            _unflatten_into(flat, group)
        return tensors

    def allreduce_tensors_(self, tensors):
        """Sum a list of tensors over the ranks in place, one collective
        per dtype: the tensors are packed into one buffer in list order,
        reduced, and unpacked."""
        if not self.grouped or self.size == 1:
            return tensors
        for group in _by_dtype(tensors):
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            self.allreduce_(flat)
            _unflatten_into(flat, group)
        return tensors

    def allreduce(self, ndarray):
        """Sum an NDArray over the ranks (dist_sync's push + pull)."""
        return self.allreduce_async(ndarray)()

    def allreduce_async(self, ndarray):
        """Start the sum of an NDArray over the ranks and return a
        zero-argument function that waits for it and returns the result
        as a new NDArray. The start returns at once; only the wait
        blocks on the slowest rank (dist_async applies each result one
        push later)."""
        if not self.grouped:
            return lambda: ndarray
        from ..ndarray import NDArray
        t = ndarray._read().detach().clone()
        work = torch.distributed.all_reduce(t, async_op=True)
        ctx = ndarray.context

        def materialize():
            work.wait()
            return NDArray(t, ctx=ctx)

        return materialize

    # ---------------------------------------------------- rendezvous
    def barrier(self, timeout=300):
        """Wait until every rank reached its n-th barrier (n counted per
        process), through the store, for at most ``timeout`` seconds;
        returns the wait in ms, clocked into ``dist.barrier_wait_ms``."""
        if self.size == 1:
            return 0.0
        t0 = time.perf_counter()
        self._barrier_n += 1
        key = "mx/barrier/%d" % self._barrier_n
        self._store.add(key, 1)
        deadline = time.monotonic() + float(timeout)
        while self._store.add(key, 0) < self.size:
            if time.monotonic() > deadline:
                raise MXNetError(
                    "barrier %d: %d of %d ranks arrived within %.0f s"
                    % (self._barrier_n, self._store.add(key, 0), self.size,
                       timeout))
            time.sleep(0.002)
        wait_ms = (time.perf_counter() - t0) * 1000.0
        from .. import telemetry
        scope = telemetry.registry().scope("dist")
        scope.counter("barriers").add()
        scope.counter("barrier_wait_ms").add(wait_ms)
        return wait_ms

    # ------------------------------------------------------- liveness
    def _beat(self):
        self._store.add("mx/hb/%d" % self.rank, 1)

    def _heartbeat_loop(self):
        while not self._hb_stop.wait(self._hb_interval):
            try:
                self._beat()
            except Exception:  # noqa: BLE001 - the store's host is gone
                return

    def num_dead_nodes(self, timeout=60):
        """Peers whose heartbeat counter has not moved for
        ``heartbeat_timeout`` seconds (kvstore_dist.h GetNumDeadNode).
        The probe never blocks; ``timeout`` is kept for the API."""
        del timeout
        if self.size == 1 or self._store is None:
            return 0
        now = time.monotonic()
        dead = 0
        for r in range(self.size):
            if r == self.rank:
                continue
            try:
                count = int(self._store.add("mx/hb/%d" % r, 0))
            except Exception:  # noqa: BLE001 - the store answers no more
                return self.size - 1
            last = self._seen.get(r)
            if last is None or last[0] != count:
                self._seen[r] = (count, now)
            elif now - last[1] > self.heartbeat_timeout:
                dead += 1
        return dead

    # ----------------------------------------------------- store access
    @property
    def store(self):
        """The coordination store (None in a world without a group)."""
        return self._store

    def shutdown(self):
        """Leave the job: stop the heartbeat, check out through the
        store, and on rank 0 (which holds the store) wait, at most
        ``EXIT_WAIT_S`` seconds, for every rank to check out before the
        group is torn down."""
        if self._closed:
            return
        self._closed = True
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2 * self._hb_interval + 1)
        if self._store is not None and self.size > 1:
            try:
                self._store.add("mx/exit", 1)
                if self.rank == 0:
                    deadline = time.monotonic() + EXIT_WAIT_S
                    while self._store.add("mx/exit", 0) < self.size and \
                            time.monotonic() < deadline:
                        time.sleep(0.01)
            except Exception:  # noqa: BLE001 - a peer took the store down
                pass
        if self.grouped and torch.distributed.is_initialized():
            try:
                torch.distributed.destroy_process_group()
            except Exception:  # noqa: BLE001 - teardown after a fault
                pass


def _by_dtype(tensors):
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def _unflatten_into(flat, group):
    off = 0
    with torch.no_grad():
        for t in group:
            n = t.numel()
            t.copy_(flat[off:off + n].view(t.shape))
            off += n


def get_runtime():
    """The process-wide :class:`DistRuntime`, bootstrapping from the
    environment on first use (``init_from_env``), else a world of one."""
    global _RUNTIME
    if _RUNTIME is None:
        from .bootstrap import init_from_env
        init_from_env()          # may install _RUNTIME via initialize()
        if _RUNTIME is None:
            _RUNTIME = DistRuntime()
    return _RUNTIME


def _install_runtime(rt):
    """Register ``rt`` as the process singleton (the bootstrap's hook);
    a grouped runtime checks out at interpreter exit."""
    global _RUNTIME
    _RUNTIME = rt
    if rt.grouped:
        atexit.register(rt.shutdown)
    return rt


def active_runtime():
    """The installed runtime, or None: a peek that never bootstraps."""
    return _RUNTIME


def dp_runtime():
    """The runtime a module trains across, or None for one process: the
    live runtime when its world has two or more ranks (bootstrapping from
    the environment when it declares such a job), unless
    ``MXNET_DIST_GLOBAL_MESH=0`` opts out (every rank then trains its own
    replica)."""
    if os.environ.get("MXNET_DIST_GLOBAL_MESH", "1") == "0":
        return None
    rt = _RUNTIME
    if rt is None:
        from .bootstrap import coordination_env
        if coordination_env()["num_processes"] > 1:
            rt = get_runtime()
    return rt if rt is not None and rt.size > 1 else None


def reset_runtime():
    """Drop the cached runtime (tests, restarts). Does not tear down the
    process group: :meth:`DistRuntime.shutdown` does."""
    global _RUNTIME
    _RUNTIME = None
