"""KVStore — parameter aggregation (PyTorch counterpart of
``mxnet_tpu/kvstore.py``), exported as ``mx.kv`` and ``mx.kvstore``.

The kinds ``local`` and ``device`` (and ``local_allreduce_cpu``/
``local_allreduce_device``) run in one process: ``push`` of a list of
arrays (one per device) sums them in list order into the first one's
device, so the sum is the same bit for bit on every run; with an updater
set (``set_optimizer``, ``_set_updater``) the sum updates the stored
weight, else it replaces the stored value; ``pull`` into a list copies
the stored value to every array. ``save_optimizer_states`` writes the
updater's v2 payload (``Updater.get_states``).

The ``dist_*`` kinds ride the multi-process runtime
(:mod:`mxnet_tpu_torch.dist`, started from the launch environment on
first use): ``rank``, ``num_workers`` and ``get_num_dead_node`` come from
it, and ``push`` sums each key over the ranks (a SUM all-reduce, the same
bits on every rank) before the updater or the store takes it.
``dist_sync``, ``dist_device_sync`` and ``dist`` apply each push at
once. ``dist_async`` applies each push one step late (staleness 1): a
push starts this step's reduction and applies the previous one, so no
rank waits in ``push`` on a straggler's reduction; ``barrier()`` (and the
exit finalizer, unless ``set_barrier_before_exit(False)``) applies the
last one, so every gradient is applied exactly once. In a world of one
the dist kinds are the local store with rank 0 and one worker.

``Module.fit`` with a synchronous dist kind reduces the gradients inside
its train step instead of through the store (``module.module``).
"""
from __future__ import annotations

from .base import MXNetError
from . import optimizer as opt

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "device", "local_allreduce_device", "local_allreduce_cpu")
_DIST = ("dist_sync", "dist_device_sync", "dist_async", "dist")
SYNC_DIST = ("dist_sync", "dist_device_sync", "dist")


def _drain_pending(ctx, best_effort=True):
    """Apply dist_async's in-flight reductions: shared by ``barrier()``
    (errors propagate) and the exit finalizer (best effort: the group may
    be gone already; it holds no reference to the store object)."""
    if best_effort and not ctx["enabled"]:
        return
    pending, store = ctx["pending"], ctx["store"]
    for k in sorted(list(pending), key=str):
        thunk = pending.pop(k)
        try:
            effective = thunk()
            if ctx["updater"] is not None:
                ctx["updater"](k, effective, store[k])
            else:
                store[k] = effective
        except Exception:  # noqa: BLE001 - teardown race at exit
            if not best_effort:
                raise
            return


def _key_list(key):
    return key if isinstance(key, (list, tuple)) else [key]


def _val_list(key, value):
    if isinstance(key, (list, tuple)):
        if not (isinstance(value, (list, tuple)) and len(key) == len(value)):
            raise MXNetError("a list of keys needs a list of values of the "
                             "same length")
        return list(value)
    return [value]


class KVStore(object):
    """Key-value store for data synchronisation across devices and
    processes."""

    def __init__(self, kind="local"):
        if kind not in _LOCAL + _DIST:
            raise MXNetError("unknown KVStore type %s" % kind)
        self._kind = kind
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._barrier_before_exit = True
        # dist_async: per key, the reduction started by the previous push
        self._pending = {}
        self._dist = None
        if kind in _DIST:
            from .dist.runtime import get_runtime
            self._dist = get_runtime()
        if kind == "dist_async":
            import weakref
            self._flush_ctx = {"pending": self._pending,
                               "store": self._store, "updater": None,
                               "enabled": True}
            self._flush_finalizer = weakref.finalize(
                self, _drain_pending, self._flush_ctx)

    # ------------------------------------------------------------- basics
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return self._dist.rank if self._dist else 0

    @property
    def num_workers(self):
        return self._dist.size if self._dist else 1

    def init(self, key, value):
        """Initialise key(s) with a copy of value(s)."""
        for k, v in zip(_key_list(key), _val_list(key, value)):
            if k in self._store:
                raise MXNetError("duplicate init of key %s" % str(k))
            self._store[k] = v.copy()

    def push(self, key, value, priority=0):
        """Aggregate value(s) into the store (KVStore::Push). A list of
        per-device arrays is summed in list order on the first one's
        device, then over the ranks for a dist kind (one push later for
        ``dist_async``); the updater, when set, merges the sum into the
        stored weight, else the sum replaces the stored value."""
        for k, v in zip(_key_list(key), _val_list(key, value)):
            if k not in self._store:
                raise MXNetError("please init key %s first" % str(k))
            if isinstance(v, (list, tuple)):
                merged = v[0].copy()
                for other in v[1:]:
                    merged += other.as_in_context(merged.context)
            else:
                merged = v.copy()
            if self._kind == "dist_async" and self._dist is not None:
                pending = self._pending.get(k)
                self._pending[k] = self._dist.allreduce_async(merged)
                if pending is None:
                    continue
                merged = pending()
            elif self._dist is not None:
                merged = self._dist.allreduce(merged)
            if self._updater is not None:
                self._updater(k, merged, self._store[k])
            else:
                self._store[k] = merged

    def pull(self, key, out=None, priority=0):
        """Copy the stored value(s) into ``out`` (an array or a list of
        arrays per key, every one of which receives the value)."""
        if out is None:
            raise MXNetError("pull needs out=")
        for k, o in zip(_key_list(key), _val_list(key, out)):
            src = self._store.get(k)
            if src is None:
                raise MXNetError("please init key %s first" % str(k))
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                src.copyto(t)

    # ---------------------------------------------------------- optimizer
    def set_optimizer(self, optimizer):
        """Apply ``optimizer`` to every push (update on the kvstore)."""
        self._optimizer = optimizer
        self._set_updater(opt.get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater
        if hasattr(self, "_flush_ctx"):
            self._flush_ctx["updater"] = updater

    def save_optimizer_states(self, fname):
        """Write the updater's states (the v2 payload) to ``fname``."""
        if self._updater is None:
            raise MXNetError("no optimizer set on this KVStore")
        from .checkpoint.serialize import atomic_write_bytes
        atomic_write_bytes(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Restore the updater's states from ``fname``."""
        if self._updater is None:
            raise MXNetError("no optimizer set on this KVStore")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def _send_command_to_servers(self, head, body):
        """With no server processes, a command loops back to the
        controller registered in process through MXKVStoreRunServer
        (reference kvstore_dist.h SendCommandToServers)."""
        ctrl = getattr(self, "_server_controller", None)
        if ctrl is not None:
            ctrl(int(head), str(body))

    # ---------------------------------------------------------- dist
    def barrier(self):
        """Apply dist_async's in-flight reductions, then wait for every
        rank (a no-op in one process)."""
        if hasattr(self, "_flush_ctx"):
            _drain_pending(self._flush_ctx, best_effort=False)
        if self._dist is not None:
            self._dist.barrier()

    def _barrier(self):
        self.barrier()

    def set_barrier_before_exit(self, barrier_before_exit):
        self._barrier_before_exit = barrier_before_exit
        if hasattr(self, "_flush_ctx"):
            self._flush_ctx["enabled"] = bool(barrier_before_exit)

    @property
    def num_dead_node(self):
        return 0

    def get_num_dead_node(self, node_id, timeout=60):
        """Peers the runtime's heartbeats find dead (0 without one)."""
        if self._dist is not None:
            return self._dist.num_dead_nodes(timeout)
        return 0


def create(name="local"):
    """A KVStore of kind ``name`` (KVStore::Create): ``local``,
    ``device``, ``local_allreduce_device``, ``local_allreduce_cpu``,
    ``dist_sync``, ``dist_device_sync``, ``dist_async`` or ``dist``."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _LOCAL + _DIST:
        raise MXNetError("unknown KVStore type %s" % name)
    return KVStore(name)
