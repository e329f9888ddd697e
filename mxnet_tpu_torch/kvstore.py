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

The ``dist_*`` kinds run on the JAX package's ``dist`` runtime, which the
port does not have yet: they raise ``MXNetError`` naming ROADMAP A8.
"""
from __future__ import annotations

from .base import MXNetError
from . import optimizer as opt

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "device", "local_allreduce_device", "local_allreduce_cpu")
_DIST = ("dist_sync", "dist_device_sync", "dist_async", "dist")


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
    """Key-value store for data synchronisation across devices."""

    def __init__(self, kind="local"):
        if kind not in _LOCAL:
            raise MXNetError(
                "KVStore type %r: the dist kinds come with the distributed "
                "slice (ROADMAP A8) of the port; one process has %s"
                % (kind, ", ".join(_LOCAL)))
        self._kind = kind
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._barrier_before_exit = True

    # ------------------------------------------------------------- basics
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Initialise key(s) with a copy of value(s)."""
        for k, v in zip(_key_list(key), _val_list(key, value)):
            if k in self._store:
                raise MXNetError("duplicate init of key %s" % str(k))
            self._store[k] = v.copy()

    def push(self, key, value, priority=0):
        """Aggregate value(s) into the store (KVStore::Push). A list of
        per-device arrays is summed in list order on the first one's
        device; the updater, when set, merges the sum into the stored
        weight, else the sum replaces the stored value."""
        for k, v in zip(_key_list(key), _val_list(key, value)):
            if k not in self._store:
                raise MXNetError("please init key %s first" % str(k))
            if isinstance(v, (list, tuple)):
                merged = v[0].copy()
                for other in v[1:]:
                    merged += other.as_in_context(merged.context)
            else:
                merged = v.copy()
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

    # -------------------------------------------------- one-process no-ops
    def barrier(self):
        """Nothing to wait for in one process."""

    _barrier = barrier

    def set_barrier_before_exit(self, barrier_before_exit):
        self._barrier_before_exit = barrier_before_exit

    @property
    def num_dead_node(self):
        return 0

    def get_num_dead_node(self, node_id, timeout=60):
        """No node can fail in one process."""
        return 0


def create(name="local"):
    """A KVStore of kind ``name`` (KVStore::Create): ``local``,
    ``device``, ``local_allreduce_device`` or ``local_allreduce_cpu``;
    the ``dist_*`` kinds raise ``MXNetError`` (ROADMAP A8)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _LOCAL + _DIST:
        raise MXNetError("unknown KVStore type %s" % name)
    return KVStore(name)
