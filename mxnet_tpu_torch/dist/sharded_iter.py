"""ShardedDataIter — one process's deterministic slice of the stream
(PyTorch counterpart of ``mxnet_tpu/dist/sharded_iter.py``).

The reference feeds multi-worker training by pointing every worker at
its own record partition (``ImageRecordIter(num_parts=N, part_index=
rank)``); synthetic or in-memory pipelines instead replicate the source
and slice each batch. This iterator is the slice rule for the second
style:

* rank r of R takes the r-th CONTIGUOUS row block of every global batch
  (:func:`shard_rows`), so the ranks' blocks, in rank order, are the
  global batch;
* any per-batch randomness (an optional ``transform(parts, rng)`` on the
  local slice, numpy in and out) is seeded from ``(seed, epoch,
  batch_index, rank)`` (:func:`batch_seed`), never from worker identity,
  thread timing or pull order;
* ``set_epoch(e)`` pins the epoch coordinate, so a run resumed at epoch
  e replays the stream the uninterrupted run saw.

``provide_data``/``provide_label`` report the GLOBAL batch shapes, as in
the JAX package; ``local_provide_data``/``local_provide_label`` the
rank's. Each rank's module binds the rank's shapes (``Module.fit`` reads
the local ones) and the cross-rank step makes the global batch of them.
"""
from __future__ import annotations

import numpy as onp

from ..base import MXNetError
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["ShardedDataIter", "shard_rows", "batch_seed", "local_pad",
           "rank_batch"]


def shard_rows(arr, rank, num_shards):
    """The r-th contiguous row block of ``arr`` (numpy array or tensor):
    the slice rule shared by this iterator, the virtual-host feed and the
    sharded cache."""
    n = arr.shape[0]
    if n % num_shards:
        raise MXNetError(
            "global batch of %d rows does not divide over %d shards"
            % (n, num_shards))
    block = n // num_shards
    return arr[rank * block:(rank + 1) * block]


def batch_seed(seed, epoch, batch_index, rank):
    """SplitMix-style fold of (seed, epoch, batch_index, rank): adjacent
    coordinates land on unrelated streams, and the value is a pure
    function of those coordinates only (the JAX package's fold, integer
    for integer)."""
    x = (seed * 0x9e3779b97f4a7c15
         + epoch * 0xbf58476d1ce4e5b9
         + batch_index * 0x94d049bb133111eb
         + rank * 0xd6e8feb86659fd93) & 0xffffffffffffffff
    x ^= x >> 31
    return x & 0x7fffffff


def local_pad(global_pad, global_rows, rank, num_shards):
    """Pad rows sit at the END of the global batch: rank ``rank``'s pad
    is the overlap of the global pad range with its row block."""
    if not global_pad:
        return 0
    block = global_rows // num_shards
    lo, hi = rank * block, (rank + 1) * block
    return max(0, hi - max(lo, global_rows - global_pad))


def rank_batch(batch, rank, num_shards):
    """Rank ``rank``'s row block of a global ``DataBatch``: every data
    and label entry (NDArray, tensor or numpy) cut with
    :func:`shard_rows`, the pad made local."""
    from ..ndarray import NDArray

    def cut(v):
        if v is None:
            return None
        if isinstance(v, NDArray):
            return NDArray(shard_rows(v._read(), rank, num_shards))
        return shard_rows(v, rank, num_shards)

    rows = batch.data[0].shape[0]
    return DataBatch(data=[cut(d) for d in batch.data],
                     label=None if batch.label is None
                     else [cut(lb) for lb in batch.label],
                     pad=local_pad(batch.pad or 0, rows, rank, num_shards),
                     index=batch.index)


def _local_descs(descs, num_shards):
    return [DataDesc(d[0], (d[1][0] // num_shards,) + tuple(d[1][1:]),
                     getattr(d, "dtype", onp.float32),
                     getattr(d, "layout", "NCHW")) for d in descs or []]


class ShardedDataIter(DataIter):
    """Deterministic per-rank view over a global-batch ``DataIter``.

    Parameters
    ----------
    data_iter : DataIter
        Source yielding GLOBAL batches (every rank runs an identical copy).
    rank, num_shards : int, optional
        This process's coordinates. Default: the live
        :class:`~mxnet_tpu_torch.dist.DistRuntime`'s rank and size.
    seed : int
        Root of the per-batch transform seeding.
    transform : callable, optional
        ``transform({"data": [...], "label": [...]}, rng) -> same``
        applied to this rank's rows (numpy arrays) with the
        deterministically seeded ``numpy.random.RandomState``.
    """

    def __init__(self, data_iter, rank=None, num_shards=None, seed=0,
                 transform=None):
        if rank is None or num_shards is None:
            from .runtime import get_runtime
            rt = get_runtime()
            rank = rt.rank if rank is None else rank
            num_shards = rt.size if num_shards is None else num_shards
        rank, num_shards = int(rank), int(num_shards)
        if not 0 <= rank < num_shards:
            raise MXNetError("rank %d outside [0, %d)" % (rank, num_shards))
        gbs = getattr(data_iter, "batch_size", 0)
        if gbs and gbs % num_shards:
            raise MXNetError(
                "global batch %d does not divide over %d shards"
                % (gbs, num_shards))
        super().__init__(gbs // num_shards if gbs else 0)
        self._iter = data_iter
        self.rank = rank
        self.num_shards = num_shards
        self.global_batch_size = gbs
        self._seed = int(seed)
        self._transform = transform
        self._epoch = 0
        self._nbatch = -1
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.local_provide_data = _local_descs(self.provide_data,
                                               num_shards)
        self.local_provide_label = _local_descs(self.provide_label,
                                                num_shards)

    # ---------------------------------------------------------- epochs
    @property
    def epoch_coord(self):
        """The pinned epoch coordinate (the set_epoch protocol marker)."""
        return self._epoch

    def set_epoch(self, epoch):
        """Pin the epoch coordinate of the seeding."""
        self._epoch = int(epoch)

    def reset(self):
        self._iter.reset()
        self._epoch += 1
        self._nbatch = -1

    def skip_batches(self, n):
        """Advance the stream by ``n`` batches without slicing them
        (fit's mid-epoch resume). Returns the number skipped."""
        done = 0
        for _ in range(int(n)):
            try:
                self._iter.next()
            except StopIteration:
                break
            self._nbatch += 1
            done += 1
        return done

    # ----------------------------------------------------------- pulls
    def _slice(self, arr):
        from ..ndarray import NDArray
        vals = arr._read() if isinstance(arr, NDArray) else arr
        return shard_rows(vals, self.rank, self.num_shards)

    def next(self):
        from .. import ndarray as nd
        batch = self._iter.next()     # raises StopIteration at epoch end
        self._nbatch += 1
        rows = batch.data[0].shape[0]
        data = [self._slice(d) for d in batch.data]
        label = None
        if batch.label:
            label = [None if lb is None else self._slice(lb)
                     for lb in batch.label]
        if self._transform is not None:
            rng = onp.random.RandomState(batch_seed(
                self._seed, self._epoch, self._nbatch, self.rank))
            parts = self._transform(
                {"data": [_host(d) for d in data],
                 "label": [None if lb is None else _host(lb)
                           for lb in (label or [])]}, rng)
            data = parts["data"]
            if label is not None:
                label = parts["label"]
        data = [_wrap(nd, d) for d in data]
        if label is not None:
            label = [None if lb is None else _wrap(nd, lb) for lb in label]
        return DataBatch(data=data, label=label,
                         pad=local_pad(batch.pad or 0, rows, self.rank,
                                       self.num_shards),
                         index=batch.index)


def _host(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else onp.asarray(v)


def _wrap(nd, v):
    if isinstance(v, nd.NDArray):
        return v
    if hasattr(v, "detach"):
        return nd.NDArray(v)
    import torch
    return nd.NDArray(torch.from_numpy(onp.ascontiguousarray(v)))
