"""TransformIter — N ordered transform workers over any DataIter
(PyTorch counterpart of ``mxnet_tpu/data/transform.py``; host threads).

The source iterator is pulled by one sequencer thread (the iterator
protocol is stateful and stays serial); each pulled batch goes to a pool
of N workers together with a numpy RNG seeded from ``(seed, epoch,
batch_index)`` by the SplitMix fold (:func:`fold_seed`), and finished
batches are reassembled IN ORDER. The seed never depends on which worker
took the batch or when, so the delivered stream is bitwise identical at
1, 2 or 4 workers and a ``reset()`` replays the next epoch identically
for the same epoch index. A transform's error is delivered to the
consumer at its batch's position; with ``restart_on_error`` the stream
then goes on past the failed batch.

Fault seam (``mxnet_tpu_torch.faults``): ``data.transform`` at each
worker's apply, healed through ``faults.retry`` — the batch's RNG is
re-seeded for each attempt, so a healed retry delivers the same bytes.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as onp

from .. import faults as _faults
from ..base import MXNetError
from ..io import DataIter
from .augment import fold_seed

__all__ = ["TransformIter"]

# end-of-epoch sentinel (identity-compared)
_END = object()


class TransformIter(DataIter):
    """Apply ``transform(batch, rng)`` with ``num_workers`` threads,
    delivering batches in source order.

    Parameters
    ----------
    data_iter : DataIter
        Source iterator.  It is pulled from exactly one thread.
    transform : callable, optional
        ``transform(batch, rng) -> batch`` where ``rng`` is a
        ``numpy.random.RandomState`` deterministically seeded per
        (epoch, batch index).  ``None`` means identity — the iterator
        is then a pure ordered multi-buffer prefetcher (the
        ``PrefetchingIter`` pattern with a bounded depth).
    num_workers : int
        Transform worker threads.  Changing it never changes the
        delivered bytes, only the throughput.
    depth : int, optional
        Maximum batches in flight (pulled but not yet consumed).
        Default ``2 * num_workers``.  The sequencer blocks when the
        bound is hit — a slow consumer backpressures the source
        instead of buffering an epoch in RAM.
    seed : int
        Root of the per-batch seeding.
    restart_on_error : bool, optional
        Deliver a TRANSFORM error in order and go on past the failed
        batch (the pool and sequencer are still alive); a source error
        stays terminal, since a source iterator's state after its own
        exception is undefined. Default ``MXNET_FAULT_STAGER_RESTART``
        = 1.
    """

    def __init__(self, data_iter, transform=None, num_workers=2,
                 depth=None, seed=0, restart_on_error=None):
        super().__init__(getattr(data_iter, "batch_size", 0))
        if restart_on_error is None:
            restart_on_error = os.environ.get(
                "MXNET_FAULT_STAGER_RESTART", "0") == "1"
        self._restart_on_error = bool(restart_on_error)
        self._source_dead = False
        if num_workers < 1:
            raise MXNetError("num_workers must be >= 1 (got %d)"
                             % num_workers)
        self._iter = data_iter
        self._transform = transform
        self._num_workers = int(num_workers)
        self._depth = int(depth) if depth else 2 * self._num_workers
        if self._depth < 1:
            raise MXNetError("depth must be >= 1 (got %d)" % self._depth)
        self._seed = int(seed)
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=self._num_workers,
            thread_name_prefix="mxtpu-transform")
        self._epoch = -1
        self._sequencer = None
        self._start_epoch(reset_source=False)

    # -- epoch machinery -----------------------------------------------
    def _start_epoch(self, reset_source):
        """Tear down any in-flight epoch, optionally reset the source,
        and launch a fresh sequencer.  Serial by construction: the old
        sequencer is joined before the source is touched, so a
        ``reset()`` mid-epoch can never race an in-flight pull."""
        self._stop_sequencer()
        if reset_source:
            self._iter.reset()
        with self._cond:
            self._results = {}
            self._next_put = 0      # next sequence number to pull
            self._next_get = 0      # next sequence number to deliver
            self._stop = False
            self._exhausted = False
            self._source_dead = False
        self._epoch += 1
        with self._cond:
            # epoch tag: a straggler transform submitted before a
            # reset() must never deposit its (stale) batch into the new
            # epoch's reassembly window
            self._live_epoch = self._epoch
        self._sequencer = threading.Thread(
            target=self._sequence, args=(self._epoch,),
            name="mxtpu-transform-seq", daemon=True)
        self._sequencer.start()

    def _stop_sequencer(self):
        seq = self._sequencer
        if seq is None:
            return
        with self._cond:
            self._stop = True
            # unblock a sequencer waiting on a full window and any
            # worker-completion waits
            self._cond.notify_all()
        seq.join()
        self._sequencer = None
        # drop any transformed-but-undelivered batches
        with self._cond:
            self._results = {}

    def _sequence(self, epoch):
        """Pull batches serially, fan transforms out to the pool."""
        while True:
            with self._cond:
                while not self._stop and \
                        self._next_put - self._next_get >= self._depth:
                    self._cond.wait(0.05)
                if self._stop:
                    return
                seq = self._next_put
                self._next_put += 1
            try:
                batch = self._iter.next()
            except StopIteration:
                self._finish(epoch, seq, _END)
                return
            except Exception as exc:  # noqa: BLE001 — delivered in order
                self._source_dead = True
                self._finish(epoch, seq, exc)
                return
            if self._transform is None:
                self._finish(epoch, seq, batch)
            else:
                self._pool.submit(self._run_transform, epoch, seq, batch)

    def _run_transform(self, epoch, seq, batch):
        def attempt():
            if _faults.armed():
                _faults.check("data.transform", epoch=epoch, index=seq)
            rng = onp.random.RandomState(self._batch_seed(epoch, seq))
            return self._transform(batch, rng)
        try:
            out = _faults.retry(attempt, site="data.transform",
                                seed=self._seed)
        except Exception as exc:  # noqa: BLE001 — delivered in order
            out = exc
        self._finish(epoch, seq, out)

    def _batch_seed(self, epoch, seq):
        # the SplitMix fold shared with DeviceAugment's draws: adjacent
        # batches land on unrelated streams, and the value is a function
        # of the sequence position only — worker identity never enters
        return fold_seed(self._seed, epoch, seq)

    def _finish(self, epoch, seq, value):
        with self._cond:
            if self._stop or epoch != self._live_epoch:
                return
            self._results[seq] = value
            self._cond.notify_all()

    # -- DataIter surface ----------------------------------------------
    def next(self):
        if self._closed:
            raise MXNetError("TransformIter is closed")
        with self._cond:
            if self._exhausted:
                # the sequencer exited at epoch end (or on an error it
                # already delivered) — keep raising StopIteration like
                # every DataIter does until reset(), instead of waiting
                # on results that can never arrive
                raise StopIteration
            while self._next_get not in self._results:
                if self._stop:
                    raise MXNetError("TransformIter was reset/closed "
                                     "while a next() was blocked")
                self._cond.wait(0.05)
            value = self._results.pop(self._next_get)
            self._next_get += 1
            if value is _END or (isinstance(value, BaseException) and
                                 not (self._restart_on_error and
                                      not self._source_dead)):
                self._exhausted = True
            self._cond.notify_all()
        if value is _END:
            raise StopIteration
        if isinstance(value, BaseException):
            raise value
        return value

    def iter_next(self):
        try:
            self._current = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getpad(self):
        return self._current.pad

    def getindex(self):
        return self._current.index

    def reset(self):
        """Rewind to a fresh epoch.  Safe to call repeatedly and while
        transforms are in flight: the old epoch's work is cancelled and
        joined before the source resets, so no stale batch can leak
        into the new epoch."""
        if self._closed:
            raise MXNetError("TransformIter is closed")
        self._start_epoch(reset_source=True)

    # -- lifecycle -----------------------------------------------------
    def close(self):
        """Join the sequencer and shut the worker pool down.
        Idempotent; also runs via the context-manager exit."""
        if self._closed:
            return
        self._closed = True
        self._stop_sequencer()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
