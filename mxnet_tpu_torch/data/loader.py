"""DeviceLoader — a bounded ring of batches already resident on the card
(PyTorch counterpart of ``mxnet_tpu/data/loader.py``).

A background stager thread pulls host batches from any ``DataIter`` and
copies batch i+1/i+2 to the card while the step of batch i runs, keeping
a bounded ring (depth 2-3) of staged batches. Host decode, the host→card
copy and the step then overlap; the consumer's ``next()`` only waits
when the input path cannot keep up, and that wait is measured
(``PipelineStats.host_wait_ms``).

On a CUDA device the stager works on a stream of its own:

* each batch's host arrays are packed into one **pinned** slab and
  copied with ``non_blocking=True`` on the side stream, then an event is
  recorded there;
* a slab is reused only after its copies' event has completed, so an
  async copy never reads a slab the stager is already refilling;
* the consumer's ``next()`` makes its current stream wait on the event
  before it hands the batch out, and marks every staged tensor with
  ``record_stream`` for that stream, so the caching allocator keeps
  their memory until the step that reads them has run.

Delivered tensors are exact copies of the host bytes, so a prefetched
``fit`` trains to the same bits as an unprefetched one. With
``batch_group=K`` the stager stacks K batches into one ``(K, B, ...)``
block per input, copies it, and passes it through the bound group's
``stage_stacked`` (which runs a deferred augment over the K·B rows); the
delivered batches are views that carry the block, so ``fit``'s grouped
step consumes it whole. A source that sets ``background_pull_safe =
False`` is pulled on the consumer thread instead (pass-through).
"""
from __future__ import annotations

import threading
import time

import numpy as onp
import torch

from ..base import MXNetError
from ..context import current_context
from ..io import DataBatch, DataIter
from .augment import unwrap
from .stats import PipelineStats

__all__ = ["DeviceLoader"]

_END = object()
_ALIGN = 64


def _is_host(v):
    return isinstance(v, onp.ndarray) or (
        isinstance(v, torch.Tensor) and v.device.type == "cpu")


def _batch_wire_stats(batches):
    """(bytes, dtype) a group of batches puts on the transport: the sum of
    every host array's bytes (a tensor already on the card counts 0), and
    the image (first data entry) dtype."""
    total = 0
    for b in batches:
        for a in list(b.data) + list(b.label or []):
            v = unwrap(a)
            if v is not None and _is_host(v):
                total += int(v.nbytes) if isinstance(v, onp.ndarray) \
                    else v.numel() * v.element_size()
    first = unwrap(batches[0].data[0])
    dtype = getattr(first, "dtype", None)
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    return total, dtype


class _PinnedSlabs(object):
    """Pinned host slabs for the stager's copies. A slab returns to the
    free list with the event recorded after the copies out of it; it is
    handed out again only once that event has completed."""

    def __init__(self, limit):
        self._free = []          # [(slab, event)]
        self._limit = int(limit)

    def take(self, nbytes):
        for i, (slab, ev) in enumerate(self._free):
            if slab.numel() >= nbytes and ev.query():
                return self._free.pop(i)[0]
        if len(self._free) >= self._limit:
            # every slab is busy or too small: wait for the oldest copy
            slab, ev = self._free.pop(0)
            ev.synchronize()
            if slab.numel() >= nbytes:
                return slab
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def give(self, slab, event):
        self._free.append((slab, event))

    def clear(self):
        for _, ev in self._free:
            ev.synchronize()
        self._free = []


class DeviceLoader(DataIter):
    """Wrap ``data_iter`` so every delivered batch is on the device.

    Parameters
    ----------
    data_iter : DataIter
        Host-side source (NDArrayIter, ImageRecordIter, a
        :class:`TransformIter`, ...), pulled from the stager thread only.
    module : Module, optional
        A bound module: its group's device is the target, and with
        ``batch_group`` its ``stage_stacked`` takes the blocks.
    depth : int
        Ring bound: the most batches staged on the device at once.
    batch_group : int, optional
        Stage blocks of K batches for ``fit(batch_group=K)``; the epoch
        tail forms a smaller last block.
    stats : PipelineStats, optional
        Shared counter block (default: a fresh one, ``.pipeline_stats``).
    close_source : bool
        Also close ``data_iter`` from ``close()`` (default False: the
        caller's iterator stays usable).
    ctx : Context, optional
        Target device without a module (default: the current context; a
        gpu context on a machine without CUDA raises here).
    """

    def __init__(self, data_iter, module=None, depth=2, batch_group=None,
                 stats=None, close_source=False, ctx=None):
        super().__init__(getattr(data_iter, "batch_size", 0))
        depth = int(depth)
        if depth < 1:
            raise MXNetError("depth must be >= 1 (got %d)" % depth)
        group = int(batch_group) if batch_group else 0
        if group == 1:
            group = 0
        self._iter = data_iter
        self._depth = depth
        self._group = group
        self._close_source = bool(close_source)
        self._owns_stats = stats is None
        self.pipeline_stats = stats or PipelineStats(ring_depth=depth)
        self.pipeline_stats.ring_depth = depth
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self._data_names = [d[0] for d in self.provide_data]
        self._label_names = [d[0] for d in (self.provide_label or [])]

        grp = getattr(module, "_exec_group", None) \
            if module is not None else None
        if grp is not None and not getattr(grp, "fused", False):
            grp = None
        self._group_handle = grp
        if grp is not None:
            ctx = grp.contexts[0]
        elif module is not None:
            ctx = module._context[0]
        self._device = (ctx or current_context()).torch_device()
        self._cuda = self._device.type == "cuda"
        self._stream = None
        self._slabs = _PinnedSlabs(depth + 2) if self._cuda else None
        self.pipeline_stats.augment_placement = \
            "device" if grp is not None and \
            getattr(grp, "_device_augment", None) else \
            getattr(data_iter, "augment_placement", None) or "host"
        # u8 pipelines advertise their spec; forward it so a manually
        # built DeviceLoader can be handed straight to fit()
        self.device_augment_spec = getattr(data_iter,
                                           "device_augment_spec", None)
        self._passthrough = not getattr(data_iter,
                                        "background_pull_safe", True)
        self._cond = threading.Condition()
        self._ring = []          # staged entries, delivery order
        self._pending = []
        self._closed = False
        self._stager = None
        self._live_epoch = -1
        self._start_epoch(reset_source=False)

    # -- staging (stager thread) ---------------------------------------
    def _copy_arrays(self, arrays):
        """Host arrays/tensors -> tensors on the device, in order; values
        already on the device pass through. On CUDA the host values are
        packed into one pinned slab and copied asynchronously on the
        current (side) stream; returns (tensors, slab or None)."""
        vals = [unwrap(a) for a in arrays]
        if not self._cuda:
            return [None if v is None else
                    (v.clone() if isinstance(v, torch.Tensor)
                     else torch.from_numpy(onp.array(v)))
                    for v in vals], None
        host = [v is not None and _is_host(v) for v in vals]
        sizes = []
        for v, h in zip(vals, host):
            n = 0
            if h:
                n = v.nbytes if isinstance(v, onp.ndarray) \
                    else v.numel() * v.element_size()
            sizes.append(-(-n // _ALIGN) * _ALIGN)
        slab = self._slabs.take(max(sum(sizes), _ALIGN)) \
            if any(host) else None
        out, off = [], 0
        for v, h, n in zip(vals, host, sizes):
            if v is None:
                out.append(None)
            elif not h:
                out.append(v.to(self._device))
            else:
                src = torch.from_numpy(onp.ascontiguousarray(v)) \
                    if isinstance(v, onp.ndarray) else v.contiguous()
                nb = src.numel() * src.element_size()
                view = slab[off:off + nb].view(src.dtype).view(src.shape)
                view.copy_(src)
                out.append(view.to(self._device, non_blocking=True))
            off += n
        return out, slab

    def _stage_batch(self, batch):
        """One host batch -> (staged batch, pinned slab)."""
        n_data = len(batch.data)
        labels = list(batch.label or [])
        staged, slab = self._copy_arrays(list(batch.data) + labels)
        from ..ndarray import NDArray
        data = [NDArray(t) for t in staged[:n_data]]
        label = [None if t is None else NDArray(t)
                 for t in staged[n_data:]] or None
        return DataBatch(data=data, label=label, pad=batch.pad,
                         index=batch.index), slab

    def _stage_block(self, batches):
        """K host batches -> one (K, B, ...) block per input, copied once
        and passed through the group's ``stage_stacked``; delivered as
        per-batch views carrying the staged dict."""
        from ..module.base_module import stack_group_inputs
        from ..ndarray import NDArray
        stacked = stack_group_inputs(batches, self._data_names,
                                     self._label_names)
        names = list(stacked)
        tensors, slab = self._copy_arrays([stacked[n] for n in names])
        staged = self._group_handle.stage_stacked(dict(zip(names, tensors)))
        out = []
        for j, b in enumerate(batches):
            data = [NDArray(staged[n][j]) for n in self._data_names
                    if n in staged]
            label = None
            if b.label:
                label = [NDArray(staged[n][j]) if n in staged
                         else b.label[i]
                         for i, n in enumerate(self._label_names)
                         if i < len(b.label)]
            view = DataBatch(data=data, label=label, pad=b.pad,
                             index=b.index)
            view._staged_block = staged
            view._staged_index = j
            view._staged_size = len(batches)
            out.append(view)
        return out, slab

    @staticmethod
    def _uniform_shapes(batches):
        """A block must stack; ragged shapes fall back to per-batch
        staging (fit's grouped loop flushes on the shape change)."""
        def sig(b):
            s = [tuple(d.shape) for d in b.data]
            for lb in (b.label or []):
                s.append(tuple(lb.shape) if lb is not None else None)
            return s

        first = sig(batches[0])
        return all(sig(b) == first for b in batches[1:])

    def _stage_entry(self):
        """Pull and stage the next ring entry: (list of delivered
        batches, the copies' event or None), or _END at epoch end."""
        from .. import telemetry
        if self._group:
            pulled = []
            for _ in range(self._group):
                try:
                    pulled.append(self._iter.next())
                except StopIteration:
                    break
            if not pulled:
                return _END
        else:
            try:
                pulled = [self._iter.next()]
            except StopIteration:
                return _END
        nbytes, dtype = _batch_wire_stats(pulled)
        t0 = time.perf_counter()
        slabs = []
        with telemetry.span("data.stage", k=len(pulled)):
            if self._group and self._group_handle is not None and \
                    self._uniform_shapes(pulled):
                staged, slab = self._stage_block(pulled)
                slabs.append(slab)
            else:
                staged = []
                for b in pulled:
                    s, slab = self._stage_batch(b)
                    staged.append(s)
                    slabs.append(slab)
            event = None
            if self._cuda:
                event = torch.cuda.Event()
                event.record(self._stream)
                for slab in slabs:
                    if slab is not None:
                        self._slabs.give(slab, event)
        rows = sum(b.data[0].shape[0] for b in staged)
        self.pipeline_stats.note_staged(rows, time.perf_counter() - t0,
                                        nbytes, dtype)
        return staged, event

    def _run_stager(self, epoch):
        if self._cuda:
            torch.cuda.set_device(self._device)
            if self._stream is None:
                self._stream = torch.cuda.Stream(self._device)
        while True:
            with self._cond:
                while not self._stop and len(self._ring) >= self._depth:
                    if not self._noted_full:
                        self._noted_full = True
                        self.pipeline_stats.note_ring_full()
                    self._cond.wait(0.05)
                if self._stop:
                    return
                self._noted_full = False
            try:
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        entry = self._stage_entry()
                else:
                    entry = self._stage_entry()
            except Exception as exc:  # noqa: BLE001 — re-raised in order
                entry = exc
            with self._cond:
                if self._stop or epoch != self._live_epoch:
                    return
                self._ring.append(entry)
                self.pipeline_stats.note_ring(len(self._ring))
                self._cond.notify_all()
                if entry is _END or isinstance(entry, BaseException):
                    return

    # -- epochs ----------------------------------------------------------
    def _start_epoch(self, reset_source):
        self._stop_stager()
        if reset_source:
            self._iter.reset()
        with self._cond:
            self._ring = []
            self._pending = []
            self._stop = False
            self._exhausted = False
            self._noted_full = False
            self._live_epoch += 1
        if not reset_source:
            # construction: pre-fill right away. After a reset() the
            # stager restarts lazily on the first next(), so a reset
            # consumes nothing from the source (the caller's iterator
            # leaves a prefetched fit in the state a plain fit leaves it)
            self._launch_stager()

    def _launch_stager(self):
        if self._stager is not None or self._passthrough:
            return
        with self._cond:
            epoch = self._live_epoch
        self._stager = threading.Thread(
            target=self._run_stager, args=(epoch,),
            name="mxtpu-device-stager", daemon=True)
        self._stager.start()

    def _stop_stager(self):
        stager = self._stager
        if stager is None:
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        stager.join()
        self._stager = None
        with self._cond:
            self._ring = []
            self._pending = []

    # -- DataIter surface ------------------------------------------------
    def _deliver(self, entry):
        """Order the consumer's stream after the entry's copies and tie
        the staged tensors' memory to that stream."""
        batches, event = entry
        if event is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(event)
            seen = set()
            for b in batches:
                for a in list(b.data) + list(b.label or []):
                    t = unwrap(a)
                    if isinstance(t, torch.Tensor) and t.is_cuda and \
                            id(t) not in seen:
                        seen.add(id(t))
                        t.record_stream(cur)
                for t in (getattr(b, "_staged_block", None) or {}).values():
                    if id(t) not in seen:
                        seen.add(id(t))
                        t.record_stream(cur)
        return batches

    def _next_passthrough(self):
        """Consumer-thread pull: one batch staged on the current stream,
        with the stats kept."""
        t0 = time.perf_counter()
        batch = self._iter.next()       # StopIteration ends the epoch
        nbytes, dtype = _batch_wire_stats([batch])
        t1 = time.perf_counter()
        staged, slab = self._stage_batch(batch)
        if slab is not None:
            event = torch.cuda.Event()
            event.record()
            self._slabs.give(slab, event)
        rows = staged.data[0].shape[0]
        self.pipeline_stats.note_staged(rows, time.perf_counter() - t1,
                                        nbytes, dtype)
        self.pipeline_stats.note_delivered(rows, t1 - t0)
        return staged

    def next(self):
        if self._closed:
            raise MXNetError("DeviceLoader is closed")
        if self._passthrough:
            return self._next_passthrough()
        if self._stager is None:
            self._launch_stager()
        if self._pending:
            batch = self._pending.pop(0)
            self.pipeline_stats.note_delivered(batch.data[0].shape[0], 0.0)
            return batch
        t0 = time.perf_counter()
        with self._cond:
            if self._exhausted:
                # the stager exited at epoch end (or after an error it
                # delivered): keep raising StopIteration until reset()
                raise StopIteration
            while not self._ring:
                if self._stop:
                    raise MXNetError("DeviceLoader was reset/closed "
                                     "while a next() was blocked")
                self._cond.wait(0.05)
            entry = self._ring.pop(0)
            if entry is _END or isinstance(entry, BaseException):
                self._exhausted = True
            self.pipeline_stats.note_ring(len(self._ring))
            self._cond.notify_all()
        wait = time.perf_counter() - t0
        if entry is _END:
            raise StopIteration
        if isinstance(entry, BaseException):
            raise entry
        batches = self._deliver(entry)
        self._pending = list(batches[1:])
        batch = batches[0]
        self.pipeline_stats.note_delivered(batch.data[0].shape[0], wait)
        return batch

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

    def _note_cache_stats(self):
        """Forward a CachedDataset source's resolved tier into the
        stats once it is built."""
        info_fn = getattr(self._iter, "cache_info", None)
        if info_fn is None:
            return
        info = info_fn()
        if info.get("tier"):
            self.pipeline_stats.note_cache(
                info["tier"], info.get("shard_bytes", info.get("bytes", 0)),
                info.get("rows", 0))

    def reset(self):
        """Rewind for a fresh epoch: stop and join the stager and reset
        the source; the stager restarts lazily on the next ``next()``.
        Repeatable; never delivers a stale pre-reset batch."""
        if self._closed:
            raise MXNetError("DeviceLoader is closed")
        self._start_epoch(reset_source=True)
        # a CachedDataset source builds its cache inside reset()
        self._note_cache_stats()

    def set_epoch(self, epoch):
        """Forward ``fit``'s epoch pin to the source. A no-op when the
        source is already at ``epoch`` (the prefilled ring stays valid);
        a real rebase stops the stager, rewinds the source (the dropped
        ring batches were already pulled), pins the epoch, and the stager
        restarts lazily."""
        if self._closed:
            raise MXNetError("DeviceLoader is closed")
        fwd = getattr(self._iter, "set_epoch", None)
        if fwd is None:
            return
        self._note_cache_stats()
        coord = getattr(self._iter, "epoch_coord", None)
        if coord is None:
            # a coordinate-less wrapper's pin is a no-op by contract
            fwd(epoch)
            return
        if coord == int(epoch):
            return
        self._stop_stager()
        self._iter.reset()
        fwd(epoch)
        with self._cond:
            self._ring = []
            self._pending = []
            self._stop = False
            self._exhausted = False
            self._noted_full = False
            self._live_epoch += 1

    # -- lifecycle -------------------------------------------------------
    def close(self):
        """Stop and join the stager thread, dropping the ring
        (idempotent). The source stays usable unless ``close_source``."""
        if self._closed:
            return
        self._closed = True
        self._stop_stager()
        if self._slabs is not None:
            self._slabs.clear()
        if self._owns_stats:
            self.pipeline_stats.release()
        if self._close_source:
            inner_close = getattr(self._iter, "close", None)
            if callable(inner_close):
                inner_close()

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
