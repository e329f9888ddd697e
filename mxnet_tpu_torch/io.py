"""Data batches and iterators (PyTorch counterpart of
``mxnet_tpu/io.py``: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``MNISTIter``, ``CSVIter``, ``ResizeIter`` and
``PrefetchingIter``; ``ImageRecordIter``, ``ImageIter`` and
``ImageRecordUInt8Iter`` are re-exported lazily from ``image.py``).

Batches stay on the host (CPU NDArrays); the executor group copies each
into its bound arrays on the card, or ``data.DeviceLoader`` stages them
there ahead of the step. ``NDArrayIter(shuffle=True)`` draws its order
from numpy's global generator, as the JAX package does, so one
``np.random.seed`` gives both packages the same batches.
"""
from __future__ import annotations

import collections
import gzip
import os
import struct
import threading

import numpy as onp

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "CSVIter", "ResizeIter", "PrefetchingIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """Name+shape (+dtype/layout) descriptor for a data source."""

    def __new__(cls, name, shape, dtype=onp.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        """The axis of ``N`` in ``layout`` (0 when there is none)."""
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        """DataDescs of (name, shape) pairs, with dtypes from ``types``."""
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch(object):
    """One mini-batch: lists of data/label NDArrays + pad/index."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter(object):
    """Base data iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Input as a list of (name, numpy array) pairs."""
    if data is None:
        if not allow_empty:
            raise ValueError("data is required")
        data = []
    if isinstance(data, (onp.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("data is required")
        if len(data) == 1:
            data = collections.OrderedDict([(default_name, data[0])])
        else:
            data = collections.OrderedDict(
                [("_%d_%s" % (i, default_name), d)
                 for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = collections.OrderedDict()
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out[k] = onp.asarray(v)
    return list(out.items())


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays in batches of ``batch_size`` rows.

    ``last_batch_handle``: ``"pad"`` fills the last batch from the start
    of the data and reports the filled rows in ``pad``; ``"discard"``
    drops the incomplete batch; ``"roll_over"`` carries it into the next
    epoch."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)

        self.idx = onp.arange(self.data[0][1].shape[0])
        if shuffle:
            onp.random.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]

        if last_batch_handle == "discard":
            new_n = self.data[0][1].shape[0] - \
                self.data[0][1].shape[0] % batch_size
            self.idx = self.idx[:new_n]

        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        """Rewind to the first batch, dropping any rolled-over rows."""
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % \
                self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise ValueError("DataIter needs reset.")
        if self.cursor + self.batch_size <= self.num_data:
            return [array(x[1][self.cursor:self.cursor + self.batch_size],
                          ctx=cpu(), dtype=x[1].dtype) for x in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [array(onp.concatenate((x[1][self.cursor:], x[1][:pad]),
                                      axis=0), ctx=cpu(), dtype=x[1].dtype)
                for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class MNISTIter(DataIter):
    """MNIST idx-format reader (plain or gzipped idx files): images
    scaled to [0, 1] as (n, 1, 28, 28), or (n, 784) with ``flat``;
    shuffled once with ``RandomState(seed)``; incomplete last batch
    dropped."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, **kwargs):
        super().__init__(batch_size)
        imgs = self._read_idx(image)
        labels = self._read_idx(label)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, imgs.shape[1],
                                imgs.shape[2])
        imgs = imgs.astype(onp.float32) / 255.0
        if shuffle:
            perm = onp.random.RandomState(seed).permutation(imgs.shape[0])
            imgs, labels = imgs[perm], labels[perm]
        self._iter = NDArrayIter(imgs, labels.astype(onp.float32),
                                 batch_size=batch_size,
                                 last_batch_handle="discard")
        self.provide_data = self._iter.provide_data
        self.provide_label = self._iter.provide_label

    @staticmethod
    def _read_idx(path):
        if not os.path.exists(path):
            if not os.path.exists(path + ".gz"):
                raise MXNetError("MNIST file %s not found" % path)
            path = path + ".gz"
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            data = onp.frombuffer(f.read(), dtype=onp.uint8)
        return data.reshape(dims)

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()

    def iter_next(self):
        return self._iter.iter_next()


class CSVIter(DataIter):
    """CSV reader: rows of ``data_csv`` reshaped to ``data_shape``, labels
    from ``label_csv`` (zeros without one); ``round_batch`` pads the last
    batch from the start, else it is dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = onp.loadtxt(data_csv, delimiter=",", dtype=onp.float32,
                           ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = onp.loadtxt(label_csv, delimiter=",", dtype=onp.float32,
                                ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[1:] == (1,):
                label = label.reshape(-1)
        else:
            label = onp.zeros((data.shape[0],), dtype=onp.float32)
        handle = "pad" if round_batch else "discard"
        self._iter = NDArrayIter(data, label, batch_size=batch_size,
                                 last_batch_handle=handle)
        self.provide_data = self._iter.provide_data
        self.provide_label = self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


class ResizeIter(DataIter):
    """Resize another iterator to ``size`` batches per epoch: it wraps
    around (resetting the inner iterator) when the inner one ends early,
    and stops after ``size`` batches when it runs longer."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def set_epoch(self, epoch):
        """Forward fit's epoch-coordinate pin to the wrapped iterator."""
        fwd = getattr(self.data_iter, "set_epoch", None)
        if fwd is not None:
            fwd(epoch)

    @property
    def epoch_coord(self):
        return getattr(self.data_iter, "epoch_coord", None)

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetcher over one or more iterators (their
    batches are joined: data lists, then label lists).

    ``close()`` (or the context-manager exit) stops and joins the worker
    threads; the wrapped iterators stay usable. ``reset()`` may be called
    repeatedly and while a prefetch is in flight: it waits for the fetch
    to land before the sources rewind (the pre-reset batch is dropped),
    so no worker reads a source mid-reset. For N ordered transform
    workers see ``data.TransformIter``; for batches staged on the card,
    ``data.DeviceLoader``."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        if self.n_iter == 0:
            raise ValueError("PrefetchingIter needs at least one iterator")
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = None
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                # a timed wait: a close() that lands between this
                # worker's data_taken.clear() and its next wait must not
                # strand it
                while not self.data_taken[i].wait(0.1):
                    if not self.started:
                        return
                if not self.started:
                    return
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i],
                             name="io-prefetch-%d" % i, daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def close(self):
        """Stop and join the prefetch workers (idempotent)."""
        if not getattr(self, "started", False):
            return
        self.started = False
        for e in self.data_taken:
            e.set()
        for thread in self.prefetch_threads:
            thread.join()

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

    def _renamed(self, renames, attr):
        if renames is None:
            return sum([getattr(i, attr) for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(r[x[0]], x[1])
                     for x in getattr(i, attr)]
                    for r, i in zip(renames, self.iters)], [])

    @property
    def provide_data(self):
        return self._renamed(self.rename_data, "provide_data")

    @property
    def provide_label(self):
        return self._renamed(self.rename_label, "provide_label")

    def _check_open(self):
        if not self.started:
            raise MXNetError("PrefetchingIter is closed")

    def _restart(self, fwds=None, epoch=None):
        """Wait for the in-flight prefetch, rewind every source (pinning
        ``epoch`` where ``fwds`` gives a pin), and start fetching anew."""
        for e in self.data_ready:
            e.wait()
        for k, i in enumerate(self.iters):
            i.reset()
            if fwds is not None and fwds[k] is not None:
                fwds[k](epoch)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def reset(self):
        """Rewind every source for a fresh epoch (safe to repeat)."""
        self._check_open()
        self._restart()

    def set_epoch(self, epoch):
        """Forward fit's epoch-coordinate pin to every source. Sources
        already at ``epoch``, and those without a coordinate (whose pin is
        a no-op), keep the prefetched batch; a real rebase drops it,
        rewinds every source and pins the new epoch."""
        self._check_open()
        fwds = [getattr(i, "set_epoch", None) for i in self.iters]
        if not any(fwds):
            return
        if all(fwd is None
               or getattr(i, "epoch_coord", None) in (None, int(epoch))
               for i, fwd in zip(self.iters, fwds)):
            # a source already AT the epoch is not re-pinned: its first
            # batch of the epoch is the one prefetched
            for i, fwd in zip(self.iters, fwds):
                if fwd is not None and \
                        getattr(i, "epoch_coord", None) is None:
                    fwd(epoch)
            return
        self._restart(fwds, epoch)

    @property
    def epoch_coord(self):
        """The sources' common epoch coordinate (None when mixed or none
        are pinnable)."""
        coords = {getattr(i, "epoch_coord", None) for i in self.iters}
        coords.discard(None)
        return coords.pop() if len(coords) == 1 else None

    def iter_next(self):
        self._check_open()
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            if any(b is not None for b in self.next_batch):
                raise MXNetError("Number of entry mismatches between "
                                 "iterators")
            return False
        if any(b is None or b.pad != self.next_batch[0].pad
               for b in self.next_batch):
            raise MXNetError("Number of entry mismatches between iterators")
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def __getattr__(name):
    """Lazy re-exports from ``image.py`` (``mx.io.ImageRecordIter``)."""
    if name in ("ImageRecordIter", "ImageIter", "ImageRecordUInt8Iter"):
        from . import image
        if name == "ImageRecordUInt8Iter":
            return image.ImageRecordIter
        return getattr(image, name)
    raise AttributeError("module 'mxnet_tpu_torch.io' has no attribute %r"
                         % name)
