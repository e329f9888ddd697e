"""Data batches and in-memory iterators (PyTorch counterpart of
``mxnet_tpu/io.py``: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter`` and ``MNISTIter``).

Batches stay on the host (CPU NDArrays); the executor group copies each
into its bound arrays on the card. ``NDArrayIter(shuffle=True)`` draws
its order from numpy's global generator, as the JAX package does, so one
``np.random.seed`` gives both packages the same batches.
"""
from __future__ import annotations

import collections
import gzip
import os
import struct

import numpy as onp

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter"]


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


class DataBatch(object):
    """One mini-batch: lists of data/label NDArrays + pad/index."""

    def __init__(self, data, label=None, pad=None, index=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index


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
