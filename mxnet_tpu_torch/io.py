"""Data batches (PyTorch counterpart of ``mxnet_tpu/io.py``, the part the
training step consumes: ``DataBatch``)."""
from __future__ import annotations

__all__ = ["DataBatch"]


class DataBatch(object):
    """One mini-batch: lists of data/label NDArrays + pad/index."""

    def __init__(self, data, label=None, pad=None, index=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
