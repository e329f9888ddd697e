"""Bucketed sentence iteration (PyTorch counterpart of
``mxnet_tpu/rnn/io.py``): ``encode_sentences`` maps tokens to ids, and
``BucketSentenceIter`` pads sentences into one dense matrix per length
bucket up front, shuffles at each reset (batch order with Python's
``random``, rows with numpy's global generator, as the JAX package) and
hands out host-side batches whose ``bucket_key`` tells a
``BucketingModule`` which bucket to run. Labels are the next token, the
last position padded with ``invalid_label``.
"""
from __future__ import annotations

import bisect
import logging
import random

import numpy as onp

from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray import array

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Token sequences as id sequences, and the vocabulary. With
    ``vocab=None`` one is built in first-seen order from ``start_label``,
    skipping ``invalid_label``; with a given vocab an unknown token
    raises."""
    building = vocab is None
    if building:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    encoded = []
    for sentence in sentences:
        ids = []
        for token in sentence:
            if token not in vocab:
                if not building:
                    raise ValueError("unknown token %r with a fixed vocab"
                                     % (token,))
                if next_id == invalid_label:
                    next_id += 1
                vocab[token] = next_id
                next_id += 1
            ids.append(vocab[token])
        encoded.append(ids)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Padded variable-length sequences grouped into length buckets; each
    batch carries ``bucket_key`` and next-token labels. Without
    ``buckets``, every length that fills at least one batch is one."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NTC"):
        super().__init__(batch_size)
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError(
                "layout %r: need batch-major ('NT...') or time-major "
                "('TN...')" % layout)
        if not buckets:
            counts = onp.bincount([len(s) for s in sentences])
            buckets = [length for length, c in enumerate(counts)
                       if c >= batch_size]
        self.buckets = sorted(buckets)
        self.default_bucket_key = max(self.buckets)

        rows = [[] for _ in self.buckets]
        dropped = 0
        for s in sentences:
            b = bisect.bisect_left(self.buckets, len(s))
            if b == len(self.buckets):
                dropped += 1
                continue
            rows[b].append(s)
        if dropped:
            logging.warning(
                "BucketSentenceIter: dropped %d sentences longer than the "
                "largest bucket (%d)", dropped, self.default_bucket_key)
        self.data = []
        for blen, sents in zip(self.buckets, rows):
            mat = onp.full((len(sents), blen), invalid_label, dtype=dtype)
            for r, s in enumerate(sents):
                mat[r, :len(s)] = s
            self.data.append(mat)

        bshape = (batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else (self.default_bucket_key, batch_size)
        self.provide_data = [DataDesc(data_name, bshape, layout=layout)]
        self.provide_label = [DataDesc(label_name, bshape, layout=layout)]
        # (bucket, first row) of every full batch
        self.idx = [(b, r) for b, mat in enumerate(self.data)
                    for r in range(0, len(mat) - batch_size + 1, batch_size)]
        self.curr_idx = 0
        self.labels = []
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        self.labels = []
        for mat in self.data:
            onp.random.shuffle(mat)
            lab = onp.roll(mat, -1, axis=1)
            lab[:, -1] = self.invalid_label
            self.labels.append(lab)

    def next(self):
        if self.curr_idx >= len(self.idx):
            raise StopIteration
        b, r = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.data[b][r:r + self.batch_size]
        label = self.labels[b][r:r + self.batch_size]
        if self.major_axis == 1:
            data, label = data.T, label.T
        data = array(data, ctx=cpu(), dtype=self.dtype)
        label = array(label, ctx=cpu(), dtype=self.dtype)
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[b],
            provide_data=[DataDesc(self.data_name, data.shape)],
            provide_label=[DataDesc(self.label_name, label.shape)])
