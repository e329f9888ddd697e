"""CachedDataset — serve epochs >= 2 from a uint8 cache on the card
(PyTorch counterpart of ``mxnet_tpu/data/cached.py``).

The streaming path decodes (or at best host-gathers) every image every
epoch and pays a host->card copy per batch. A decoded u8 epoch is small
(CIFAR-10 ~150 MB; 512 ImageNet images at 224² ~77 MB) and its bytes
never change after the first epoch. CachedDataset captures the first full
epoch it streams (pad rows stripped), holds the decoded ``(N, H, W, C)``
uint8 block and its labels ON THE CARD, and serves every later epoch as a
gather on the card: a ``(B,)`` index is the only transfer. Augmentation
still varies per epoch: the :class:`DeviceAugment` draws are a pure
function of ``(seed, epoch, batch_index)``, so cached epochs train to the
same bits as streamed ones.

Memory is a declared budget (``budget_mb``, default
``MXNET_DATA_CACHE_BUDGET_MB``, 1024): the card when the block fits, else
the host tier (decoded once, gathered on the host, staged as u8), or pure
streaming with ``placement="off"``. Every tier logs where it placed the
cache, and ``cache_info()`` reports it. All three deliver bitwise-equal
batch streams.
"""
from __future__ import annotations

import logging
import os

import numpy as onp
import torch

from ..base import MXNetError
from ..context import current_context
from ..io import DataBatch, DataDesc, DataIter
from .augment import (as_host, crop_input_name, fold_seed,
                      mirror_input_name, _placement_default)

__all__ = ["CachedDataset", "global_shuffle_order"]

_PLACEMENTS = ("auto", "device", "host", "off")


def _budget_bytes(budget_mb):
    if budget_mb is None:
        budget_mb = float(os.environ.get("MXNET_DATA_CACHE_BUDGET_MB",
                                         "1024"))
    return int(float(budget_mb) * (1 << 20))


def global_shuffle_order(seed, epoch, rows):
    """The per-epoch global shuffle: a permutation of ``rows`` drawn from
    the ``(seed, epoch)`` coordinate by the SplitMix fold, a pure function
    of the coordinate (the JAX package's rule, bit for bit)."""
    rng = onp.random.RandomState(
        fold_seed(int(seed) ^ 0x5ca1ab1e, int(epoch), 0))
    return rng.permutation(int(rows))


class CachedDataset(DataIter):
    """Wrap a fixed-order u8 source; epoch 1 streams and captures, later
    epochs serve from the cache.

    Parameters
    ----------
    data_iter : DataIter
        Source delivering ONE image data entry per batch (the uint8 HWC
        block; a deferred-augment source's parameter entries are
        dropped and drawn anew) plus labels, in the same order every
        epoch. Per-epoch order belongs to this class (``shuffle=True``).
    augment : DeviceAugment, optional
        Spec attached to every delivered batch, draws keyed on ``(epoch,
        batch_index)`` as :class:`DeviceAugmentIter`'s; default: the
        source's ``device_augment_spec``.
    module : Module, optional
        When given, the cache lives on the device of the module's bound
        group (else on ``ctx``, default the current context).
    placement : str, optional
        ``"auto"`` (device if the block fits ``budget_mb``, else host),
        ``"device"``, ``"host"`` or ``"off"`` (streaming). Default:
        ``MXNET_DATA_CACHE_PLACEMENT``, else ``"auto"``.
    budget_mb : float, optional
        Device-cache budget; default ``MXNET_DATA_CACHE_BUDGET_MB``.
    shuffle, shuffle_from, seed : the cached epochs' row permutation
        (``global_shuffle_order``), applied from epoch ``shuffle_from``.
    augment_placement : ``"device"`` or ``"host"`` (``apply_host`` on the
        delivered rows).
    """

    def __init__(self, data_iter, augment=None, module=None,
                 data_name=None, placement=None, budget_mb=None,
                 shuffle=False, shuffle_from=1, seed=0,
                 augment_placement=None, logger=None, ctx=None):
        super().__init__(getattr(data_iter, "batch_size", 0))
        self._iter = data_iter
        self._name = data_name or data_iter.provide_data[0][0]
        if augment is None:
            src_spec = getattr(data_iter, "device_augment_spec", None)
            if src_spec:
                augment = src_spec.get(self._name)
        self._augment = augment
        self._module = module
        self._ctx = ctx
        n_src = len(data_iter.provide_data)
        n_ok = {1}
        if augment is not None:
            n_ok.add(1 + len(augment.param_descs(self._name,
                                                 self.batch_size)))
        if n_src not in n_ok:
            raise MXNetError(
                "CachedDataset caches ONE image data entry; the source "
                "provides %r — attach augment params via "
                "CachedDataset(augment=...), not on the source"
                % ([d[0] for d in data_iter.provide_data],))
        self.placement = (placement
                          or os.environ.get("MXNET_DATA_CACHE_PLACEMENT")
                          or "auto")
        if self.placement not in _PLACEMENTS:
            raise MXNetError("placement must be one of %r (got %r)"
                             % (_PLACEMENTS, self.placement))
        self._budget = _budget_bytes(budget_mb)
        self.shuffle = bool(shuffle)
        self.shuffle_from = int(shuffle_from)
        self.seed = int(seed)
        self.logger = logger or logging.getLogger(__name__)
        self.augment_placement = (augment_placement
                                  or _placement_default()) \
            if augment is not None else None

        b = self.batch_size
        if augment is not None and self.augment_placement == "device":
            self.provide_data = augment.data_descs(self._name, b)
            self.device_augment_spec = {self._name: augment}
        elif augment is not None:
            self.provide_data = [DataDesc(self._name,
                                          augment.model_shape(b))]
            self.device_augment_spec = {}
        else:
            self.provide_data = list(data_iter.provide_data)
            self.device_augment_spec = {}
        self.provide_label = data_iter.provide_label

        self._epoch = 0
        self._seq = 0
        self._pending = [] if self.placement != "off" else None
        self._epoch_complete = False
        self._cache_ready = False
        self._rows = 0
        self._images = None       # host u8 block (host tier only)
        self._labels = None       # label blocks: host (host tier) or card
        self._dev_images = None   # the u8 block on the card (device tier)
        self._device = None
        self._order = None
        self._order_epoch = None
        self.cache_placement = None     # resolved at finalize
        self.cache_built_epoch = None

    # -- epoch coordinate ----------------------------------------------
    @property
    def epoch_coord(self):
        return self._epoch

    def set_epoch(self, epoch):
        self._epoch = int(epoch)
        self._seq = 0
        self._order = None

    def reset(self):
        if not self._cache_ready:
            if self._epoch_complete and self._pending is not None:
                self._finalize()
            else:
                # partial epoch (or placement "off"): nothing usable was
                # captured; stream the next epoch from the source
                if self._pending is not None:
                    self._pending = []
                self._iter.reset()
        self._epoch += 1
        self._seq = 0
        self._order = None
        self._epoch_complete = False

    # -- capture -> cache ----------------------------------------------
    def _target_device(self):
        grp = getattr(self._module, "_exec_group", None)
        if grp is not None:
            return grp.contexts[0].torch_device()
        if self._module is not None:
            return self._module._context[0].torch_device()
        return (self._ctx or current_context()).torch_device()

    def _finalize(self):
        """One full epoch captured: place the cache on its tier."""
        imgs = onp.concatenate([e[0] for e in self._pending])
        labels = None
        if self._pending[0][1] is not None:
            labels = [onp.concatenate([e[1][i] for e in self._pending])
                      for i in range(len(self._pending[0][1]))]
        self._pending = []
        nbytes = imgs.nbytes + sum(l.nbytes for l in (labels or []))
        mb = nbytes / float(1 << 20)
        placement = self.placement
        if placement == "auto":
            placement = "device" if nbytes <= self._budget else "host"
            if placement == "host":
                self.logger.warning(
                    "CachedDataset: decoded epoch is %.1f MB > device "
                    "budget %.1f MB (MXNET_DATA_CACHE_BUDGET_MB) — "
                    "serving from the host-RAM cache instead",
                    mb, self._budget / (1 << 20))
        self._images, self._labels = imgs, labels
        self._rows = int(imgs.shape[0])
        self.cache_bytes = nbytes
        self.cache_built_epoch = self._epoch
        if placement == "device":
            try:
                dev = self._target_device()
                self._dev_images = torch.from_numpy(imgs).to(dev)
                self._labels = None if labels is None else \
                    [torch.from_numpy(l).to(dev) for l in labels]
                self._device = dev
                self._images = None
                self.logger.info(
                    "CachedDataset: %d rows, %.1f MB, cached on %s",
                    self._rows, mb, dev)
            except (RuntimeError, MXNetError) as exc:
                # out of memory on the card (or no card for this
                # context): the host tier serves the same bytes
                self.logger.warning(
                    "CachedDataset: device placement of the %.1f MB "
                    "cache failed (%s) — serving from the host-RAM "
                    "cache instead", mb, exc)
                self._dev_images, self._device = None, None
                self._labels = labels
                placement = "host"
        if placement == "host":
            self.logger.info("CachedDataset: %d rows, %.1f MB, cached in "
                             "host memory", self._rows, mb)
        self.cache_placement = placement
        self._cache_ready = True

    # -- delivery -------------------------------------------------------
    def _epoch_order(self):
        n = self._rows
        if not self.shuffle or self._epoch < self.shuffle_from:
            # the capture epoch (and any before shuffle_from) serves
            # capture order, so replaying it gives what it delivered
            return onp.arange(n)
        return global_shuffle_order(self.seed, self._epoch, n)

    def _attach(self, img, labels, pad):
        """One delivered batch: augment parameters attached (device
        placement) or the host reference applied (host placement),
        draws keyed on (epoch, seq) either way."""
        aug = self._augment
        if aug is None:
            self._seq += 1
            return DataBatch(data=[img], label=labels, pad=pad)
        # draws sized to the delivered rows, as DeviceAugmentIter's
        rows = int(img.shape[0])
        params = aug.draw(self._name, self._epoch, self._seq, rows)
        self._seq += 1
        if self.augment_placement == "device":
            data = [img] + [params[d.name] for d in
                            aug.param_descs(self._name, rows)]
        else:
            data = [aug.apply_host(
                img, params.get(crop_input_name(self._name)),
                params.get(mirror_input_name(self._name)), train=True)]
        return DataBatch(data=data, label=labels, pad=pad)

    @staticmethod
    def _host_batch(batch):
        """A streamed source batch as ``(img, labels, pad)`` in numpy."""
        img = as_host(batch.data[0])
        labels = None
        if batch.label:
            labels = [as_host(lb) for lb in batch.label]
        return img, labels, int(batch.pad or 0)

    def next(self):
        if self._cache_ready:
            return self._next_cached()
        try:
            batch = self._iter.next()
        except StopIteration:
            self._epoch_complete = True
            raise
        img, labels, pad = self._host_batch(batch)
        if self._pending is not None:
            self._capture_batch(img, labels, pad)
        return self._attach(img, labels, pad)

    def _strip_pad(self, img, labels, pad):
        """The real rows of a captured batch: pad rows are present only
        when the source wrapped the batch to full size; a short tail sets
        pad but holds real rows only."""
        keep = img.shape[0] - pad \
            if pad and img.shape[0] == self.batch_size \
            else img.shape[0]
        return img[:keep], \
            None if labels is None else [lb[:keep] for lb in labels]

    def _capture_batch(self, img, labels, pad):
        img, labels = self._strip_pad(img, labels, pad)
        self._pending.append(
            (img.copy(),
             None if labels is None else [lb.copy() for lb in labels]))

    def _next_cached(self):
        b = self.batch_size
        if self._order is None or self._order_epoch != self._epoch:
            self._order = self._epoch_order()
            self._order_epoch = self._epoch
        lo = self._seq * b
        if lo >= len(self._order):
            raise StopIteration
        idxs = self._order[lo:lo + b]
        pad = b - len(idxs)
        if pad > 0:
            # round-batch semantics: wrap the epoch head, report pad
            idxs = onp.concatenate([idxs, self._order[:pad]])
        idxs = onp.ascontiguousarray(idxs.astype(onp.int64))
        labels = None
        if self._dev_images is not None:
            idx = torch.from_numpy(idxs)
            if self._device.type == "cuda":
                idx = idx.pin_memory().to(self._device, non_blocking=True)
            img = torch.index_select(self._dev_images, 0, idx)
            if self._labels is not None:
                labels = [torch.index_select(lb, 0, idx)
                          for lb in self._labels]
        else:
            img = self._images[idxs]
            if self._labels is not None:
                labels = [lb[idxs] for lb in self._labels]
        return self._attach(img, labels, pad)

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

    # -- introspection --------------------------------------------------
    def cache_info(self):
        """Resolved cache state: ``placement`` (None until built: the
        tier, ``device`` or ``host``), ``tier`` (``hbm``/``host``, the JAX
        package's spelling), ``rows``, ``bytes``, ``built_epoch`` and
        ``device``."""
        tier = {"device": "hbm", "host": "host"}.get(self.cache_placement)
        return {
            "placement": self.cache_placement,
            "rows": self._rows,
            "bytes": getattr(self, "cache_bytes", 0),
            "built_epoch": self.cache_built_epoch,
            "tier": tier,
            "tiers": [tier] if tier else [],
            "shard_bytes": getattr(self, "cache_bytes", 0),
            "shard_rows": self._rows,
            "device": None if self._device is None else str(self._device),
        }

    def close(self):
        self._dev_images = None
        inner = getattr(self._iter, "close", None)
        if callable(inner):
            inner()
