"""mxnet_tpu_torch.data — the device-feed pipeline (PyTorch counterpart of
``mxnet_tpu/data``).

* :class:`TransformIter` — N ordered transform workers over any
  ``DataIter``, seeded per batch from ``(seed, epoch, batch_index)``: the
  delivered stream is bitwise identical at 1, 2 or 4 workers.
* :class:`DeviceLoader` — a bounded ring (depth 2-3) of batches already
  on the card, staged by a background thread through pinned slabs on a
  side CUDA stream while the step runs; ``(K, B, ...)`` blocks through
  the executor group's ``stage_stacked`` for ``fit(batch_group=K)``.
* :class:`PipelineStats` — host-wait ms a step, ring occupancy, staged
  bytes and dtype, augment placement and cache tier.
* :class:`DeviceAugment` / :class:`DeviceAugmentIter` — the u8 wire
  path: uint8 NHWC batches (4x fewer bytes than float32 NCHW) with crop,
  mirror and normalize run on the card at staging, draws keyed
  ``(seed, epoch, batch)``; the host placement trains to the same bits.
* :class:`CachedDataset` — the decoded u8 epoch held on the card: epochs
  after the first are served by a gather on the card, bit-identical to
  streaming, with a budgeted host fallback.

* :class:`ShardedCachedDataset` — the cache sharded over the dp world
  (virtual hosts, or the ranks of a process group): each shard holds its
  row block only, with an ``hbm`` -> ``host`` -> ``recordio`` budget
  ladder and a global shuffle that no width enters.

``Module.fit(prefetch_to_device=2)`` trains to parameters bit-equal to an
unprefetched ``fit``.
"""
from __future__ import annotations

from .augment import DeviceAugment, DeviceAugmentIter, fold_seed
from .cached import CachedDataset, global_shuffle_order
from .loader import DeviceLoader
from .sharded_cache import ShardedCachedDataset, cache_row_of_pos
from .stats import PipelineStats
from .transform import TransformIter

__all__ = ["DeviceLoader", "TransformIter", "PipelineStats",
           "DeviceAugment", "DeviceAugmentIter", "CachedDataset",
           "global_shuffle_order", "fold_seed", "ShardedCachedDataset",
           "cache_row_of_pos"]
