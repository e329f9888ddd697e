"""ShardedCachedDataset — the dataset cache sharded over the dp world
(PyTorch counterpart of ``mxnet_tpu/data/sharded_cache.py``).

:class:`CachedDataset` is single-host: at dp=N every process would
capture the whole decoded epoch. This class shards the capture with the
:func:`~mxnet_tpu_torch.dist.shard_rows` rule: each shard keeps only its
row block of every streamed batch, in host-major cache row order
(:func:`cache_row_of_pos` maps a stream position to its cache row), and
the per-batch transfer stays a ``(B,)`` index. Three worlds:

* virtual (``cluster=``, a :class:`~mxnet_tpu_torch.dist.VirtualCluster`):
  one process simulates the hosts; each host's shard is captured and
  accounted on its own, and the device cache is assembled on the one
  device from the hosts' blocks (``dist.staging.assemble_host_slices``);
  batches are the global batches;
* one process: one shard;
* a live process group of R ranks: each rank holds only its own block
  and delivers its row block of every global batch (``provide_data`` is
  global, ``local_provide_data`` the rank's). A batch's rows may sit in
  any rank's shard: each rank writes the rows it holds into a zero
  global batch on its device and one SUM all-reduce completes it, then
  the rank takes its block.

**Spill tiers**, resolved per shard at finalize under one budget ladder
(``MXNET_DATA_CACHE_BUDGET_MB`` -> ``MXNET_DATA_CACHE_HOST_BUDGET_MB`` ->
nothing): ``hbm`` (the block on the device, gathered there), ``host``
(the block in host RAM, gathered on the host) and ``recordio`` (nothing
retained: every epoch re-streams the source, and global shuffle is
unavailable: capture order, with a warning). One spilled shard moves the
whole cache to the worst tier (the serving tier); each shard's own tier
is recorded in ``cache_info()`` and in the ``data.cache_tier_*`` gauges.

**dp-stable global shuffle**: the order of a cached epoch is
:func:`~mxnet_tpu_torch.data.global_shuffle_order`, a pure function of
``(seed, epoch)``; neither the dp width nor the shard count enters it, so
a resume at another width re-draws the same global order. A cache built
at an epoch >= ``shuffle_from`` ingests its source eagerly first.
"""
from __future__ import annotations

import os

import numpy as onp
import torch

from ..base import MXNetError
from .cached import CachedDataset, _budget_bytes, global_shuffle_order

__all__ = ["ShardedCachedDataset", "cache_row_of_pos"]

_TIERS = ("auto", "hbm", "host", "recordio")
_TIER_RANK = {"hbm": 0, "host": 1, "recordio": 2}


def cache_row_of_pos(counts, num_shards, rows_per_shard_padded=None):
    """Map a global STREAM position to its cache row in the sharded
    layout: shard h's block is the concatenation, over captured batches
    k, of batch k's h-th row sub-block, so position p (batch k, offset o)
    sits at ``h * rows_per_shard + cum_m[k] + o % m_k`` with
    ``h = o // m_k``, ``m_k = counts[k] / num_shards`` (the JAX package's
    mapping, integer for integer)."""
    counts = [int(c) for c in counts]
    R = int(num_shards)
    total = sum(counts)
    for k, c in enumerate(counts):
        if c % R:
            raise MXNetError(
                "captured batch %d has %d rows, not divisible over %d "
                "shards (the shard_rows rule)" % (k, c, R))
    rps = total // R
    rps_pad = int(rows_per_shard_padded) if rows_per_shard_padded \
        else rps
    row_of_pos = onp.empty(total, onp.int64)
    base = cum = 0
    for c in counts:
        m = c // R
        o = onp.arange(c)
        row_of_pos[base:base + c] = (o // m) * rps_pad + cum + (o % m)
        base += c
        cum += m
    return row_of_pos


class ShardedCachedDataset(CachedDataset):
    """Epoch cache sharded over the dp world, over a fixed-order
    global-batch source.

    Parameters (beyond :class:`CachedDataset`'s)
    --------------------------------------------
    cluster : VirtualCluster, optional
        Virtual-host mode (module docstring). Without one: one shard
        alone, one shard a rank under a live process group.
    budget_mb : float or sequence, optional
        Per-shard device budget (``MXNET_DATA_CACHE_BUDGET_MB``); a
        sequence gives each shard its own.
    host_budget_mb : float or sequence, optional
        Per-shard host-RAM budget (``MXNET_DATA_CACHE_HOST_BUDGET_MB``,
        default 16384); a shard over it resolves ``recordio``.
    tier : str, optional
        Force ``hbm``, ``host`` or ``recordio`` for every shard
        (``MXNET_DATA_CACHE_TIER``, default ``auto``).
    """

    def __init__(self, data_iter, cluster=None, augment=None, module=None,
                 data_name=None, budget_mb=None, host_budget_mb=None,
                 tier=None, shuffle=False, shuffle_from=1, seed=0,
                 augment_placement=None, logger=None, ctx=None):
        super().__init__(
            data_iter, augment=augment, module=module, data_name=data_name,
            placement="auto",
            budget_mb=budget_mb if not isinstance(budget_mb, (list, tuple))
            else None,
            shuffle=shuffle, shuffle_from=shuffle_from, seed=seed,
            augment_placement=augment_placement, logger=logger,
            ctx=ctx if cluster is None else cluster.context)
        self._cluster = cluster
        self._rt = None
        self.rank = 0
        if cluster is not None:
            self.num_shards = int(cluster.n_hosts)
            self._virtual = True
        else:
            from ..dist.runtime import dp_runtime
            self._virtual = False
            self._rt = dp_runtime()
            if self._rt is not None:
                self.rank, self.num_shards = self._rt.rank, self._rt.size
            else:
                self.num_shards = 1
        self._multi = not self._virtual and self.num_shards > 1
        if self.batch_size % self.num_shards:
            raise MXNetError("global batch %d does not divide over %d "
                             "shards" % (self.batch_size, self.num_shards))
        if self._multi:
            from ..dist.sharded_iter import _local_descs
            self.local_provide_data = _local_descs(self.provide_data,
                                                   self.num_shards)
            self.local_provide_label = _local_descs(self.provide_label,
                                                    self.num_shards)
        self._dev_budgets = self._per_shard(budget_mb, _budget_bytes,
                                            "budget_mb")
        self._host_budgets = self._per_shard(
            host_budget_mb,
            lambda v: int(float(
                v if v is not None else os.environ.get(
                    "MXNET_DATA_CACHE_HOST_BUDGET_MB", "16384"))
                * (1 << 20)),
            "host_budget_mb")
        self.tier = (tier or os.environ.get("MXNET_DATA_CACHE_TIER")
                     or "auto")
        if self.tier not in _TIERS:
            raise MXNetError("tier must be one of %r (got %r)"
                             % (_TIERS, self.tier))
        self._serving_tier = None
        self._shard_tiers = None
        self._dev_cache = None      # device leaves (image block, labels)
        self._host_cache = None     # host (numpy) leaves
        self._cap_counts = []       # global per-batch row counts
        self._cap_row_nbytes = None
        self._row_of_pos = None
        self._rows_per_shard = 0
        self.cache_shard_bytes = 0
        self._shuffle_warned = False

    def _per_shard(self, value, to_bytes, name):
        if isinstance(value, (list, tuple)):
            if len(value) != self.num_shards:
                raise MXNetError("%s has %d entries for %d shards"
                                 % (name, len(value), self.num_shards))
            return [to_bytes(v) for v in value]
        return [to_bytes(value)] * self.num_shards

    # -- delivery of one batch -------------------------------------------
    def _deliver(self, img, labels, pad):
        """The delivered batch: the global one, or, under a process
        group, this rank's row block of it (augment draws are made for
        the global batch first, so every rank's rows carry the draws a
        one-process run gives them)."""
        batch = self._attach(img, labels, pad)
        if not self._multi:
            return batch
        from ..dist.sharded_iter import rank_batch
        return rank_batch(batch, self.rank, self.num_shards)

    # -- capture ----------------------------------------------------------
    def _capture_batch(self, img, labels, pad):
        img, labels = self._strip_pad(img, labels, pad)
        rows = int(img.shape[0])
        if rows % self.num_shards:
            raise MXNetError(
                "streamed batch of %d rows does not divide over %d shards "
                "(the sharded cache needs every captured batch to split "
                "evenly: the shard_rows rule)" % (rows, self.num_shards))
        self._cap_counts.append(rows)
        if self._cap_row_nbytes is None and rows:
            self._cap_row_nbytes = int(img.nbytes) // rows + sum(
                int(lb.nbytes) // rows for lb in (labels or []))
        if self.tier == "recordio":
            return      # the re-stream tier retains nothing
        if self._multi:
            from ..dist.sharded_iter import shard_rows
            img = shard_rows(img, self.rank, self.num_shards)
            labels = None if labels is None else \
                [shard_rows(lb, self.rank, self.num_shards)
                 for lb in labels]
        self._pending.append(
            (onp.ascontiguousarray(img),
             None if labels is None else
             [onp.ascontiguousarray(lb) for lb in labels]))

    def _prefill(self):
        """Eager ingest before a shuffled epoch's first batch."""
        while True:
            try:
                batch = self._iter.next()
            except StopIteration:
                break
            img, labels, pad = self._host_batch(batch)
            self._capture_batch(img, labels, pad)
        self._epoch_complete = True
        self._finalize()
        if self._serving_tier == "recordio":
            self._iter.reset()

    def next(self):
        if not self._cache_ready and self.shuffle \
                and self._epoch >= self.shuffle_from:
            self._prefill()
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
        return self._deliver(img, labels, pad)

    # -- finalize -----------------------------------------------------------
    def _finalize(self):
        counts = list(self._cap_counts)
        if not counts or not sum(counts):
            raise MXNetError("sharded cache captured no rows: the source "
                             "must deliver at least one batch")
        total = sum(counts)
        self._rows = int(total)
        rps = total // self.num_shards
        self._rows_per_shard = rps
        self._row_of_pos = cache_row_of_pos(counts, self.num_shards)
        row_bytes = int(self._cap_row_nbytes or 0)
        self.cache_bytes = total * row_bytes
        self.cache_shard_bytes = rps * row_bytes
        self.cache_built_epoch = self._epoch
        self._shard_tiers = [self._resolve_tier(h)
                             for h in range(self.num_shards)]
        self._serving_tier = max(self._shard_tiers,
                                 key=lambda t: _TIER_RANK[t])
        if self._serving_tier != "hbm":
            spilled = [h for h, t in enumerate(self._shard_tiers)
                       if t != "hbm"]
            self.logger.warning(
                "ShardedCachedDataset: shard(s) %s spilled off the device "
                "(%.1f MB/shard vs per-shard budgets): serving tier is %r "
                "for the whole cache", spilled,
                self.cache_shard_bytes / (1 << 20), self._serving_tier)
        leaves = None
        if self._serving_tier != "recordio" and self._pending:
            leaves = self._collect_leaves(counts)
        self._pending = []
        if self._serving_tier == "hbm":
            try:
                self._place_device(leaves)
            except (RuntimeError, MXNetError) as exc:
                self.logger.warning(
                    "ShardedCachedDataset: device placement failed (%s): "
                    "serving from host RAM", exc)
                self._dev_cache = None
                self._serving_tier = "host"
                self._shard_tiers = ["host"] * self.num_shards
        if self._serving_tier == "host":
            self._host_cache = [onp.concatenate(leaf)
                                if isinstance(leaf, list) else leaf
                                for leaf in leaves]
        if self._serving_tier == "recordio":
            self._warn_no_shuffle()
            self._host_cache = None
        self.cache_placement = {"hbm": "device", "host": "host",
                                "recordio": "off"}[self._serving_tier]
        self._cache_ready = True
        self._publish_telemetry()
        self.logger.info(
            "ShardedCachedDataset: %d rows cached across %d shard(s) "
            "(%.1f MB/shard, tier=%s)", total, self.num_shards,
            self.cache_shard_bytes / (1 << 20), self._serving_tier)

    def _warn_no_shuffle(self):
        if self.shuffle and not self._shuffle_warned:
            self._shuffle_warned = True
            self.logger.warning(
                "ShardedCachedDataset: the recordio tier re-streams the "
                "source every epoch and has no random access: global "
                "shuffle is unavailable; delivering capture order")

    def _collect_leaves(self, counts):
        """Per leaf (image block, then labels): the shards' blocks in
        host-major order, a list of per-shard arrays in virtual mode, the
        one array of this process's shard(s) otherwise."""
        n_labels = 0 if self._pending[0][1] is None \
            else len(self._pending[0][1])
        leaves = []
        for li in range(1 + n_labels):
            def leaf_of(entry):
                return entry[0] if li == 0 else entry[1][li - 1]

            if not self._virtual:
                leaves.append(onp.concatenate(
                    [leaf_of(e) for e in self._pending]))
                continue
            blocks = []
            for h in range(self.num_shards):
                parts = []
                for k, e in enumerate(self._pending):
                    m = counts[k] // self.num_shards
                    parts.append(leaf_of(e)[h * m:(h + 1) * m])
                blocks.append(onp.concatenate(parts))
            leaves.append(blocks)
        return leaves

    def _resolve_tier(self, shard):
        if self.tier != "auto":
            return self.tier
        if self.cache_shard_bytes <= self._dev_budgets[shard]:
            return "hbm"
        if self.cache_shard_bytes <= self._host_budgets[shard]:
            return "host"
        return "recordio"

    def _cache_device(self):
        if self._rt is not None and self._module is None:
            return self._rt.device
        return self._target_device()

    def _place_device(self, leaves):
        from ..dist.staging import assemble_host_slices
        dev = self._cache_device()
        placed = []
        for leaf in leaves:
            if isinstance(leaf, list):
                placed.append(assemble_host_slices(leaf, dev))
            else:
                placed.append(torch.from_numpy(leaf).to(dev))
        self._dev_cache = tuple(placed)

    def _publish_telemetry(self):
        from .. import telemetry
        reg = telemetry.registry()
        for t in ("hbm", "host", "recordio"):
            reg.gauge("data.cache_tier_%s" % t).set(
                sum(1 for s in self._shard_tiers if s == t))
        reg.gauge("data.cache_shard_bytes").set(self.cache_shard_bytes)
        reg.gauge("data.cache_global_rows").set(self._rows)

    # -- delivery -----------------------------------------------------------
    def epoch_positions(self, epoch):
        """The delivered GLOBAL sample order of ``epoch`` as capture
        positions: a pure function of ``(seed, epoch)`` at any width."""
        if not self._cache_ready:
            raise MXNetError("cache not built yet")
        if not self.shuffle or epoch < self.shuffle_from \
                or self._serving_tier == "recordio":
            return onp.arange(self._rows)
        return global_shuffle_order(self.seed, epoch, self._rows)

    def _gather(self, idx):
        """The cache rows ``idx`` (global cache row numbers) as leaves:
        from the one cache, or, under a process group, completed by one
        all-reduce of the rows each rank holds."""
        if not self._multi:
            if self._dev_cache is not None:
                t = torch.from_numpy(idx)
                dev = self._dev_cache[0].device
                if dev.type == "cuda":
                    t = t.pin_memory().to(dev, non_blocking=True)
                return [torch.index_select(c, 0, t) for c in self._dev_cache]
            return [leaf[idx] for leaf in self._host_cache]
        rps = self._rows_per_shard
        mine = onp.nonzero(idx // rps == self.rank)[0]
        local = idx[mine] - self.rank * rps
        dev = self._rt.device
        out = []
        for li in range(len(self._dev_cache if self._dev_cache is not None
                            else self._host_cache)):
            if self._dev_cache is not None:
                src = self._dev_cache[li]
                rows = torch.index_select(src, 0, torch.from_numpy(
                    local).to(src.device))
            else:
                rows = torch.from_numpy(
                    onp.ascontiguousarray(self._host_cache[li][local]))
            buf = torch.zeros((len(idx),) + tuple(rows.shape[1:]),
                              dtype=rows.dtype, device=dev)
            buf[torch.from_numpy(mine).to(dev)] = rows.to(dev)
            out.append(self._rt.allreduce_(buf))
        return out

    def _next_cached(self):
        if self._serving_tier == "recordio":
            batch = self._iter.next()   # StopIteration ends the epoch
            img, labels, pad = self._host_batch(batch)
            return self._deliver(img, labels, pad)
        b = self.batch_size
        if self._order is None or self._order_epoch != self._epoch:
            self._order = self.epoch_positions(self._epoch)
            self._order_epoch = self._epoch
        lo = self._seq * b
        if lo >= len(self._order):
            raise StopIteration
        pos = self._order[lo:lo + b]
        pad = b - len(pos)
        if pad > 0:
            pos = onp.concatenate([pos, self._order[:pad]])
        idx = onp.ascontiguousarray(self._row_of_pos[pos].astype(onp.int64))
        leaves = self._gather(idx)
        labels = list(leaves[1:]) if len(leaves) > 1 else None
        return self._deliver(leaves[0], labels, pad)

    def _epoch_batches(self):
        return -(-self._rows // self.batch_size)

    def skip_batches(self, n):
        """Advance the stream by ``n`` batches without gathering them
        (fit's mid-epoch resume). Returns the number skipped."""
        n = int(n)
        if not self._cache_ready and self.shuffle \
                and self._epoch >= self.shuffle_from:
            self._prefill()
        if self._cache_ready and self._serving_tier != "recordio":
            done = min(n, max(0, self._epoch_batches() - self._seq))
            self._seq += done
            return done
        done = 0
        for _ in range(n):
            try:
                self.next()
            except StopIteration:
                break
            done += 1
        return done

    def reset(self):
        super().reset()
        if not self._cache_ready:
            # a partial capture was dropped: so is its accounting
            self._cap_counts = []
            self._cap_row_nbytes = None
        elif self._serving_tier == "recordio":
            self._iter.reset()

    # -- introspection --------------------------------------------------
    def cache_info(self):
        """Resolved cache state: serving ``tier``, per-shard ``tiers``,
        ``shard_rows``/``shard_bytes``, global ``rows``/``bytes``,
        ``num_shards``, ``built_epoch`` and ``placement``."""
        return {
            "tier": self._serving_tier,
            "tiers": list(self._shard_tiers or []),
            "placement": self.cache_placement,
            "rows": self._rows,
            "bytes": getattr(self, "cache_bytes", 0),
            "shard_rows": self._rows_per_shard,
            "shard_bytes": self.cache_shard_bytes,
            "num_shards": self.num_shards,
            "built_epoch": self.cache_built_epoch,
        }

    def close(self):
        self._dev_cache = None
        self._host_cache = None
        super().close()
