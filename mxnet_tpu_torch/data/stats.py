"""PipelineStats — one shared counter block for the device-feed pipeline
(PyTorch counterpart of ``mxnet_tpu/data/stats.py``), drained as an
immutable snapshot.

The numbers say whether the input path or the card paced a run, without
a readback anywhere: they are host clocks and counters, updated by the
stager and transform threads and read by ``Speedometer``, ``fit`` and
``chip_smoke.py``. Each instance is a view over the shared
:class:`mxnet_tpu_torch.telemetry.MetricsRegistry` under a ``data.<i>.*``
scope, so the Prometheus endpoint and the JSONL flush export pipeline
health too. ``Module.fit`` publishes the loader it trains through as
``telemetry.set_active_pipeline(...)``; ``Speedometer`` and the epoch log
read host-wait from there.
"""
from __future__ import annotations

from .. import telemetry

__all__ = ["PipelineStats"]


class PipelineStats:
    """Thread-safe counters for a :class:`DeviceLoader` (and the
    :class:`TransformIter` feeding it).

    Snapshot fields (``snapshot()``):

    * ``batches_delivered`` / ``images_delivered`` — batches/rows handed
      to the consumer so far.
    * ``host_wait_ms`` — cumulative wall time the CONSUMER spent blocked
      in ``next()`` waiting for the ring to produce a batch.  Zero means
      the device step fully hides the input path; a large fraction of
      the epoch means the pipeline is input-bound.
    * ``host_wait_ms_per_step`` — ``host_wait_ms / batches_delivered``.
    * ``stage_ms`` — cumulative time the stager spent pulling, packing
      and enqueueing the host→card copies (overlapped with compute, so
      this is throughput accounting, not a stall).
    * ``stager_img_per_sec`` — staging throughput over the stager's
      active time.
    * ``ring_depth`` / ``ring_occupancy`` / ``ring_high_water`` — the
      configured bound, the current fill, and the maximum fill ever
      observed (the bound holding is the backpressure contract).
    * ``ring_full_waits`` — times the stager blocked on a full ring
      (a healthy overlapped pipeline blocks here, not in ``next()``).
    """

    def __init__(self, ring_depth=0, scope=None):
        self.scope = scope or telemetry.registry().unique_scope("data")
        c = self.scope.counter
        self._c_batches_delivered = c("batches_delivered")
        self._c_images_delivered = c("images_delivered")
        self._c_host_wait_ms = c("host_wait_ms")
        self._c_stage_ms = c("stage_ms")
        self._c_images_staged = c("images_staged")
        self._c_batches_staged = c("batches_staged")
        self._c_bytes_staged = c("bytes_staged")
        self._c_ring_full_waits = c("ring_full_waits")
        # wire-format attribution: what dtype actually crossed the
        # transport and where the augment stage ran — plain attrs, not
        # registry instruments (strings; exported through snapshot())
        self.staged_dtype = None
        self.augment_placement = None
        # dataset-cache attribution (a CachedDataset feeding this
        # pipeline): the resolved serving tier plus its byte/row
        # accounting
        self.cache_tier = None
        self._g_cache_shard_bytes = self.scope.gauge("cache_shard_bytes")
        self._g_cache_global_rows = self.scope.gauge("cache_global_rows")
        self._g_ring_depth = self.scope.gauge("ring_depth")
        self._g_ring_occupancy = self.scope.gauge("ring_occupancy")
        self._g_ring_high_water = self.scope.gauge("ring_high_water")
        self.ring_depth = int(ring_depth)
        self.reset()

    # registry-backed field reads (keeps the historical attribute
    # surface: tests and the fit loop read these directly)
    batches_delivered = telemetry.instrument_value("_c_batches_delivered")
    images_delivered = telemetry.instrument_value("_c_images_delivered")
    host_wait_ms = telemetry.instrument_value("_c_host_wait_ms")
    stage_ms = telemetry.instrument_value("_c_stage_ms")
    images_staged = telemetry.instrument_value("_c_images_staged")
    batches_staged = telemetry.instrument_value("_c_batches_staged")
    bytes_staged = telemetry.instrument_value("_c_bytes_staged")
    ring_full_waits = telemetry.instrument_value("_c_ring_full_waits")
    ring_occupancy = telemetry.instrument_value("_g_ring_occupancy")
    ring_high_water = telemetry.instrument_value("_g_ring_high_water")
    cache_shard_bytes = telemetry.instrument_value("_g_cache_shard_bytes")
    cache_global_rows = telemetry.instrument_value("_g_cache_global_rows")

    @property
    def ring_depth(self):
        return int(self._g_ring_depth.value)

    @ring_depth.setter
    def ring_depth(self, depth):
        self._g_ring_depth.set(int(depth))

    def release(self):
        """Drop this instance's ``data.<i>`` scope from the shared
        registry (the counters keep working locally). A DeviceLoader
        that created its own stats releases them on ``close()`` — a
        fit-per-call workload would otherwise grow the registry and
        every ``/metrics`` scrape without bound."""
        self.scope.release()

    def reset(self):
        depth = self.ring_depth
        for inst in (self._c_batches_delivered, self._c_images_delivered,
                     self._c_host_wait_ms, self._c_stage_ms,
                     self._c_images_staged, self._c_batches_staged,
                     self._c_bytes_staged, self._c_ring_full_waits,
                     self._g_ring_occupancy, self._g_ring_high_water,
                     self._g_cache_shard_bytes,
                     self._g_cache_global_rows):
            inst.reset()
        self._g_ring_depth.set(depth)

    # -- producer side -------------------------------------------------
    def note_staged(self, rows, seconds, nbytes=0, dtype=None):
        self._c_batches_staged.add()
        self._c_images_staged.add(int(rows))
        self._c_stage_ms.add(seconds * 1000.0)
        if nbytes:
            self._c_bytes_staged.add(int(nbytes))
        if dtype is not None:
            self.staged_dtype = str(dtype)

    def note_ring(self, occupancy):
        occupancy = int(occupancy)
        self._g_ring_occupancy.set(occupancy)
        if occupancy > self.ring_high_water:
            self._g_ring_high_water.set(occupancy)

    def note_ring_full(self):
        self._c_ring_full_waits.add()

    def note_cache(self, tier, shard_bytes, global_rows):
        """Record the dataset cache feeding this pipeline: resolved
        serving tier plus per-shard bytes / global rows (DeviceLoader
        forwards ``cache_info()`` here once the cache finalizes)."""
        self.cache_tier = str(tier) if tier else None
        self._g_cache_shard_bytes.set(int(shard_bytes or 0))
        self._g_cache_global_rows.set(int(global_rows or 0))

    # -- consumer side -------------------------------------------------
    def note_delivered(self, rows, wait_seconds):
        self._c_batches_delivered.add()
        self._c_images_delivered.add(int(rows))
        self._c_host_wait_ms.add(wait_seconds * 1000.0)

    # -- reading -------------------------------------------------------
    def snapshot(self):
        """Immutable dict of the counters (fields: the class
        docstring)."""
        batches = self.batches_delivered
        host_wait = self.host_wait_ms
        stage_ms = self.stage_ms
        per_step = host_wait / batches if batches else 0.0
        stager_rate = (self.images_staged / (stage_ms / 1000.0)
                       if stage_ms > 0 else 0.0)
        staged_batches = self.batches_staged
        staged_bytes = self.bytes_staged
        return {
            "batches_delivered": batches,
            "images_delivered": self.images_delivered,
            "host_wait_ms": round(host_wait, 3),
            "host_wait_ms_per_step": round(per_step, 3),
            "stage_ms": round(stage_ms, 3),
            "stager_img_per_sec": round(stager_rate, 2),
            "ring_depth": self.ring_depth,
            "ring_occupancy": self.ring_occupancy,
            "ring_high_water": self.ring_high_water,
            "ring_full_waits": self.ring_full_waits,
            "staged_bytes": staged_bytes,
            "staged_bytes_per_batch": round(
                staged_bytes / staged_batches, 1) if staged_batches
            else 0.0,
            "staged_dtype": self.staged_dtype,
            "augment_placement": self.augment_placement,
            "cache_tier": self.cache_tier,
            "cache_shard_bytes": self.cache_shard_bytes,
            "cache_global_rows": self.cache_global_rows,
        }

    def __repr__(self):
        return "PipelineStats(%r)" % (self.snapshot(),)
