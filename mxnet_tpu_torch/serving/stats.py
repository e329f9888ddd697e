"""Serving observability: counters, gauges, latency percentiles, and
per-request phase traces (the port's copy of
``mxnet_tpu/serving/stats.py``).

One :class:`ServingStats` instance is shared by a ``Predictor`` and any
``DynamicBatcher`` built on it, so ``stats()`` is a single coherent
snapshot of the serving stack: request outcomes, device-launch batch
fill, queue depth, and the compile counter that pins the "zero
compiles after warmup" contract. In the port a "compile" is the first
forward of a bucket's module (where cuDNN picks its algorithms for the
bucket's shapes and the caching allocator grows) or, with the persistent
executable cache, the ``torch.export`` trace of the bucket's program; a
program loaded from the cache compiles nothing.

ServingStats is a **view over the shared**
:class:`mxnet_tpu_torch.telemetry.MetricsRegistry`: every counter lives
in a per-instance registry scope (``serving.<i>.*``), so the
process-wide Prometheus endpoint / JSONL flush sees serving traffic
without any extra wiring, while ``snapshot()`` keeps the JAX package's
exact shape. The latency reservoir is a local bounded ring of the most
recent samples (exact percentiles over current behavior); each
completion also lands in the scope's ``latency_ms`` histogram.

* **deadline misses are latency samples.** ``note_timeout(age_ms)``
  folds an expired request's queue age into the reservoir and the
  ``latency_ms`` histogram (and a dedicated ``timeout_age_ms``
  histogram), so the reported tail includes the requests that never
  made it.
* **request traces.** When telemetry is enabled, every request gets a
  stable id and a phase-decomposed trace — queue-wait, coalesce-wait,
  pad, device, resolve — kept in a bounded ring
  (:meth:`request_traces`), exported as Chrome-trace ``ph:X`` events
  into the span ring, and aggregated into per-phase, per-bucket latency
  histograms (``serving.<i>.b<bucket>.phase_<name>_ms``) so a p99
  blowup is attributable to queueing vs device time per bucket. Ring
  capacity rides ``MXNET_TELEMETRY_REQTRACE`` (0 disables).
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time

from .. import telemetry

__all__ = ["ServingStats", "TRACE_PHASES", "DECODE_TRACE_PHASES"]

# request-trace phase names, in wall-clock order
TRACE_PHASES = ("queue_wait_ms", "coalesce_wait_ms", "pad_ms",
                "device_ms", "resolve_ms")

# the decode plane's phase decomposition (serving.decode): one request
# spans a queue wait, its bucketed prefill, the continuous-batched
# decode steps it was active for, and resolution
DECODE_TRACE_PHASES = ("queue_wait_ms", "prefill_ms", "decode_ms",
                       "resolve_ms")


class ServingStats:
    """Thread-safe serving counters over a telemetry-registry scope,
    with a bounded latency reservoir and a request-trace ring."""

    def __init__(self, latency_window=2048, scope=None,
                 trace_capacity=None, phases=None):
        self._phases = tuple(phases) if phases else TRACE_PHASES
        self._lock = threading.Lock()
        self._window = int(latency_window)
        self._lat = [0.0] * self._window
        self._lat_n = 0            # total samples ever (ring write head)
        self.scope = scope or telemetry.registry().unique_scope("serving")
        c = self.scope.counter
        self._c_requests = c("requests")   # submitted (batcher or direct)
        self._c_completed = c("completed")
        self._c_rejected = c("rejected")   # queue-full backpressure
        self._c_timeouts = c("timeouts")   # expired before launch
        self._c_errors = c("errors")
        self._c_batches = c("batches")     # device launches (excl. warmup)
        self._c_warmup_batches = c("warmup_batches")
        self._c_real_rows = c("real_rows")     # request rows served
        self._c_padded_rows = c("padded_rows")  # bucket rows launched
        self._c_compiles = c("compiles")   # first forward or trace per bucket
        # the persistent executable cache (serving.cache): buckets whose
        # program was loaded (hit) or traced afresh (miss) at warmup
        self._c_cache_hits = c("cache_hits")
        self._c_cache_misses = c("cache_misses")
        # SLO-driven admission: requests shed because the tenant's own
        # burn windows are in breach (distinct from queue-full rejects)
        self._c_sheds = c("sheds")
        # worker supervision: times the batcher worker loop was
        # restarted after an unexpected exception escaped it (the
        # implicated requests failed with WorkerCrashed, loudly)
        self._c_worker_restarts = c("worker_restarts")
        self._h_latency = self.scope.histogram("latency_ms")
        self._h_timeout_age = self.scope.histogram("timeout_age_ms")
        self._h_shed_age = self.scope.histogram("shed_age_ms")
        self._warmup_ms = {}       # bucket -> warmup ms (trace/load + run)
        self._g_queue = self.scope.gauge("queue_depth")
        self.compile_tracking = True
        self.bucket_hits = {}      # bucket size -> launch count
        self._queue_probe = None   # () -> current queue depth
        if trace_capacity is None:
            trace_capacity = int(
                os.environ.get("MXNET_TELEMETRY_REQTRACE", "512"))
        self._trace_capacity = int(trace_capacity)
        self._traces = collections.deque(
            maxlen=max(self._trace_capacity, 1))
        self._req_ids = itertools.count()
        self._phase_hists = {}     # (bucket, phase) -> Histogram

    # -- registry-backed counter values (internal + snapshot use) -------
    requests = telemetry.instrument_value("_c_requests")
    completed = telemetry.instrument_value("_c_completed")
    rejected = telemetry.instrument_value("_c_rejected")
    timeouts = telemetry.instrument_value("_c_timeouts")
    errors = telemetry.instrument_value("_c_errors")
    batches = telemetry.instrument_value("_c_batches")
    warmup_batches = telemetry.instrument_value("_c_warmup_batches")
    real_rows = telemetry.instrument_value("_c_real_rows")
    padded_rows = telemetry.instrument_value("_c_padded_rows")
    compiles = telemetry.instrument_value("_c_compiles")
    cache_hits = telemetry.instrument_value("_c_cache_hits")
    cache_misses = telemetry.instrument_value("_c_cache_misses")
    sheds = telemetry.instrument_value("_c_sheds")
    worker_restarts = telemetry.instrument_value("_c_worker_restarts")

    def release(self):
        """Drop this instance's ``serving.<i>`` scope from the shared
        registry (the counters keep working locally). Call when the
        owning Predictor is discarded in a long-lived process."""
        self.scope.release()

    # -- recorders (called by Predictor / DynamicBatcher) ---------------
    def note_compile(self):
        self._c_compiles.add()

    def note_request(self, n=1):
        self._c_requests.add(n)

    def note_reject(self):
        self._c_rejected.add()

    def _reserve(self, latency_ms):
        """One sample into the percentile reservoir + export histogram
        — THE one rule for what the reported tail covers (completions
        AND deadline misses)."""
        self._h_latency.observe(latency_ms)
        with self._lock:
            self._lat[self._lat_n % self._window] = latency_ms
            self._lat_n += 1

    def note_timeout(self, age_ms=None):
        """A request expired before launch. ``age_ms`` (its time in
        queue) folds the miss into the latency reservoir/histogram —
        reported p99 must reflect the requests that never made it —
        plus the dedicated ``timeout_age_ms`` histogram."""
        self._c_timeouts.add()
        if age_ms is not None:
            age_ms = float(age_ms)
            self._h_timeout_age.observe(age_ms)
            self._reserve(age_ms)

    def note_error(self):
        self._c_errors.add()

    def note_shed(self, age_ms=None):
        """A request shed by SLO-driven admission (the tenant's own
        burn windows in breach). A worker-side shed passes the queue
        age — like a deadline miss it is a worst outcome the client
        experienced, so it folds into the latency reservoir/histogram
        (plus the dedicated ``shed_age_ms`` histogram); a submit-time
        reject passes None (the request never waited)."""
        self._c_sheds.add()
        if age_ms is not None:
            age_ms = float(age_ms)
            self._h_shed_age.observe(age_ms)
            self._reserve(age_ms)

    def note_worker_restart(self):
        """The batcher worker crashed on this tenant's work and was
        restarted (`serving.<i>.worker_restarts`)."""
        self._c_worker_restarts.add()

    def note_warmup_bucket(self, bucket, ms, source=None):
        """One bucket's warmup wall time (its trace or load, and its first
        run, read back) into the ``b<bucket>.warmup_ms`` gauge; ``source``
        counts a cache hit (``"deserialized"``) or miss (``"compiled"``);
        None: no cache in play."""
        ms = round(float(ms), 3)
        with self._lock:
            self._warmup_ms[int(bucket)] = ms
        self.scope.gauge("b%d.warmup_ms" % int(bucket)).set(ms)
        if source == "deserialized":
            self._c_cache_hits.add()
        elif source == "compiled":
            self._c_cache_misses.add()

    def note_batch(self, bucket, rows, warmup=False):
        if warmup:
            self._c_warmup_batches.add()
            return
        self._c_batches.add()
        self._c_real_rows.add(rows)
        self._c_padded_rows.add(bucket)
        with self._lock:
            self.bucket_hits[bucket] = self.bucket_hits.get(bucket, 0) + 1
        self.scope.counter("bucket_hits.%d" % bucket).add()

    def note_completed(self, latency_ms):
        latency_ms = float(latency_ms)
        self._c_completed.add()
        self._reserve(latency_ms)

    def set_queue_probe(self, fn):
        """Install a ``() -> int`` gauge for the current queue depth
        (the batcher points this at its deque)."""
        self._queue_probe = fn
        self._g_queue.set_fn(fn)

    # -- request traces --------------------------------------------------
    def new_request_id(self):
        """A stable per-instance request id (``r<seq>``) — stamped on
        every submitted request and carried by its trace."""
        return "r%08d" % next(self._req_ids)

    def _phase_hist(self, bucket, phase):
        key = (bucket, phase)
        h = self._phase_hists.get(key)
        if h is None:
            h = self._phase_hists[key] = self.scope.histogram(
                "b%d.phase_%s" % (bucket, phase))
        return h

    def note_trace(self, req_id, rows, bucket, phases, outcome="ok",
                   ts_end=None):
        """Record one request's phase-decomposed trace (callers gate on
        ``telemetry.enabled()`` — one branch when off). ``phases`` maps
        phase name (this instance's phase set — :data:`TRACE_PHASES` by
        default, :data:`DECODE_TRACE_PHASES` for a decode engine) to ms;
        missing phases are 0.
        The trace lands in the bounded ring, each phase in its
        per-bucket histogram, and (for served requests) as Chrome-trace
        ``ph:X`` events in the span ring, next to the host spans."""
        if self._trace_capacity <= 0:
            return None
        ts_end = time.time() if ts_end is None else float(ts_end)
        phases = {p: round(float(phases.get(p, 0.0)), 3)
                  for p in self._phases}
        total = round(sum(phases.values()), 3)
        trace = {"id": str(req_id), "rows": int(rows),
                 "bucket": int(bucket) if bucket else None,
                 "outcome": str(outcome), "phases": phases,
                 "total_ms": total,
                 "ts": round(ts_end - total / 1000.0, 6)}
        with self._lock:
            self._traces.append(trace)
        if bucket:
            for p, ms in phases.items():
                if ms or p in ("queue_wait_ms", "device_ms",
                               "decode_ms"):
                    self._phase_hist(trace["bucket"], p).observe(ms)
        elif phases.get("queue_wait_ms"):
            # never-launched outcomes (timeout, admission shed) have no
            # bucket but DID wait — their queue time lands in a
            # bucket-free histogram so the decision stays attributable
            # in this scope's phase view
            self.scope.histogram("phase_queue_wait_ms").observe(
                phases["queue_wait_ms"])
        # phase events laid out back-to-back ending at ts_end: the
        # request renders as a contiguous bar decomposed by phase
        events, t_us = [], (ts_end - total / 1000.0) * 1e6
        tid = threading.get_ident()
        for p in self._phases:
            dur_us = phases[p] * 1e3
            if dur_us <= 0:
                continue
            events.append({
                "name": "serving.req.%s" % p[:-3], "cat": "serving",
                "ph": "X", "ts": t_us, "dur": dur_us, "pid": 0,
                "tid": tid,
                "args": {"id": trace["id"], "rows": trace["rows"],
                         "bucket": trace["bucket"],
                         "outcome": trace["outcome"]}})
            t_us += dur_us
        if events:
            telemetry.record_events(events)
        return trace

    def request_traces(self):
        """The retained request traces, oldest first."""
        with self._lock:
            return [dict(t) for t in self._traces]

    # -- snapshot -------------------------------------------------------
    @staticmethod
    def _pct(sorted_vals, p):
        if not sorted_vals:
            return None
        idx = min(len(sorted_vals) - 1,
                  max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
        return sorted_vals[idx]

    def snapshot(self):
        """One coherent dict of every counter/gauge/percentile — the
        ``stats()`` surface, with the JAX package's keys.
        ``latency_ms.count`` counts reservoir samples: completions plus
        deadline misses recorded with their queue age (so the
        percentiles cover the worst outcomes, not only the served
        ones)."""
        with self._lock:
            lat_total = self._lat_n
            n = min(lat_total, self._window)
            lats = sorted(self._lat[:n])
            bucket_hits = dict(self.bucket_hits)
            warmup_ms = dict(self._warmup_ms)
        real_rows, padded_rows = self.real_rows, self.padded_rows
        fill = (real_rows / float(padded_rows)) if padded_rows else None
        out = {
            "requests": self.requests,
            "completed": self.completed,
            "rejected": self.rejected,
            "timeouts": self.timeouts,
            "errors": self.errors,
            "batches": self.batches,
            "warmup_batches": self.warmup_batches,
            "batch_fill": round(fill, 4) if fill is not None else None,
            "compiles": self.compiles,
            "compile_tracking": self.compile_tracking,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "sheds": self.sheds,
            "worker_restarts": self.worker_restarts,
            "warmup_ms": warmup_ms,
            "bucket_hits": bucket_hits,
            "latency_ms": {
                "count": lat_total,
                "mean": round(sum(lats) / n, 3) if n else None,
                "p50": self._pct(lats, 50),
                "p95": self._pct(lats, 95),
                "p99": self._pct(lats, 99),
                "max": lats[-1] if lats else None,
            },
        }
        probe = self._queue_probe
        try:
            out["queue_depth"] = int(probe()) if probe is not None else 0
        except Exception:
            out["queue_depth"] = 0
        return out
