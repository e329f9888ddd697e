"""RegressionWatchdog — a live judge over the training gauges (the port's
copy of ``mxnet_tpu/telemetry/health.py``).

A step-time or MFU regression used to be visible only when a human
re-ran a benchmark. The watchdog watches the LIVE run instead: off the step
path, it compares windows of recent :class:`StepTimeline` records and
registry gauges against a pinned baseline and emits ONE structured
incident per distinct regression.

* **Arming** — ``Module.fit`` arms the process watchdog at the warmup
  boundary (end of its first epoch — compiles are over, the steady
  state begins) when telemetry is enabled, unless
  ``MXNET_TELEMETRY_WATCHDOG=0``. The baseline is either **pinned**
  (``baseline=`` dict or a committed ``BASELINE.json``-style snapshot
  path, e.g. via ``MXNET_TELEMETRY_BASELINE``) or **self-calibrated**
  from the first post-warmup window (the first polled epoch becomes
  the reference — a clean run is its own baseline and stays silent).
* **Polling** — ``poll()`` runs between epochs (fit calls it at each
  post-warmup epoch end). Pure host arithmetic over retained records: the
  zero-perturbation contract is untouched. Watched signals:

  - ``step_total_ms`` / ``step_ms`` — median per-batch step time
    (grouped records normalize by their true K);
  - ``host_wait_fraction`` — the input path's share of the step;
  - ``train.mfu`` / ``achieved_hbm_gbps`` — the live roofline fields
    stamped into post-warmup records (skipped when the peak table
    doesn't know the device — a CPU run never false-fires on MFU);
  - ``eval_step_ms`` — the eval/score loop's records (``loop="eval"``),
    so a served/eval regression trips the same wire;
  - ``compile.post_warmup_retraces`` — any value > 0 is an incident;
  - ``dist.straggler_ratio`` — a straggling host past the threshold;
  - ``precision.scale_skips`` — a loss-scaler skip storm (more than
    ``scale_skip_threshold`` skipped updates between two polls).

* **Incidents** — at most ONE per poll (the highest-priority new
  finding; co-occurring signals ride in its ``also`` list) and at most
  one EVER per distinct gauge (warn-once): an injected slowdown
  produces exactly one ``health.*`` incident, not one per epoch.
  Each incident carries the offending gauge, window stats, baseline
  and threshold; it increments ``health.incidents``, flips the
  ``health.healthy`` gauge, logs one warning, appends a
  ``{"kind": "health"}`` JSONL event, and is noted into the
  :class:`FlightRecorder` ring — a postmortem carries the drift
  history that led up to the crash.

``telemetry.health_report()`` returns the whole state as JSON (also
served as ``GET /health`` by
:class:`~mxnet_tpu_torch.telemetry.MetricsServer`).
"""
from __future__ import annotations

import json
import logging
import threading
import time

__all__ = ["RegressionWatchdog"]

# check priority: when one poll finds several co-moving regressions
# (a transform sleep raises host-wait AND total), the FIRST key below
# becomes THE incident and the rest ride in its "also" list
_PRIORITY = ("compile.post_warmup_retraces", "step_total_ms", "step_ms",
             "host_wait_fraction", "train.mfu",
             "train.achieved_hbm_gbps", "eval_step_ms",
             "dist.straggler_ratio", "precision.scale_skips")


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    if not n:
        return None
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


class RegressionWatchdog(object):
    """Baseline-vs-live regression monitor (module docstring).

    Parameters
    ----------
    tolerance : float
        Relative degradation that fires: a step-time median more than
        ``(1 + tolerance)`` × baseline (default 1.0 — 2× — robust to
        CI timing jitter), an MFU/HBM median below
        ``(1 - mfu_tolerance)`` × baseline.
    min_delta_ms : float
        Absolute floor for time regressions — a 2× blowup of a 0.5 ms
        step is noise, not an incident.
    straggler_threshold : float
        ``dist.straggler_ratio`` (max/mean host clock) above this is an
        incident on its own (no baseline needed).
    scale_skip_threshold : int
        Loss-scaler skipped updates accumulated BETWEEN two polls
        above this is an incident (a pathological skip storm — the
        scaler halving forever on persistently non-finite grads —
        used to be invisible). Absolute judge, no baseline needed.
    min_samples : int
        A window with fewer records than this is skipped, not judged.
    """

    def __init__(self, registry=None, timeline=None, tolerance=1.0,
                 mfu_tolerance=0.5, min_delta_ms=5.0,
                 host_wait_margin=0.3, straggler_threshold=2.0,
                 scale_skip_threshold=8, min_samples=3,
                 max_incidents=64, logger=None):
        if registry is None or timeline is None:
            import mxnet_tpu_torch.telemetry as _tel
            registry = registry or _tel.registry()
            timeline = timeline or _tel.timeline()
        self._registry = registry
        self._timeline = timeline
        self.tolerance = float(tolerance)
        self.mfu_tolerance = float(mfu_tolerance)
        self.min_delta_ms = float(min_delta_ms)
        self.host_wait_margin = float(host_wait_margin)
        self.straggler_threshold = float(straggler_threshold)
        self.scale_skip_threshold = int(scale_skip_threshold)
        self._scale_skips_seen = None   # gauge value at the last poll
        self.min_samples = int(min_samples)
        self.logger = logger or logging.getLogger("mxnet_tpu_torch.telemetry")
        self._lock = threading.Lock()
        scope = registry.scope("health")
        self._c_incidents = scope.counter("incidents")
        self._c_polls = scope.counter("polls")
        self._g_armed = scope.gauge("armed")
        self._g_healthy = scope.gauge("healthy")
        self._armed = False
        self._baseline = None
        self._pinned = False
        self._calibrated = False
        self._incidents = []
        self._max_incidents = int(max_incidents)
        self._warned = set()          # gauges that already fired
        # per-stream high-water marks: judge records newer than these.
        # Separate pointers so a stream too thin to judge this poll
        # (e.g. one eval record per score() call) is CARRIED into the
        # next window instead of silently consumed
        self._after = {"train": -1, "eval": -1}
        self._last_window = None
        self._g_healthy.set(1)

    # -- arming ---------------------------------------------------------
    @property
    def armed(self):
        return self._armed

    def arm(self, baseline=None):
        """Start judging from HERE: records already retained are
        warmup, not evidence. ``baseline`` pins the reference — a dict
        of medians or a JSON snapshot path (``BASELINE.json`` style:
        either flat or under a ``"health_baseline"`` key); None
        self-calibrates from the first polled window. Re-arming (a new
        fit) restarts calibration against the new program; incident
        history and warn-once state persist for the process."""
        with self._lock:
            if isinstance(baseline, str):
                with open(baseline) as f:
                    loaded = json.load(f)
                baseline = loaded.get("health_baseline", loaded)
            if baseline is not None:
                self._baseline = {k: float(v)
                                  for k, v in dict(baseline).items()}
                self._pinned = True
                self._calibrated = True
            elif not self._pinned:
                self._baseline = None
                self._calibrated = False
            recs = self._timeline.records()
            last = recs[-1]["step"] if recs else -1
            self._after = {"train": last, "eval": last}
            self._armed = True
        self._g_armed.set(1)
        return self

    def disarm(self):
        with self._lock:
            self._armed = False
        self._g_armed.set(0)

    def reset(self):
        """Disarm and forget everything — baseline, calibration,
        incidents, warn-once state (test/bench plumbing; a production
        process keeps its incident history instead)."""
        self.disarm()
        with self._lock:
            self._baseline = None
            self._pinned = False
            self._calibrated = False
            self._incidents = []
            self._warned = set()
            self._after = {"train": -1, "eval": -1}
            self._last_window = None
        self._g_healthy.set(1)

    @property
    def baseline(self):
        with self._lock:
            return dict(self._baseline) if self._baseline else None

    def save_baseline(self, path):
        """Write the calibrated baseline as a committed-snapshot JSON
        (the ``BASELINE.json``-style file :meth:`arm` loads)."""
        with self._lock:
            if not self._baseline:
                raise ValueError("no calibrated baseline to save")
            payload = {"format": "health-baseline-r1",
                       "generated_ts": round(time.time(), 3),
                       "health_baseline": dict(self._baseline)}
        from .export import atomic_json_dump
        return atomic_json_dump(path, payload)

    # -- window stats ---------------------------------------------------
    def _train_stats(self, train):
        """Per-batch medians of one train window (grouped records
        normalize by their true K)."""
        ks = [max(int(r.get("batch_group", 1)), 1) for r in train]
        out = {
            "step_total_ms": _median(
                [r["total_ms"] / k for r, k in zip(train, ks)]),
            "step_ms": _median(
                [r["step_ms"] / k for r, k in zip(train, ks)]),
            "host_wait_fraction": _median(
                [r["host_wait_ms"] / max(r["total_ms"], 1e-9)
                 for r in train]),
            "n_train": len(train),
        }
        mfus = [r["mfu"] for r in train if r.get("mfu")]
        if len(mfus) >= self.min_samples:
            out["train.mfu"] = _median(mfus)
        hbm = [r["achieved_hbm_gbps"] for r in train
               if r.get("achieved_hbm_gbps")]
        if len(hbm) >= self.min_samples:
            out["train.achieved_hbm_gbps"] = _median(hbm)
        return out

    @staticmethod
    def _eval_stats(evals):
        return {
            "eval_step_ms": _median(
                [r["step_ms"] / max(int(r.get("batch_group", 1)), 1)
                 for r in evals]),
            "n_eval": len(evals),
        }

    def _findings(self, window):
        """Compare one window against the baseline + absolute
        thresholds; returns {gauge: finding} (not yet deduped)."""
        found = {}
        base = self._baseline or {}

        def _slower(key):
            b, v = base.get(key), window.get(key)
            if b is None or v is None:
                return
            if v > b * (1.0 + self.tolerance) and \
                    v - b > self.min_delta_ms:
                found[key] = {"value": round(v, 3),
                              "baseline": round(b, 3),
                              "threshold": round(
                                  b * (1.0 + self.tolerance), 3)}

        _slower("step_total_ms")
        _slower("step_ms")
        _slower("eval_step_ms")
        b, v = base.get("host_wait_fraction"), \
            window.get("host_wait_fraction")
        if b is not None and v is not None and \
                v > b + self.host_wait_margin:
            found["host_wait_fraction"] = {
                "value": round(v, 4), "baseline": round(b, 4),
                "threshold": round(b + self.host_wait_margin, 4)}
        for key in ("train.mfu", "train.achieved_hbm_gbps"):
            bv, vv = base.get(key), window.get(key)
            if bv and vv is not None and \
                    vv < bv * (1.0 - self.mfu_tolerance):
                found[key] = {"value": round(vv, 6),
                              "baseline": round(bv, 6),
                              "threshold": round(
                                  bv * (1.0 - self.mfu_tolerance), 6)}
        # absolute judges — no baseline needed
        retr = self._registry.counter(
            "compile.post_warmup_retraces").value
        if retr > 0:
            found["compile.post_warmup_retraces"] = {
                "value": retr, "baseline": 0, "threshold": 0}
        strag = self._registry.gauge("dist.straggler_ratio").value
        if strag and strag > self.straggler_threshold:
            found["dist.straggler_ratio"] = {
                "value": round(float(strag), 4), "baseline": None,
                "threshold": self.straggler_threshold}
        # loss-scaler skip storm: judge the DELTA between polls of the
        # precision.scale_skips gauge fit publishes at each epoch
        # boundary — occasional overflow skips are the scaler working,
        # a burst above the threshold per poll window is pathology.
        # The FIRST observation only calibrates (warmup's intentional
        # init-scale halving skips are not a storm), and the marker
        # always tracks the gauge so a later fit's smaller cumulative
        # value re-calibrates instead of masking its real storms
        skips = self._registry.gauge("precision.scale_skips").value or 0
        prev, self._scale_skips_seen = self._scale_skips_seen, skips
        if prev is not None and \
                skips - prev > self.scale_skip_threshold:
            found["precision.scale_skips"] = {
                "value": int(skips), "baseline": int(prev),
                "threshold": self.scale_skip_threshold}
        return found

    # -- polling --------------------------------------------------------
    def poll(self):
        """One off-step-path judgment pass: gather the records since
        the last poll, calibrate each stream's first adequate window
        (unless pinned), then compare. A stream with fewer than
        ``min_samples`` new records is CARRIED into the next window
        (its high-water mark does not advance), so slow trickles —
        one eval record per score() call — still accumulate into a
        judged window. The absolute judges
        (post-warmup retraces, straggler ratio) run on every poll.
        Returns the list of NEW incidents (empty for a healthy pass)."""
        with self._lock:
            if not self._armed:
                return []
            recs = self._timeline.records()
            train = [r for r in recs
                     if r["step"] > self._after["train"]
                     and r.get("loop", "train") == "train"
                     and not r.get("recompile")]
            evals = [r for r in recs
                     if r["step"] > self._after["eval"]
                     and r.get("loop") == "eval"
                     and not r.get("recompile")]
            window = {}
            if len(train) >= self.min_samples:
                self._after["train"] = train[-1]["step"]
                window.update(self._train_stats(train))
            if len(evals) >= self.min_samples:
                self._after["eval"] = evals[-1]["step"]
                window.update(self._eval_stats(evals))
            self._c_polls.add()
            if window:
                self._last_window = window
            if self._baseline is None:
                self._baseline = {}
            judged = {}
            for k, v in window.items():
                if k.startswith("n_"):
                    continue
                if self._pinned or k in self._baseline:
                    judged[k] = v
                else:
                    # this key's first adequate window IS its baseline
                    self._baseline[k] = v
            self._calibrated = self._calibrated or bool(self._baseline)
            found = self._findings(judged)
            fresh = [k for k in _PRIORITY
                     if k in found and k not in self._warned]
            if not fresh:
                return []
            # one incident per poll: the top-priority NEW finding owns
            # it; co-occurring signals ride along (and are consumed —
            # warn-once covers the whole co-moving cluster)
            lead, also = fresh[0], fresh[1:]
            self._warned.update(fresh)
            stats = window or self._last_window or {}
            incident = {
                "kind": "regression", "gauge": lead,
                "ts": round(time.time(), 6),
                "window": {k: stats[k] for k in sorted(stats)},
                "also": also,
            }
            incident.update(found[lead])
            self._incidents.append(incident)
            del self._incidents[:-self._max_incidents]
        self._c_incidents.add()
        self._g_healthy.set(0)
        self.logger.warning(
            "health incident: %s regressed to %s (baseline %s, "
            "threshold %s)%s — window %s", lead, incident["value"],
            incident["baseline"], incident["threshold"],
            " [also: %s]" % ", ".join(also) if also else "",
            incident["window"])
        import mxnet_tpu_torch.telemetry as _tel
        _tel.log_event("health", dict(incident))
        _tel.flight_recorder().note(
            "health_incident", gauge=lead, value=incident["value"],
            baseline=incident["baseline"],
            threshold=incident["threshold"], also=also)
        return [incident]

    # -- reading --------------------------------------------------------
    def incidents(self):
        with self._lock:
            return [dict(i) for i in self._incidents]

    @property
    def healthy(self):
        with self._lock:
            return not self._incidents

    def report(self):
        """The health state as one JSON-able dict — the
        ``telemetry.health_report()`` / ``GET /health`` payload."""
        with self._lock:
            return {
                "armed": self._armed,
                "calibrated": self._calibrated,
                "baseline_pinned": self._pinned,
                "baseline": dict(self._baseline)
                if self._baseline else None,
                "polls": self._c_polls.value,
                "last_window": dict(self._last_window)
                if self._last_window else None,
                "incidents": [dict(i) for i in self._incidents],
                "healthy": not self._incidents,
                "watching": list(_PRIORITY),
            }
