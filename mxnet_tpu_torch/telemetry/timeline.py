"""StepTimeline — a bounded per-step record of where fit's time went (the
port's copy of ``mxnet_tpu/telemetry/timeline.py``).

One record per train step (per GROUP with ``batch_group=K``), written
by the ``Module.fit`` loop from pure host clocks — no device readback,
no RNG touch, so a telemetry-on run trains to bitwise-identical params
(the zero-perturbation contract).

Record fields:

* ``step`` — global step index (monotonic across epochs and fits).
* ``epoch`` / ``nbatch`` — the fit loop's coordinates (``nbatch`` is
  the last batch of the group on the grouped path).
* ``host_wait_ms`` — time blocked pulling this step's batch from the
  iterator (the input path's share of the step).
* ``step_ms`` — host-observed forward+backward+update time: dispatch
  plus any blocking the async step imposes. On the card this is the
  host's view WITHOUT forcing a sync (the step's kernels are queued,
  not finished); a sudden jump means the host caught up with the card
  (or a first run of a new program — see the flag).
* ``metric_cb_ms`` — update_metric + batch_end_callback time.
* ``checkpoint_ms`` — epoch-end checkpoint staging time, attributed to
  the epoch's last step record (0 elsewhere). The streamed JSONL step
  lines are written BEFORE this fold, so the sink carries the cost as
  its own ``{"kind": "checkpoint"}`` event; ``to_jsonl``/``records``
  post-hoc reads see it folded in.
* ``batch_group`` — K for grouped steps, 1 per-batch (eval records
  from the device-score path use it for the number of batches the one
  record covers).
* ``loop`` — ``"train"`` for the fit loops, ``"eval"`` for the
  ``Module.score``/eval-pass records (same shape, so the health
  watchdog judges served/eval regressions on the same wire; the
  streamed JSONL twin of an eval record is ``{"kind": "eval_step"}``).
* ``recompile`` — True when the CompileWatch counter moved during this
  step: a program's first run for its (kind, shapes), where cuDNN picks
  its algorithms and the caching allocator grows (the "why was step
  412 slow" answer).
* ``total_ms`` / ``ts`` — the sum of the above clocks and the record's
  wall-clock stamp.
* ``mfu`` / ``achieved_hbm_gbps`` / ``bound_by`` — the live roofline
  (fit folds them in via ``BaseModule._roofline_note`` once the step
  program's FLOPs/bytes resolve at the warmup boundary; absent on
  first-epoch records and when introspection has no basis — see
  ``telemetry.introspect``).

Query post-hoc: ``timeline.slowest(k)``, ``timeline.records()``,
``timeline.to_jsonl(path)``.
"""
from __future__ import annotations

import collections
import json
import threading
import time

__all__ = ["StepTimeline"]


class StepTimeline(object):
    """Bounded ring of per-step records (see module docstring)."""

    def __init__(self, capacity=4096):
        self._records = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._next_step = 0

    def record(self, epoch, nbatch, host_wait_ms=0.0, step_ms=0.0,
               metric_cb_ms=0.0, checkpoint_ms=0.0, batch_group=1,
               recompile=False, loop="train"):
        """Append one step record; returns the record dict."""
        with self._lock:
            step = self._next_step
            self._next_step += 1
            rec = {
                "step": step, "epoch": int(epoch), "nbatch": int(nbatch),
                "loop": str(loop),
                "host_wait_ms": round(float(host_wait_ms), 3),
                "step_ms": round(float(step_ms), 3),
                "metric_cb_ms": round(float(metric_cb_ms), 3),
                "checkpoint_ms": round(float(checkpoint_ms), 3),
                "batch_group": int(batch_group),
                "recompile": bool(recompile),
                "total_ms": round(float(host_wait_ms) + float(step_ms)
                                  + float(metric_cb_ms)
                                  + float(checkpoint_ms), 3),
                "ts": round(time.time(), 6),
            }
            self._records.append(rec)
            return rec

    def note_checkpoint(self, ms):
        """Fold an epoch-end checkpoint cost into the newest record
        (the step it actually delayed)."""
        with self._lock:
            if not self._records:
                return
            rec = self._records[-1]
            rec["checkpoint_ms"] = round(rec["checkpoint_ms"] + float(ms),
                                         3)
            rec["total_ms"] = round(rec["total_ms"] + float(ms), 3)

    # -- reading --------------------------------------------------------
    def records(self):
        """The retained records, oldest first (copies are shallow —
        treat them as read-only)."""
        with self._lock:
            return list(self._records)

    def __len__(self):
        with self._lock:
            return len(self._records)

    def slowest(self, k=10):
        """The ``k`` slowest retained steps by ``total_ms``, slowest
        first — the post-hoc "why was step N slow" query."""
        return sorted(self.records(), key=lambda r: -r["total_ms"])[:int(k)]

    def to_jsonl(self, path, append=False):
        """Write every retained record as one ``{"kind": "step", ...}``
        JSON line; returns the record count."""
        recs = self.records()
        with open(path, "a" if append else "w") as f:
            for rec in recs:
                line = dict(rec)
                line["kind"] = "step"
                f.write(json.dumps(line, sort_keys=True) + "\n")
        return len(recs)

    def clear(self):
        with self._lock:
            self._records.clear()
