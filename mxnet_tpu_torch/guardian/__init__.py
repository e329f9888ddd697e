"""mxnet_tpu_torch.guardian — the training guardian: numeric-health
sentinels, loss-spike rollback-and-skip, and an SDC parity probe (the
port's counterpart of ``mxnet_tpu/guardian``; its host logic is the JAX
package's, line for line).

A NaN gradient, a loss spike, or a silent-data-corruption bit flip
used to either crash ``fit`` or quietly poison the parameters for
every remaining step. The guardian closes the loop out of seams the
stack already has:

* **Sentinels** — an armed :class:`~mxnet_tpu_torch.module.MeshExecutorGroup`
  threads a device-resident health word ``(flags, first_bad, count,
  loss-ring)`` through the fused train step (per batch and grouped,
  the way the loss-scale triple rides — ZERO step-path readbacks),
  detecting non-finite loss/grads/params on the device; the
  guardian polls it off-path at the epoch boundary and runs a host-side
  rolling loss-spike judge (median + MAD over the ring, the watchdog's
  robustness guards) over the per-step loss scalars.
* **Rollback-and-skip** — on a verdict, ``fit`` restores the newest
  VERIFIABLE checkpoint entry that precedes the poisoned data
  coordinate (:meth:`CheckpointManager.restore_before` — artifact
  verification plus a value-level finite-params check), discards the
  poisoned trajectory's newer entries, fast-forwards the
  deterministic ``(seed, epoch, batch_index)`` stream past the
  poisoned coordinate, and continues — bounded by ``max_rollbacks``,
  escalating to the terminal :class:`UnrecoverableNumericError` when a
  step stays bad after its batch was skipped (bad STATE, not bad
  data).
* **SDC parity probe** — every N-th step optionally runs twice, from
  copies of the same parameters, optimizer states, aux and staged
  inputs, and compares the updated params BITWISE on the device
  (``view(torch.int32)``, so a NaN payload equals itself); under the
  determinism the probe requires (``torch.backends.cudnn.deterministic``
  on, ``benchmark`` off, no op whose CUDA backward adds with atomics)
  any mismatch is a true hardware/silent-corruption signal, counted as
  ``guardian.sdc_checks`` / ``sdc_mismatches`` and treated as a
  rollback trigger.

Opt-in and zero-cost when off: ``fit(guardian=None)`` (the default)
runs the step it ran before and pays one attribute branch per seam —
the fit digest is bit for bit the one without the guardian. Arm with
``fit(guardian=Guardian(manager))``, a checkpoint directory path, or
``MXNET_GUARDIAN=1`` + ``MXNET_GUARDIAN_DIR``.

Env knobs (defaults in parentheses): ``MXNET_GUARDIAN`` (0),
``MXNET_GUARDIAN_DIR`` (unset), ``MXNET_GUARDIAN_SPIKE_WINDOW`` (32),
``MXNET_GUARDIAN_SPIKE_THRESHOLD`` (8 MADs),
``MXNET_GUARDIAN_MAX_ROLLBACKS`` (4), ``MXNET_GUARDIAN_SDC_PERIOD``
(0 = probe off).
"""
from __future__ import annotations

import logging
import os
from collections import namedtuple

import numpy as onp

from ..base import MXNetError

__all__ = ["Guardian", "Verdict", "UnrecoverableNumericError",
           "spike_judge", "resolve",
           "FLAG_LOSS", "FLAG_GRAD", "FLAG_PARAM", "FLAG_SDC"]

# health-word flag bits (mesh_executor_group is the writer)
FLAG_LOSS = 1
FLAG_GRAD = 2
FLAG_PARAM = 4
FLAG_SDC = 8

_FLAG_NAMES = ((FLAG_LOSS, "loss_nonfinite"),
               (FLAG_GRAD, "grad_nonfinite"),
               (FLAG_PARAM, "param_nonfinite"),
               (FLAG_SDC, "sdc_mismatch"))


class UnrecoverableNumericError(MXNetError):
    """The guardian gave up: the rollback budget is exhausted, no
    checkpoint entry precedes the poisoned coordinate, or a step
    stayed bad after its batch was skipped (corrupt STATE, not bad
    data). Terminal by design — the operator-visible failure, not a
    silent poisoned convergence."""


Verdict = namedtuple("Verdict", ["kind", "epoch", "nbatch", "flags",
                                 "detail"])
Verdict.__doc__ = """One poll's finding: ``kind`` is ``"nonfinite"``,
``"loss_spike"`` or ``"sdc"``; ``(epoch, nbatch)`` the poisoned data
coordinate; ``flags`` the raw sentinel bitmask; ``detail`` a dict of
judge evidence (spike value/median/mad, flag names, ...)."""


def _flag_names(flags):
    return [name for bit, name in _FLAG_NAMES if flags & bit]


def spike_judge(values, threshold, min_samples=8, prior=()):
    """The rolling loss-spike judge: scan ``values`` — ``(step_ordinal,
    loss_scalar)`` pairs, oldest first — IN ORDER, convicting the
    first entry that sits more than ``threshold`` robust units ABOVE
    the median of everything accepted before it (``prior`` seeds the
    baseline with earlier healthy windows). Causal and one-sided by
    design: a spike poisons every later step of its window, so a
    whole-window median would absorb the aftermath and miss the onset;
    and only UPWARD deviations convict — a loss cliff downward (lr
    schedule, warmup ending) is progress, not poison. The robust unit
    is ``max(MAD, 5% of |median|, 1e-6)`` — the watchdog's guard
    discipline (median not mean, an absolute floor so a flat-loss
    window cannot false-fire on noise). Non-finite values are excluded
    (the finiteness sentinels own those). Returns ``(step_ordinal,
    value, median, unit)`` or None."""
    accepted = [float(v) for v in prior if onp.isfinite(v)]
    for s, v in values:
        v = float(v)
        if not onp.isfinite(v):
            continue
        if len(accepted) >= int(min_samples):
            vals = onp.asarray(accepted, onp.float64)
            med = float(onp.median(vals))
            mad = float(onp.median(onp.abs(vals - med)))
            unit = max(mad, 0.05 * abs(med), 1e-6)
            if v - med > float(threshold) * unit:
                return s, v, med, unit
        accepted.append(v)
    return None


def _env_float(name, default):
    v = os.environ.get(name)
    return default if v in (None, "") else float(v)


def _env_int(name, default):
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


class Guardian(object):
    """The numeric-health closed loop ``fit`` drives (module
    docstring).

    Parameters
    ----------
    manager : CheckpointManager or str
        The durable rollback store (committed entries always win when
        one precedes the poisoned coordinate). Arming additionally
        takes an IN-MEMORY snapshot of params/optimizer-state/RNG, so
        poison before anything committed — the first epoch of a fresh
        run — still has a restore target; the snapshot never writes
        into the manager, whose step-id scheme belongs to the caller's
        own checkpointing. (If the snapshot itself fails, e.g.
        non-addressable multi-host shards, first-epoch poison
        escalates loudly instead of rolling back.)
    spike_window : int
        Device loss-ring length (and so the judge's window). Env
        ``MXNET_GUARDIAN_SPIKE_WINDOW``, default 32.
    spike_threshold : float
        Robust units (MADs, floored) of deviation that convict. Env
        ``MXNET_GUARDIAN_SPIKE_THRESHOLD``, default 8.
    max_rollbacks : int
        Rollback budget for this guardian's lifetime (a job thrashing
        on rollbacks must fail loudly, not loop); exceeding it raises
        :class:`UnrecoverableNumericError`. Env
        ``MXNET_GUARDIAN_MAX_ROLLBACKS``, default 4.
    sdc_probe_period : int
        Run every N-th step as a parity probe (0 = off). Env
        ``MXNET_GUARDIAN_SDC_PERIOD``.
    spike_metric : str or EvalMetric or None
        The fused statistic defining the ring's per-step loss scalar
        (default ``"ce"`` — cross-entropy; None/"off" disables the
        spike judge, finiteness sentinels stay armed).
    """

    def __init__(self, manager, spike_window=None, spike_threshold=None,
                 max_rollbacks=None, sdc_probe_period=None,
                 spike_metric="ce", spike_min_samples=8, logger=None):
        from ..checkpoint import CheckpointManager
        if isinstance(manager, str):
            manager = CheckpointManager(manager)
        self.manager = manager
        self.spike_window = int(spike_window
                                if spike_window is not None else
                                _env_int("MXNET_GUARDIAN_SPIKE_WINDOW",
                                         32))
        if self.spike_window < 1:
            raise MXNetError("spike_window must be >= 1 (got %d)"
                             % self.spike_window)
        self.spike_threshold = float(
            spike_threshold if spike_threshold is not None else
            _env_float("MXNET_GUARDIAN_SPIKE_THRESHOLD", 8.0))
        self.max_rollbacks = int(
            max_rollbacks if max_rollbacks is not None else
            _env_int("MXNET_GUARDIAN_MAX_ROLLBACKS", 4))
        self.sdc_probe_period = int(
            sdc_probe_period if sdc_probe_period is not None else
            _env_int("MXNET_GUARDIAN_SDC_PERIOD", 0))
        self.spike_min_samples = int(spike_min_samples)
        self.logger = logger or logging.getLogger("mxnet_tpu_torch.guardian")
        self._spike_metric = None
        if spike_metric not in (None, "off", ""):
            from .. import metric as metric_mod
            # ONE metric object for the guardian's lifetime, as in the
            # JAX package (whose programs key on its identity)
            self._spike_metric = metric_mod.create(spike_metric)
        # per-fit state
        self.rollbacks = 0
        self.skips = set()          # {(epoch, nbatch)} excluded coords
        self._loss_history = []     # healthy windows' scalars (judge
        # baseline across polls — the ring resets per epoch, so a
        # spike early in an epoch still has an adequate prior)
        self._group = None
        self._epoch = None
        self._epoch_steps = []      # executed-step ordinal -> nbatch
        self._armed = False
        self._baseline = None       # arm-time in-memory snapshot
        self._begin_epoch = 0
        from .. import telemetry
        self._tel = telemetry.registry().scope("guardian")
        # per-instance SDC accounting: the telemetry counters are
        # process-wide (every guardian in the process feeds them); a
        # creation-time base makes stats() report THIS guardian's
        # activity, never another instance's probes
        self.sdc_mismatches = 0
        self._sdc_checks_base = int(
            self._tel.counter("sdc_checks").value)

    # ------------------------------------------------------------ arming
    @property
    def armed(self):
        return self._armed

    def arm(self, module, begin_epoch):
        """Called by ``fit`` after bind/init: arm the executor group's
        device sentinel and make sure the manager has a restorable
        baseline. Returns False (with one warning) when the module
        cannot carry the sentinel — the classic executor path has no
        one-program step to thread the health word through."""
        grp = getattr(module, "_exec_group", None)
        updater = getattr(module, "_updater", None)
        # the health word rides the fused train step: the group must be
        # fused with the step enabled, the optimizer must have a pure
        # fused apply, and updates must be local (a kvstore update path
        # never calls step_update) — otherwise every step would run
        # classic and the sentinel would never observe anything while
        # claiming to be armed
        if not getattr(grp, "fused", False) or \
                not getattr(grp, "_step_enabled", False) or \
                getattr(module, "_kvstore", None) is not None or \
                updater is None or \
                updater.fused_apply_or_none() is None:
            self.logger.warning(
                "guardian requires the fused route with its one-function "
                "train step (fused group, fusable optimizer, local "
                "updates); training unguarded")
            self._armed = False
            return False
        grp.enable_health(window=self.spike_window,
                          stat_metric=self._spike_metric,
                          probe_period=self.sdc_probe_period)
        self._group = grp
        self._armed = True
        self._begin_epoch = int(begin_epoch)
        self._tel.gauge("armed").set(1)
        # the arm-time baseline: an IN-MEMORY snapshot of params /
        # optimizer state / RNG, so poison in the very first epoch —
        # before anything committed — still has a restore target
        # (committed entries always win when one precedes the
        # coordinate; this is the fallback, and it never writes into
        # the caller's manager, whose step-id scheme belongs to its
        # own checkpointing callbacks)
        try:
            self._baseline = self._snapshot_baseline(module)
        except Exception:  # noqa: BLE001 — first-epoch poison then
            # escalates instead of rolling back, which is loud, not wrong
            self.logger.exception(
                "guardian: baseline snapshot failed; epoch-%d poison "
                "without a committed checkpoint will escalate",
                begin_epoch)
            self._baseline = None
        return True

    def _snapshot_baseline(self, module):
        # host copies of the VALUES (the port's step writes parameters
        # in place, so a reference to live storage would move with it)
        from ..checkpoint import pack_params
        arrays = {name: arr.asnumpy().copy() for name, arr in
                  pack_params(*module.get_params()).items()}
        opt = None
        try:
            opt = module._states_updater().get_states()
        except Exception:  # noqa: BLE001 — states are continuity
            # sugar; params + rng are the parity-critical payload
            pass
        from .. import random as random_mod
        return {"params": arrays, "opt": opt,
                "rng": random_mod.get_state()}

    def disarm(self):
        if self._group is not None:
            self._group.disable_health()
        self._group = None
        self._armed = False
        self._tel.gauge("armed").set(0)

    # ----------------------------------------------------- epoch bracket
    def begin_epoch(self, module, epoch):
        """Epoch-boundary bracket: reset the device word so ``count``
        is the executed-step ordinal within this polling window, and
        start a fresh ordinal->nbatch map."""
        del module
        self._epoch = epoch
        self._epoch_steps = []
        if self._group is not None:
            self._group.health_reset()

    def should_skip(self, epoch, nbatch):
        """Whether this data coordinate was convicted by an earlier
        rollback — the fit loops pull and DISCARD it (the batch is
        consumed from the stream, so every later batch is bitwise the
        batch an untouched run would see)."""
        return (epoch, nbatch) in self.skips

    def note_skipped(self, epoch, nbatch):
        self._tel.counter("skipped_batches").add()
        self.logger.warning(
            "guardian: skipping poisoned batch (epoch %d, nbatch %d)",
            epoch, nbatch)

    def note_step(self, epoch, nbatch):
        """One executed (trained) step: ordinal->nbatch bookkeeping the
        poll uses to map a device-side step ordinal back to its data
        coordinate. Host list append only."""
        del epoch
        self._epoch_steps.append(int(nbatch))

    def maybe_poll_window(self, module, epoch):
        """Window-boundary poll INSIDE long epochs: once a full ring of
        steps has accumulated since the last bracket, judge it now and
        re-bracket — otherwise a spike early in a longer-than-window
        epoch would have scrolled out of the ring (and its ordinal map)
        by the epoch boundary, and the aftermath could convict an
        innocent later batch. One tiny readback per ``spike_window``
        executed steps, at a step boundary; the fit loops break out on
        a verdict and hand it to the epoch-level rollback. Returns the
        verdict or None."""
        if not self._armed or self._group is None:
            return None
        if len(self._epoch_steps) < self.spike_window:
            return None
        verdict = self.poll(module, epoch)
        if verdict is None:
            # healthy full window (history already extended by poll):
            # fresh bracket so ring slots and the ordinal map keep
            # corresponding one-to-one
            self._epoch_steps = []
            self._group.health_reset()
        return verdict

    # ------------------------------------------------------------ polling
    def poll(self, module, epoch):
        """The off-path judgment pass (epoch/commit boundary): read
        the health word back, map any sentinel hit or loss spike to
        its data coordinate, and return a :class:`Verdict` (or None
        for a healthy window)."""
        del module
        if not self._armed or self._group is None:
            return None
        h = self._group.health_poll()
        if h is None or h["count"] <= 0:
            return None
        flags = int(h["flags"])
        if flags:
            nbatch = self._ordinal_nbatch(h["first_bad"])
            names = _flag_names(flags)
            if flags & FLAG_SDC:
                self.sdc_mismatches += 1
                self._tel.counter("sdc_mismatches").add()
            kind = "sdc" if flags == FLAG_SDC else "nonfinite"
            return Verdict(kind=kind, epoch=epoch, nbatch=nbatch,
                           flags=flags,
                           detail={"flags": names,
                                   "first_bad_ordinal":
                                       int(h["first_bad"])})
        vals = self._ring_values(h)
        hit = spike_judge(vals, self.spike_threshold,
                          self.spike_min_samples,
                          prior=self._loss_history)
        if hit is None:
            # a healthy window extends the judge's rolling baseline;
            # convicted windows never do (their aftermath is poison)
            self._loss_history.extend(
                float(v) for _s, v in vals if onp.isfinite(v))
            del self._loss_history[:-4 * self.spike_window]
            return None
        ordinal, value, med, unit = hit
        return Verdict(kind="loss_spike", epoch=epoch,
                       nbatch=self._ordinal_nbatch(ordinal), flags=0,
                       detail={"value": round(value, 6),
                               "median": round(med, 6),
                               "unit": round(unit, 6),
                               "threshold": self.spike_threshold,
                               "ordinal": int(ordinal)})

    def _ordinal_nbatch(self, ordinal):
        """Device step ordinal (within this polling window) -> the
        nbatch coordinate of that executed step."""
        ordinal = int(ordinal)
        if 0 <= ordinal < len(self._epoch_steps):
            return self._epoch_steps[ordinal]
        # a probe/ring ordinal past the map (shouldn't happen — one
        # note_step per executed step) degrades to the newest step
        return self._epoch_steps[-1] if self._epoch_steps else 0

    def _ring_values(self, h):
        """The ring's retained ``(step_ordinal, value)`` pairs, oldest
        first: slot ``s % window`` holds executed step ``s`` for the
        last ``window`` steps."""
        count, ring = int(h["count"]), h["ring"]
        w = len(ring)
        return [(s, ring[s % w]) for s in range(max(0, count - w),
                                               count)]

    # ------------------------------------------------------------ rollback
    def rollback(self, module, verdict):
        """Restore-and-skip: walk back to the newest verifiable entry
        strictly BEFORE the verdict's data coordinate, discard the
        poisoned trajectory's newer entries, convict the coordinate,
        and hand ``fit`` the epoch to re-enter (with the module's
        ``_resume_skip`` set for a mid-epoch entry). Escalates to
        :class:`UnrecoverableNumericError` when the verdict's
        coordinate was ALREADY skipped (the state, not the data, is
        bad) or the rollback budget is exhausted."""
        coord = (int(verdict.epoch), int(verdict.nbatch))
        self.logger.warning(
            "guardian: %s verdict at (epoch %d, nbatch %d): %s",
            verdict.kind, coord[0], coord[1], verdict.detail)
        if coord in self.skips:
            self._escalate(
                "step stays bad after skipping its batch — corrupt "
                "training state, not bad data", verdict)
        if self.rollbacks + 1 > self.max_rollbacks:
            self._escalate(
                "rollback budget exhausted (max_rollbacks=%d)"
                % self.max_rollbacks, verdict)

        def before(step, extra):
            del step
            e = extra.get("epoch")
            if e is None:
                return False
            nb = extra.get("nbatch")
            # an entry without a batch coordinate trained through the
            # END of its epoch: position (e+1, -1)
            pos = (int(e), int(nb)) if nb is not None \
                else (int(e) + 1, -1)
            return pos < coord

        def finite(ckpt):
            for name, arr in ckpt.params.items():
                if onp.issubdtype(onp.dtype(arr.dtype), onp.floating) \
                        and not onp.isfinite(arr).all():
                    return "restored array %r has non-finite values" \
                        % name
            return None

        try:
            ckpt = self.manager.restore_before(before, verify=finite)
        except MXNetError as exc:
            # no committed entry precedes the coordinate (poison in the
            # first epoch, or every qualifying entry failed
            # verification): fall back to the arm-time baseline
            # snapshot — restore-to-the-very-beginning
            if self._baseline is None:
                self._escalate(
                    "no restorable entry before the poisoned "
                    "coordinate and no baseline snapshot: %s" % exc,
                    verdict)
            from ..checkpoint.manager import Checkpoint
            ckpt = Checkpoint(
                step=-1, params=dict(self._baseline["params"]),
                optimizer_state=self._baseline["opt"],
                extra={"epoch": self._begin_epoch - 1,
                       "guardian_baseline": True},
                rng=self._baseline["rng"])
        self.manager.discard_after(ckpt.step)
        # the fit resume machinery restores params/opt/rng and computes
        # the re-entry epoch (+ mid-epoch fast-forward via _resume_skip)
        new_epoch = module._resume_from(ckpt, coord[0])
        self.rollbacks += 1
        self.skips.add(coord)
        self._tel.counter("rollbacks").add()
        self._record_rollback(verdict, ckpt.step, new_epoch)
        self.logger.warning(
            "guardian: rolled back to checkpoint step %d (re-entering "
            "epoch %d, %d/%d rollbacks used); batch (epoch %d, nbatch "
            "%d) will be skipped", ckpt.step, new_epoch,
            self.rollbacks, self.max_rollbacks, coord[0], coord[1])
        return new_epoch

    def _record_rollback(self, verdict, restore_step, new_epoch):
        """The witness trail: a FlightRecorder ``guardian_rollback``
        event carrying the offending step's timeline record (when
        telemetry retained one) plus the data coordinate."""
        from .. import telemetry
        step_rec = None
        for rec in reversed(telemetry.timeline().records()):
            if rec.get("epoch") == verdict.epoch and \
                    rec.get("nbatch") == verdict.nbatch and \
                    rec.get("loop", "train") == "train":
                step_rec = dict(rec)
                break
        telemetry.flight_recorder().note(
            "guardian_rollback", verdict_kind=verdict.kind,
            epoch=int(verdict.epoch), nbatch=int(verdict.nbatch),
            flags=int(verdict.flags), detail=dict(verdict.detail),
            restore_step=int(restore_step), resume_epoch=int(new_epoch),
            step_record=step_rec)
        telemetry.log_event("guardian_rollback", {
            "kind": verdict.kind, "epoch": int(verdict.epoch),
            "nbatch": int(verdict.nbatch),
            "restore_step": int(restore_step)})

    def _escalate(self, reason, verdict):
        from .. import telemetry
        self._tel.counter("escalations").add()
        telemetry.flight_recorder().note(
            "guardian_escalation", reason=reason,
            verdict_kind=verdict.kind,
            epoch=int(verdict.epoch), nbatch=int(verdict.nbatch))
        raise UnrecoverableNumericError(
            "guardian: %s (last verdict: %s at epoch %d nbatch %d %r)"
            % (reason, verdict.kind, verdict.epoch, verdict.nbatch,
               verdict.detail))

    # ------------------------------------------------------------ stats
    def stats(self):
        """Counters for transcripts/reports: rollbacks, convicted
        coordinates, SDC probe activity."""
        return {
            "rollbacks": int(self.rollbacks),
            "skipped": sorted(list(self.skips)),
            "sdc_checks": int(self._tel.counter("sdc_checks").value)
            - self._sdc_checks_base,
            "sdc_mismatches": int(self.sdc_mismatches),
        }


def resolve(guardian):
    """``fit``'s guardian argument -> an armed-able Guardian or None.
    Accepts a Guardian, a checkpoint-directory path/manager, or None —
    in which case ``MXNET_GUARDIAN=1`` (+ ``MXNET_GUARDIAN_DIR``)
    builds one from the environment. A set ``MXNET_GUARDIAN=1``
    without a directory warns once and stays off (the guardian cannot
    roll back without a durable store)."""
    if guardian is None:
        if os.environ.get("MXNET_GUARDIAN", "0") != "1":
            return None
        directory = os.environ.get("MXNET_GUARDIAN_DIR")
        if not directory:
            logging.getLogger("mxnet_tpu_torch.guardian").warning(
                "MXNET_GUARDIAN=1 but MXNET_GUARDIAN_DIR is unset; "
                "training unguarded (the guardian needs a checkpoint "
                "directory to roll back into)")
            return None
        return Guardian(directory)
    if isinstance(guardian, Guardian):
        return guardian
    return Guardian(guardian)
