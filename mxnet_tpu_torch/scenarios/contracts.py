"""Contract engine — the verdict half of the scenario matrix (the
port's counterpart of ``mxnet_tpu/scenarios/contracts.py``).

A contract is one falsifiable claim over a finished scenario run's
result dict (built by :mod:`mxnet_tpu_torch.scenarios.runner`).  Each
``check(result)`` returns a :class:`Verdict`; the runner never
interprets results itself, so a deliberately broken contract fails
loudly in exactly one place and the report row records WHY
(``tests/test_torch_scenarios.py`` pins each failure mode).

The result-dict keys a contract may read:

- ``digest`` / ``repeat_digest``: bitwise param digests of the main
  and repeat fits;
- ``post_warmup_retraces``: CompileWatch counter delta across the
  whole scenario run;
- ``accuracy``: the scenario's score() measurement;
- ``gauges``: set of telemetry gauge names present after the run;
- ``resume_digest``: digest of the kill/resume trajectory (only when
  the scenario declares checkpoint_resume);
- ``serving``: the serving probe's dict (``{"ok": bool, ...}``);
- ``chaos``: the chaos sweep's dict (``digest`` under the armed plan,
  ``incidents``, ``unfired``) — present only in sweep mode.
"""
import collections

__all__ = ["Verdict", "Contract", "BitwiseRepeat", "ZeroRetraces",
           "AccuracyFloor", "GaugePresent", "ResumeParity",
           "ServingParity", "ChaosHeal", "evaluate"]

Verdict = collections.namedtuple("Verdict", ["contract", "ok", "detail"])


class Contract(object):
    """One claim; subclasses set ``name`` and implement ``check``."""

    name = "contract"

    def check(self, result):
        raise NotImplementedError

    def _verdict(self, ok, detail):
        return Verdict(self.name, bool(ok), detail)

    def __repr__(self):
        return type(self).__name__ + "()"


class BitwiseRepeat(Contract):
    """Re-running the identical seeded fit reproduces the trained
    params bit for bit — the determinism floor every other gate in
    this repo (chaos, resume, serving) stands on."""

    name = "bitwise_repeat"

    def check(self, result):
        a, b = result.get("digest"), result.get("repeat_digest")
        if not a or not b:
            return self._verdict(False, "missing digest(s)")
        return self._verdict(
            a == b, "digest %s vs repeat %s" % (a[:16], b[:16]))


class ZeroRetraces(Contract):
    """CompileWatch saw zero post-warmup retraces across the whole
    scenario (all fits + scoring + serving): every steady-state shape
    traced during warmup, none came back."""

    name = "zero_post_warmup_retraces"

    def check(self, result):
        n = result.get("post_warmup_retraces")
        if n is None:
            return self._verdict(False, "retrace counter not recorded")
        return self._verdict(
            int(n) == 0, "%d post-warmup retrace(s)" % int(n))


class AccuracyFloor(Contract):
    """The scored quality measurement clears the pinned floor —
    direction-aware (``mode="max"`` for perplexity/loss-like scores
    where lower is better)."""

    name = "accuracy_floor"

    def __init__(self, floor, mode="min"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max', got %r"
                             % (mode,))
        self.floor = float(floor)
        self.mode = mode

    def check(self, result):
        acc = result.get("accuracy")
        if acc is None or acc != acc:   # missing or NaN
            return self._verdict(False, "accuracy missing or NaN")
        acc = float(acc)
        ok = acc >= self.floor if self.mode == "min" \
            else acc <= self.floor
        return self._verdict(
            ok, "%.4f %s floor %.4f" % (
                acc, ">=" if self.mode == "min" else "<=", self.floor))

    def __repr__(self):
        return "AccuracyFloor(%r, mode=%r)" % (self.floor, self.mode)


class GaugePresent(Contract):
    """Every declared telemetry gauge exists in the registry snapshot
    after the run (the observability wiring actually fired)."""

    name = "gauges_present"

    def __init__(self, gauge_names):
        self.gauge_names = tuple(gauge_names)

    def check(self, result):
        have = result.get("gauges") or set()
        missing = [g for g in self.gauge_names if g not in have]
        return self._verdict(
            not missing,
            "all %d gauge(s) present" % len(self.gauge_names)
            if not missing else "missing gauge(s) %r" % (missing,))

    def __repr__(self):
        return "GaugePresent(%r)" % (self.gauge_names,)


class ResumeParity(Contract):
    """A checkpointed partial fit killed at the resume boundary and
    continued via ``fit(resume_from=manager)`` lands bitwise on the
    straight uninterrupted run."""

    name = "resume_bitwise"

    def check(self, result):
        a, b = result.get("digest"), result.get("resume_digest")
        if not a or not b:
            return self._verdict(False, "missing resume digest")
        return self._verdict(
            a == b, "straight %s vs resumed %s" % (a[:16], b[:16]))


class ServingParity(Contract):
    """The served-inference probe (Predictor or DecodeEngine) reported
    parity with the training module."""

    name = "serving_parity"

    def check(self, result):
        sv = result.get("serving")
        if not isinstance(sv, dict) or "ok" not in sv:
            return self._verdict(False, "serving probe did not report")
        return self._verdict(
            sv["ok"], sv.get("detail", "probe ok=%r" % sv["ok"]))


class ChaosHeal(Contract):
    """The chaos sweep: under the armed seeded FaultPlan every planned
    rule fired, every incident healed, and the trained params are
    bitwise identical to the fault-free run, per scenario."""

    name = "chaos_heal_bitwise"

    def check(self, result):
        ch = result.get("chaos")
        if not isinstance(ch, dict):
            return self._verdict(False, "no chaos sweep recorded")
        ref = result.get("digest")
        problems = []
        if not ref or ch.get("digest") != ref:
            problems.append("digest diverged (%s vs %s)" % (
                (ch.get("digest") or "?")[:16], (ref or "?")[:16]))
        if ch.get("unfired"):
            problems.append("unfired rule(s) %r" % (ch["unfired"],))
        if not ch.get("incidents"):
            problems.append("plan fired no incidents")
        return self._verdict(
            not problems,
            "; ".join(problems) if problems else
            "%d incident(s) healed, bitwise equal" % ch["incidents"])


def evaluate(contracts, result):
    """Run every contract over ``result``; returns (verdicts, green)
    where green is the AND of all verdicts.  A contract that raises is
    itself a failed verdict — the engine never lets one broken check
    hide the others."""
    verdicts = []
    for c in contracts:
        try:
            verdicts.append(c.check(result))
        except Exception as exc:  # noqa: BLE001 - report, don't mask
            verdicts.append(Verdict(
                getattr(c, "name", repr(c)), False,
                "contract raised %s: %s" % (type(exc).__name__, exc)))
    return verdicts, all(v.ok for v in verdicts)
