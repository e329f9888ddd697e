"""FaultPlan — declarative, deterministically seeded fault injection (the
port's copy of ``mxnet_tpu/faults/plan.py``: pure host code, so the same
plan and seed fire, draw and corrupt exactly as the JAX package's do).

A plan is a list of :class:`FaultRule` entries, each naming an
injection **site** (a dotted seam name like ``checkpoint.commit`` or
``serving.worker``), a **kind** (what happens when the rule fires), and
a **trigger** (when it fires). The whole plan carries ONE seed; every
probabilistic draw and every corruption offset is a pure SplitMix fold
of ``(seed, rule index, evaluation counter)`` — so the same plan + seed
over the same workload produces the same incident transcript, and a
fault run is replayable the way a seeded training run is.

Rule grammar (the ``FaultPlan.parse`` / ``MXNET_FAULT_PLAN`` spelling)::

    site:kind[@key=value[,key=value...]] [; site:kind@... ...]

Trigger keys (at most one of ``nth``/``prob``; context matches compose
with either):

* ``nth=N``   — fire on the N-th evaluation of the site (1-based).
  Deterministic for serially-evaluated sites (the step loop, the
  batcher worker); concurrent sites (transform workers) should match
  on context instead.
* ``prob=P``  — fire with probability P per evaluation, drawn from the
  plan-seeded SplitMix stream (never from wall time or ``random``).
* any other ``key=value`` — fire only when the seam's context carries
  that exact coordinate (``step=12``, ``epoch=1``, ``num_update=14``,
  ``index=3``...). This is the "fire at step/epoch/request N" spelling.

Behavior keys:

* ``count=N`` — maximum firings (default 1; ``count=0`` = unlimited).
* ``ms=N``    — delay duration for ``kind=delay`` (default 50).
* ``value=N`` — the injected value for ``kind=value``.
* ``dead=N``  — dead-peer count for ``kind=worker_lost`` (default 1).

Kinds (which seams honor which kind is the seam table in
:mod:`mxnet_tpu_torch.faults`):

=============  ==========================================================
``error``      raise :class:`InjectedFault` (permanent — never retried)
``transient``  raise :class:`TransientFault` (healed by ``faults.retry``)
``delay``      ``time.sleep(ms)`` — a straggler / slow device
``value``      seam reads an injected value (heartbeat dead count)
``worker_lost``  raise :class:`mxnet_tpu_torch.dist.WorkerLost` (elastic path)
``flood``      boolean fire — the serving queue treats itself as full
``bitflip``    flip one byte of a committed artifact file
``truncate``   truncate a committed artifact file to half its size
``grad_nonfinite``  poison one step's batch with NaN (numeric seam)
``loss_spike``      scale one step's batch by ``value=`` (default 1000)
``param_bitflip``   corrupt one restored parameter element (read SDC)
=============  ==========================================================

Every firing appends one incident to the plan's transcript (and, via
:mod:`mxnet_tpu_torch.faults`, to the telemetry ``faults.*`` counters and the
FlightRecorder event ring) — the chaos-soak gate asserts the recorded
incidents are EXACTLY the planned ones.
"""
from __future__ import annotations

import json
import threading
import time

from ..base import MXNetError

__all__ = ["FaultError", "InjectedFault", "TransientFault", "WorkerLost",
           "FaultRule", "FaultPlan", "KINDS", "NUMERIC_KINDS", "PARAM_KINDS"]

KINDS = ("error", "transient", "delay", "value", "worker_lost", "flood",
         "bitflip", "truncate", "grad_nonfinite", "loss_spike",
         "param_bitflip")

# which kinds each seam entry point (faults.check/value/fires/
# corrupt_file/poison/corrupt_params) dispatches — a rule whose kind
# the site's entry point does not honor simply never fires there
# (documented in the seam table)
RAISING_KINDS = ("error", "transient", "worker_lost", "delay")
VALUE_KINDS = ("value",)
FLOOD_KINDS = ("flood",)
FILE_KINDS = ("bitflip", "truncate")
# numeric seams (the training-guardian drivers, mxnet_tpu_torch.guardian):
# grad_nonfinite poisons a step's batch with NaN (non-finite
# loss/grads/params downstream); loss_spike scales it by a large
# finite factor (``value=``, default 1000) — a finite-but-poisonous
# batch; param_bitflip corrupts one restored parameter element's bit
# pattern at the checkpoint-restore hand-off (a read-path SDC)
NUMERIC_KINDS = ("grad_nonfinite", "loss_spike")
PARAM_KINDS = ("param_bitflip",)

# behavior/trigger keys that are NOT context matches
_RESERVED = ("nth", "prob", "count", "ms", "value", "dead")


class FaultError(MXNetError):
    """Base class of every plan-injected failure."""


class InjectedFault(FaultError):
    """A permanent injected failure — recovery must route around it
    (fallback entry, worker restart, failed future), never retry it."""


class TransientFault(InjectedFault):
    """A retryable injected failure — :func:`mxnet_tpu_torch.faults.retry`
    heals it with bounded jittered backoff."""


# the elastic path's signal is the dist runtime's own class (the same
# object, so one ``except WorkerLost`` catches a planned and a detected
# loss alike)
from ..dist.elastic import WorkerLost  # noqa: E402


def splitmix64(x):
    """One SplitMix64 scramble step (the TransformIter/DeviceAugment
    seeding discipline): adjacent inputs land on unrelated outputs,
    and the value is a pure function of its input."""
    x = (x + 0x9e3779b97f4a7c15) & 0xffffffffffffffff
    x = ((x ^ (x >> 30)) * 0xbf58476d1ce4e5b9) & 0xffffffffffffffff
    x = ((x ^ (x >> 27)) * 0x94d049bb133111eb) & 0xffffffffffffffff
    return x ^ (x >> 31)


def fold(*parts):
    """Fold integers into one 64-bit SplitMix draw."""
    x = 0
    for p in parts:
        x = splitmix64((x ^ (int(p) & 0xffffffffffffffff)))
    return x


def _coerce(text):
    """Grammar values: int when int-like, float when float-like, else
    the raw string."""
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


class FaultRule(object):
    """One ``(site, trigger, kind)`` entry of a plan (module docstring
    has the grammar). Build directly or via :meth:`parse`."""

    def __init__(self, site, kind, nth=None, prob=None, count=1,
                 match=None, args=None):
        self.site = str(site)
        self.kind = str(kind)
        if self.kind not in KINDS:
            raise MXNetError("unknown fault kind %r (known: %s)"
                             % (kind, ", ".join(KINDS)))
        if nth is not None and prob is not None:
            raise MXNetError("rule %s:%s: nth= and prob= are exclusive "
                             "triggers" % (self.site, self.kind))
        self.nth = int(nth) if nth is not None else None
        if self.nth is not None and self.nth < 1:
            raise MXNetError("nth= is 1-based (got %d)" % self.nth)
        self.prob = float(prob) if prob is not None else None
        self.count = int(count)
        self.match = dict(match or {})
        self.args = dict(args or {})
        self.evals = 0      # evaluations of this rule's site
        self.fired = 0      # times this rule actually fired

    @classmethod
    def parse(cls, text):
        """``site:kind[@k=v,...]`` -> FaultRule."""
        text = text.strip()
        head, _, tail = text.partition("@")
        site, sep, kind = head.partition(":")
        if not sep or not site.strip() or not kind.strip():
            raise MXNetError(
                "fault rule %r does not parse: expected "
                "'site:kind[@key=value,...]'" % text)
        kw = {"match": {}, "args": {}}
        for item in filter(None, (s.strip() for s in tail.split(","))):
            key, sep, val = item.partition("=")
            if not sep:
                raise MXNetError("fault rule %r: %r is not key=value"
                                 % (text, item))
            key, val = key.strip(), _coerce(val.strip())
            if key in ("nth", "prob", "count"):
                kw[key] = val
            elif key in ("ms", "value", "dead"):
                kw["args"][key] = val
            else:
                kw["match"][key] = val
        return cls(site.strip(), kind.strip(), **kw)

    def describe(self):
        bits = []
        if self.nth is not None:
            bits.append("nth=%d" % self.nth)
        if self.prob is not None:
            bits.append("prob=%g" % self.prob)
        bits += ["%s=%s" % kv for kv in sorted(self.match.items())]
        bits += ["%s=%s" % kv for kv in sorted(self.args.items())]
        spec = "%s:%s" % (self.site, self.kind)
        return spec + ("@" + ",".join(bits) if bits else "")

    def to_dict(self):
        return {"site": self.site, "kind": self.kind, "nth": self.nth,
                "prob": self.prob, "count": self.count,
                "match": dict(self.match), "args": dict(self.args)}

    # ----------------------------------------------------------- firing
    def _matches(self, ctx):
        for key, want in self.match.items():
            if key not in ctx or ctx[key] != want:
                return False
        return True

    def should_fire(self, ctx, seed, index):
        """Evaluate one seam hit against this rule (advances the
        rule's evaluation counter). Pure given (plan seed, rule index,
        counter state) — no wall clock, no global RNG."""
        self.evals += 1
        if self.count and self.fired >= self.count:
            return False
        if not self._matches(ctx):
            return False
        if self.nth is not None:
            return self.evals == self.nth
        if self.prob is not None:
            draw = fold(seed, index, self.evals) / float(1 << 64)
            return draw < self.prob
        # pure context match: fire every matching evaluation (bounded
        # by count, default 1)
        return True


class FaultPlan(object):
    """A seeded list of :class:`FaultRule` entries plus the incident
    transcript their firings produce. Thread-safe: seams are evaluated
    from stager/worker/batcher threads."""

    def __init__(self, rules, seed=0):
        self.rules = []
        for r in rules:
            self.rules.append(r if isinstance(r, FaultRule)
                              else FaultRule.parse(r) if isinstance(r, str)
                              else FaultRule(**r))
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._transcript = []
        self._seq = 0

    # ---------------------------------------------------------- parsing
    @classmethod
    def parse(cls, spec, seed=0):
        """Build a plan from the grammar string (rules separated by
        ``;``), a JSON list (text beginning ``[``), or a file path
        prefixed ``@`` containing either."""
        spec = str(spec).strip()
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                spec = f.read().strip()
        if spec.startswith("["):
            entries = json.loads(spec)
            return cls([FaultRule(**e) if isinstance(e, dict)
                        else FaultRule.parse(e) for e in entries],
                       seed=seed)
        rules = [FaultRule.parse(part)
                 for part in filter(None, (s.strip()
                                           for s in spec.split(";")))]
        if not rules:
            return cls([], seed=seed)
        return cls(rules, seed=seed)

    def describe(self):
        return {"seed": self.seed,
                "rules": [r.describe() for r in self.rules]}

    # --------------------------------------------------------- evaluate
    def evaluate(self, site, ctx, kinds):
        """All rules for ``site`` (restricted to the entry point's
        ``kinds``) that fire on this evaluation; appends one incident
        per firing to the transcript."""
        fired = []
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.site != site or rule.kind not in kinds:
                    continue
                if rule.should_fire(ctx, self.seed, i):
                    rule.fired += 1
                    self._seq += 1
                    incident = {
                        "seq": self._seq,
                        "site": site,
                        "kind": rule.kind,
                        "rule": rule.describe(),
                        "ctx": {k: v for k, v in sorted(ctx.items())},
                    }
                    self._transcript.append(incident)
                    fired.append((rule, incident))
        return fired

    def draw(self, *parts):
        """A deterministic 64-bit draw in the plan's seeded stream
        (corruption offsets, jitter)."""
        return fold(self.seed, *parts)

    # -------------------------------------------------------- reporting
    def incidents(self):
        """The incident transcript so far, oldest first."""
        with self._lock:
            return [dict(i) for i in self._transcript]

    def unfired(self):
        """Deterministic rules (nth / pure context match) that never
        fired — a chaos gate asserts this is empty, so a plan that
        silently missed its target step fails loudly."""
        with self._lock:
            return [r.describe() for r in self.rules
                    if r.prob is None and r.fired == 0]

    def sleep(self, seconds):
        """The delay-kind clock (separated for tests to stub)."""
        time.sleep(seconds)
