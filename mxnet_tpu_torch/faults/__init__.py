"""mxnet_tpu_torch.faults — deterministic fault injection + shared recovery
(the port's counterpart of ``mxnet_tpu/faults``; host code only).

Failure is an input, not an accident: a :class:`FaultPlan` (a seeded
list of ``(site, trigger, kind)`` rules — grammar in
:mod:`mxnet_tpu_torch.faults.plan`) is **armed** process-wide, and named
injection seams threaded through the stack evaluate it. The port's
seams are the JAX package's 25:

===========================  ===============  =============================
site                         entry point      where it lives
===========================  ===============  =============================
``checkpoint.commit``        check            between entry write and rename
``checkpoint.shard``         corrupt_file     a committed shard file
``checkpoint.manifest``      corrupt_file     a committed manifest
``checkpoint.params``        corrupt_params   restore hand-off (read SDC)
``data.transform``           check            TransformIter worker apply
``data.stager``              check            DeviceLoader stage entry
``data.device_put``          check            DeviceLoader device placement
``module.step``              poison           fit step boundary (numeric)
``guardian.sdc``             value            SDC probe's second run
``serving.worker``           check            DynamicBatcher launch path
``serving.device``           check            Predictor device launch
``serving.queue_flood``      fires            DynamicBatcher submit
``serving.cache``            corrupt_file     a committed executable entry
``serving.decode_worker``    check            DecodeEngine scheduler tick
``serving.decode_step``      check            DecodeEngine per-step launch
``serving.decode_abandon``   fires            DecodeEngine mid-stream abandon
``dist.connect``             check            bootstrap coordinator connect
``dist.heartbeat``           value            HeartbeatMonitor dead-node probe
``dist.straggler``           check            VirtualFeed per-host slice clock
``dist.worker``              check            ElasticTrainer per-batch check
``autopilot.poll``           check            Autopilot controller tick
``autopilot.scale``          check            ReplicaPool spin-up path
``gateway.accept``           fires            GatewayServer edge admission
``gateway.route``            check            Router replica selection
``gateway.stream``           check            GatewayServer token flush
===========================  ===============  =============================

``SITES`` holds the same table (site -> entry point). The discipline is
``telemetry.enabled()``'s: an UNARMED process pays one module-attribute
branch per seam (``faults.armed()``) and trains bit for bit as a build
without the seams. Armed, every firing is recorded — the plan's
incident transcript, the ``faults.*`` telemetry counters, and a
FlightRecorder ``fault_injected`` event — so a chaos gate can assert
the incidents that happened are EXACTLY the ones planned.

:func:`retry` is the shared bounded jittered-backoff helper every
transient seam heals through.

Env: ``MXNET_FAULT_PLAN`` arms a plan at import (grammar string, JSON,
or ``@file``); ``MXNET_FAULT_SEED`` seeds it; ``MXNET_FAULT_RETRIES``/
``MXNET_FAULT_BACKOFF`` set the retry defaults.
"""
from __future__ import annotations

import glob as _glob
import logging
import os
import threading

from .plan import (FaultError, FaultPlan, FaultRule, InjectedFault,
                   TransientFault, WorkerLost, KINDS, RAISING_KINDS,
                   VALUE_KINDS, FLOOD_KINDS, FILE_KINDS, NUMERIC_KINDS,
                   PARAM_KINDS)
from .retry import retry

__all__ = ["FaultError", "InjectedFault", "TransientFault", "WorkerLost",
           "FaultRule", "FaultPlan", "KINDS", "SITES", "retry", "arm",
           "disarm",
           "armed", "active", "check", "value", "fires", "corrupt_file",
           "poison", "corrupt_params", "incidents"]

_log = logging.getLogger("mxnet_tpu_torch.faults")

# the seam table (module docstring): site -> its one entry point
SITES = {
    "checkpoint.commit": "check",
    "checkpoint.shard": "corrupt_file",
    "checkpoint.manifest": "corrupt_file",
    "checkpoint.params": "corrupt_params",
    "data.transform": "check",
    "data.stager": "check",
    "data.device_put": "check",
    "module.step": "poison",
    "guardian.sdc": "value",
    "serving.worker": "check",
    "serving.device": "check",
    "serving.queue_flood": "fires",
    "serving.cache": "corrupt_file",
    "serving.decode_worker": "check",
    "serving.decode_step": "check",
    "serving.decode_abandon": "fires",
    "dist.connect": "check",
    "dist.heartbeat": "value",
    "dist.straggler": "check",
    "dist.worker": "check",
    "autopilot.poll": "check",
    "autopilot.scale": "check",
    "gateway.accept": "fires",
    "gateway.route": "check",
    "gateway.stream": "check",
}
_PLAN = None
_lock = threading.Lock()


def armed():
    """Whether a plan is armed — THE one branch an unarmed seam costs
    (the ``telemetry.enabled()`` discipline)."""
    return _PLAN is not None


def active():
    """The armed :class:`FaultPlan`, or None."""
    return _PLAN


def arm(plan, seed=None):
    """Arm ``plan`` process-wide (a :class:`FaultPlan`, a grammar/JSON
    string, or a ``@file`` path). Returns the armed plan. Re-arming
    replaces the previous plan."""
    global _PLAN
    if not isinstance(plan, FaultPlan):
        plan = FaultPlan.parse(plan, seed=int(seed or 0))
    elif seed is not None:
        plan.seed = int(seed)
    with _lock:
        _PLAN = plan
    if plan.rules:
        _log.warning("fault plan ARMED (seed %d): %s", plan.seed,
                     "; ".join(r.describe() for r in plan.rules))
    return plan


def disarm():
    """Disarm (idempotent); the previous plan stays readable for its
    transcript."""
    global _PLAN
    with _lock:
        prev, _PLAN = _PLAN, None
    return prev


def incidents():
    """The armed plan's incident transcript ([] when unarmed)."""
    plan = _PLAN
    return plan.incidents() if plan is not None else []


# ---------------------------------------------------------------------------
# incident recording
# ---------------------------------------------------------------------------
def _note_retry(site, gave_up=False):
    """Count one retry (or give-up) into the telemetry registry."""
    from .. import telemetry
    scope = telemetry.registry().scope("faults")
    scope.counter("retry_giveups" if gave_up else "retries").add()


def _record(incident):
    """One fired rule -> telemetry counter + FlightRecorder event (the
    'exactly the planned incidents' witness surface)."""
    from .. import telemetry
    telemetry.registry().scope("faults").counter("injected").add()
    telemetry.flight_recorder().note(
        "fault_injected", site=incident["site"],
        fault_kind=incident["kind"], seq=incident["seq"],
        ctx=incident["ctx"])
    _log.warning("fault injected: %s (%s) ctx=%r", incident["site"],
                 incident["kind"], incident["ctx"])


# ---------------------------------------------------------------------------
# seam entry points (each site uses exactly ONE — see the seam table)
# ---------------------------------------------------------------------------
def check(site, **ctx):
    """Raising/delaying seam. Fired ``delay`` rules sleep; fired
    ``error``/``transient``/``worker_lost`` rules raise. Returns the
    fired incidents (usually ignored). No-op unless armed."""
    plan = _PLAN
    if plan is None:
        return []
    fired = plan.evaluate(site, ctx, RAISING_KINDS)
    # record + apply delays for EVERY fired rule first: a raising rule
    # must not leave a co-fired rule's incident unrecorded (the plan
    # transcript and the FlightRecorder must stay 1:1)
    out = []
    for _rule, incident in fired:
        _record(incident)
        out.append(incident)
    for rule, _incident in fired:
        if rule.kind == "delay":
            plan.sleep(float(rule.args.get("ms", 50)) / 1000.0)
    for rule, _incident in fired:
        if rule.kind == "delay":
            continue
        if rule.kind == "transient":
            raise TransientFault(
                "injected transient fault at %s (%s)"
                % (site, rule.describe()))
        if rule.kind == "worker_lost":
            raise WorkerLost(
                "injected worker loss at %s (%s)"
                % (site, rule.describe()),
                dead_count=int(rule.args.get("dead", 1)))
        raise InjectedFault(
            "injected fault at %s (%s)" % (site, rule.describe()))
    return out


def value(site, default, **ctx):
    """Value seam: the first fired ``value`` rule's injected value,
    else ``default`` (the heartbeat dead-node count)."""
    plan = _PLAN
    if plan is None:
        return default
    fired = plan.evaluate(site, ctx, VALUE_KINDS)
    for _rule, incident in fired:
        # every fired rule records (transcript and FlightRecorder stay
        # 1:1) even though only the first rule's value is returned
        _record(incident)
    if fired:
        return fired[0][0].args.get("value", default)
    return default


def fires(site, **ctx):
    """Boolean seam: True when a ``flood`` rule fired (the serving
    queue then behaves as if at capacity)."""
    plan = _PLAN
    if plan is None:
        return False
    fired = plan.evaluate(site, ctx, FLOOD_KINDS)
    for _rule, incident in fired:
        _record(incident)
    return bool(fired)


def corrupt_file(site, root, pattern="*", **ctx):
    """Corruption seam: apply a fired ``bitflip``/``truncate`` rule to
    one committed artifact file under ``root`` matching ``pattern``.
    The target file and the flipped byte are plan-seeded draws — the
    same plan poisons the same byte every run. Returns the mutated
    path (or None)."""
    plan = _PLAN
    if plan is None:
        return None
    fired = plan.evaluate(site, ctx, FILE_KINDS)
    mutated = None
    for rule, incident in fired:
        _record(incident)
        candidates = sorted(
            p for p in _glob.glob(os.path.join(str(root), pattern))
            if os.path.isfile(p))
        if not candidates:
            _log.warning("fault %s fired but no file matches %s/%s",
                         site, root, pattern)
            continue
        path = candidates[plan.draw(incident["seq"], 1)
                          % len(candidates)]
        size = os.path.getsize(path)
        if rule.kind == "truncate":
            with open(path, "r+b") as f:
                f.truncate(max(size // 2, 1))
            _log.warning("fault: truncated %s to %d bytes", path,
                         max(size // 2, 1))
        else:
            off = plan.draw(incident["seq"], 2) % max(size, 1)
            with open(path, "r+b") as f:
                f.seek(off)
                byte = f.read(1)
                f.seek(off)
                f.write(bytes([(byte[0] if byte else 0) ^ 0xFF]))
            _log.warning("fault: flipped byte %d of %s", off, path)
        incident["target"] = os.path.basename(path)
        mutated = path
    return mutated


def poison(site, **ctx):
    """Numeric seam (the :mod:`mxnet_tpu_torch.guardian` drivers): the batch
    multiplier a fired numeric rule injects at the step boundary —
    ``float('nan')`` for ``grad_nonfinite`` (non-finite loss/grads/
    params downstream), the rule's ``value=`` (default 1000) for
    ``loss_spike`` (a finite but poisonous batch) — or None when
    nothing fired. The fit loops apply the factor to the step's first
    floating data input. No-op unless armed."""
    plan = _PLAN
    if plan is None:
        return None
    fired = plan.evaluate(site, ctx, NUMERIC_KINDS)
    factor = None
    for rule, incident in fired:
        # every fired rule records (transcript and FlightRecorder stay
        # 1:1) even though only the first rule's factor applies
        _record(incident)
        if factor is None:
            factor = float("nan") if rule.kind == "grad_nonfinite" \
                else float(rule.args.get("value", 1000.0))
    return factor


def corrupt_params(site, params, **ctx):
    """Restore-hand-off SDC seam: a fired ``param_bitflip`` rule
    corrupts ONE element of one restored float parameter array IN
    PLACE — the element's bit pattern is forced to a quiet-NaN, the
    deterministic spelling of a silent read-path corruption the
    guardian's param sentinel (or its post-restore verification) must
    catch. Target array and element are plan-seeded draws. Returns the
    corrupted array name (or None)."""
    plan = _PLAN
    if plan is None:
        return None
    fired = plan.evaluate(site, ctx, PARAM_KINDS)
    target = None
    import numpy as onp
    for _rule, incident in fired:
        _record(incident)
        names = sorted(n for n, a in params.items()
                       if hasattr(a, "dtype")
                       and onp.issubdtype(onp.dtype(a.dtype),
                                          onp.floating)
                       and getattr(a, "size", 0) > 0)
        if not names:
            _log.warning("fault %s fired but no float param to corrupt",
                         site)
            continue
        name = names[plan.draw(incident["seq"], 1) % len(names)]
        arr = params[name]
        idx = plan.draw(incident["seq"], 2) % arr.size
        flat = arr.reshape(-1)
        if flat.dtype == onp.float32:
            # force a quiet-NaN bit pattern (exponent all-ones +
            # mantissa MSB) — guaranteed non-finite whatever the
            # element held, unlike a single-bit flip
            bits = flat.view(onp.uint32)
            bits[idx] |= onp.uint32(0x7FC00000)
        else:
            flat[idx] = onp.nan
        incident["target"] = name
        incident["element"] = int(idx)
        _log.warning("fault: corrupted %s[%d] of restored params",
                     name, idx)
        target = name
    return target


def _autostart():
    spec = os.environ.get("MXNET_FAULT_PLAN")
    if spec:
        arm(spec, seed=int(os.environ.get("MXNET_FAULT_SEED", "0")))


_autostart()
