"""Matrix runner — executes registered scenarios through the REAL
``Module.fit`` / serving stack (no mocks) and evaluates their
contracts (the port's counterpart of ``mxnet_tpu/scenarios/runner.py``).

One scenario run is a fixed pipeline (each phase only when the
scenario's feature tags ask for it):

1. main fit       -> param digest, accuracy score, serving probe
2. repeat fit     -> bitwise-repeat digest
3. kill/resume    -> partial fit checkpointed via module_checkpoint,
                     fresh module continued with fit(resume_from=...),
                     digest must land on the straight run
4. chaos sweep    -> the same fit under an armed seeded FaultPlan
                     (sweep mode only): heal-to-bitwise, all rules
                     fired

``compile.post_warmup_retraces`` is measured as a delta across the
WHOLE scenario (all fits, scoring, serving): every steady-state shape
must run its first program during its fit's warmup (the first epoch)
and never come back.  Serving warmups count into their own CompileWatch
stream and stay out of this counter by design.
"""
import hashlib
import logging
import shutil
import tempfile
import time

from .contracts import ChaosHeal, evaluate
from .registry import get, selected_names

__all__ = ["param_digest", "run_scenario", "run_matrix", "chaos_sweep"]

log = logging.getLogger("mxnet_tpu_torch.scenarios")


def _seed_all(seed):
    """Pin every RNG a scenario's data/model factories may draw from —
    python's global `random` (BucketSentenceIter's shuffle), numpy's
    global state (synthetic data, det augment), and the mx trainer
    RNG."""
    import random as pyrandom

    import numpy as onp

    import mxnet_tpu_torch as mx
    pyrandom.seed(seed)
    onp.random.seed(seed)
    mx.random.seed(seed)


def param_digest(mod):
    """sha256 over the trained params, sorted by name — the bitwise
    identity every parity contract in this repo compares (the JAX
    package's arithmetic: each array's host bytes in name order)."""
    h = hashlib.sha256()
    args, auxs = mod.get_params()
    for k in sorted(args):
        h.update(args[k].asnumpy().tobytes())
    for k in sorted(auxs):
        h.update(auxs[k].asnumpy().tobytes())
    return h.hexdigest()


def _run_fit(sc, epochs=None, manager=None, resume=False):
    """One seeded fit through the scenario's factories; returns the
    trained module.  ``manager`` + ``resume=False`` checkpoints every
    epoch (the kill half of kill/resume); ``resume=True`` continues
    from the manager's newest entry (the resume half)."""
    import mxnet_tpu_torch as mx
    _seed_all(sc.seed)
    mod = sc.make_module()
    data = sc.make_data(mod)
    kw = dict(sc.fit_kwargs() if callable(sc.fit_kwargs)
              else sc.fit_kwargs)
    if epochs is not None:
        kw["num_epoch"] = int(epochs)
    callbacks = []
    if manager is not None and not resume:
        callbacks.append(mx.callback.module_checkpoint(
            mod, save_optimizer_states=True, manager=manager,
            async_save=True))
    guard, guard_dir = None, None
    if "guardian" in sc.features:
        guard_dir = tempfile.mkdtemp(prefix="scenario_guardian_")
        guard = mx.guardian.Guardian(guard_dir)
    try:
        mod.fit(data,
                epoch_end_callback=callbacks or None,
                resume_from=manager if resume else None,
                guardian=guard, **kw)
    finally:
        if guard_dir is not None:
            shutil.rmtree(guard_dir, ignore_errors=True)
    return mod


def chaos_sweep(sc, reference_digest=None):
    """Re-run the scenario's fit under its armed seeded FaultPlan:
    every planned rule must fire, every incident must heal, and the
    trained params must stay bitwise identical to the fault-free run
    (``reference_digest``; computed fresh when not supplied).  Returns
    the chaos result dict the :class:`ChaosHeal` contract reads."""
    import mxnet_tpu_torch as mx
    if not sc.chaos_rules:
        raise ValueError(
            "scenario %r declares no chaos_rules to sweep" % sc.name)
    if reference_digest is None:
        reference_digest = param_digest(_run_fit(sc))
    plan = mx.faults.arm(";".join(sc.chaos_rules), seed=sc.seed)
    try:
        mod = _run_fit(sc)
        digest = param_digest(mod)
        incidents = len(plan.incidents())
        unfired = [r.describe() for r in plan.unfired()]
    finally:
        mx.faults.disarm()
    return {"digest": digest, "reference": reference_digest,
            "incidents": incidents, "unfired": unfired,
            "rules": list(sc.chaos_rules)}


def run_scenario(sc, chaos=False):
    """Execute one scenario end to end and judge its contracts.
    Returns the report row (a JSON-ready dict); ``row["green"]`` is
    the AND of every contract verdict."""
    from mxnet_tpu_torch import telemetry
    if isinstance(sc, str):
        sc = get(sc)
    log.info("scenario %s: features %s", sc.name, sorted(sc.features))
    t0 = time.time()
    telemetry.enable()
    try:
        counter = telemetry.registry().counter(
            "compile.post_warmup_retraces")
        before = counter.value
        mod = _run_fit(sc)
        fit_seconds = time.time() - t0
        result = {"digest": param_digest(mod)}
        result["accuracy"] = float(sc.score(mod))
        result["gauges"] = set(
            telemetry.registry().snapshot()["gauges"])
        if sc.serving is not None:
            result["serving"] = sc.serving(mod)
        result["repeat_digest"] = param_digest(_run_fit(sc))
        if "checkpoint_resume" in sc.features:
            ckpt_dir = tempfile.mkdtemp(prefix="scenario_ckpt_")
            try:
                from mxnet_tpu_torch.checkpoint import CheckpointManager
                manager = CheckpointManager(ckpt_dir)
                _run_fit(sc, epochs=sc.resume_at, manager=manager)
                manager.wait_until_finished()
                assert manager.latest() is not None, \
                    "partial fit committed no checkpoint entry"
                result["resume_digest"] = param_digest(
                    _run_fit(sc, manager=manager, resume=True))
            finally:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
        if chaos and sc.chaos_rules:
            result["chaos"] = chaos_sweep(
                sc, reference_digest=result["digest"])
        result["post_warmup_retraces"] = int(counter.value - before)
    finally:
        telemetry.disable()
    contracts = sc.contracts()
    if "chaos" in result:
        contracts.append(ChaosHeal())
    verdicts, green = evaluate(contracts, result)
    row = {
        "features": sorted(sc.features),
        "seed": sc.seed,
        "digest": result["digest"][:16],
        "repeat_digest": result["repeat_digest"][:16],
        "post_warmup_retraces": result["post_warmup_retraces"],
        "accuracy": round(result["accuracy"], 6),
        "floor": sc.floor,
        "floor_mode": sc.floor_mode,
        "fit_seconds": round(fit_seconds, 3),
        "contracts": {v.contract: {"ok": v.ok, "detail": v.detail}
                      for v in verdicts},
        "green": green,
    }
    if "resume_digest" in result:
        row["resume_digest"] = result["resume_digest"][:16]
    if "serving" in result:
        row["serving"] = result["serving"]
    if "chaos" in result:
        ch = dict(result["chaos"])
        ch["digest"] = ch["digest"][:16]
        ch["reference"] = ch["reference"][:16]
        row["chaos"] = ch
    for v in verdicts:
        (log.info if v.ok else log.error)(
            "scenario %s: %s %s (%s)", sc.name, v.contract,
            "PASS" if v.ok else "FAIL", v.detail)
    return row


def run_matrix(names=None, chaos=False, environ=None):
    """Run the selected scenarios (``names``, else the
    MXNET_SCENARIOS / MXNET_SCENARIO_FILTER selection, else all) and
    return the matrix report::

        {"selected": [...], "scenarios": {name: row},
         "green": bool}

    ``chaos=True`` additionally sweeps every selected scenario that
    declares chaos rules.
    """
    picked = list(names) if names is not None \
        else selected_names(environ)
    if not picked:
        raise ValueError("no scenarios selected (registry empty or "
                         "filters matched nothing)")
    rows = {}
    for name in picked:
        rows[name] = run_scenario(get(name), chaos=chaos)
    return {"selected": picked, "scenarios": rows,
            "green": all(r["green"] for r in rows.values())}
