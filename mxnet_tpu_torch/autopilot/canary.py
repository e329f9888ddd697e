"""CanaryController — continuous delivery over the tenancy plane (the
port's counterpart of ``mxnet_tpu/autopilot/canary.py``).

Watches a :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager` for new
committed generations (``step_metadata()`` reads ``params_digest``
without loading arrays), admits each one as a LOW-priority, unprotected
canary tenant on the serving :class:`~mxnet_tpu_torch.serving.DynamicBatcher`,
and promotes or rolls back from two sensors:

* the canary tenant's OWN ``slo.*`` burn windows (per-tenant SLO from
  the tenancy plane — protected/stable traffic never shares them);
* an accuracy/parity **probe** run out-of-band against the canary
  Predictor each poll (default: a fixed zero batch whose outputs must
  be finite — a NaN-poisoned generation fails it on the first tick).

The safety contract: a poisoned generation can only reach the
protected route through ``promote``, and ``promote`` requires a
passing probe after ``canary_soak_ticks`` clean polls — so a poisoned
canary is rolled back (and its step marked rejected, never re-admitted)
while the stable tenant keeps serving its own generation untouched.
The decision itself lives in :func:`mxnet_tpu_torch.autopilot.kernel
.decide_canary`; this class is the sensor (``observe``) and the
actuator (``apply``).
"""
from __future__ import annotations

import logging

__all__ = ["CanaryController", "finite_probe"]


def finite_probe(inputs=None, batch=None):
    """Build the default accuracy probe: ``probe(predictor) -> bool``
    running one fixed batch (``inputs`` name->array, or zeros at the
    smallest bucket) and requiring every output element finite. The
    cheapest possible parity check — it catches the failure class the
    chaos plan injects (non-finite params) without a labeled set;
    pass your own callable for a real accuracy/parity gate."""
    import numpy as onp

    def probe(pred):
        feed = inputs
        if feed is None:
            b = batch or pred.buckets[0]
            feed = {name: onp.zeros((b,) + tuple(shape[1:]),
                                    onp.float32)
                    for name, shape in pred._data_descs}
        outs = pred.predict(feed)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        return all(bool(onp.isfinite(onp.asarray(o)).all())
                   for o in outs)
    return probe


class CanaryController(object):
    """Sensor + actuator for one stable/canary tenant pair.

    Parameters
    ----------
    manager : CheckpointManager or str
        The trainer's checkpoint directory — each newly committed step
        is a candidate generation.
    batcher : DynamicBatcher
        The serving plane; must host the ``stable_name`` tenant. The
        canary is admitted/removed via ``add_tenant``/``remove_tenant``
        and a promotion atomically swaps the stable route
        (``replace_tenant``).
    stable_step : int
        The generation the stable tenant currently serves (promotions
        advance it).
    data_shapes : list, optional
        ``Predictor.load`` shapes for admitted generations (required
        with the default ``predictor_factory``).
    predictor_factory : callable, optional
        ``factory(step) -> Predictor`` for a committed step; defaults
        to ``Predictor.load(manager, step, data_shapes=...)`` warmed
        through ``cache_dir``.
    probe : callable, optional
        ``probe(predictor) -> bool`` accuracy/parity gate (default
        :func:`finite_probe` at the smallest bucket).
    slo_factory : callable, optional
        ``slo_factory(name) -> SLOTracker`` building the canary
        tenant's own objectives; None admits the canary without a
        tracker (probe-only gating).
    cache_dir : str, optional
        Executable-cache root each admitted generation warms from.
    """

    def __init__(self, manager, batcher, stable_step,
                 data_shapes=None, stable_name="stable",
                 canary_name="canary", predictor_factory=None,
                 probe=None, slo_factory=None, cache_dir=None,
                 context=None, logger=None):
        from ..checkpoint import CheckpointManager
        if isinstance(manager, str):
            manager = CheckpointManager(manager)
        self.manager = manager
        self.batcher = batcher
        self.stable_step = stable_step
        self.stable_name = str(stable_name)
        self.canary_name = str(canary_name)
        self._data_shapes = data_shapes
        self._factory = predictor_factory
        self._probe = probe or finite_probe()
        self._slo_factory = slo_factory
        self._cache_dir = cache_dir
        self._context = context
        self._logger = logger or logging.getLogger(
            "mxnet_tpu_torch.autopilot")
        self._canary = None      # {"step", "predictor", "since_tick"}
        self._rejected = set()   # steps rolled back — never re-admitted
        from .. import telemetry
        scope = telemetry.registry().scope("autopilot")
        self._c_admit = scope.counter("canary_admissions")
        self._c_promote = scope.counter("canary_promotions")
        self._c_rollback = scope.counter("canary_rollbacks")
        self._g_canary = scope.gauge("canary_step")

    # ------------------------------------------------------- sensors
    def observe(self, tick=0, now=None):
        """One poll of the delivery sensors, as the JSON-able obs dict
        :func:`~mxnet_tpu_torch.autopilot.kernel.decide_canary` consumes.
        Re-runs the probe on a live canary every poll — the probe is a
        sensor, and a generation that degrades AFTER admission must
        still fail before its soak completes."""
        latest = self.manager.latest()
        obs = {"latest_step": latest, "stable_step": self.stable_step,
               "canary_step": None, "probe_ok": None,
               "canary_breach": False, "ticks_in_canary": 0,
               "rejected": bool(latest is not None
                                and latest in self._rejected)}
        if self._canary is not None:
            c = self._canary
            obs["canary_step"] = c["step"]
            obs["ticks_in_canary"] = int(tick) - c["since_tick"]
            obs["probe_ok"] = self._run_probe(c["predictor"])
            ten = self.batcher.tenant(self.canary_name)
            obs["canary_breach"] = bool(
                ten.slo is not None and ten.slo.breached(now=now))
        return obs

    def _run_probe(self, pred):
        try:
            return bool(self._probe(pred))
        except Exception as exc:  # noqa: BLE001 — a probe that cannot
            # run is a failing probe: the generation must not promote
            # on a broken sensor
            self._logger.warning("canary probe raised: %r", exc)
            return False

    def _load(self, step):
        if self._factory is not None:
            return self._factory(step)
        from ..serving import Predictor
        pred = Predictor.load(self.manager, step,
                              data_shapes=self._data_shapes,
                              context=self._context)
        pred.warmup(cache_dir=self._cache_dir)
        return pred

    # ------------------------------------------------------ actuators
    def apply(self, decision, tick=0):
        """Actuate one kernel decision (``admit``/``promote``/
        ``rollback``; ``hold`` is a no-op)."""
        action = decision.get("action")
        if action == "admit":
            self._admit(decision["step"], tick)
        elif action == "rollback":
            self._rollback(decision)
        elif action == "promote":
            self._promote(decision)

    def _admit(self, step, tick):
        from .. import telemetry
        from ..serving import Tenant
        pred = self._load(step)
        slo = self._slo_factory("%s_%d" % (self.canary_name, step)) \
            if self._slo_factory is not None else None
        # priority 0 + protected=False: the canary is the FIRST tenant
        # shed under pressure and never survives its own breach
        self.batcher.add_tenant(Tenant(self.canary_name, pred, slo=slo,
                                       priority=0, protected=False))
        self._canary = {"step": step, "predictor": pred,
                        "since_tick": int(tick)}
        self._c_admit.add()
        self._g_canary.set(step)
        telemetry.flight_recorder().note(
            "canary_admitted", step=step,
            digest=(pred.params_digest or "")[:12])
        self._logger.info("autopilot: admitted step %d as canary %r",
                          step, self.canary_name)

    def _rollback(self, decision):
        from .. import telemetry
        c, self._canary = self._canary, None
        self.batcher.remove_tenant(self.canary_name)
        self._rejected.add(c["step"])
        c["predictor"].release()
        self._c_rollback.add()
        self._g_canary.set(-1)
        telemetry.flight_recorder().note(
            "canary_rollback", step=c["step"],
            reason=decision.get("reason"))
        self._logger.warning(
            "autopilot: rolled back canary step %d (%s) — generation "
            "marked rejected", c["step"], decision.get("reason"))

    def _promote(self, decision):
        from .. import telemetry
        from ..serving import Tenant
        c, self._canary = self._canary, None
        # remove the canary route FIRST: the promoted Predictor must
        # not be hosted under two names (the batcher refuses shared
        # predictor instances across tenants)
        self.batcher.remove_tenant(self.canary_name)
        old = self.batcher.tenant(self.stable_name)
        self.batcher.replace_tenant(self.stable_name, Tenant(
            self.stable_name, c["predictor"], slo=old.slo,
            priority=max(1, old.priority), protected=True))
        old.predictor.release()
        self.stable_step = c["step"]
        self._c_promote.add()
        self._g_canary.set(-1)
        telemetry.flight_recorder().note(
            "canary_promoted", step=c["step"],
            reason=decision.get("reason"))
        self._logger.info(
            "autopilot: promoted canary step %d to %r", c["step"],
            self.stable_name)

    # ---------------------------------------------------------- misc
    @property
    def canary_step(self):
        """The live canary's generation, or None."""
        return self._canary["step"] if self._canary is not None else None

    @property
    def rejected_steps(self):
        """Generations rolled back (never re-admitted), sorted."""
        return sorted(self._rejected)
