"""mxnet_tpu_torch.autopilot — the fleet controller closing the
telemetry→action loop (the port's counterpart of
``mxnet_tpu/autopilot``).

Every sensor this repo grew (``slo.*`` burn-rate gauges, checkpoint
manifests with ``params_digest``, restart transcripts) and every
actuator (multi-tenant serving admission, the persistent executable
cache, elastic restarts) existed — with a human between them. The
autopilot is the deterministic poll loop that removes the human, in
three planes:

* **serving autoscale** — :class:`ReplicaPool` spins replicas up/down
  against an :class:`~mxnet_tpu_torch.telemetry.SLOTracker`'s burn state
  with hysteresis: a BOTH-window breach scales out, sustained idle
  scales in, bounded by min/max replicas and a cooldown; every
  spin-up warms through the persistent executable cache (zero
  compiles, bitwise rows);
* **continuous delivery** — :class:`CanaryController` admits each new
  committed checkpoint generation as a low-priority canary tenant,
  promotes after a clean soak, rolls back on SLO burn or a failing
  accuracy probe; a poisoned generation never takes protected traffic;
* **training goodput** — :class:`PeerCheckpointStore` keeps ring-
  replicated in-memory copies of every elastic commit so a dp-shrink
  resume restores from host memory instead of disk
  (``ElasticTrainer(peer_store=...)``).

Every decision is a pure function of (config, polled snapshot, seed)
in :mod:`~mxnet_tpu_torch.autopilot.kernel`; the controller only assembles
observations and actuates. Each tick appends ``{tick, plane, obs,
decision}`` to ``Autopilot.transcript`` and :meth:`Autopilot.replay`
re-derives every decision — a divergence is a bug (pinned by
tests/test_torch_autopilot.py). Observability rides ``autopilot.*``
gauges/counters and FlightRecorder events; the controller's own
misbehavior is chaos-testable through the ``autopilot.poll`` and
``autopilot.scale`` fault seams (unarmed = bitwise no-op).

The subsystem is opt-in end to end: nothing constructs these classes
unless you do, and the background loop (:meth:`Autopilot.start`) only
runs under ``MXNET_AUTOPILOT=1`` — an autopilot-off process is bitwise
identical to one where the subsystem doesn't exist.

Quick start::

    from mxnet_tpu_torch import autopilot

    pool = autopilot.ReplicaPool(make_predictor, min_replicas=1,
                                 max_replicas=3, cache_dir=cache)
    ap = autopilot.Autopilot(
        config=autopilot.AutopilotConfig(cooldown_ticks=2),
        slo=tracker, pool=pool)
    ap.step()          # one deterministic tick (tests drive this)
    ap.start()         # ... or the MXNET_AUTOPILOT=1 background loop
    assert ap.replay() == []   # transcript re-derives bitwise
"""
from __future__ import annotations

import logging
import os
import threading

from .. import faults as _faults
from .canary import CanaryController, finite_probe
from .kernel import (AutopilotConfig, decide_canary, decide_resume,
                     decide_scale, replay)
from .peer import PeerCheckpointStore
from .pool import ReplicaPool

__all__ = ["Autopilot", "AutopilotConfig", "ReplicaPool",
           "CanaryController", "PeerCheckpointStore", "finite_probe",
           "decide_scale", "decide_canary", "decide_resume", "replay",
           "enabled"]


def enabled():
    """Whether the background autopilot loop may run
    (``MXNET_AUTOPILOT``, default off). Explicit ``step()`` calls are
    always honored — the flag gates the autonomous thread, so an
    autopilot-off process never acts on its own."""
    return os.environ.get("MXNET_AUTOPILOT", "0") != "0"


class Autopilot(object):
    """The poll-driven controller: one ``step()`` polls every
    configured plane, runs the pure decision kernel, actuates, and
    appends to the replayable transcript.

    Parameters
    ----------
    config : AutopilotConfig, optional
        The policy (default :meth:`AutopilotConfig.from_env`).
    slo : SLOTracker, optional
        The serving objectives driving autoscale (with ``pool``).
    pool : ReplicaPool, optional
        The autoscale actuator.
    canary : CanaryController, optional
        The continuous-delivery plane.
    peer : PeerCheckpointStore, optional
        Held for introspection (``ElasticTrainer`` consults the store
        directly on its recovery path).
    """

    def __init__(self, config=None, slo=None, pool=None, canary=None,
                 peer=None, logger=None):
        self.config = config or AutopilotConfig.from_env()
        self.slo = slo
        self.pool = pool
        self.canary = canary
        self.peer = peer
        self.transcript = []
        self._tick = 0
        self._idle_ticks = 0
        self._cooldown_until = 0
        self._stop = threading.Event()
        self._thread = None
        self._logger = logger or logging.getLogger(
            "mxnet_tpu_torch.autopilot")
        from .. import telemetry
        scope = telemetry.registry().scope("autopilot")
        self._g_ticks = scope.gauge("ticks")
        self._c_poll_err = scope.counter("poll_errors")
        self._c_canary_err = scope.counter("canary_errors")

    # ------------------------------------------------------------ tick
    def step(self, now=None):
        """One deterministic controller tick: poll, decide, actuate.
        Returns the tick's transcript entries. A fired
        ``autopilot.poll`` fault (delay sleeps; error skips) exercises
        a controller that itself misbehaves — a skipped poll is a
        counted, transcribed non-event, never a crash."""
        from .. import telemetry
        tick = self._tick
        self._tick += 1
        self._g_ticks.set(self._tick)
        if _faults.armed():
            try:
                _faults.check("autopilot.poll", tick=tick)
            except _faults.FaultError as exc:
                self._c_poll_err.add()
                entry = {"tick": tick, "plane": "poll",
                         "error": str(exc)}
                self.transcript.append(entry)
                telemetry.flight_recorder().note(
                    "autopilot_poll_error", tick=tick, error=str(exc))
                self._logger.warning(
                    "autopilot: poll failed at tick %d (%s) — tick "
                    "skipped", tick, exc)
                return [entry]
        out = []
        if self.pool is not None and self.slo is not None:
            out.append(self._step_scale(tick, now))
        if self.canary is not None:
            out.append(self._step_canary(tick, now))
        return out

    def _step_scale(self, tick, now):
        from .. import telemetry
        burn = self.slo.burn_state(now=now)
        idle = burn["n_fast"] == 0 and not burn["breach"]
        self._idle_ticks = self._idle_ticks + 1 if idle else 0
        obs = {"tick": tick, "replicas": self.pool.size,
               "breach": bool(burn["breach"]),
               "breach_epochs": int(burn["breach_epochs"]),
               "idle_ticks": self._idle_ticks,
               "cooldown_remaining":
                   max(0, self._cooldown_until - tick)}
        decision = decide_scale(self.config, obs)
        entry = {"tick": tick, "plane": "scale", "obs": obs,
                 "decision": decision}
        if decision["action"] in ("scale_out", "scale_in"):
            try:
                self.pool.scale_to(decision["target"])
            except Exception as exc:  # noqa: BLE001 — an actuator
                # failure (incl. the autopilot.scale seam) must not
                # kill the loop; the pool stays at its previous size
                # and the cooldown paces the retry
                entry["actuate_error"] = str(exc)
                telemetry.flight_recorder().note(
                    "autopilot_scale_error", tick=tick,
                    action=decision["action"], error=str(exc))
                self._logger.warning(
                    "autopilot: %s to %d failed (%s)",
                    decision["action"], decision["target"], exc)
            else:
                telemetry.flight_recorder().note(
                    "autopilot_scale", tick=tick,
                    action=decision["action"],
                    target=decision["target"],
                    reason=decision["reason"])
            self._cooldown_until = tick + 1 + self.config.cooldown_ticks
            self._idle_ticks = 0
        self.transcript.append(entry)
        return entry

    def _step_canary(self, tick, now):
        from .. import telemetry
        obs = self.canary.observe(tick=tick, now=now)
        decision = decide_canary(self.config, obs)
        entry = {"tick": tick, "plane": "canary", "obs": obs,
                 "decision": decision}
        if decision["action"] != "hold":
            try:
                self.canary.apply(decision, tick=tick)
            except Exception as exc:  # noqa: BLE001 — same discipline
                # as the scale actuator: record, count, keep looping
                self._c_canary_err.add()
                entry["actuate_error"] = str(exc)
                telemetry.flight_recorder().note(
                    "autopilot_canary_error", tick=tick,
                    action=decision["action"], error=str(exc))
                self._logger.warning(
                    "autopilot: canary %s failed (%s)",
                    decision["action"], exc)
        self.transcript.append(entry)
        return entry

    # ---------------------------------------------------------- replay
    def replay(self):
        """Re-derive every transcribed decision through the pure
        kernel; returns the divergences (empty == deterministic, the
        gate's witness)."""
        return replay(self.config, self.transcript)

    # ------------------------------------------------- background loop
    def start(self):
        """Start the background poll loop — ONLY under
        ``MXNET_AUTOPILOT=1`` (returns None and does nothing
        otherwise, so an autopilot-off process never self-actuates).
        Returns self when started."""
        if not enabled():
            self._logger.info(
                "autopilot: MXNET_AUTOPILOT is off — background loop "
                "not started (explicit step() still works)")
            return None
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="mxtorch-autopilot", daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.config.poll_interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the loop must survive
                self._logger.exception("autopilot tick failed")

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2 * self.config.poll_interval_s + 1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
