"""The autopilot decision kernel — pure functions over polled snapshots
(the port's copy of ``mxnet_tpu/autopilot/kernel.py``; its decisions
equal the JAX package's on every observation).

Every fleet decision the autopilot takes is computed here, and ONLY
here, as a pure function ``decide_*(config, obs) -> decision`` over a
JSON-able observation dict the controller assembled from one poll of
the sensor plane (``slo.*`` burn state, pool size, checkpoint
generations, peer-replica inventory). No clocks, no randomness, no
I/O: the same (config, obs) always yields the same decision, which is
what makes a recorded transcript *replayable* — :func:`replay` re-runs
the kernel over every recorded observation and any divergence from the
recorded decision is a bug (tests/test_torch_autopilot_kernel.py holds
both packages' replays to each other).

Decisions are plain dicts ``{"action", "reason", ...}`` so the
transcript serializes as-is into a chaos report.
"""
from __future__ import annotations

import collections
import math
import os

__all__ = ["AutopilotConfig", "decide_scale", "decide_canary",
           "decide_resume", "replay"]


class AutopilotConfig(collections.namedtuple("AutopilotConfig", (
        "min_replicas", "max_replicas", "cooldown_ticks", "idle_ticks",
        "canary_soak_ticks", "poll_interval_s", "seed"))):
    """The autopilot's whole policy, as one immutable record.

    ``min_replicas``/``max_replicas`` bound the serving pool;
    ``cooldown_ticks`` is the hysteresis gap after ANY scale action
    (no further scaling while it runs down); ``idle_ticks`` is how many
    consecutive zero-traffic polls scale-in waits for;
    ``canary_soak_ticks`` how many clean polls a canary must survive
    before promotion. ``poll_interval_s`` paces the background loop
    (and converts ``MXNET_AUTOPILOT_COOLDOWN_S`` into ticks); ``seed``
    rides into the transcript so a replay names the full decision
    input even though the current policies draw nothing from it.
    """
    __slots__ = ()

    @classmethod
    def from_env(cls, **overrides):
        """Build a config from the ``MXNET_AUTOPILOT_*`` knobs
        (the JAX package's knobs and defaults), explicit ``overrides`` winning."""
        poll_s = float(overrides.pop("poll_interval_s", 1.0))
        cooldown_s = float(os.environ.get(
            "MXNET_AUTOPILOT_COOLDOWN_S", "30"))
        base = {
            "min_replicas": int(os.environ.get(
                "MXNET_AUTOPILOT_MIN_REPLICAS", "1")),
            "max_replicas": int(os.environ.get(
                "MXNET_AUTOPILOT_MAX_REPLICAS", "2")),
            "cooldown_ticks": max(
                1, int(math.ceil(cooldown_s / max(poll_s, 1e-9)))),
            "idle_ticks": 3,
            "canary_soak_ticks": 2,
            "poll_interval_s": poll_s,
            "seed": 0,
        }
        base.update(overrides)
        cfg = cls(**base)
        if cfg.min_replicas < 0 or cfg.max_replicas < cfg.min_replicas:
            raise ValueError(
                "need 0 <= min_replicas <= max_replicas (got %d..%d)"
                % (cfg.min_replicas, cfg.max_replicas))
        return cfg


AutopilotConfig.__new__.__defaults__ = (1, 2, 3, 3, 2, 1.0, 0)


def _hold(reason):
    return {"action": "hold", "reason": reason}


def decide_scale(cfg, obs):
    """One autoscale decision from one polled burn-rate snapshot.

    ``obs`` carries ``replicas`` (current pool size), ``breach`` (the
    tracker's BOTH-window burn verdict), ``breach_epochs`` (the
    monotonic counter, recorded for hysteresis audits), ``idle_ticks``
    (consecutive zero-traffic polls, maintained by the controller) and
    ``cooldown_remaining`` (ticks left of the post-action freeze).

    Policy: cooldown freezes everything (the hysteresis half of the
    contract — one breach epoch cannot flap the pool); a both-window
    breach scales OUT one replica up to ``max_replicas``; sustained
    idleness (``idle_ticks`` consecutive quiet polls, no breach)
    scales IN one replica down to ``min_replicas``; a pool below
    ``min_replicas`` is repaired first.
    """
    replicas = int(obs["replicas"])
    if int(obs.get("cooldown_remaining", 0)) > 0:
        return _hold("cooldown")
    if replicas < cfg.min_replicas:
        return {"action": "scale_out", "target": replicas + 1,
                "reason": "below_min"}
    if obs.get("breach"):
        if replicas >= cfg.max_replicas:
            return _hold("breach_at_max")
        return {"action": "scale_out", "target": replicas + 1,
                "reason": "slo_breach"}
    if int(obs.get("idle_ticks", 0)) >= cfg.idle_ticks \
            and replicas > cfg.min_replicas:
        return {"action": "scale_in", "target": replicas - 1,
                "reason": "sustained_idle"}
    return _hold("steady")


def decide_canary(cfg, obs):
    """One continuous-delivery decision from one generation snapshot.

    ``obs`` carries ``latest_step`` (newest committed checkpoint
    generation), ``stable_step`` (the generation protected traffic is
    served from), ``rejected`` (latest generation already rolled
    back once — never re-admitted), and — while a canary is live —
    ``canary_step``, ``probe_ok`` (the accuracy/parity probe's fresh
    verdict), ``canary_breach`` (the canary tenant's OWN SLO burn) and
    ``ticks_in_canary``.

    Policy: a new, never-rejected generation is ADMITTED as a canary;
    a live canary ROLLS BACK the moment its probe fails or its burn
    windows breach; only after ``canary_soak_ticks`` clean polls with
    a passing probe is it PROMOTED to the protected route. A poisoned
    generation therefore never reaches protected traffic: its only
    path there runs through ``probe_ok`` twice (admission and soak).
    """
    canary = obs.get("canary_step")
    if canary is None:
        latest = obs.get("latest_step")
        stable = obs.get("stable_step")
        if latest is not None and latest != stable \
                and (stable is None or latest > stable) \
                and not obs.get("rejected"):
            return {"action": "admit", "step": latest,
                    "reason": "new_generation"}
        return _hold("no_new_generation")
    if obs.get("probe_ok") is False:
        return {"action": "rollback", "step": canary,
                "reason": "probe_failed"}
    if obs.get("canary_breach"):
        return {"action": "rollback", "step": canary,
                "reason": "slo_breach"}
    if int(obs.get("ticks_in_canary", 0)) >= cfg.canary_soak_ticks \
            and obs.get("probe_ok"):
        return {"action": "promote", "step": canary,
                "reason": "soaked_clean"}
    return _hold("soaking")


def decide_resume(cfg, obs):
    """Where an elastic restart should restore from.

    ``obs`` carries ``disk_step`` (the checkpoint manager's newest
    committed step), ``peer_step`` (the newest step the peer-replicated
    in-memory store can still assemble from the SURVIVING hosts) and
    ``peer_restorable``. Peer memory wins only when it holds exactly
    the step disk would restore — a stale peer snapshot must never
    shadow a newer durable commit.
    """
    disk = obs.get("disk_step")
    peer = obs.get("peer_step")
    if obs.get("peer_restorable") and peer is not None \
            and peer == disk:
        return {"action": "peer_restore", "step": peer,
                "reason": "peer_current"}
    reason = "no_peer_snapshot" if peer is None else (
        "peer_stale" if obs.get("peer_restorable")
        else "peer_shards_lost")
    return {"action": "disk_restore", "step": disk, "reason": reason}


_DECIDERS = {"scale": decide_scale, "canary": decide_canary,
             "resume": decide_resume}


def replay(cfg, transcript):
    """Re-run the kernel over a recorded transcript; return the list
    of divergences (empty == fully replayable, the determinism
    witness). Entries without a decision plane (e.g. ``poll`` fault
    incidents) are skipped — they record sensor failures, not
    decisions."""
    mismatches = []
    for i, entry in enumerate(transcript):
        decider = _DECIDERS.get(entry.get("plane"))
        if decider is None or "decision" not in entry:
            continue
        again = decider(cfg, entry["obs"])
        if again != entry["decision"]:
            mismatches.append({"index": i, "plane": entry["plane"],
                               "recorded": entry["decision"],
                               "replayed": again})
    return mismatches
