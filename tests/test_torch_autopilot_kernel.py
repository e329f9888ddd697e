"""The autopilot's decision kernel (mxnet_tpu_torch.autopilot.kernel)
against the JAX package's (mxnet_tpu.autopilot.kernel), on the CPU.

The kernel is pure: ``decide_*(config, obs) -> decision``. The same
observation transcripts (drawn by Hypothesis, and from numpy seeds) go
through both packages' deciders and ``replay``; every decision must be
equal exactly, and a tampered transcript must diverge at the same
indices in both. The policy asserts of the JAX package's
``tests/test_autopilot.py`` are held against the port too.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import mxnet_tpu.autopilot.kernel as J

import mxnet_tpu_torch.autopilot.kernel as T

FIELDS = J.AutopilotConfig._fields

configs = st.builds(
    lambda lo, span, cool, idle, soak, seed: (lo, lo + span, cool, idle,
                                              soak, 1.0, seed),
    st.integers(0, 4), st.integers(0, 4), st.integers(0, 5),
    st.integers(0, 5), st.integers(0, 5), st.integers(0, 2 ** 31 - 1))

small = st.integers(-1, 8)
maybe_step = st.one_of(st.none(), st.integers(0, 12))
maybe_bool = st.one_of(st.none(), st.booleans())

scale_obs = st.fixed_dictionaries(
    {"replicas": st.integers(0, 10), "breach": st.booleans(),
     "breach_epochs": st.integers(0, 50), "idle_ticks": small,
     "cooldown_remaining": small})
canary_obs = st.fixed_dictionaries(
    {"latest_step": maybe_step, "stable_step": maybe_step,
     "canary_step": maybe_step, "rejected": st.booleans(),
     "probe_ok": maybe_bool, "canary_breach": st.booleans(),
     "ticks_in_canary": small})
resume_obs = st.fixed_dictionaries(
    {"disk_step": maybe_step, "peer_step": maybe_step,
     "peer_restorable": st.booleans()})

entries = st.one_of(
    st.tuples(st.just("scale"), scale_obs),
    st.tuples(st.just("canary"), canary_obs),
    st.tuples(st.just("resume"), resume_obs),
    st.tuples(st.just("poll"), st.none()))

DECIDE = {"scale": "decide_scale", "canary": "decide_canary",
          "resume": "decide_resume"}


def _transcript(pkg, cfg, drawn):
    out = []
    for tick, (plane, obs) in enumerate(drawn):
        if plane == "poll":
            out.append({"tick": tick, "plane": "poll", "error": "injected"})
            continue
        decision = getattr(pkg, DECIDE[plane])(cfg, dict(obs))
        out.append({"tick": tick, "plane": plane, "obs": dict(obs),
                    "decision": decision})
    return out


@settings(max_examples=150, deadline=None)
@given(configs, st.lists(entries, max_size=30))
def test_transcripts_decide_and_replay_the_same(cfg_tuple, drawn):
    jcfg, tcfg = J.AutopilotConfig(*cfg_tuple), T.AutopilotConfig(*cfg_tuple)
    jt, tt = _transcript(J, jcfg, drawn), _transcript(T, tcfg, drawn)
    assert tt == jt
    assert T.replay(tcfg, tt) == [] == J.replay(jcfg, jt)
    # each package replays the other's transcript
    assert T.replay(tcfg, jt) == [] == J.replay(jcfg, tt)


@settings(max_examples=100, deadline=None)
@given(configs, st.lists(entries, min_size=1, max_size=20),
       st.data())
def test_tampered_transcripts_diverge_identically(cfg_tuple, drawn, data):
    jcfg, tcfg = J.AutopilotConfig(*cfg_tuple), T.AutopilotConfig(*cfg_tuple)
    tt = _transcript(T, tcfg, drawn)
    i = data.draw(st.integers(0, len(tt) - 1))
    tt[i]["decision"] = {"action": "hold", "reason": "tampered"}
    assert T.replay(tcfg, tt) == J.replay(jcfg, tt)


@pytest.mark.parametrize("seed", range(6))
def test_seeded_numpy_transcripts(seed):
    """Long controller-shaped transcripts from a numpy seed: replicas
    wandering inside the bounds, breaches in bursts, generations
    arriving and rejected, peers lost."""
    rng = np.random.RandomState(seed)
    cfg_tuple = (1, 3, int(rng.randint(1, 4)), int(rng.randint(1, 4)),
                 int(rng.randint(1, 4)), 1.0, seed)
    drawn = []
    for _ in range(400):
        plane = ("scale", "canary", "resume", "poll")[rng.randint(4)]
        if plane == "scale":
            obs = {"replicas": int(rng.randint(0, 5)),
                   "breach": bool(rng.rand() < 0.3),
                   "breach_epochs": int(rng.randint(0, 9)),
                   "idle_ticks": int(rng.randint(0, 5)),
                   "cooldown_remaining": int(rng.randint(0, 3))}
        elif plane == "canary":
            live = rng.rand() < 0.5
            obs = {"latest_step": int(rng.randint(0, 6)),
                   "stable_step": int(rng.randint(0, 6)),
                   "canary_step": int(rng.randint(0, 6)) if live else None,
                   "rejected": bool(rng.rand() < 0.2),
                   "probe_ok": bool(rng.rand() < 0.8) if live else None,
                   "canary_breach": bool(rng.rand() < 0.1),
                   "ticks_in_canary": int(rng.randint(0, 4))}
        elif plane == "resume":
            obs = {"disk_step": int(rng.randint(0, 6)),
                   "peer_step": None if rng.rand() < 0.3
                   else int(rng.randint(0, 6)),
                   "peer_restorable": bool(rng.rand() < 0.7)}
        else:
            obs = None
        drawn.append((plane, obs))
    jcfg, tcfg = J.AutopilotConfig(*cfg_tuple), T.AutopilotConfig(*cfg_tuple)
    tt = _transcript(T, tcfg, drawn)
    assert tt == _transcript(J, jcfg, drawn)
    actions = {e["decision"]["action"] for e in tt if "decision" in e}
    assert {"scale_out", "scale_in", "hold", "admit", "rollback",
            "promote", "peer_restore", "disk_restore"} <= actions


def test_config_defaults_and_env_match(monkeypatch):
    assert T.AutopilotConfig._fields == FIELDS
    assert tuple(T.AutopilotConfig()) == tuple(J.AutopilotConfig())
    monkeypatch.setenv("MXNET_AUTOPILOT_MIN_REPLICAS", "2")
    monkeypatch.setenv("MXNET_AUTOPILOT_MAX_REPLICAS", "4")
    monkeypatch.setenv("MXNET_AUTOPILOT_COOLDOWN_S", "7")
    for poll in (0.5, 1.0, 3.0):
        assert tuple(T.AutopilotConfig.from_env(poll_interval_s=poll)) \
            == tuple(J.AutopilotConfig.from_env(poll_interval_s=poll))
    monkeypatch.setenv("MXNET_AUTOPILOT_MAX_REPLICAS", "1")
    for pkg in (T, J):
        with pytest.raises(ValueError):
            pkg.AutopilotConfig.from_env()


def test_decide_scale_policy():
    cfg = T.AutopilotConfig(min_replicas=1, max_replicas=3,
                            cooldown_ticks=2, idle_ticks=3)

    def obs(**kw):
        base = {"replicas": 1, "breach": False, "breach_epochs": 0,
                "idle_ticks": 0, "cooldown_remaining": 0}
        base.update(kw)
        return base

    assert T.decide_scale(cfg, obs(breach=True)) == {
        "action": "scale_out", "target": 2, "reason": "slo_breach"}
    assert T.decide_scale(cfg, obs(replicas=3, breach=True))["reason"] \
        == "breach_at_max"
    assert T.decide_scale(cfg, obs(breach=True, cooldown_remaining=1)) \
        == {"action": "hold", "reason": "cooldown"}
    assert T.decide_scale(cfg, obs(replicas=2, idle_ticks=2))["action"] \
        == "hold"
    assert T.decide_scale(cfg, obs(replicas=2, idle_ticks=3)) == {
        "action": "scale_in", "target": 1, "reason": "sustained_idle"}
    assert T.decide_scale(cfg, obs(replicas=1, idle_ticks=99))["action"] \
        == "hold"
    assert T.decide_scale(cfg, obs(replicas=0))["reason"] == "below_min"


def test_decide_canary_policy():
    cfg = T.AutopilotConfig(canary_soak_ticks=2)

    def obs(**kw):
        base = {"latest_step": None, "stable_step": 1,
                "canary_step": None, "rejected": False,
                "probe_ok": None, "canary_breach": False,
                "ticks_in_canary": 0}
        base.update(kw)
        return base

    assert T.decide_canary(cfg, obs(latest_step=2)) == {
        "action": "admit", "step": 2, "reason": "new_generation"}
    assert T.decide_canary(cfg, obs(latest_step=1))["reason"] \
        == "no_new_generation"
    assert T.decide_canary(cfg, obs(latest_step=2, rejected=True))[
        "action"] == "hold"
    assert T.decide_canary(cfg, obs(canary_step=2, probe_ok=False)) == {
        "action": "rollback", "step": 2, "reason": "probe_failed"}
    assert T.decide_canary(cfg, obs(canary_step=2, probe_ok=True,
                                    canary_breach=True))["reason"] \
        == "slo_breach"
    assert T.decide_canary(cfg, obs(canary_step=2, probe_ok=True,
                                    ticks_in_canary=1))["action"] == "hold"
    assert T.decide_canary(cfg, obs(canary_step=2, probe_ok=True,
                                    ticks_in_canary=2)) == {
        "action": "promote", "step": 2, "reason": "soaked_clean"}


def test_decide_resume_policy():
    cfg = T.AutopilotConfig()
    assert T.decide_resume(cfg, {"disk_step": 4, "peer_step": 4,
                                 "peer_restorable": True}) == {
        "action": "peer_restore", "step": 4, "reason": "peer_current"}
    assert T.decide_resume(cfg, {"disk_step": 5, "peer_step": 4,
                                 "peer_restorable": True})["reason"] \
        == "peer_stale"
    assert T.decide_resume(cfg, {"disk_step": 5, "peer_step": None,
                                 "peer_restorable": False})["reason"] \
        == "no_peer_snapshot"
    assert T.decide_resume(cfg, {"disk_step": 5, "peer_step": 5,
                                 "peer_restorable": False})["reason"] \
        == "peer_shards_lost"


def test_replay_detects_divergence():
    cfg = T.AutopilotConfig()
    obs = {"replicas": 1, "breach": True, "breach_epochs": 1,
           "idle_ticks": 0, "cooldown_remaining": 0}
    transcript = [
        {"tick": 0, "plane": "poll", "error": "injected"},  # skipped
        {"tick": 1, "plane": "scale", "obs": obs,
         "decision": T.decide_scale(cfg, obs)},
    ]
    assert T.replay(cfg, transcript) == []
    transcript[1]["decision"] = {"action": "hold", "reason": "tampered"}
    bad = T.replay(cfg, transcript)
    assert len(bad) == 1 and bad[0]["index"] == 1
    assert bad[0]["replayed"]["action"] == "scale_out"
