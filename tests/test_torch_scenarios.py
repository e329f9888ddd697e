"""The PyTorch port's scenario matrix (mxnet_tpu_torch.scenarios) on the
CPU.

* Registry and contract engine: the asserts of the JAX package's
  ``tests/test_scenarios.py``, against the port's copies; the feature
  catalog and the six scenarios' names, features, floors, seeds and
  chaos rules equal the JAX package's.
* Library regressions the matrix needs of the port: the guardian's spike
  metric degrades (not crashes) over a non-softmax head, a shared bind at
  another batch gives batch-shaped ``__lr_mult__ == 0`` state args their
  own buffers and still refuses a learned-param mismatch, and a
  Predictor over a net with RNN begin states serves its bucket ladder.
* One scenario (``mlp_sharded_cache``) through the port from the JAX
  module's initial parameters: its trained parameters within relative
  L2 ``FIT_REL`` of the JAX run's, and its contracts green.
* The full matrix and the chaos sweep are marked slow, as their JAX
  counterparts are.

Scenarios registered here are unregistered by a fixture finaliser.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.scenarios as jscenarios

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.scenarios import (AccuracyFloor, BitwiseRepeat,
                                       ChaosHeal, GaugePresent,
                                       ResumeParity, Scenario,
                                       ServingParity, Verdict,
                                       ZeroRetraces, evaluate, registry)
from mxnet_tpu_torch.scenarios import runner

torch.set_num_threads(2)

CPU = mx.cpu()
# 48 SGD-momentum steps of the MLP from the same start in float32: the
# two packages' products accumulate in other orders (XLA's against
# torch's CPU kernels), ~1e-7 a step
FIT_REL = 1e-4


def _dummy(**over):
    """A minimal VALID scenario spec; tests perturb one field each."""
    kw = dict(name="dummy", features=("fit",),
              make_module=lambda: None, make_data=lambda mod: None,
              fit_kwargs={"num_epoch": 4}, score=lambda mod: 1.0,
              floor=0.5)
    kw.update(over)
    return Scenario(**kw)


@pytest.fixture
def registered():
    """Registers scenarios for one test; the finaliser unregisters
    them."""
    names = []

    def reg(sc):
        registry.register(sc)
        names.append(sc.name)
        return sc
    yield reg
    for name in names:
        registry.unregister(name)


# ---------------------------------------------------------------- registry

def test_registry_refuses_duplicate_name(registered):
    registered(_dummy(name="dup_probe"))
    with pytest.raises(ValueError, match="already registered"):
        registry.register(_dummy(name="dup_probe"))


def test_registry_unregister_leaves_the_catalog():
    registry.register(_dummy(name="gone_probe"))
    registry.unregister("gone_probe")
    assert "gone_probe" not in registry.names()
    assert len(registry.names()) == 6
    with pytest.raises(KeyError, match="unknown scenario"):
        registry.get("gone_probe")


def test_registry_refuses_unknown_feature():
    with pytest.raises(ValueError, match="unknown feature"):
        _dummy(features=("fit", "warp_drive"))


def test_registry_requires_fit():
    with pytest.raises(ValueError, match="'fit' feature"):
        _dummy(features=("telemetry",))


def test_registry_chaos_tag_and_rules_must_agree():
    with pytest.raises(ValueError, match="chaos_rules but not"):
        _dummy(chaos_rules=("data.stager:transient@nth=1",))
    with pytest.raises(ValueError, match="no chaos_rules"):
        _dummy(features=("fit", "chaos"))


def test_registry_serving_tag_requires_probe():
    with pytest.raises(ValueError, match="no serving probe"):
        _dummy(features=("fit", "serving_predictor"))


def test_registry_floor_mode_and_resume_at_validated():
    with pytest.raises(ValueError, match="floor_mode"):
        _dummy(floor_mode="sideways")
    with pytest.raises(ValueError, match="resume_at"):
        _dummy(features=("fit", "checkpoint_resume"), resume_at=9)
    with pytest.raises(ValueError, match="non-empty string name"):
        _dummy(name="")


def test_contract_list_derived_from_features():
    plain = _dummy()
    kinds = [type(c).__name__ for c in plain.contracts()]
    assert kinds == ["BitwiseRepeat", "ZeroRetraces", "AccuracyFloor"]
    full = _dummy(features=("fit", "telemetry", "checkpoint_resume",
                            "serving_predictor"),
                  gauges=("train.mfu",), serving=lambda mod: {"ok": True})
    kinds = [type(c).__name__ for c in full.contracts()]
    assert kinds == ["BitwiseRepeat", "ZeroRetraces", "AccuracyFloor",
                     "GaugePresent", "ResumeParity", "ServingParity"]


def test_selected_names_env_knobs():
    all_names = registry.names()
    assert registry.selected_names(environ={}) == all_names
    two = ",".join(all_names[:2])
    assert registry.selected_names(
        environ={"MXNET_SCENARIOS": two}) == all_names[:2]
    with pytest.raises(KeyError, match="unknown scenario"):
        registry.selected_names(environ={"MXNET_SCENARIOS": "tpyo"})
    assert registry.selected_names(
        environ={"MXNET_SCENARIO_FILTER": "LSTM"}) == \
        [n for n in all_names if "lstm" in n]
    assert registry.selected_names(
        environ={"MXNET_SCENARIOS": two,
                 "MXNET_SCENARIO_FILTER": "no-such-substring"}) == []


def test_selected_names_read_the_process_env(monkeypatch):
    monkeypatch.setenv("MXNET_SCENARIOS", "nce_loss,ssd_toy")
    monkeypatch.delenv("MXNET_SCENARIO_FILTER", raising=False)
    assert registry.selected_names() == ["nce_loss", "ssd_toy"]


def test_catalog_is_the_jax_catalog():
    """The six scenarios, in order, with the JAX package's features,
    floors, seeds, chaos rules, gauges, pinned examples and resume
    points; and the feature catalog's tags."""
    assert set(registry.FEATURES) == set(jscenarios.FEATURES)
    assert registry.names() == jscenarios.registry.names()
    for sc in registry.scenarios():
        js = jscenarios.registry.get(sc.name)
        for field in ("features", "floor", "floor_mode", "chaos_rules",
                      "gauges", "example", "seed", "resume_at"):
            assert getattr(sc, field) == getattr(js, field), \
                (sc.name, field)
        kw, jkw = sc.fit_kwargs(), js.fit_kwargs()
        assert set(kw) == set(jkw)
        for key in ("optimizer", "optimizer_params", "num_epoch",
                    "batch_group", "prefetch_to_device"):
            assert kw.get(key) == jkw.get(key), (sc.name, key)
        assert [type(c).__name__ for c in sc.contracts()] == \
            [type(c).__name__ for c in js.contracts()]
    assert any(sc.chaos_rules for sc in registry.scenarios())


# -------------------------------------------------------- contract engine

GOOD = {
    "digest": "a" * 64, "repeat_digest": "a" * 64,
    "post_warmup_retraces": 0, "accuracy": 0.97,
    "gauges": {"train.mfu", "data.cache_shard_bytes"},
    "resume_digest": "a" * 64,
    "serving": {"ok": True, "detail": "rows bitwise"},
    "chaos": {"digest": "a" * 64, "reference": "a" * 64,
              "incidents": 2, "unfired": []},
}


def _one(contract, result):
    v = contract.check(result)
    assert isinstance(v, Verdict)
    return v


def test_bitwise_repeat_contract():
    assert _one(BitwiseRepeat(), GOOD).ok
    assert not _one(BitwiseRepeat(), dict(GOOD,
                                          repeat_digest="b" * 64)).ok
    assert not _one(BitwiseRepeat(), {}).ok


def test_zero_retraces_contract():
    assert _one(ZeroRetraces(), GOOD).ok
    v = _one(ZeroRetraces(), dict(GOOD, post_warmup_retraces=3))
    assert not v.ok and "3" in v.detail
    assert not _one(ZeroRetraces(), {}).ok


def test_accuracy_floor_contract_directions():
    assert _one(AccuracyFloor(0.9), GOOD).ok
    assert not _one(AccuracyFloor(0.99), GOOD).ok
    ppl = dict(GOOD, accuracy=1.7)
    assert _one(AccuracyFloor(2.5, mode="max"), ppl).ok
    assert not _one(AccuracyFloor(1.5, mode="max"), ppl).ok
    assert not _one(AccuracyFloor(0.5), dict(GOOD,
                                             accuracy=float("nan"))).ok
    assert not _one(AccuracyFloor(0.5), {}).ok
    with pytest.raises(ValueError):
        AccuracyFloor(0.5, mode="sideways")


def test_gauge_present_contract():
    assert _one(GaugePresent(("train.mfu",)), GOOD).ok
    v = _one(GaugePresent(("train.mfu", "slo.missing")), GOOD)
    assert not v.ok and "slo.missing" in v.detail
    assert not _one(GaugePresent(("train.mfu",)), {}).ok


def test_resume_parity_contract():
    assert _one(ResumeParity(), GOOD).ok
    assert not _one(ResumeParity(), dict(GOOD,
                                         resume_digest="b" * 64)).ok
    assert not _one(ResumeParity(), {"digest": "a" * 64}).ok


def test_serving_parity_contract():
    assert _one(ServingParity(), GOOD).ok
    assert not _one(ServingParity(),
                    dict(GOOD, serving={"ok": False})).ok
    v = _one(ServingParity(), {})
    assert not v.ok and "did not report" in v.detail


def test_chaos_heal_contract_failure_modes():
    assert _one(ChaosHeal(), GOOD).ok
    v = _one(ChaosHeal(), dict(GOOD, chaos=dict(GOOD["chaos"],
                                                digest="b" * 64)))
    assert not v.ok and "diverged" in v.detail
    v = _one(ChaosHeal(), dict(GOOD, chaos=dict(
        GOOD["chaos"], unfired=["data.stager:transient@nth=99"])))
    assert not v.ok and "unfired" in v.detail
    v = _one(ChaosHeal(), dict(GOOD, chaos=dict(GOOD["chaos"],
                                                incidents=0)))
    assert not v.ok and "no incidents" in v.detail
    assert not _one(ChaosHeal(), dict(GOOD, chaos=None)).ok


@pytest.mark.parametrize("name", ["BitwiseRepeat", "ZeroRetraces",
                                  "AccuracyFloor", "GaugePresent",
                                  "ResumeParity", "ServingParity",
                                  "ChaosHeal"])
@pytest.mark.parametrize("case", ["good", "empty", "perturbed"])
def test_verdicts_equal_the_jax_engine(name, case):
    import mxnet_tpu.scenarios.contracts as J
    import mxnet_tpu_torch.scenarios.contracts as T
    args = {"AccuracyFloor": (0.9,), "GaugePresent": (("train.mfu",
                                                       "x.y"),)}
    result = {"good": GOOD, "empty": {},
              "perturbed": dict(GOOD, digest="c" * 64, accuracy=0.5,
                                post_warmup_retraces=1,
                                serving={"ok": False})}[case]
    ours = getattr(T, name)(*args.get(name, ())).check(result)
    theirs = getattr(J, name)(*args.get(name, ())).check(result)
    assert tuple(ours) == tuple(theirs)


def test_evaluate_turns_raises_into_failed_verdicts():
    class Broken(BitwiseRepeat):
        name = "broken"

        def check(self, result):
            raise RuntimeError("boom")

    verdicts, green = evaluate([Broken(), ZeroRetraces()], GOOD)
    assert not green
    assert verdicts[0].contract == "broken" and not verdicts[0].ok
    assert "boom" in verdicts[0].detail
    assert verdicts[1].ok          # a broken check hides nothing
    assert evaluate([ZeroRetraces()], GOOD)[1] is True


def test_run_matrix_refuses_an_empty_selection():
    with pytest.raises(ValueError, match="no scenarios selected"):
        runner.run_matrix(environ={"MXNET_SCENARIO_FILTER": "nothing"})


def test_chaos_sweep_needs_rules():
    with pytest.raises(ValueError, match="no chaos_rules"):
        runner.chaos_sweep(_dummy())


def test_param_digest_is_the_jax_arithmetic():
    """The same parameter values give one digest in both packages."""
    rng = np.random.RandomState(0)
    w = rng.rand(4, 3).astype(np.float32)
    b = rng.rand(4).astype(np.float32)
    s = rng.rand(4).astype(np.float32)

    class _M(object):
        def __init__(self, nd):
            self.nd = nd

        def get_params(self):
            return ({"w": self.nd.array(w), "b": self.nd.array(b)},
                    {"s": self.nd.array(s)})

    import mxnet_tpu.scenarios.runner as jrunner
    with CPU:
        ours = runner.param_digest(_M(mx.nd))
    assert ours == jrunner.param_digest(_M(jmx.nd))


# ----------------------------------------------------- library regressions

def test_guardian_spike_stat_degrades_over_logistic_head(tmp_path,
                                                          caplog):
    """The guardian's default cross-entropy spike stat cannot run over a
    LogisticRegressionOutput head's label/output shapes; that degrades
    the health ring to the coarse output-mean scalar with a warning,
    never crashes the step."""
    rng = np.random.RandomState(0)
    X = rng.rand(128, 8).astype(np.float32)
    y = np.stack([X.sum(axis=1) > 4.0, X[:, 0] > 0.5],
                 axis=1).astype(np.float32)
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=8, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=2, name="fc2")
    net = mx.sym.LogisticRegressionOutput(
        net, mx.sym.Variable("softmax_label"), name="softmax")
    mod = mx.mod.Module(net, context=CPU)
    data = mx.io.NDArrayIter(X, label=y, batch_size=32)
    guard = mx.guardian.Guardian(str(tmp_path / "guardian"))
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.guardian"):
        mod.fit(data, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                initializer=mx.initializer.Xavier(),
                eval_metric=mx.metric.MSE(),
                num_epoch=2, guardian=guard)
    assert any("falling back to the coarse" in r.getMessage()
               for r in caplog.records), \
        "spike-stat degrade warning not emitted"
    args, _ = mod.get_params()
    assert all(np.isfinite(v.asnumpy()).all() for v in args.values())


def _state_net(num_hidden=8, batch=8):
    """FC head plus a batch-shaped non-learned state arg — the shape an
    RNN cell's zero ``begin_state`` takes (``__lr_mult__`` 0, first dim
    the batch)."""
    data = mx.sym.Variable("data")
    state = mx.sym.Variable("mix_begin_state", lr_mult=0.0,
                            shape=(batch, num_hidden))
    fc = mx.sym.FullyConnected(data, num_hidden=num_hidden, name="fc1")
    return mx.sym.elemwise_add(fc, state, name="mix")


def test_shared_bind_gives_state_args_fresh_buffers():
    base = mx.mod.Module(_state_net(batch=8), label_names=[], context=CPU)
    base.bind(data_shapes=[("data", (8, 4))], for_training=False)
    base.init_params(mx.init.Xavier())
    small = mx.mod.Module(_state_net(batch=2), label_names=[],
                          context=CPU)
    small.bind(data_shapes=[("data", (2, 4))], for_training=False,
               shared_module=base)
    xb = np.arange(8 * 4, dtype=np.float32).reshape(8, 4) / 10.0
    base.forward(mx.io.DataBatch(data=[mx.nd.array(xb, ctx=CPU)]),
                 is_train=False)
    small.forward(mx.io.DataBatch(data=[mx.nd.array(xb[:2], ctx=CPU)]),
                  is_train=False)
    big = base.get_outputs()[0].asnumpy()
    cut = small.get_outputs()[0].asnumpy()
    # the learned params are the parent's; the state arg is its own zero
    # buffer, so the rows equal a fresh batch-2 module's on the same
    # params bit for bit (torch's CPU product at batch 8 may round the
    # last bit otherwise: held to big[:2] within float32 rounding)
    fresh = mx.mod.Module(_state_net(batch=2), label_names=[], context=CPU)
    fresh.bind(data_shapes=[("data", (2, 4))], for_training=False)
    bargs, _ = base.get_params()
    fresh.init_params(mx.init.Zero(), arg_params={
        k: v for k, v in bargs.items() if k.startswith("fc1")},
        allow_missing=True)
    fresh.forward(mx.io.DataBatch(data=[mx.nd.array(xb[:2], ctx=CPU)]),
                  is_train=False)
    np.testing.assert_array_equal(fresh.get_outputs()[0].asnumpy(), cut)
    np.testing.assert_allclose(cut, big[:2], rtol=1e-6, atol=1e-7)
    assert small._exec_group.param_arrays[0][0] is \
        base._exec_group.param_arrays[0][0]


def test_shared_bind_still_rejects_learned_param_mismatch():
    base = mx.mod.Module(_state_net(num_hidden=8), label_names=[],
                         context=CPU)
    base.bind(data_shapes=[("data", (8, 4))], for_training=False)
    base.init_params(mx.init.Xavier())
    clash = mx.mod.Module(_state_net(num_hidden=16), label_names=[],
                          context=CPU)
    with pytest.raises(MXNetError, match="learned param"):
        clash.bind(data_shapes=[("data", (8, 4))], for_training=False,
                   shared_module=base)


def test_predictor_serves_rnn_state_params_across_buckets():
    from mxnet_tpu_torch.serving import Predictor
    V, T = 12, 6
    cell = mx.rnn.FusedRNNCell(8, num_layers=1, mode="lstm",
                               prefix="lstm_")
    data = mx.sym.Variable("data")
    emb = mx.sym.Embedding(data, input_dim=V, output_dim=4, name="embed")
    out, _ = cell.unroll(T, inputs=emb, merge_outputs=True)
    pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, 8)),
                                 num_hidden=V, name="pred")
    net = mx.sym.Reshape(mx.sym.softmax(pred, axis=-1),
                         shape=(-1, T * V), name="rows")
    mod = mx.mod.Module(net, label_names=[], context=CPU)
    mod.bind(data_shapes=[("data", (8, T))], for_training=False)
    mod.init_params(mx.init.Xavier())
    tokens = np.arange(8 * T, dtype=np.float32).reshape(8, T) % V
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(tokens, ctx=CPU)]),
                is_train=False)
    ref = mod.get_outputs()[0].asnumpy()
    pr = Predictor(mod, max_batch_size=8)
    try:
        for rows in (1, 3, 8):     # distinct ladder buckets
            got = pr.predict(tokens[:rows])
            np.testing.assert_array_equal(ref[:rows], np.asarray(got))
    finally:
        pr.release()


# -------------------------------------------- one scenario from JAX's start

def _start_params(jsc):
    """The JAX module's initial parameters for scenario ``jsc`` (its
    initializer under its seed), as numpy."""
    import mxnet_tpu.scenarios.runner as jrunner
    jrunner._seed_all(jsc.seed)
    jmod = jsc.make_module()
    data = jsc.make_data(jmod)
    jmod.bind(data_shapes=data.provide_data,
              label_shapes=data.provide_label)
    jmod.init_params(initializer=jsc.fit_kwargs()["initializer"])
    a, x = jmod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def _fit_from(pkg, seed_all, sc, args, aux):
    seed_all(sc.seed)
    mod = sc.make_module()
    data = sc.make_data(mod)
    kw = sc.fit_kwargs()
    kw.pop("initializer")
    mod.fit(data,
            arg_params={k: pkg.nd.array(v) for k, v in args.items()},
            aux_params={k: pkg.nd.array(v) for k, v in aux.items()},
            **kw)
    a, x = mod.get_params()
    out = {k: v.asnumpy() for k, v in a.items()}
    out.update({k: v.asnumpy() for k, v in x.items()})
    return out


def test_mlp_sharded_cache_trains_to_the_jax_parameters():
    import mxnet_tpu.scenarios.runner as jrunner
    name = "mlp_sharded_cache"
    jsc, sc = jscenarios.registry.get(name), registry.get(name)
    args, aux = _start_params(jsc)
    theirs = _fit_from(jmx, jrunner._seed_all, jsc, args, aux)
    with CPU:
        ours = _fit_from(mx, runner._seed_all, sc, args, aux)
    assert set(ours) == set(theirs)
    for k in theirs:
        a, b = ours[k].astype(np.float64), theirs[k].astype(np.float64)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel <= FIT_REL, (k, rel)
        assert not np.array_equal(ours[k], args.get(k, aux.get(k))), k


def test_mlp_sharded_cache_row_is_green_on_the_cpu():
    with CPU:
        row = runner.run_scenario("mlp_sharded_cache")
    bad = {c: v for c, v in row["contracts"].items() if not v["ok"]}
    assert row["green"], bad
    assert row["post_warmup_retraces"] == 0
    assert row["digest"] == row["repeat_digest"]


# ----------------------------------------------------------------- matrix

@pytest.mark.slow
def test_full_matrix_green():
    """Every registered scenario holds its full contract set through the
    port's fit and serving stack, on the CPU."""
    from mxnet_tpu_torch import scenarios
    with CPU:
        report = scenarios.run_matrix()
    assert report["selected"] == registry.names()
    for name, row in report["scenarios"].items():
        bad = {c: v for c, v in row["contracts"].items()
               if not v["ok"]}
        assert row["green"], "scenario %s failed %r" % (name, bad)
        assert row["post_warmup_retraces"] == 0
    assert report["green"]


@pytest.mark.slow
def test_chaos_sweep_heals_to_bitwise():
    """The seeded chaos sweep on a live scenario: every planned rule
    fires, every incident heals, and the trained params land bit for
    bit on the fault-free run."""
    from mxnet_tpu_torch import scenarios
    with CPU:
        row = scenarios.run_scenario(registry.get("nce_loss"), chaos=True)
    assert row["green"], row["contracts"]
    ch = row["chaos"]
    assert ch["incidents"] >= 1 and not ch["unfired"]
    assert ch["digest"] == row["digest"]
