"""The port's fault-injection plane (``mxnet_tpu_torch.faults``) against the
JAX package's (``mxnet_tpu.faults``), and its seams in the port.

Held bit for bit to the JAX package, as a hypothesis property over plans
and seeds: the grammar (``FaultPlan.parse`` / ``describe``), the SplitMix
``fold``, the incident transcript of a plan over one scripted sequence of
seam calls (which calls raise, the values and factors the seams return,
the parameter element ``corrupt_params`` poisons), the retry backoff with
its deterministic jitter, and the byte ``corrupt_file`` flips or the
length it truncates to. Then the port's own seams: unarmed seams are
no-ops; healed transients at ``data.device_put`` and ``data.stager`` train
to the unarmed run's parameters bit for bit; ``checkpoint.commit``
transients heal through the retry; ``checkpoint.shard`` and
``checkpoint.manifest`` corruption falls back to the previous entry;
``checkpoint.params`` poisons one restored element; the stager and the
transform workers restart past a failed batch.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mxnet_tpu import faults as jfaults

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.faults import (FaultPlan, InjectedFault,
                                    TransientFault)

torch.set_num_threads(2)

CPU = mx.cpu()
SITES = ("s.a", "s.b", "module.step", "checkpoint.params")
KINDS = ("error", "transient", "delay", "value", "worker_lost", "flood",
         "bitflip", "truncate", "grad_nonfinite", "loss_spike",
         "param_bitflip")
ENTRIES = ("check", "value", "fires", "poison", "corrupt_params")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    jfaults.disarm()


# ------------------------------------------------------ the properties
@st.composite
def rule_text(draw):
    site = draw(st.sampled_from(SITES))
    kind = draw(st.sampled_from(KINDS))
    keys = []
    trigger = draw(st.sampled_from(("nth", "prob", "match", "none")))
    if trigger == "nth":
        keys.append("nth=%d" % draw(st.integers(1, 6)))
    elif trigger == "prob":
        keys.append("prob=%g" % draw(st.sampled_from((0.1, 0.5, 0.9))))
    elif trigger == "match":
        keys.append("step=%d" % draw(st.integers(0, 5)))
    if draw(st.booleans()):
        keys.append("count=%d" % draw(st.integers(0, 3)))
    if kind == "delay":
        keys.append("ms=0")
    if kind in ("value", "loss_spike") and draw(st.booleans()):
        keys.append("value=%d" % draw(st.integers(2, 5000)))
    return "%s:%s" % (site, kind) + ("@" + ",".join(keys) if keys else "")


plans = st.lists(rule_text(), min_size=1, max_size=4).map("; ".join)
calls = st.lists(st.tuples(st.sampled_from(ENTRIES), st.sampled_from(SITES),
                           st.integers(0, 5)), min_size=1, max_size=24)
SLOW = settings(max_examples=40, deadline=None,
                suppress_health_check=[HealthCheck.function_scoped_fixture])


def _params():
    rs = np.random.RandomState(0)
    return {"w%d" % i: rs.rand(3, 4).astype(np.float32) for i in range(3)}


def _script(pkg, spec, seed, script):
    """Run one scripted sequence of seam calls against an armed plan:
    (what each call did, the transcript, the parameters it poisoned)."""
    plan = pkg.arm(spec, seed=seed)
    params = _params()
    out = []
    for entry, site, step in script:
        try:
            if entry == "check":
                got = [i["seq"] for i in pkg.check(site, step=step)]
            elif entry == "value":
                got = pkg.value(site, -1, step=step)
            elif entry == "fires":
                got = pkg.fires(site, step=step)
            elif entry == "poison":
                got = pkg.poison(site, step=step)
                got = "nan" if got != got else got
            else:
                got = pkg.corrupt_params(site, params, step=step)
        except Exception as exc:  # noqa: BLE001 - the outcome compared
            got = type(exc).__name__
        out.append(got)
    pkg.disarm()
    return out, plan.incidents(), {k: v.tobytes() for k, v in params.items()}


@SLOW
@given(spec=plans, seed=st.integers(0, 2 ** 63 - 1))
def test_plan_grammar_and_fold_equal_jax(spec, seed):
    a = FaultPlan.parse(spec, seed=seed)
    b = jfaults.FaultPlan.parse(spec, seed=seed)
    assert a.describe() == b.describe()
    assert [r.to_dict() for r in a.rules] == [r.to_dict() for r in b.rules]
    for parts in ((seed,), (seed, 1), (seed, 7, 3), (seed % 97, seed)):
        assert a.draw(*parts) == b.draw(*parts)
    # the JSON spelling parses to the same rules in both packages
    js = json.dumps([r.to_dict() for r in a.rules])
    assert FaultPlan.parse(js, seed=seed).describe() == \
        jfaults.FaultPlan.parse(js, seed=seed).describe()


@SLOW
@given(spec=plans, seed=st.integers(0, 2 ** 32), script=calls)
def test_transcript_over_scripted_seams_equals_jax(spec, seed, script):
    """The same plan and seed over the same seam calls: the same calls
    raise (by class name), the same values and factors come back, the
    same parameter elements are poisoned, and the transcripts are
    equal."""
    mine = _script(faults, spec, seed, script)
    want = _script(jfaults, spec, seed, script)
    assert mine == want


@SLOW
@given(seed=st.integers(0, 2 ** 32), site=st.sampled_from(
    ("checkpoint.save", "data.device_put", "data.transform", "x")),
    jitter=st.sampled_from((0.0, 0.25, 0.5)), fails=st.integers(0, 4))
def test_retry_backoff_and_jitter_equal_jax(seed, site, jitter, fails):
    def delays(pkg):
        pkg.arm(pkg.FaultPlan([], seed=0))
        out, attempts = [], []

        def attempt():
            attempts.append(1)
            if len(attempts) <= fails:
                raise pkg.TransientFault("flaky")
            return len(attempts)

        try:
            got = pkg.retry(attempt, retries=3, backoff_s=0.1,
                            jitter=jitter, seed=seed, site=site,
                            sleep=out.append)
        except pkg.TransientFault:
            got = "gave up"
        pkg.disarm()
        return got, out

    assert delays(faults) == delays(jfaults)


@SLOW
@given(spec=st.sampled_from(("x.files:bitflip@nth=1",
                             "x.files:truncate@nth=1",
                             "x.files:bitflip@count=2")),
       seed=st.integers(0, 2 ** 32), n_files=st.integers(1, 4))
def test_corrupt_file_offsets_equal_jax(tmp_path_factory, spec, seed,
                                        n_files):
    got = []
    for pkg in (faults, jfaults):
        d = tmp_path_factory.mktemp("f")
        for i in range(n_files):
            (d / ("a%d.bin" % i)).write_bytes(bytes(range(97)) * (i + 1))
        pkg.arm(spec, seed=seed)
        hit = [pkg.corrupt_file("x.files", str(d), pattern="*.bin")
               for _ in range(2)]
        pkg.disarm()
        got.append(([None if h is None else os.path.basename(h)
                     for h in hit],
                    {p.name: p.read_bytes() for p in sorted(d.iterdir())}))
    assert got[0] == got[1]


# ----------------------------------------------------- the port's seams
def test_unarmed_seams_are_noops():
    assert not faults.armed()
    assert faults.check("any.site") == []
    assert faults.value("any.site", 41) == 41
    assert faults.fires("any.site") is False
    assert faults.corrupt_file("any.site", "/nonexistent") is None
    assert faults.poison("module.step") is None
    assert faults.corrupt_params("checkpoint.params", _params()) is None
    assert faults.incidents() == []


def test_retry_unarmed_is_a_passthrough_and_permanent_never_retried():
    calls = []

    def fn():
        calls.append(1)
        raise TransientFault("impossible unarmed")

    with pytest.raises(TransientFault):
        faults.retry(fn)
    assert len(calls) == 1
    faults.arm(FaultPlan([], seed=0))
    calls.clear()

    def permanent():
        calls.append(1)
        raise InjectedFault("permanent")

    with pytest.raises(InjectedFault):
        faults.retry(permanent, retries=5, backoff_s=0.0,
                     sleep=lambda s: None)
    assert len(calls) == 1


def _fit_digest():
    rng = np.random.RandomState(0)
    X = rng.rand(128, 16).astype(np.float32)
    y = rng.randint(0, 10, 128).astype(np.float32)
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    mod = mx.mod.Module(net, context=CPU)
    mx.random.seed(5)
    np.random.seed(5)
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=32), num_epoch=2,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier(), prefetch_to_device=2)
    h = hashlib.sha256()
    args, _ = mod.get_params()
    for k in sorted(args):
        h.update(args[k].asnumpy().tobytes())
    return h.hexdigest()


def test_armed_transients_and_unarmed_are_bitwise_identical():
    """unarmed == armed with an empty plan == armed with healed
    transients at the prefetch path's data.device_put and data.stager
    seams, bit for bit."""
    d_unarmed = _fit_digest()
    faults.arm(FaultPlan([], seed=1))
    d_empty = _fit_digest()
    faults.disarm()
    plan = faults.arm("data.device_put:transient@nth=3;"
                      "data.stager:transient@nth=2", seed=1)
    d_healed = _fit_digest()
    assert plan.unfired() == []
    assert [i["site"] for i in plan.incidents()] == \
        ["data.stager", "data.device_put"]
    assert d_unarmed == d_empty == d_healed


def _arrays(v):
    return {"arg:w": np.full((8,), float(v), np.float32),
            "arg:b": np.arange(4, dtype=np.float32) + v}


def test_checkpoint_commit_transient_heals_through_retry(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    plan = faults.arm("checkpoint.commit:transient@step=1", seed=0)
    mgr.save(1, _arrays(1), extra={"epoch": 1})
    mgr.wait_until_finished()
    assert plan.unfired() == [] and mgr.all_steps() == [1]
    retries = mx.telemetry.registry().counter("faults.retries").value
    assert retries >= 1
    faults.disarm()
    np.testing.assert_array_equal(mgr.restore(1).params["arg:w"],
                                  _arrays(1)["arg:w"])
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(".tmp-")]


def test_checkpoint_commit_error_leaves_no_entry(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _arrays(0), async_save=False)
    faults.arm("checkpoint.commit:error@step=1", seed=0)
    with pytest.raises(mx.MXNetError, match="step 1"):
        mgr.save(1, _arrays(1), async_save=False)
    faults.disarm()
    assert mgr.latest() == 0


@pytest.mark.parametrize("site,pattern", [("checkpoint.shard", "bitflip"),
                                          ("checkpoint.manifest",
                                           "truncate")])
def test_committed_entry_corruption_falls_back(tmp_path, site, pattern):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _arrays(0), async_save=False)
    plan = faults.arm("%s:%s@step=1" % (site, pattern), seed=4)
    mgr.save(1, _arrays(1), async_save=False)
    assert plan.unfired() == []
    assert plan.incidents()[0]["target"]
    faults.disarm()
    ckpt = mgr.restore()
    assert ckpt.step == 0
    np.testing.assert_array_equal(ckpt.params["arg:w"], _arrays(0)["arg:w"])


def test_param_bitflip_poisons_one_restored_element(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _arrays(3), async_save=False)
    plan = faults.arm("checkpoint.params:param_bitflip@nth=1", seed=2)
    ckpt = mgr.restore(3)
    inc = plan.incidents()[0]
    faults.disarm()
    bad = ckpt.params[inc["target"]].reshape(-1)
    assert np.isnan(bad[inc["element"]])
    assert np.isfinite(np.delete(bad, inc["element"])).all()
    clean = mgr.restore(3).params
    assert all(np.isfinite(v).all() for v in clean.values())


def test_device_loader_stager_restart_continues_stream():
    from mxnet_tpu_torch.data import DeviceLoader
    X = np.random.RandomState(0).rand(128, 4).astype(np.float32)
    faults.arm("data.stager:error@nth=4", seed=1)
    loader = DeviceLoader(mx.io.NDArrayIter(X, None, batch_size=16),
                          depth=2, restart_on_error=True, ctx=CPU)
    rows, crashes = [], 0
    while True:
        try:
            b = loader.next()
        except StopIteration:
            break
        except InjectedFault:
            crashes += 1
            continue
        rows.append(b.data[0].asnumpy())
    loader.close()
    assert crashes == 1
    np.testing.assert_array_equal(np.concatenate(rows), X)


def test_device_loader_default_error_still_terminal():
    from mxnet_tpu_torch.data import DeviceLoader
    X = np.zeros((64, 4), np.float32)
    faults.arm("data.stager:error@nth=2", seed=1)
    loader = DeviceLoader(mx.io.NDArrayIter(X, None, batch_size=16),
                          depth=2, ctx=CPU)
    loader.next()
    with pytest.raises(InjectedFault):
        loader.next()
    with pytest.raises(StopIteration):
        loader.next()
    loader.reset()
    assert loader.next() is not None
    loader.close()


def test_transform_iter_restart_skips_failed_batch():
    from mxnet_tpu_torch.data import TransformIter
    X = np.arange(128, dtype=np.float32).reshape(32, 4)
    faults.arm("data.transform:error@index=1", seed=1)
    ti = TransformIter(mx.io.NDArrayIter(X, None, batch_size=8),
                       transform=lambda b, rng: b, num_workers=2,
                       restart_on_error=True)
    got, errors = [], 0
    while True:
        try:
            b = ti.next()
        except StopIteration:
            break
        except InjectedFault:
            errors += 1
            continue
        got.append(b.data[0].asnumpy())
    ti.close()
    assert errors == 1
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.concatenate([X[:8], X[16:]]))


def test_transform_transient_heals_with_the_same_bytes():
    from mxnet_tpu_torch.data import TransformIter
    X = np.arange(96, dtype=np.float32).reshape(24, 4)

    def noisy(b, rng):
        return mx.io.DataBatch(
            [mx.nd.array(b.data[0].asnumpy() + rng.rand(8, 4), ctx=CPU)])

    def stream():
        ti = TransformIter(mx.io.NDArrayIter(X, None, batch_size=8),
                           transform=noisy, num_workers=2, seed=3)
        out = [b.data[0].asnumpy() for b in ti]
        ti.close()
        return np.concatenate(out)

    clean = stream()
    plan = faults.arm("data.transform:transient@index=2", seed=1)
    healed = stream()
    assert plan.unfired() == []
    np.testing.assert_array_equal(healed, clean)


def test_arm_from_env_and_file(tmp_path, monkeypatch):
    spec = tmp_path / "plan.txt"
    spec.write_text("s.a:error@nth=2")
    plan = faults.arm("@" + str(spec), seed=5)
    assert plan.describe() == {"seed": 5, "rules": ["s.a:error@nth=2"]}
    monkeypatch.setenv("MXNET_FAULT_PLAN", "s.b:flood@nth=1")
    monkeypatch.setenv("MXNET_FAULT_SEED", "9")
    faults._autostart()
    assert faults.active().describe() == {"seed": 9,
                                          "rules": ["s.b:flood@nth=1"]}
    assert faults.fires("s.b") is True
