"""The port's training guardian (``mxnet_tpu_torch.guardian``) and the fused
step's health word, on the CPU, held to ``tests/test_guardian.py``'s
contracts and to the JAX package.

* ``spike_judge``'s verdicts equal the JAX package's over the same series;
  ``resolve`` reads the same ``MXNET_GUARDIAN*`` variables; escalation is
  bounded and a repeated coordinate is terminal.
* The health word after the same steps with a NaN batch: ``flags``,
  ``first_bad`` and ``count`` equal to the JAX package's word, the loss
  ring within 1e-5 relative (NaN where the JAX ring has NaN); per batch
  and grouped.
* ``fit(guardian=None)`` == armed clean == armed with the SDC probe
  (period 3), bit for bit, with zero new programs after the warmup
  boundary.
* Rollback-and-skip: a planned ``grad_nonfinite`` / ``loss_spike`` batch,
  a ``param_bitflip`` at restore, a forced probe mismatch
  (``guardian.sdc``) and a grouped fit each heal to the parameters of a
  guarded run on the same stream with the convicted batch excluded, bit
  for bit; one ``guardian_rollback`` flight event per fault.
* Against the JAX package: lenet from the same numpy weights, guarded,
  with the same planned NaN batch: the final parameters within relative
  L2 ``JAX_REL_L2`` (1e-4) of the JAX package's guarded run (the test
  logs the measured value).
* The probe refuses setups whose runs need not repeat bit for bit.
"""
import hashlib
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
from mxnet_tpu import faults as jfaults
from mxnet_tpu import guardian as jguardian
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults, guardian, telemetry
from mxnet_tpu_torch.guardian import (Guardian, UnrecoverableNumericError,
                                      Verdict, spike_judge)
from mxnet_tpu_torch.io import DataIter
from mxnet_tpu_torch.module import mesh_executor_group as meg
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

CPU = mx.cpu()
JAX_REL_L2 = 1e-4
log = logging.getLogger(__name__)


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.disarm()
    jfaults.disarm()
    telemetry.disable()


rng = np.random.RandomState(0)
X = rng.rand(256, 16).astype(np.float32)
y = rng.randint(0, 10, 256).astype(np.float32)


def _mlp(pkg=mx):
    s = pkg.sym
    net = s.Variable("data")
    net = s.FullyConnected(net, num_hidden=32, name="fc1")
    net = s.Activation(net, act_type="relu")
    net = s.FullyConnected(net, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _make_mod():
    return mx.mod.Module(_mlp(), context=CPU)


def _iter(batch_size=32):
    return mx.io.NDArrayIter(X, y, batch_size=batch_size)


class SkippingIter(DataIter):
    """The wrapped stream with given (epoch, nbatch) coordinates dropped —
    the clean reference of rollback-and-skip."""

    def __init__(self, source, skips):
        super().__init__()
        self.source = source
        self.skips = set(skips)
        self.epoch = 0
        self.nbatch = -1

    @property
    def provide_data(self):
        return self.source.provide_data

    @property
    def provide_label(self):
        return self.source.provide_label

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def reset(self):
        self.nbatch = -1
        self.source.reset()

    def next(self):
        while True:
            batch = self.source.next()
            self.nbatch += 1
            if (self.epoch, self.nbatch) not in self.skips:
                return batch


def _digest(mod):
    h = hashlib.sha256()
    args, auxs = mod.get_params()
    for k in sorted(args):
        h.update(args[k].asnumpy().tobytes())
    for k in sorted(auxs):
        h.update(auxs[k].asnumpy().tobytes())
    return h.hexdigest()


def _fit(mod, data, g=None, num_epoch=3, batch_group=None,
         epoch_end_callback=None):
    mx.random.seed(5)
    np.random.seed(5)
    mod.fit(data, num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier(), guardian=g,
            batch_group=batch_group, epoch_end_callback=epoch_end_callback)


# ----------------------------------------------------------- host logic
@pytest.mark.parametrize("case", range(6))
def test_spike_judge_equals_jax(case):
    rs = np.random.RandomState(case)
    base = list(2.0 + 0.05 * rs.rand(24))
    if case % 2:
        base[10 + case] = 14.0 + case        # a spike
    if case == 4:
        base[5] = float("nan")               # the sentinels' business
    if case == 5:
        base = [b * 0.1 for b in base]       # a cliff downward
    series = list(enumerate(base))
    for kw in ({"threshold": 8}, {"threshold": 3, "min_samples": 4},
               {"threshold": 8, "prior": [2.0] * 8}):
        assert spike_judge(series, **kw) == \
            jguardian.spike_judge(series, **kw)


def test_resolve_env_knobs(tmp_path, monkeypatch):
    assert guardian.resolve(None) is None
    monkeypatch.setenv("MXNET_GUARDIAN", "1")
    assert guardian.resolve(None) is None     # no directory: warn, off
    monkeypatch.setenv("MXNET_GUARDIAN_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_GUARDIAN_SPIKE_WINDOW", "16")
    monkeypatch.setenv("MXNET_GUARDIAN_SPIKE_THRESHOLD", "5")
    monkeypatch.setenv("MXNET_GUARDIAN_MAX_ROLLBACKS", "2")
    monkeypatch.setenv("MXNET_GUARDIAN_SDC_PERIOD", "7")
    g, j = guardian.resolve(None), jguardian.resolve(None)
    for attr in ("spike_window", "spike_threshold", "max_rollbacks",
                 "sdc_probe_period"):
        assert getattr(g, attr) == getattr(j, attr)
    assert g.spike_window == 16 and g.sdc_probe_period == 7
    assert guardian.resolve(g) is g


def test_escalation_is_bounded_and_repeat_coordinate_terminal(tmp_path):
    v = Verdict(kind="nonfinite", epoch=0, nbatch=1, flags=2, detail={})
    with pytest.raises(UnrecoverableNumericError, match="budget"):
        Guardian(str(tmp_path), max_rollbacks=0).rollback(None, v)
    g = Guardian(str(tmp_path))
    g.skips.add((0, 1))
    with pytest.raises(UnrecoverableNumericError, match="state"):
        g.rollback(None, v)


def test_max_rollbacks_escalates_from_fit(tmp_path):
    faults.arm("module.step:grad_nonfinite@epoch=0,nbatch=1", seed=1)
    with pytest.raises(UnrecoverableNumericError, match="budget"):
        _fit(_make_mod(), _iter(), Guardian(str(tmp_path), max_rollbacks=0))


# ------------------------------------------------ the health word vs JAX
def _word_run(pkg, grouped):
    """4 steps of the MLP from fixed weights, the 2nd batch NaN, the
    health word armed (window 8, cross-entropy): the polled word."""
    names = JNameManager if pkg is jmx else TNameManager
    with names():
        net = _mlp(pkg)
    rs = np.random.RandomState(2)
    w = {"fc1_weight": 0.3 * rs.randn(32, 16), "fc1_bias": np.zeros(32),
         "fc2_weight": 0.3 * rs.randn(10, 32), "fc2_bias": np.zeros(10)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    batches = [(X[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16])
               for i in range(4)]
    batches[1] = (batches[1][0] * np.float32("nan"), batches[1][1])
    kw = {"context": pkg.cpu()}
    mod = pkg.mod.Module(net, **kw)
    mod.bind(data_shapes=[("data", (16, 16))],
             label_shapes=[("softmax_label", (16,))])
    if pkg is jmx:
        mod.init_params(arg_params={k: jmx.nd.array(v) for k, v in w.items()})
    else:
        mod.init_params(arg_params=mx.convert.params_from_numpy(w, {},
                                                                CPU)[0])
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    mod._exec_group.enable_health(
        window=8, stat_metric=pkg.metric.create("ce"))
    if grouped:
        stacked = {"data": np.stack([b[0] for b in batches]),
                   "softmax_label": np.stack([b[1] for b in batches])}
        assert mod._exec_group.step_update_grouped(mod._updater, stacked)
    else:
        for xb, yb in batches:
            ctx = {"ctx": CPU} if pkg is mx else {}
            mod.forward_backward(pkg.io.DataBatch(
                [pkg.nd.array(xb, **ctx)], [pkg.nd.array(yb, **ctx)]))
            mod.update()
    return mod._exec_group.health_poll()


@pytest.mark.parametrize("grouped", [False, True])
def test_health_word_equals_jax(grouped):
    mine, want = _word_run(mx, grouped), _word_run(jmx, grouped)
    assert (mine["flags"], mine["first_bad"], mine["count"]) == \
        (want["flags"], want["first_bad"], want["count"])
    assert mine["flags"] == (meg.HEALTH_LOSS_NONFINITE |
                             meg.HEALTH_GRAD_NONFINITE |
                             meg.HEALTH_PARAM_NONFINITE)
    assert mine["first_bad"] == 1 and mine["count"] == 4
    np.testing.assert_array_equal(np.isnan(mine["ring"]),
                                  np.isnan(want["ring"]))
    np.testing.assert_allclose(mine["ring"], want["ring"], rtol=1e-5)


def test_health_poll_is_the_only_readback():
    """The armed step reads nothing back: a step with the word armed
    runs under a guard that fails on any tensor-to-host conversion."""
    mod = _make_mod()
    mod.bind(data_shapes=[("data", (32, 16))],
             label_shapes=[("softmax_label", (32,))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd")
    mod._exec_group.enable_health(window=4,
                                  stat_metric=mx.metric.create("ce"))
    batch = next(iter(_iter()))
    reads = []

    class Guard(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.Tensor.item, torch.Tensor.tolist,
                        torch.Tensor.numpy, torch.Tensor.__bool__,
                        torch.Tensor.cpu):
                reads.append(func.__name__)
            return func(*args, **(kwargs or {}))

    with Guard():
        mod.forward_backward(batch)
        mod.update()
    assert reads == []
    assert mod._exec_group.health_poll()["count"] == 1


# -------------------------------------------------- off == armed, bitwise
def test_guardian_off_and_armed_clean_bitwise(tmp_path):
    telemetry.enable()
    retr = telemetry.registry().counter("compile.post_warmup_retraces")
    before = retr.value
    m0 = _make_mod()
    _fit(m0, _iter())
    g1 = Guardian(str(tmp_path / "a"))
    m1 = _make_mod()
    _fit(m1, _iter(), g1)
    g2 = Guardian(str(tmp_path / "b"), sdc_probe_period=3)
    m2 = _make_mod()
    _fit(m2, _iter(), g2)
    assert retr.value == before
    assert g1.rollbacks == 0 and g2.rollbacks == 0
    assert g2.stats()["sdc_checks"] == 8        # 24 steps, every 3rd
    assert g2.stats()["sdc_mismatches"] == 0
    assert _digest(m0) == _digest(m1) == _digest(m2)


# ------------------------------------------- rollback-and-skip parity
def _reference(tmp_path, skips, **kw):
    ref = _make_mod()
    _fit(ref, SkippingIter(_iter(), skips), Guardian(str(tmp_path / "ref")),
         **kw)
    return _digest(ref)


def test_grad_nonfinite_rollback_bitwise_parity(tmp_path):
    telemetry.enable()
    telemetry.flight_recorder().clear()
    retr = telemetry.registry().counter("compile.post_warmup_retraces")
    before = retr.value
    plan = faults.arm("module.step:grad_nonfinite@epoch=1,nbatch=2", seed=1)
    g = Guardian(str(tmp_path / "g"))
    m = _make_mod()
    _fit(m, _iter(), g)
    assert plan.unfired() == []
    faults.disarm()
    assert g.rollbacks == 1 and (1, 2) in g.skips
    assert retr.value == before
    events = [e for e in telemetry.flight_recorder().snapshot("t")["events"]
              if e["kind"] == "guardian_rollback"]
    assert len(events) == 1
    assert (events[0]["epoch"], events[0]["nbatch"]) == (1, 2)
    assert events[0]["verdict_kind"] == "nonfinite"
    assert events[0]["step_record"]["nbatch"] == 2
    assert _digest(m) == _reference(tmp_path, {(1, 2)})


def test_loss_spike_rollback_bitwise_parity(tmp_path):
    plan = faults.arm("module.step:loss_spike@epoch=2,nbatch=4,value=100000",
                      seed=1)
    g = Guardian(str(tmp_path / "g"))
    m = _make_mod()
    _fit(m, _iter(), g)
    assert plan.unfired() == []
    faults.disarm()
    assert g.rollbacks == 1 and (2, 4) in g.skips
    assert _digest(m) == _reference(tmp_path, {(2, 4)})


def test_two_faults_heal_with_one_event_each(tmp_path):
    telemetry.enable()
    telemetry.flight_recorder().clear()
    plan = faults.arm("module.step:grad_nonfinite@epoch=1,nbatch=2;"
                      "module.step:loss_spike@epoch=2,nbatch=1,value=100000",
                      seed=1)
    g = Guardian(str(tmp_path / "g"))
    m = _make_mod()
    _fit(m, _iter(), g)
    assert plan.unfired() == []
    assert [(i["ctx"]["epoch"], i["ctx"]["nbatch"], i["kind"])
            for i in plan.incidents()] == [(1, 2, "grad_nonfinite"),
                                           (2, 1, "loss_spike")]
    faults.disarm()
    events = [e for e in telemetry.flight_recorder().snapshot("t")["events"]
              if e["kind"] == "guardian_rollback"]
    assert [(e["epoch"], e["nbatch"]) for e in events] == [(1, 2), (2, 1)]
    assert g.rollbacks == 2
    assert _digest(m) == _reference(tmp_path, {(1, 2), (2, 1)})


def test_param_bitflip_restore_walkback_heals(tmp_path):
    plan = faults.arm("checkpoint.params:param_bitflip@nth=1;"
                      "module.step:grad_nonfinite@epoch=1,nbatch=2", seed=3)
    fallbacks = telemetry.registry().counter("checkpoint.restore_fallbacks")
    before = fallbacks.value
    g = Guardian(str(tmp_path / "g"))
    m = _make_mod()
    cb = mx.callback.module_checkpoint(m, manager=g.manager)
    _fit(m, _iter(), g, epoch_end_callback=cb)
    assert plan.unfired() == []
    faults.disarm()
    assert g.rollbacks == 1
    assert fallbacks.value > before
    assert _digest(m) == _reference(tmp_path, {(1, 2)})


def test_sdc_probe_mismatch_triggers_rollback(tmp_path):
    plan = faults.arm("guardian.sdc:value@nth=2,value=0.25", seed=2)
    g = Guardian(str(tmp_path / "g"), sdc_probe_period=3)
    m = _make_mod()
    _fit(m, _iter(), g)
    assert plan.unfired() == []
    faults.disarm()
    st = g.stats()
    assert st["sdc_mismatches"] >= 1 and g.rollbacks == 1
    # the second probe is the 4th executed step of epoch 0
    assert (0, 3) in g.skips
    ref = _make_mod()
    _fit(ref, SkippingIter(_iter(), {(0, 3)}),
         Guardian(str(tmp_path / "r"), sdc_probe_period=3))
    assert _digest(m) == _digest(ref)


def test_long_epoch_window_poll_convicts_early_spike(tmp_path):
    def fit8(mod, data, g):
        mx.random.seed(5)
        np.random.seed(5)
        mod.fit(data, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Xavier(), guardian=g)

    plan = faults.arm("module.step:loss_spike@epoch=1,nbatch=3,value=100000",
                      seed=1)
    g = Guardian(str(tmp_path / "g"), spike_window=8)
    m = _make_mod()
    fit8(m, _iter(8), g)       # 32 batches an epoch >> a window of 8
    assert plan.unfired() == []
    faults.disarm()
    assert g.rollbacks == 1 and (1, 3) in g.skips
    ref = _make_mod()
    fit8(ref, SkippingIter(_iter(8), {(1, 3)}),
         Guardian(str(tmp_path / "r"), spike_window=8))
    assert _digest(m) == _digest(ref)


def test_grouped_fit_guardian_parity(tmp_path):
    m0 = _make_mod()
    _fit(m0, _iter(), num_epoch=2, batch_group=4)
    m1 = _make_mod()
    g1 = Guardian(str(tmp_path / "a"))
    _fit(m1, _iter(), g1, num_epoch=2, batch_group=4)
    assert g1.rollbacks == 0 and _digest(m1) == _digest(m0)
    faults.arm("module.step:grad_nonfinite@epoch=1,nbatch=2", seed=1)
    g2 = Guardian(str(tmp_path / "b"))
    m2 = _make_mod()
    _fit(m2, _iter(), g2, num_epoch=2, batch_group=4)
    faults.disarm()
    assert g2.rollbacks == 1 and (1, 2) in g2.skips
    assert m2.grouped_train_engaged()
    assert _digest(m2) == _reference(tmp_path, {(1, 2)}, num_epoch=2,
                                     batch_group=4)


def test_grouped_probe_runs_the_group_twice(tmp_path):
    g = Guardian(str(tmp_path / "g"), sdc_probe_period=2)
    m = _make_mod()
    _fit(m, _iter(), g, num_epoch=2, batch_group=4)
    assert g.stats()["sdc_checks"] == 2      # 2 groups an epoch, every 2nd
    m0 = _make_mod()
    _fit(m0, _iter(), num_epoch=2, batch_group=4)
    assert _digest(m) == _digest(m0)


# ----------------------------------------------------------- the JAX run
def _lenet_guarded(pkg, tmp_path, w):
    names = JNameManager if pkg is jmx else TNameManager
    with names():
        net = pkg.models.get_symbol("lenet", num_classes=10)
    rs = np.random.RandomState(1)
    xs = rs.rand(64, 1, 28, 28).astype(np.float32)
    ys = rs.randint(0, 10, 64).astype(np.float32)
    fk = pkg.faults
    fk.arm("module.step:grad_nonfinite@epoch=1,nbatch=1", seed=1)
    kw = {"context": pkg.cpu()}
    mod = pkg.mod.Module(net, **kw)
    g = pkg.guardian.Guardian(str(tmp_path / pkg.__name__))
    if pkg is jmx:
        args = {k: jmx.nd.array(v) for k, v in w.items()}
    else:
        args = mx.convert.params_from_numpy(w, {}, CPU)[0]
    mod.fit(pkg.io.NDArrayIter(xs, ys, batch_size=16), num_epoch=3,
            optimizer="sgd", arg_params=args,
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            guardian=g)
    assert fk.active().unfired() == []
    fk.disarm()
    assert g.rollbacks == 1 and (1, 1) in g.skips
    a, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in a.items()}


def test_guarded_lenet_matches_jax(tmp_path):
    with TNameManager():
        net = mx.models.get_symbol("lenet", num_classes=10)
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(16, 1, 28, 28), softmax_label=(16,))[0]))
    rs = np.random.RandomState(0)
    w = {k: (0.1 * rs.randn(*s)).astype(np.float32)
         for k, s in shapes.items() if k not in ("data", "softmax_label")}
    mine = _lenet_guarded(mx, tmp_path, w)
    want = _lenet_guarded(jmx, tmp_path, w)
    num = sum(float(np.sum((mine[k] - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum(want[k] ** 2)) for k in want)
    rel = (num / den) ** 0.5
    log.info("guarded lenet: relative L2 to the JAX package %.3g", rel)
    assert rel <= JAX_REL_L2, rel


# ----------------------------------------------------- the probe refuses
def test_probe_refuses_nondeterministic_setups(monkeypatch):
    mod = _make_mod()
    mod.bind(data_shapes=[("data", (32, 16))],
             label_shapes=[("softmax_label", (32,))])
    grp = mod._exec_group
    grp.enable_health(probe_period=3)       # the CPU repeats bit for bit
    monkeypatch.setattr(type(CPU), "torch_device",
                        lambda self: torch.device("cuda", 0))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    with pytest.raises(mx.MXNetError, match="cudnn.deterministic"):
        grp.enable_health(probe_period=3)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    grp.enable_health(probe_period=3)
    s = mx.sym
    with TNameManager():
        net = s.UpSampling(s.Variable("data"), scale=2,
                           sample_type="bilinear", num_args=1, name="up")
        net = s.FullyConnected(s.Flatten(net), num_hidden=4, name="fc")
        net = s.SoftmaxOutput(net, name="softmax")
    monkeypatch.undo()
    up = mx.mod.Module(net, context=CPU)
    up.bind(data_shapes=[("data", (2, 1, 4, 4))],
            label_shapes=[("softmax_label", (2,))])
    monkeypatch.setattr(type(CPU), "torch_device",
                        lambda self: torch.device("cuda", 0))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    with pytest.raises(mx.MXNetError, match="UpSampling"):
        up._exec_group.enable_health(probe_period=3)
