"""The port's training telemetry (``mxnet_tpu_torch.telemetry``: timeline,
compile_watch, introspect, health, flight) on the CPU, held to the JAX
package's where the two compute the same thing and to
``tests/test_telemetry*.py``'s contracts elsewhere.

* Host logic equal to the JAX package's: ``StepTimeline`` records and
  ``slowest``, ``RegressionWatchdog`` incidents over one step-time
  series, ``roofline()``; a postmortem written by either package loads
  in the other.
* ``device_peaks``: the H100 SXM table keyed by compute dtype, no TPU row,
  (None, None) for the CPU and unlisted cards, per-component overrides.
* Program FLOPs: the port's count of lenet's fused step against the JAX
  package's ``analyze_compiled`` FLOPs of its compiled step, within
  ``FLOPS_REL`` (10%; the test logs the ratio); a convolution's count is
  2·MACs forward; the BatchNorm kernels' wrappers add their own work.
* ``fit`` with telemetry: one timeline record per step (per group when
  grouped), the live roofline from the second epoch, the watchdog armed,
  calibrated and healthy, ZERO new programs after the warmup boundary —
  with the guardian armed and across a rollback too — and the trained
  parameters bit for bit those of a telemetry-off run. A new shape after
  the boundary is counted and warned about; a fit that dies with the
  flight recorder armed leaves a postmortem.
"""
import hashlib
import json
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults, telemetry as tel
from mxnet_tpu_torch.io import DataBatch, NDArrayIter
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.telemetry import introspect

torch.set_num_threads(2)

CPU = mx.cpu()
FLOPS_REL = 0.10
log = logging.getLogger(__name__)


@pytest.fixture(autouse=True)
def _clean():
    for t in (tel, jtel):
        t.disable()
        t.timeline().clear()
        t.flight_recorder().disarm()
    yield
    faults.disarm()
    for t in (tel, jtel):
        t.disable()
        t.timeline().clear()
        t.flight_recorder().disarm()
        t.flight_recorder().uninstall()


def _mlp():
    s = mx.sym
    net = s.Variable("data")
    net = s.FullyConnected(net, num_hidden=16, name="fc1")
    net = s.Activation(net, act_type="relu")
    net = s.FullyConnected(net, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _data(n=64, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 6).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


def _fit(seed=11, epochs=2, **kw):
    X, y = _data()
    mx.random.seed(seed)
    np.random.seed(seed)
    mod = mx.mod.Module(_mlp(), context=CPU)
    mod.fit(NDArrayIter(X, y, batch_size=16, shuffle=False),
            num_epoch=epochs,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Uniform(0.07), **kw)
    return mod


def _digest(mod):
    h = hashlib.sha256()
    arg, aux = mod.get_params()
    for k in sorted(arg):
        h.update(arg[k].asnumpy().tobytes())
    for k in sorted(aux or {}):
        h.update(aux[k].asnumpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------- host logic
STEP_MS = [10.0, 11.0, 10.5, 9.8, 10.2, 10.1, 10.3, 10.0, 25.0, 26.0,
           24.5, 25.5, 10.0, 10.2, 70.0, 71.0, 69.0]


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def test_timeline_equals_jax(tmp_path):
    lines = []
    tls = (tel.StepTimeline(capacity=8), jtel.StepTimeline(capacity=8))
    for tl in tls:
        for i, ms in enumerate(STEP_MS):
            tl.record(i // 4, i % 4, host_wait_ms=ms / 7, step_ms=ms,
                      metric_cb_ms=0.25, batch_group=1 + i % 2,
                      recompile=i == 0, loop="eval" if i == 5 else "train")
            if i % 4 == 3:
                tl.note_checkpoint(1.5)
        path = tmp_path / ("t%d.jsonl" % len(lines))
        assert tl.to_jsonl(str(path)) == 8
        lines.append([{k: v for k, v in json.loads(line).items()
                       if k != "ts"} for line in path.read_text().split(
                           "\n") if line])
    assert _strip(tls[0].records()) == _strip(tls[1].records())
    assert _strip(tls[0].slowest(3)) == _strip(tls[1].slowest(3))
    assert lines[0] == lines[1]


def _incidents(pkg, series):
    reg = pkg.MetricsRegistry()
    tl = pkg.StepTimeline()
    wd = pkg.RegressionWatchdog(registry=reg, timeline=tl, min_samples=3)
    wd.arm()
    out = []
    for window in series:
        for ms in window:
            tl.record(0, 0, host_wait_ms=1.0, step_ms=ms)
        out.extend({k: v for k, v in inc.items()
                    if k not in ("ts", "window")} for inc in wd.poll())
    rep = wd.report()
    return out, rep["baseline"], rep["healthy"], rep["polls"]


@pytest.mark.parametrize("series", [
    [[10.0] * 4, [10.5] * 4, [11.0] * 4],                  # healthy
    [[10.0] * 4, [30.0] * 4, [31.0] * 4, [90.0] * 4],      # one incident
    [[10.0] * 2, [10.0] * 4, [50.0] * 3],                  # carried window
])
def test_watchdog_incidents_equal_jax(series):
    assert _incidents(tel, series) == _incidents(jtel, series)


@pytest.mark.parametrize("args", [
    (4e12, 2e9, 0.01, 989.0, 3350.0, 0.0),
    (1e9, 9e11, 0.2, 67.0, 3350.0, 0.1),
    (1e9, 1e9, 0.05, None, None, 0.7),
    (0.0, 0.0, 0.0, 494.5, 3350.0, 0.0)])
def test_roofline_equals_jax(args):
    assert introspect.roofline(*args) == jtel.roofline(*args)


def test_device_peaks_table_and_override(monkeypatch):
    sxm = "NVIDIA H100 80GB HBM3"
    assert introspect.device_peaks(sxm, "bfloat16") == (989.0, 3350.0)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert introspect.device_peaks(sxm, "float32") == (67.0, 3350.0)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert introspect.device_peaks(sxm, "float32") == (494.5, 3350.0)
    for kind in ("cpu", "NVIDIA H100 PCIe", "TPU v5 lite", "NVIDIA A100"):
        assert introspect.device_peaks(kind) == (None, None)
    monkeypatch.setenv("MXNET_PEAK_TFLOPS", "5")
    assert introspect.device_peaks("cpu") == (5.0, None)
    assert introspect.device_peaks(sxm, "bfloat16") == (5.0, 3350.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_postmortem_loads_in_the_other_package(tmp_path, writer):
    src, dst = (tel, jtel) if writer == "port" else (jtel, tel)
    rec = src.flight_recorder()
    rec.clear()
    rec.arm(str(tmp_path))
    rec.note("fault_injected", site="module.step", seq=1)
    src.timeline().record(0, 3, step_ms=4.0)
    path = rec.dump("test: boom")
    for loader in (src.load_postmortem, dst.load_postmortem):
        pm = loader(path)
        assert pm["reason"] == "test: boom"
        assert pm["events"][-1]["site"] == "module.step"
        assert pm["steps"][-1]["nbatch"] == 3
    with open(path, "r+b") as f:
        f.truncate(20)
    with pytest.raises(mx.MXNetError, match="corrupt or truncated"):
        tel.load_postmortem(path)


# ---------------------------------------------------- program analysis
def test_conv_count_is_two_macs_and_bn_adds_its_work():
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3)
    out, got = introspect.analyze_compiled(
        torch.nn.functional.conv2d, x, w, padding=1)
    assert got["flops"] == 2 * out.numel() * 3 * 9
    assert got["bytes_accessed"] == 4 * (x.numel() + w.numel()
                                         + out.numel())
    from mxnet_tpu_torch.kernels.batchnorm import bn_fwd
    g, b = torch.ones(3), torch.zeros(3)
    _, got = introspect.analyze_compiled(bn_fwd, x, g, b, torch.zeros(3),
                                         1e-5, False, True, False)
    assert got["kernels"] == 1 and got["flops"] == 7 * x.numel()
    assert got["bytes_accessed"] == 2 * 4 * x.numel()


def _lenet_step_flops(pkg):
    names = JNameManager if pkg is jmx else TNameManager
    with names():
        net = pkg.models.get_symbol("lenet", num_classes=10)
    rs = np.random.RandomState(0)
    xs = rs.rand(32, 1, 28, 28).astype(np.float32)
    ys = rs.randint(0, 10, 32).astype(np.float32)
    pkg.telemetry.enable()
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mx.random.seed(1)
    mod.fit(pkg.io.NDArrayIter(xs, ys, batch_size=16), num_epoch=1,
            optimizer="sgd", initializer=pkg.init.Xavier(),
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    basis = mod._exec_group.roofline_basis()
    pkg.telemetry.disable()
    return basis["flops_per_step"]


def test_fused_step_flops_against_jax_analysis():
    mine = _lenet_step_flops(mx)
    want = _lenet_step_flops(jmx)
    ratio = mine / want
    log.info("lenet fused-step FLOPs: port %.6g, JAX analysis %.6g, "
             "ratio %.4f", mine, want, ratio)
    assert abs(ratio - 1.0) <= FLOPS_REL, ratio


# ------------------------------------------------------------- the fit
def test_fit_timeline_roofline_watchdog_and_zero_post_warmup(monkeypatch):
    monkeypatch.setenv("MXNET_PEAK_TFLOPS", "1")
    monkeypatch.setenv("MXNET_PEAK_HBM_GBPS", "100")
    # the process watchdog, fresh; its time judges are held on a fixed
    # series in test_watchdog_incidents_equal_jax, so host-clock noise on
    # a loaded CPU must not decide this test
    wd = tel.health_watchdog()
    wd.reset()
    monkeypatch.setattr(wd, "tolerance", 1e9)
    monkeypatch.setattr(wd, "host_wait_margin", 1.0)
    retr = tel.registry().counter("compile.post_warmup_retraces")
    before = retr.value
    X, y = _data()
    tel.enable()
    mod = _fit(epochs=3, eval_data=NDArrayIter(X, y, batch_size=16))
    tel.disable()
    assert retr.value == before
    recs = tel.timeline().records()
    assert [(r["epoch"], r["nbatch"]) for r in recs] == \
        [(e, b) for e in range(3) for b in range(4)]
    assert recs[0]["recompile"] and not any(r["recompile"]
                                            for r in recs[1:])
    assert all("mfu" not in r for r in recs[:4])
    assert all(r["mfu"] > 0 and r["bound_by"] in ("compute", "hbm",
                                                  "host-wait")
               for r in recs[4:])
    gauges = tel.registry().snapshot()["gauges"]
    for g in ("train.mfu", "train.achieved_tflops",
              "train.achieved_hbm_gbps", "train.hbm_util",
              "train.bound_by"):
        assert g in gauges
    names = mod._exec_group._program_names
    assert {"train_step", "optimizer_update", "fwd_eval_stat"} <= set(names)
    rep = tel.health_report()
    assert rep["armed"] and rep["calibrated"] and rep["healthy"]


def test_grouped_fit_writes_one_record_a_group():
    tel.enable()
    _fit(epochs=2, batch_group=2)
    tel.disable()
    recs = tel.timeline().records()
    assert [r["batch_group"] for r in recs] == [2] * 4


def test_telemetry_and_guardian_zero_perturbation_and_rollback(tmp_path):
    plain = _digest(_fit(epochs=3))
    retr = tel.registry().counter("compile.post_warmup_retraces")
    before = retr.value
    tel.enable(jsonl=str(tmp_path / "run.jsonl"))
    assert _digest(_fit(epochs=3)) == plain
    g = mx.guardian.Guardian(str(tmp_path / "g"), sdc_probe_period=2)
    assert _digest(_fit(epochs=3, guardian=g)) == plain
    faults.arm("module.step:grad_nonfinite@epoch=2,nbatch=1", seed=1)
    g2 = mx.guardian.Guardian(str(tmp_path / "g2"))
    _fit(epochs=3, guardian=g2)
    faults.disarm()
    tel.disable()
    assert g2.rollbacks == 1
    assert retr.value == before
    lines = [json.loads(line) for line in
             (tmp_path / "run.jsonl").read_text().split("\n") if line]
    # the rollback's line (its payload's "kind" is the verdict's, as in
    # the JAX package) and the steps' lines
    assert [(e["epoch"], e["nbatch"], e["restore_step"]) for e in lines
            if "restore_step" in e] == [(2, 1, -1)]
    assert sum(e["kind"] == "step" for e in lines) > 12


def test_new_shape_after_warmup_is_counted_and_warned(caplog):
    X, _ = _data()
    mod = mx.mod.Module(_mlp(), context=CPU)
    mod.bind(data_shapes=[("data", (16, 6))], for_training=False)
    mod.init_params(initializer=mx.init.Uniform(0.07))
    watch = tel.CompileWatch(scope=tel.MetricsRegistry().scope("compile"))
    assert watch.attach(mod) and watch.attach(mod)

    def run(rows):
        mod.forward(DataBatch([mx.nd.array(X[:rows], ctx=CPU)], None),
                    is_train=False)
        return mod.get_outputs()[0].asnumpy()

    run(16)
    warm = watch.count
    assert warm == 1
    run(16)
    assert watch.count == warm
    watch.mark_warmup_done()
    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.telemetry"):
        mod.reshape(data_shapes=[("data", (32, 6))])
        run(32)
    assert watch.post_warmup_count == 1
    ev = [e for e in watch.events() if e["post_warmup"]][-1]
    assert ev["shapes"].get("data") == (32, 6)
    assert "test_torch_train_telemetry.py" in ev["site"]
    assert any("AFTER the warmup boundary" in r.getMessage()
               for r in caplog.records)
    with watch.suppressed():
        mod.reshape(data_shapes=[("data", (8, 6))])
        run(8)
    assert watch.post_warmup_count == 1


def test_fit_crash_dumps_postmortem(tmp_path):
    rec = tel.flight_recorder()
    rec.clear()
    rec.arm(str(tmp_path))
    tel.enable()

    def boom(param):
        if param.nbatch == 2:
            raise RuntimeError("injected callback failure")

    with pytest.raises(RuntimeError, match="injected"):
        _fit(epochs=1, batch_end_callback=boom)
    pm = tel.load_postmortem(rec.last_dump_path)
    assert "injected callback failure" in pm["reason"]
    assert pm["steps"][-1]["nbatch"] == 2
