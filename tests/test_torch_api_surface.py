"""The API names the PyTorch port took from the JAX package in one slice,
each held to its JAX counterpart on the CPU: ``Executor.debug_str``,
``Symbol.eval``, ``mx.sym.var``/``fromjson``, ``NDArray.wait_to_write``/
``writable``, the top-level ``mx.waitall``/``cpu_pinned``/``AttrScope``/
``NameManager``/``engine``/``profiler``, ``mx.model.BatchEndParam``,
``Optimizer.set_lr_scale``, ``BaseModule``'s abstract interface, and
``mx.telemetry.jsonl_sink``/``metrics_server``/``serve_metrics``. Also the
how-to twins of ``example/python-howto/debug_conv.py`` and
``example/memcost/memcost.py`` with their scripts' asserts.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

torch.set_num_threads(2)
CPU = mx.cpu()


def _conv_net(pkg):
    s = pkg.sym
    data = s.Variable("data")
    conv = s.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                         name="conv1")
    return s.SoftmaxOutput(s.Flatten(conv, name="flat"), name="softmax")


def test_top_level_names():
    for name in ("waitall", "cpu_pinned", "AttrScope", "NameManager",
                 "engine", "profiler"):
        assert hasattr(mx, name) and hasattr(jmx, name), name
    assert mx.AttrScope is mx.attribute.AttrScope
    assert mx.NameManager is mx.name.NameManager
    pinned, jpinned = mx.cpu_pinned(1), jmx.cpu_pinned(1)
    assert (pinned.device_type, pinned.device_id, str(pinned)) == \
        (jpinned.device_type, jpinned.device_id, str(jpinned))
    assert pinned != mx.cpu(1) and pinned == mx.Context("cpu_pinned", 1)
    assert pinned.torch_device() == torch.device("cpu")
    a = mx.nd.array(np.arange(4, dtype=np.float32), ctx=pinned)
    assert a.context == pinned and a.asnumpy().tolist() == [0, 1, 2, 3]
    mx.waitall()


def test_name_manager_and_attr_scope_like_jax():
    def build(pkg):
        with pkg.NameManager():
            with pkg.AttrScope(ctx_group="stage1"):
                x = pkg.sym.Variable("x")
                y = pkg.sym.FullyConnected(x, num_hidden=3)
            z = pkg.sym.Activation(y, act_type="relu")
        return z
    t, j = build(mx), build(jmx)
    assert t.list_arguments() == j.list_arguments()
    assert t.attr_dict() == j.attr_dict()


def test_symbol_var_fromjson_and_eval():
    assert mx.sym.var is mx.sym.Variable
    v = mx.sym.var("w", shape=(2, 3), lr_mult=2.0)
    jv = jmx.sym.var("w", shape=(2, 3), lr_mult=2.0)
    assert v.attr_dict() == jv.attr_dict()
    net, jnet = _conv_net(mx), _conv_net(jmx)
    # the JAX package's JSON loads in the port and round-trips
    t = mx.sym.fromjson(jnet.tojson())
    assert t.tojson() == net.tojson()
    assert mx.sym.fromjson(net.tojson()).list_arguments() == \
        jnet.list_arguments()
    # Symbol.eval against the JAX package's on the same inputs
    rs = np.random.RandomState(0)
    a = rs.rand(3, 4).astype(np.float32)
    b = rs.rand(3, 4).astype(np.float32)
    expr = lambda s: s.var("a") * 2.0 + s.var("b")  # noqa: E731
    out = expr(mx.sym).eval(a=mx.nd.array(a, ctx=CPU),
                            b=mx.nd.array(b, ctx=CPU))
    jout = expr(jmx.sym).eval(a=jmx.nd.array(a), b=jmx.nd.array(b))
    assert len(out) == len(jout) == 1
    assert out[0].context == CPU
    np.testing.assert_allclose(out[0].asnumpy(), jout[0].asnumpy(),
                               rtol=1e-6)
    out = expr(mx.sym).eval(ctx=CPU, a=mx.nd.array(a, ctx=CPU),
                            b=mx.nd.array(b, ctx=CPU))
    np.testing.assert_allclose(out[0].asnumpy(), 2 * a + b, rtol=1e-6)


def test_executor_debug_str_like_jax():
    ex = _conv_net(mx).simple_bind(ctx=CPU, data=(2, 1, 8, 8),
                                   softmax_label=(2,))
    jex = _conv_net(jmx).simple_bind(ctx=jmx.cpu(), data=(2, 1, 8, 8),
                                     softmax_label=(2,))
    text, jtext = ex.debug_str(), jex.debug_str()
    assert text.splitlines()[:-1] == jtext.splitlines()[:-1]
    assert text.splitlines()[0] == "Symbol outputs: softmax_output"
    assert "Op:Convolution, Name=conv1" in text
    assert text.splitlines()[-1].startswith("Memory planning:")


def test_ndarray_wait_to_write_and_writable():
    a = mx.nd.array(np.ones((2, 3), np.float32), ctx=CPU)
    j = jmx.nd.array(np.ones((2, 3), np.float32))
    assert a.writable and j.writable
    a.wait_to_write()
    j.wait_to_write()
    ro = mx.nd.NDArray(torch.zeros(2, 3), ctx=CPU, writable=False)
    jro = jmx.nd.NDArray(np.zeros((2, 3), np.float32), writable=False)
    for arr, err in ((ro, mx.MXNetError), (jro, jmx.MXNetError)):
        with pytest.raises(err, match="readonly"):
            arr[:] = 1.0
    assert not ro[0:1].writable and not ro.reshape((3, 2)).writable
    assert float(ro.asnumpy().sum()) == 0.0
    # monitor taps hand out read-only views, as in the JAX package
    seen = {}
    for pkg, ctx in ((mx, CPU), (jmx, jmx.cpu())):
        ex = _conv_net(pkg).simple_bind(ctx=ctx, data=(2, 1, 8, 8),
                                        softmax_label=(2,))
        ex.set_monitor_callback(
            lambda n, arr, pkg=pkg: seen.setdefault(
                (pkg.__name__, n), arr.writable))
        ex.forward(is_train=False, data=pkg.nd.array(
            np.random.rand(2, 1, 8, 8).astype(np.float32), ctx=ctx))
    port = {n: w for (p, n), w in seen.items() if p == "mxnet_tpu_torch"}
    jax = {n: w for (p, n), w in seen.items() if p == "mxnet_tpu"}
    assert port and set(port.values()) == set(jax.values()) == {False}


def test_model_batch_end_param():
    """``mx.model.BatchEndParam`` is the fit loop's record. The JAX
    package's ``model.BatchEndParam`` is a placeholder (None) that is never
    filled; its record lives in ``module.base_module``, which the port's
    name is held to."""
    assert mx.model.BatchEndParam is mx.module.base_module.BatchEndParam
    p = mx.model.BatchEndParam(epoch=1, nbatch=2, eval_metric=None,
                               locals=None)
    j = jmx.module.base_module.BatchEndParam(epoch=1, nbatch=2,
                                             eval_metric=None, locals=None)
    assert p._fields == j._fields and tuple(p) == tuple(j)
    assert type(p).__name__ == type(j).__name__


def test_optimizer_set_lr_scale_is_deprecated():
    for pkg in (mx, jmx):
        opt = pkg.optimizer.SGD(learning_rate=0.1)
        with pytest.raises(DeprecationWarning):
            opt.set_lr_scale({"w": 2.0})


ABSTRACT = ["get_params", "init_params", "forward", "backward",
            "get_outputs", "get_input_grads", "update", "update_metric",
            "bind", "init_optimizer", "install_monitor"]
ABSTRACT_PROPS = ["data_names", "output_names", "data_shapes",
                  "label_shapes", "output_shapes"]
ARGS = {"forward": (None,), "update_metric": (None, None), "bind": (None,),
        "install_monitor": (None,)}


@pytest.mark.parametrize("name", ABSTRACT + ABSTRACT_PROPS)
def test_base_module_abstract_interface(name):
    base = mx.module.BaseModule()
    jbase = jmx.module.BaseModule()
    for b in (base, jbase):
        with pytest.raises(NotImplementedError):
            if name in ABSTRACT_PROPS:
                getattr(b, name)
            else:
                getattr(b, name)(*ARGS.get(name, ()))
    # every concrete module overrides it
    for cls in (mx.mod.Module, mx.mod.BucketingModule,
                mx.mod.SequentialModule, mx.mod.PythonLossModule):
        assert getattr(cls, name) is not getattr(mx.module.BaseModule, name)


def test_telemetry_sink_server_and_serve_metrics(tmp_path):
    tel = mx.telemetry
    was = tel.enabled()
    tel.disable()
    try:
        assert tel.jsonl_sink() is None and tel.metrics_server() is None
        assert jmx.telemetry.jsonl_sink() is None or \
            jmx.telemetry.enabled()
        server = tel.serve_metrics(0)
        assert tel.metrics_server() is server
        assert tel.serve_metrics(0) is server      # already running
        assert not tel.enabled()                   # recording unchanged
        tel.registry().scope("apitest").counter("hits").add(3)
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            text = resp.read().decode()
        assert "mxtpu_apitest_hits 3" in text
        tel.enable(jsonl=str(tmp_path / "t.jsonl"))
        sink = tel.jsonl_sink()
        assert sink is not None and sink.path == str(tmp_path / "t.jsonl")
        tel.flush_metrics("api")
        line = json.loads(open(str(tmp_path / "t.jsonl")).readline())
        assert line["kind"] == "metrics"
    finally:
        tel.disable()
        if was:
            tel.enable()
    assert tel.metrics_server() is None and tel.jsonl_sink() is None


# ------------------------------------------------------------ how-to twins
def test_debug_conv_twin():
    from mxnet_tpu_torch.examples import debug_conv
    res = debug_conv.main(["--cpu"])
    assert any("conv1" in k for k in res["taps"])
    assert res["taps"]["conv1_output"] == (2, 4, 8, 8)
    assert "Op:Convolution, Name=conv1" in res["debug_str"]


def test_memcost_twin():
    """The script's asserts on the CPU: segmentation adds recompute FLOPs
    at the evaluator and in the Module step (memory is measured on the
    card only)."""
    from mxnet_tpu_torch.examples import memcost
    res = memcost.main(["--cpu", "--depth", "6", "--width", "8", "--img",
                        "16", "--batch-size", "4"])
    held_p, held_s, mem_p, mem_s, fl_p, fl_s = res["evaluator"]
    held_n, held_f, mm_none, mm_full, fl_none, fl_full = res["module"]
    assert held_p is mem_p is held_n is mm_none is None
    assert fl_none == fl_p and fl_full == fl_s    # one step, same math
    assert fl_s > 1.05 * fl_p and fl_full > 1.05 * fl_none
    # the plain evaluator's grad counts 2·MACs three times (forward,
    # weight and input gradients), less the data's input gradient
    conv0 = 4 * 16 * 16 * 9 * 3 * 8
    macs = conv0 + 4 * 16 * 16 * 9 * 5 * 8 * 8 + 4 * 8 * 10
    assert fl_p == 6 * macs - 2 * conv0
