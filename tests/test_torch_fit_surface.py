"""The rest of ``fit``'s surface in the PyTorch port (mxnet_tpu_torch)
against the JAX package's, on the CPU: the optimizers ``DCASGD``,
``NAG``, ``SGLD``, ``ccSGD``, ``AdaGrad``, ``AdaDelta``, ``Ftrl`` and
``Test``; the ``Poly``, ``Cosine`` and ``Warmup`` schedulers; the
``F1``, ``MAE``, ``MSE`` and ``RMSE`` metrics; the ``Load``, ``Mixed``,
``Constant``, ``Orthogonal``, ``MSRAPrelu`` and ``Bilinear``
initializers; ``ProgressBar`` and ``LogValidationMetricsCallback``;
``test_utils`` and ``viz.print_summary``.

Tolerances (float32): rtol 1e-5, atol 1e-6. Each optimizer takes 3
updates from the same weights and gradients (numpy, seeded) through
``Updater.update_multi`` in both packages. SGLD's noise cannot share a
stream with JAX's threefry: it is held with the noise taken out (both
packages' draws replaced by zeros), and the port's noise on its own has
the mean 0 and variance lr within 4 standard errors. The initializers
draw from different generators, so their deterministic parts are held:
``Orthogonal``'s SVD step on one given matrix, ``Bilinear``'s and
``Constant``'s values, ``MSRAPrelu``'s magnitude, and ``Mixed``'s and
``Load``'s routing.
"""
import contextlib
import io
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.optimizer as jopt_mod

import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.optimizer as topt_mod

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
CPU = tmx.cpu()
SHAPE = (5, 7)

OPTIMIZERS = {
    "dcasgd": {"momentum": 0.9, "learning_rate": 0.1, "wd": 1e-3},
    "dcasgd_nomom": {"learning_rate": 0.1, "wd": 1e-3},
    "nag": {"momentum": 0.9, "learning_rate": 0.1, "wd": 1e-3},
    "nag_nomom": {"learning_rate": 0.1, "wd": 1e-3},
    "ccsgd": {"momentum": 0.9, "learning_rate": 0.1, "wd": 1e-3},
    "adagrad": {"learning_rate": 0.1, "wd": 1e-3},
    "adadelta": {"wd": 1e-3, "rescale_grad": 0.5},
    "ftrl": {"learning_rate": 0.1, "lamda1": 0.01},
    "test": {"learning_rate": 0.1, "rescale_grad": 0.5},
    "sgld": {"learning_rate": 0.01, "wd": 1e-3},
}


def _steps(mx, name, kwargs, w0, grads):
    opt = mx.optimizer.create(name.split("_")[0],
                              param_idx2name={0: "fc_weight"}, **kwargs)
    upd = mx.optimizer.get_updater(opt)
    w = mx.nd.array(w0, ctx=mx.cpu())
    for g in grads:
        upd.update_multi([(0, mx.nd.array(g, ctx=mx.cpu()), w)])
    return w.asnumpy(), upd


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_three_steps_match_the_jax_package(name, monkeypatch):
    rng = np.random.RandomState(0)
    w0 = rng.randn(*SHAPE).astype(np.float32)
    grads = [rng.randn(*SHAPE).astype(np.float32) for _ in range(3)]
    if name == "sgld":
        # the noise term taken out of both packages
        monkeypatch.setattr(
            jopt_mod, "normal",
            lambda loc, scale, shape, ctx: jmx.nd.zeros(shape, ctx=ctx))
        monkeypatch.setattr(topt_mod._random, "key_normal",
                            lambda key, shape, device: torch.zeros(
                                shape, device=device))
    jw, _ = _steps(jmx, name, OPTIMIZERS[name], w0, grads)
    tw, upd = _steps(tmx, name, OPTIMIZERS[name], w0, grads)
    np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=ATOL)
    # Test updates without counting, as in the JAX package
    assert upd.optimizer.num_update == (0 if name == "test" else 3)
    # only SGD's alias has a pure apply (the fused step); NAG overrides
    # SGD.update, so it takes the classic update as in the JAX package
    assert (upd.fused_apply_or_none() is not None) == (name == "ccsgd")


def test_clip_gradient_clips_before_the_update():
    """The classic optimizers clip the rescaled gradient (the JAX
    package's ``clip(grad, -c, c)`` there passes its bounds positionally
    and raises, so this is held within the port): AdaGrad with
    ``clip_gradient`` equals AdaGrad on gradients clipped beforehand."""
    rng = np.random.RandomState(7)
    w0 = rng.randn(*SHAPE).astype(np.float32)
    grads = [rng.randn(*SHAPE).astype(np.float32) for _ in range(3)]
    clipped, _ = _steps(tmx, "adagrad", {"learning_rate": 0.1,
                                         "clip_gradient": 0.5}, w0, grads)
    pre, _ = _steps(tmx, "adagrad", {"learning_rate": 0.1}, w0,
                    [np.clip(g, -0.5, 0.5) for g in grads])
    np.testing.assert_array_equal(clipped, pre)


def test_sgld_noise_mean_and_variance():
    """One SGLD update with a zero gradient moves each weight by N(0, lr):
    the mean and variance of 200,000 moves within 4 standard errors."""
    lr, n = 0.01, 200000
    tmx.random.seed(3)
    opt = tmx.optimizer.create("sgld", learning_rate=lr)
    upd = tmx.optimizer.get_updater(opt)
    w = tmx.nd.zeros((n,), ctx=CPU)
    upd.update_multi([(0, tmx.nd.zeros((n,), ctx=CPU), w)])
    d = w.asnumpy().astype(np.float64)
    assert abs(d.mean()) < 4 * np.sqrt(lr / n)
    assert abs(d.var() - lr) < 4 * lr * np.sqrt(2.0 / n)
    # the next update draws a fresh key: different noise
    w2 = tmx.nd.zeros((n,), ctx=CPU)
    upd.update_multi([(0, tmx.nd.zeros((n,), ctx=CPU), w2)])
    assert not np.array_equal(w2.asnumpy(), w.asnumpy())


def test_nag_trains_a_module_on_the_classic_update():
    rng = np.random.RandomState(1)
    X = rng.rand(32, 4).astype(np.float32)
    y = rng.randint(0, 2, 32).astype(np.float32)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=2, name="fc"), name="softmax")
    mod = tmx.mod.Module(net, context=CPU)
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=8), num_epoch=2,
            optimizer="nag", optimizer_params={"learning_rate": 0.1,
                                               "momentum": 0.9})
    assert mod._updater.fused_apply_or_none() is None
    assert mod._optimizer.num_update == 8


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------
def _schedules(mx):
    ls = mx.lr_scheduler
    return {
        "poly": ls.PolyScheduler(max_update=20, base_lr=0.1, power=2.0,
                                 final_lr=0.001),
        "cosine": ls.CosineScheduler(max_update=20, base_lr=0.1,
                                     final_lr=0.001),
        "warmup": ls.WarmupScheduler(ls.CosineScheduler(max_update=15,
                                                        base_lr=0.1),
                                     warmup_steps=5, start_lr=0.01),
    }


@pytest.mark.parametrize("name", ["poly", "cosine", "warmup"])
def test_scheduler_sequences(name):
    j, t = _schedules(jmx)[name], _schedules(tmx)[name]
    seq_j = [j(k) for k in range(25)]
    seq_t = [t(k) for k in range(25)]
    np.testing.assert_allclose(seq_t, seq_j, rtol=1e-12)
    # through an optimizer: the base lr is the optimizer's learning_rate
    opts = [mx.optimizer.SGD(learning_rate=0.3,
                             lr_scheduler=_schedules(mx)[name])
            for mx in (jmx, tmx)]
    np.testing.assert_allclose([opts[1].lr_scheduler(k) for k in range(25)],
                               [opts[0].lr_scheduler(k) for k in range(25)],
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _metric_inputs(name):
    rng = np.random.RandomState(4)
    if name == "f1":
        preds = [rng.rand(16, 2).astype(np.float32) for _ in range(3)]
        labels = [rng.randint(0, 2, 16).astype(np.float32) for _ in range(3)]
    else:
        preds = [rng.randn(8, 3).astype(np.float32) for _ in range(3)]
        labels = [rng.randn(8, 3).astype(np.float32) for _ in range(3)]
    return labels, preds


@pytest.mark.parametrize("name", ["f1", "mae", "mse", "rmse"])
def test_metrics_match_the_jax_package(name):
    labels, preds = _metric_inputs(name)
    vals = []
    for mx in (jmx, tmx):
        m = mx.metric.create(name)
        for lab, pr in zip(labels, preds):
            m.update([mx.nd.array(lab, ctx=mx.cpu())],
                     [mx.nd.array(pr, ctx=mx.cpu())])
        vals.append(m.get())
    assert vals[0][0] == vals[1][0]
    np.testing.assert_allclose(vals[1][1], vals[0][1], rtol=RTOL, atol=ATOL)
    if name == "f1":
        stat = tmx.metric.F1().fused_stat()
        total = sum(float(stat(torch, [torch.tensor(lab)],
                               [torch.tensor(pr)])[0])
                    for lab, pr in zip(labels, preds))
        np.testing.assert_allclose(total / 3, vals[1][1], rtol=1e-6)
    else:
        assert tmx.metric.create(name).fused_stat() is None


def test_f1_rides_the_device_tally_in_fit():
    rng = np.random.RandomState(5)
    X = rng.rand(32, 4).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=2, name="fc"), name="softmax")
    mod = tmx.mod.Module(net, context=CPU)
    f1 = tmx.metric.F1()
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=8), num_epoch=1,
            eval_metric=f1, optimizer_params={"learning_rate": 0.1})
    assert mod._exec_group._metric_live is f1
    host = tmx.metric.F1()
    assert 0.0 <= f1.get()[1] <= 1.0 and f1.num_inst == 4
    del host


def test_torch_and_caffe_metrics_wait_for_their_plugins():
    """The plugins are ported: ``metric.Torch`` and ``metric.Caffe`` are
    the JAX package's (``Loss`` under the plugins' names), their sums
    equal on the same outputs."""
    rs = np.random.RandomState(2)
    outs = [rs.rand(4, 3).astype(np.float32) for _ in range(2)]
    for name in ("Torch", "Caffe"):
        t, j = getattr(tmx.metric, name)(), getattr(jmx.metric, name)()
        assert t.name == j.name == name.lower()
        for o in outs:
            t.update(None, [tmx.nd.array(o, ctx=CPU)])
            j.update(None, [jmx.nd.array(o)])
        assert t.num_inst == j.num_inst == 24
        np.testing.assert_allclose(t.get()[1], j.get()[1], rtol=1e-6)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def _init_value(mx, init, name, shape):
    arr = mx.nd.zeros(shape, ctx=mx.cpu())
    init(mx.init.InitDesc(name) if hasattr(mx.init, "InitDesc") else name,
         arr)
    return arr.asnumpy()


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 2, 2, 2)])
def test_orthogonal_svd_step(shape):
    nout, nin = shape[0], int(np.prod(shape[1:]))
    np.random.seed(11)
    tmp = np.random.uniform(-1.0, 1.0, (nout, nin))
    np.random.seed(11)
    jv = _init_value(jmx, jmx.init.Orthogonal(scale=1.3), "w_weight", shape)
    tv = tmx.initializer.orthogonal_from(tmp, shape, 1.3)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    # the port's own draw is orthogonal at the same scale
    got = _init_value(tmx, tmx.init.Orthogonal(scale=1.3), "w_weight",
                      shape).reshape(nout, nin)
    gram = got @ got.T if nout <= nin else got.T @ got
    np.testing.assert_allclose(gram, 1.69 * np.eye(min(nout, nin)),
                               atol=1e-4)


@pytest.mark.parametrize("case", ["bilinear", "constant", "upsampling"])
def test_deterministic_initializers(case):
    if case == "bilinear":
        inits, name, shape = (jmx.init.Bilinear(), tmx.init.Bilinear()), \
            "up_weight", (2, 3, 4, 5)
    elif case == "constant":
        inits, name, shape = (jmx.init.Constant(0.37),
                              tmx.init.Constant(0.37)), "c_weight", (3, 4)
    else:
        inits, name, shape = (jmx.init.Xavier(), tmx.init.Xavier()), \
            "upsampling0_weight", (1, 1, 4, 4)
    jv = _init_value(jmx, inits[0], name, shape)
    tv = _init_value(tmx, inits[1], name, shape)
    np.testing.assert_array_equal(tv, jv)


def test_msraprelu_scale_and_dumps():
    for slope in (0.0, 0.25):
        j = jmx.init.MSRAPrelu(factor_type="in", slope=slope)
        t = tmx.init.MSRAPrelu(factor_type="in", slope=slope)
        assert t.magnitude == j.magnitude and t.rnd_type == j.rnd_type
        assert t.dumps() == j.dumps()
    tmx.random.seed(0)
    v = _init_value(tmx, tmx.init.MSRAPrelu(factor_type="in"), "c_weight",
                    (400, 500))
    want = np.sqrt((2.0 / (1 + 0.25 ** 2)) / 500)
    assert abs(v.std() - want) < 0.01 * want


def test_mixed_and_load_routing():
    params = {"a_weight": np.full((2, 2), 3.0, np.float32)}
    got = []
    for mx in (jmx, tmx):
        init = mx.init.Mixed(
            ["gate.*", "a_.*", ".*"],
            [mx.init.One(),
             mx.init.Load({"a_weight": mx.nd.array(params["a_weight"],
                                                   ctx=mx.cpu())}),
             mx.init.Constant(-1.0)])
        got.append([_init_value(mx, init, n, (2, 2))
                    for n in ("gate0", "a_weight", "b_bias", "z_weight")])
        with pytest.raises(ValueError):
            mx.init.Mixed(["x.*"], [mx.init.One()])(
                "y", mx.nd.zeros((1,), ctx=mx.cpu()))
        with pytest.raises(ValueError):
            mx.init.Load({})("q_weight", mx.nd.zeros((1,), ctx=mx.cpu()))
    for j, t in zip(*got):
        np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# callbacks
# ---------------------------------------------------------------------------
def test_progress_bar_and_validation_log(caplog):
    from mxnet_tpu.module.base_module import BatchEndParam as JParam
    from mxnet_tpu_torch.module.base_module import BatchEndParam as TParam
    logs = []
    for mx, Param in ((jmx, JParam), (tmx, TParam)):
        metric = mx.metric.Accuracy()
        metric.update([mx.nd.array([1.0, 0.0], ctx=mx.cpu())],
                      [mx.nd.array([[0.1, 0.9], [0.2, 0.8]], ctx=mx.cpu())])
        with caplog.at_level(logging.INFO):
            caplog.clear()
            mx.callback.ProgressBar(total=8, length=20)(
                Param(epoch=1, nbatch=3, eval_metric=metric, locals={}))
            mx.callback.LogValidationMetricsCallback()(
                Param(epoch=1, nbatch=3, eval_metric=metric, locals={}))
            logs.append([r.getMessage() for r in caplog.records])
    assert logs[0] == logs[1] and len(logs[1]) == 2


# ---------------------------------------------------------------------------
# test_utils and visualization
# ---------------------------------------------------------------------------
def _fc_net(mx):
    d = mx.sym.Variable("data")
    return mx.sym.Activation(mx.sym.FullyConnected(d, num_hidden=3,
                                                   name="fc"),
                             act_type="tanh", name="act")


def test_test_utils_oracles():
    tu = tmx.test_utils
    rng = np.random.RandomState(6)
    loc = {"data": rng.randn(2, 4).astype(np.float32),
           "fc_weight": rng.randn(3, 4).astype(np.float32),
           "fc_bias": rng.randn(3).astype(np.float32)}
    net = _fc_net(tmx)
    tu.check_numeric_gradient(net, loc, numeric_eps=1e-2, rtol=5e-2,
                              ctx=CPU)
    want = np.tanh(loc["data"] @ loc["fc_weight"].T + loc["fc_bias"])
    tu.check_symbolic_forward(net, loc, [want], ctx=CPU, rtol=1e-5,
                              atol=1e-6)
    head = rng.randn(2, 3).astype(np.float32)
    dz = head * (1 - want ** 2)
    tu.check_symbolic_backward(net, loc, [head],
                               {"data": dz @ loc["fc_weight"],
                                "fc_weight": dz.T @ loc["data"],
                                "fc_bias": dz.sum(0)},
                               ctx=CPU, rtol=1e-5, atol=1e-5)
    jout = jmx.test_utils.simple_forward(_fc_net(jmx), ctx=jmx.cpu(),
                                         **loc)
    tout = tu.simple_forward(net, ctx=CPU, **loc)
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    outs = tu.check_consistency(net, [
        {"ctx": CPU, "data": (2, 4), "type_dict": {"data": np.float64}},
        {"ctx": CPU, "data": (2, 4)}])
    assert len(outs) == 2
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(np.ones(2), np.zeros(2))
    assert tu.check_speed(net, ctx=CPU, N=2, data=(2, 4)) > 0
    assert tu.reldiff(np.ones(3), np.ones(3)) == 0


def test_print_summary_table_matches_the_jax_package():
    def net(mx):
        d = mx.sym.Variable("data")
        c = mx.sym.Convolution(d, kernel=(3, 3), num_filter=4, name="conv")
        b = mx.sym.BatchNorm(c, name="bn")
        a = mx.sym.Activation(b, act_type="relu", name="relu")
        f = mx.sym.FullyConnected(mx.sym.Flatten(a, name="flat"),
                                  num_hidden=5, name="fc")
        return mx.sym.SoftmaxOutput(f, name="softmax")

    tables = []
    for mx in (jmx, tmx):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mx.viz.print_summary(net(mx), shape={"data": (2, 3, 8, 8)})
        tables.append(buf.getvalue())
    assert tables[1] == tables[0]
    assert "Total params: 845" in tables[1]
    dot = tmx.viz.plot_network(net(tmx))
    text = dot if isinstance(dot, str) else dot.source
    assert "Convolution" in text and "conv_weight" not in text
