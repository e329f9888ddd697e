"""Precision modes in the PyTorch port (mxnet_tpu_torch.precision), held to
``tests/test_precision.py``'s contracts on the CPU: the mode registry,
``resolve`` and ``MXNET_PRECISION_MODE``, deterministic naming, the
manifest round trip, ``wrap_fused_apply`` (float32 math on the unrounded
state, the state rounded back), the f32 mode bit-identical to no policy,
bf16 optimizer state (SGD momentum, Adam moments) reproducible within the
mode, grouped steps equal to sequential under a mode, a bf16 checkpoint
round trip that resumes bit for bit, cross-mode and tampered-dtype
refusals, the legacy float32 payload, the loss-scale transition rule,
modes refused off the fused route, the quantized modes bound (the
training ones train, the serving-only ones refuse a training bind), and
the serving gate (a module loaded under another mode is
refused; buckets strip the training-only fields).

Against the JAX package, from the same numpy-seeded parameters, 3 steps:
``f32``, ``bf16_opt`` and ``combined`` parameters within rtol 1e-5 and bf16
state leaves within 1 bf16 ulp; ``bf16`` outputs and parameters no
further (relative L2) from the port's own f32 run than twice the JAX
package's bf16-vs-f32 distance on the same inputs, a bound that does not
depend on how each framework rounds.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.precision import (MODES, PrecisionPolicy, canon_dtype,
                                       canon_remat, loss_scale_config,
                                       mode_name, resolve, wrap_fused_apply)

torch.set_num_threads(2)

CPU = mx.cpu()
BATCH = 8
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _bn_mlp(pkg=mx, names=TNameManager):
    # fc1 has no bias: a bias right before a BatchNorm has no gradient but
    # rounding noise, which the two frameworks round differently
    with names():
        s = pkg.sym
        net = s.Variable("data")
        net = s.FullyConnected(net, num_hidden=16, no_bias=True, name="fc1")
        net = s.BatchNorm(net, name="bn", fix_gamma=False)
        net = s.Activation(net, act_type="relu")
        net = s.FullyConnected(net, num_hidden=10, name="fc2")
        return s.SoftmaxOutput(net, name="softmax")


def _module(opt="sgd", opt_kw=None, **kw):
    mx.random.seed(42)
    mod = mx.mod.Module(_bn_mlp(), context=CPU, **kw)
    mod.bind(data_shapes=[("data", (BATCH, 6))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(mx.init.Uniform(0.07))
    mod.init_optimizer(optimizer=opt, optimizer_params=opt_kw or SGD)
    return mod


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [mx.io.DataBatch(
        [mx.nd.array(rng.rand(BATCH, 6).astype(np.float32), ctx=CPU)],
        [mx.nd.array(rng.randint(0, 10, BATCH).astype(np.float32),
                     ctx=CPU)]) for _ in range(n)]


def _train(mod, n=6, seed=0):
    for b in _batches(n, seed=seed):
        mod.forward(b)
        mod.backward()
        mod.update()
    return _params(mod)


def _params(mod):
    return {n: p.asnumpy() for n, p in mod._exec_group._param_dict.items()}


def _assert_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _state_leaves(updater):
    def flat(st):
        if st is None:
            return []
        if isinstance(st, (tuple, list)):
            return [x for s in st for x in flat(s)]
        return [st]

    return [x for k in sorted(updater.states)
            for x in flat(updater.states[k])]


# ------------------------------------------------------------------ policy
def test_mode_registry_and_resolve():
    assert resolve(None) is None
    assert resolve("f32") is MODES["f32"]
    assert resolve("combined").opt_state_dtype == "bfloat16"
    assert resolve("combined").remat == "dots"
    assert resolve("bf16").compute_dtype == "bfloat16"
    pol = PrecisionPolicy(opt_state_dtype="bf16")
    assert resolve(pol) is pol
    with pytest.raises(MXNetError):
        resolve("no_such_mode")
    assert mode_name(None) == "f32"
    assert mode_name(MODES["combined"]) == "combined"
    # the same registry as the JAX package: names and recorded fields
    from mxnet_tpu.precision import MODES as JMODES
    assert sorted(MODES) == sorted(JMODES)
    for name in MODES:
        assert MODES[name].describe() == JMODES[name].describe(), name


def test_mode_env_default(monkeypatch):
    monkeypatch.setenv("MXNET_PRECISION_MODE", "bf16_opt")
    assert resolve(None) is MODES["bf16_opt"]
    assert mx.mod.Module(_bn_mlp(), context=CPU).precision_mode == \
        "bf16_opt"


def test_experimental_modes_gated_and_loss_scale_knobs(monkeypatch):
    monkeypatch.delenv("MXNET_PRECISION_EXPERIMENTAL", raising=False)
    with pytest.raises(MXNetError):
        resolve("int8_act")
    monkeypatch.setenv("MXNET_PRECISION_EXPERIMENTAL", "1")
    assert resolve("fp8").act_cast == "fp8"
    cfg = loss_scale_config(resolve("fp8"))
    assert cfg["init"] == 2.0 ** 15 and cfg["window"] == 2000
    monkeypatch.setenv("MXNET_PRECISION_LOSS_SCALE", "1024")
    monkeypatch.setenv("MXNET_PRECISION_SCALE_WINDOW", "50")
    cfg = loss_scale_config(resolve("fp8"))
    assert cfg["init"] == 1024.0 and cfg["window"] == 50


@pytest.mark.parametrize("mode", ["int8_act", "fp8", "fp8_native",
                                  "int8_weight", "int8_serve"])
def test_quantized_modes_bind(mode, monkeypatch):
    """``int8_act`` and ``fp8`` train: bfloat16 compute under the live
    loss scale, two runs bit for bit, finite moved parameters. The three
    serving-only modes refuse a training bind with ``ValueError`` and
    serve an eval bind (finite outputs of the bound shape)."""
    monkeypatch.setenv("MXNET_PRECISION_EXPERIMENTAL", "1")
    if not resolve(mode).serving_only():
        runs = []
        for _ in range(2):
            mod = _module(precision=mode)
            before = _params(mod)
            runs.append(_train(mod, n=3))
            grp = mod._exec_group
            assert mod._compute_dtype == "bfloat16"
            assert grp.loss_scale() == 2.0 ** 15 and grp.scale_skips() == 0
        _assert_equal(runs[0], runs[1])
        assert all(np.isfinite(v).all() for v in runs[0].values())
        assert not np.array_equal(runs[0]["fc2_weight"],
                                  before["fc2_weight"])
        return
    mod = mx.mod.Module(_bn_mlp(), context=CPU, precision=mode)
    with pytest.raises(ValueError, match="serving-only"):
        mod.bind(data_shapes=[("data", (BATCH, 6))],
                 label_shapes=[("softmax_label", (BATCH,))])
    mod.bind(data_shapes=[("data", (BATCH, 6))],
             label_shapes=[("softmax_label", (BATCH,))], for_training=False)
    mx.random.seed(42)
    mod.init_params(mx.init.Uniform(0.07))
    mod.forward(_batches(1)[0], is_train=False)
    out = mod.get_outputs()[0].asnumpy()
    assert out.shape == (BATCH, 10) and np.isfinite(out).all()
    assert mod.precision_mode == mode


def test_policy_canonicalization_and_naming():
    assert canon_dtype("f32") is None
    assert canon_dtype("bf16") == "bfloat16"
    assert canon_dtype(torch.bfloat16) == "bfloat16"
    with pytest.raises(MXNetError):
        canon_dtype("float16")
    assert canon_remat("none") is None
    assert canon_remat("dots_saveable") == "dots"
    assert canon_remat("offload_bn_stats") == "bn_stats"
    with pytest.raises(MXNetError):
        canon_remat("everything")
    a = PrecisionPolicy(opt_state_dtype="bf16", remat="dots_saveable")
    b = PrecisionPolicy(opt_state_dtype="bfloat16", remat="dots")
    assert a.name == b.name == "custom(opt=bfloat16,remat=dots)"
    assert PrecisionPolicy().is_default()
    assert not a.is_default()
    ls = PrecisionPolicy(loss_scale=1024)
    assert not ls.is_default() and ls.name == "custom(ls=1024)"
    assert PrecisionPolicy(loss_scale=1024, loss_scale_window=64).name \
        == "custom(ls=1024,lsw=64)"


def test_policy_manifest_roundtrip_preserves_all_fields():
    pol = PrecisionPolicy(compute_dtype="bf16", opt_state_dtype="bf16",
                          remat="full", loss_scale=512,
                          loss_scale_window=100)
    back = mx.mod.Module._policy_from_manifest(pol.name, pol.describe())
    assert back.describe() == pol.describe()
    # and the JAX package reads the same record back to the same fields
    jback = jmx.mod.Module._policy_from_manifest(pol.name, pol.describe())
    assert jback.describe() == pol.describe()


def test_fused_apply_wrapper_upcasts_and_rounds_back():
    def fa(xp, p, g, s, lr, wd):
        assert s.dtype == torch.float32       # master math sees f32
        ns = s * 0.9 + g
        return p - lr * ns, ns

    wrapped = wrap_fused_apply(fa, "bfloat16")
    p = torch.ones(4)
    g = torch.full((4,), 0.123456789)
    s = torch.full((4,), 0.333, dtype=torch.bfloat16)
    new_p, new_s = wrapped(torch, p, g, s, 0.1, 0.0)
    assert new_s.dtype == torch.bfloat16
    ref = s.float() * 0.9 + g
    np.testing.assert_array_equal(new_s.float().numpy(),
                                  ref.to(torch.bfloat16).float().numpy())
    # the parameter update consumed the UNROUNDED float32 state
    np.testing.assert_array_equal(new_p.numpy(), (p - 0.1 * ref).numpy())


# ------------------------------------------------------- training contracts
def test_f32_mode_is_bit_identical_to_no_policy():
    plain, named = _module(), _module(precision="f32")
    _assert_equal(_train(plain), _train(named))
    assert named.precision_mode == "f32"


@pytest.mark.parametrize("opt,opt_kw,n_leaves", [
    ("sgd", SGD, 5), ("adam", {"learning_rate": 0.01}, 10)])
def test_bf16_opt_state_narrowed_and_reproducible(opt, opt_kw, n_leaves):
    m1 = _module(opt, opt_kw, precision="bf16_opt")
    p1 = _train(m1)
    leaves = _state_leaves(m1._updater)
    assert len(leaves) == n_leaves
    assert all(x._read().dtype == torch.bfloat16 for x in leaves)
    _assert_equal(p1, _train(_module(opt, opt_kw, precision="bf16_opt")))
    # the mode really engaged: the bf16-rounded state moves the params
    pf = _train(_module(opt, opt_kw))
    assert any(not np.array_equal(p1[k], pf[k]) for k in p1)


@pytest.mark.parametrize("mode", ["bf16", "combined",
                                  PrecisionPolicy(remat="offload_bn_stats")])
def test_modes_reproducible(mode):
    _assert_equal(_train(_module(precision=mode)),
                  _train(_module(precision=mode)))


def test_bf16_compute_runs_in_bf16_with_f32_masters():
    mod = _module(precision="bf16")
    _train(mod, 2)
    for n, p in mod._exec_group._param_dict.items():
        assert p._read().dtype == torch.float32, n
    for g in mod._exec_group._grad_dict.values():
        assert g._read().dtype == torch.float32
    assert mod.get_outputs()[0]._read().dtype == torch.float32
    seen = []
    from mxnet_tpu_torch.ops import nn as nn_ops
    real = nn_ops.bn_fwd

    def spy(x, *a, **k):
        seen.append(x.dtype)
        return real(x, *a, **k)

    nn_ops.bn_fwd = spy
    try:
        _train(mod, 1)
    finally:
        nn_ops.bn_fwd = real
    assert seen == [torch.bfloat16]


def test_grouped_steps_match_sequential_under_mode():
    bs = _batches(4)
    seq = _module(precision="bf16_opt")
    for b in bs:
        seq.forward(b)
        seq.backward()
        seq.update()
    grp = _module(precision="bf16_opt")
    stacked = {"data": np.stack([b.data[0].asnumpy() for b in bs]),
               "softmax_label": np.stack([b.label[0].asnumpy()
                                          for b in bs])}
    assert grp._exec_group.step_update_grouped(grp._updater, stacked)
    _assert_equal(_params(seq), _params(grp))
    for a, b in zip(_state_leaves(seq._updater),
                    _state_leaves(grp._updater)):
        assert torch.equal(a._read(), b._read())


def test_loss_scale_policy_reproducible_and_live():
    pol = PrecisionPolicy(compute_dtype="bf16", loss_scale=1024,
                          loss_scale_window=2)
    m1 = _module(precision=pol)
    assert m1._exec_group.loss_scale() == 1024.0
    p1 = _train(m1, 4)
    _assert_equal(p1, _train(_module(precision=pol), 4))
    # four finite steps with a window of 2 double the scale twice
    assert m1._exec_group.loss_scale() == 4096.0
    assert m1._exec_group.scale_skips() == 0


def test_loss_scale_transition_rule():
    """The AMP table on device values: an overflow halves the scale and
    zeroes the counter; ``window`` finite steps double it, clamped."""
    from mxnet_tpu_torch.module.mesh_executor_group import _ls_update
    cfg = {"window": 2, "scale_max": 2.0 ** 24, "scale_min": 1.0}
    t, f = torch.tensor(True), torch.tensor(False)
    s, g = _ls_update(cfg, torch.tensor(1024.0), torch.tensor(0), t)
    assert float(s) == 1024.0 and int(g) == 1
    s, g = _ls_update(cfg, s, g, t)
    assert float(s) == 2048.0 and int(g) == 0
    s, g = _ls_update(cfg, s, torch.tensor(1), f)
    assert float(s) == 1024.0 and int(g) == 0
    s, _ = _ls_update(cfg, torch.tensor(2.0 ** 24), torch.tensor(1), t)
    assert float(s) == 2.0 ** 24
    s, _ = _ls_update(cfg, torch.tensor(1.0), torch.tensor(0), f)
    assert float(s) == 1.0


def test_overflow_skips_the_update_on_the_device():
    """A non-finite gradient skips the whole update (parameters and
    state) and halves the scale; the skip is counted."""
    pol = PrecisionPolicy(loss_scale=2.0 ** 24, loss_scale_window=1000)
    mod = _module(precision=pol)
    before = _params(mod)
    b = _batches(1)[0]
    b.data[0][:] = np.full((BATCH, 6), np.inf, np.float32)
    mod.forward_backward(b)
    mod.update()
    _assert_equal(before, _params(mod))
    assert mod._exec_group.scale_skips() == 1
    assert mod._exec_group.loss_scale() == 2.0 ** 23


# ------------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_bf16_bit_exact(tmp_path):
    """save -> restore -> resume inside the mode is bit for bit, and
    Module.load adopts the recorded mode."""
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path))
    a = _module(precision="bf16_opt")
    _train(a, 3)
    a.save_checkpoint(None, 3, save_optimizer_states=True, manager=mgr,
                      async_save=False)
    meta = mgr.step_metadata(3)
    assert meta["precision_mode"] == "bf16_opt"
    b = mx.mod.Module.load(mgr, load_optimizer_states=True, context=CPU)
    assert b.precision_mode == "bf16_opt"
    b.bind(data_shapes=[("data", (BATCH, 6))],
           label_shapes=[("softmax_label", (BATCH,))])
    b.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    _train(b, 0)
    for k in sorted(a._updater.states):
        b._updater._state(k, b._exec_group.param_arrays[k][0])
    for x, y in zip(_state_leaves(a._updater), _state_leaves(b._updater)):
        assert y._read().dtype == torch.bfloat16
        assert torch.equal(x._read(), y._read())
    _assert_equal(_train(a, 3, seed=1), _train(b, 3, seed=1))


def test_cross_mode_state_restore_refused():
    bf = _module(precision="bf16_opt")
    _train(bf, 2)
    with pytest.raises(MXNetError, match="state_dtype"):
        _module()._updater.set_states(bf._updater.get_states())
    f32 = _module()
    _train(f32, 2)
    with pytest.raises(MXNetError, match="state_dtype"):
        _module(precision="bf16_opt")._updater.set_states(
            f32._updater.get_states())


def test_tampered_per_leaf_dtype_record_refused():
    src = _module(precision="bf16_opt")
    _train(src, 2)
    payload = pickle.loads(src._updater.get_states())
    assert payload["state_dtype"] == "bfloat16"
    k = next(iter(payload["state_dtypes"]))
    assert payload["state_dtypes"][k] == "bfloat16"
    payload["state_dtypes"][k] = "float32"
    with pytest.raises(MXNetError, match="inconsistent"):
        _module(precision="bf16_opt")._updater.set_states(
            pickle.dumps(payload))


def test_legacy_f32_payload_still_loads():
    """A bare dict of float32 numpy leaves (no envelope) loads into a
    float32 Updater."""
    src = _module()
    _train(src, 2)
    legacy = pickle.dumps({k: st.asnumpy()
                           for k, st in src._updater.states.items()})
    dst = _module()
    dst._updater.set_states(legacy)
    for k, st in src._updater.states.items():
        np.testing.assert_array_equal(
            dst._updater._state(k, src._exec_group.param_arrays[k][0])
            .asnumpy(), st.asnumpy())
    with pytest.raises(MXNetError, match="state_dtype"):
        _module(precision="bf16_opt")._updater.set_states(legacy)


def test_bf16_payload_from_the_jax_package_refused():
    """A JAX-package bf16 optimizer payload (ml_dtypes leaves) is refused
    by name."""
    jmx.random.seed(1)
    jm = jmx.mod.Module(_bn_mlp(jmx, JNameManager), context=jmx.cpu(),
                        precision="bf16_opt")
    jm.bind(data_shapes=[("data", (BATCH, 6))],
            label_shapes=[("softmax_label", (BATCH,))])
    jm.init_params(jmx.init.Uniform(0.07))
    jm.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    b = jmx.io.DataBatch([jmx.nd.array(np.ones((BATCH, 6), np.float32))],
                         [jmx.nd.array(np.zeros(BATCH, np.float32))])
    jm.forward_backward(b)
    jm.update()
    with pytest.raises(MXNetError, match="JAX package"):
        _module(precision="bf16_opt")._updater.set_states(
            jm._updater.get_states())


# ------------------------------------------------------------------ guards
def test_non_default_mode_requires_fused_path(monkeypatch):
    monkeypatch.setenv("MXNET_MODULE_FUSED", "0")
    mod = mx.mod.Module(_bn_mlp(), context=CPU, precision="bf16_opt")
    with pytest.raises(ValueError, match="fused mesh path"):
        mod.bind(data_shapes=[("data", (BATCH, 6))],
                 label_shapes=[("softmax_label", (BATCH,))])
    mod = mx.mod.Module(_bn_mlp(), context=CPU, precision="f32")
    mod.bind(data_shapes=[("data", (BATCH, 6))],
             label_shapes=[("softmax_label", (BATCH,))])


def test_classic_update_refuses_narrowed_state_without_fused_apply():
    from mxnet_tpu_torch import optimizer as opt
    sgd = opt.SGD(momentum=0.9, state_dtype="bf16")
    upd = opt.get_updater(sgd)
    w = mx.nd.ones((3,), ctx=CPU)
    with pytest.raises(MXNetError, match="fused"):
        upd(0, mx.nd.ones((3,), ctx=CPU), w)


def test_optimizer_instance_state_dtype_conflict():
    from mxnet_tpu_torch import optimizer as opt
    sgd = opt.SGD(momentum=0.9, learning_rate=0.1, state_dtype="f32")
    mod = mx.mod.Module(_bn_mlp(), context=CPU, precision="bf16_opt")
    mod.bind(data_shapes=[("data", (BATCH, 6))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(mx.init.Uniform(0.07))
    mod.init_optimizer(optimizer=sgd)
    assert sgd.state_dtype == "bfloat16"


# ------------------------------------------------------------------ serving
def test_serving_refuses_mode_mismatch(tmp_path):
    from mxnet_tpu_torch.serving import Predictor
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path))
    a = _module(precision="bf16_opt")
    _train(a, 2)
    a.save_checkpoint(None, 1, manager=mgr, async_save=False)
    wrong = mx.mod.Module.load(mgr, context=CPU, precision="f32")
    with pytest.raises(MXNetError, match="precision mode"):
        Predictor(wrong, data_shapes=[("data", (BATCH, 6))],
                  max_batch_size=BATCH)
    right = mx.mod.Module.load(mgr, context=CPU)
    assert right.precision_mode == "bf16_opt"
    pred = Predictor(right, data_shapes=[("data", (BATCH, 6))],
                     max_batch_size=BATCH)
    try:
        X = np.random.RandomState(3).rand(4, 6).astype(np.float32)
        ref = a.predict(mx.io.NDArrayIter(X, None, batch_size=4)).asnumpy()
        np.testing.assert_array_equal(np.asarray(pred.predict(X)), ref)
    finally:
        pred.release()


@pytest.mark.parametrize("mode", ["bf16", "bf16_opt", "combined"])
def test_serving_buckets_strip_training_only_policy_fields(mode):
    from mxnet_tpu_torch.serving import Predictor
    m = _module(precision=mode)
    _train(m, 2)
    pred = Predictor(m, data_shapes=[("data", (BATCH, 6))],
                     max_batch_size=BATCH)
    try:
        for bm in pred._modules.values():
            assert bm.precision_mode == mode
            assert bm._remat is None
            assert bm._precision.opt_state_dtype is None
            assert bm._compute_dtype == m._compute_dtype
        X = np.random.RandomState(5).rand(4, 6).astype(np.float32)
        ref = m.predict(mx.io.NDArrayIter(X, None, batch_size=4)).asnumpy()
        np.testing.assert_allclose(np.asarray(pred.predict(X)), ref,
                                   rtol=1e-2 if mode == "bf16" else 0,
                                   atol=1e-3 if mode == "bf16" else 0)
    finally:
        pred.release()


# ----------------------------------------------------------- against JAX
def _jax_and_port(prec, opt="sgd", opt_kw=None, steps=3):
    """Both packages trained ``steps`` steps under ``prec`` from the same
    numpy-seeded parameters and batches: {package: (outputs, params,
    state leaves as float32 numpy)}."""
    rs = np.random.RandomState(0)
    jsym, tsym = _bn_mlp(jmx, JNameManager), _bn_mlp()
    shapes = dict(zip(jsym.list_arguments(), jsym.infer_shape(
        data=(BATCH, 6), softmax_label=(BATCH,))[0]))
    args = {k: (0.3 * rs.randn(*v)).astype(np.float32)
            for k, v in shapes.items() if k not in ("data", "softmax_label")}
    aux = {"bn_moving_mean": np.zeros(16, np.float32),
           "bn_moving_var": np.ones(16, np.float32)}
    data = [(rs.rand(BATCH, 6).astype(np.float32),
             rs.randint(0, 10, BATCH).astype(np.float32))
            for _ in range(steps)]
    res = {}
    for pkg, sym in ((jmx, jsym), (mx, tsym)):
        ctx = pkg.cpu()
        mod = pkg.mod.Module(sym, context=ctx, precision=prec)
        mod.bind(data_shapes=[("data", (BATCH, 6))],
                 label_shapes=[("softmax_label", (BATCH,))])
        if pkg is jmx:
            mod.init_params(
                arg_params={k: jmx.nd.array(v) for k, v in args.items()},
                aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
        else:
            a, x = mx.convert.params_from_numpy(args, aux, ctx)
            mod.init_params(arg_params=a, aux_params=x)
        mod.init_optimizer(optimizer=opt, optimizer_params=opt_kw or SGD)
        for x, y in data:
            kw = {"ctx": ctx} if pkg is mx else {}
            mod.forward_backward(pkg.io.DataBatch(
                [pkg.nd.array(x, **kw)], [pkg.nd.array(y, **kw)]))
            mod.update()
        a, x = mod.get_params()
        params = {k: v.asnumpy() for k, v in list(a.items()) +
                  list(x.items())}
        leaves = [np.asarray(leaf.asnumpy(), np.float32)
                  for leaf in _state_leaves(mod._updater)]
        res[pkg.__name__] = (mod.get_outputs()[0].asnumpy(), params, leaves)
    return res["mxnet_tpu"], res["mxnet_tpu_torch"]


@pytest.mark.parametrize("prec,opt,opt_kw", [
    (None, "sgd", None), ("bf16_opt", "sgd", None),
    ("combined", "sgd", None), ("bf16_opt", "adam",
                                {"learning_rate": 0.01})])
def test_modes_match_jax(prec, opt, opt_kw):
    (jo, jp, jl), (to, tp, tl) = _jax_and_port(prec, opt, opt_kw)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if prec is None:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        else:
            # one bf16 ulp: 2^-7 of the larger magnitude
            ulp = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b))
            assert np.all(np.abs(a - b) <= ulp + 1e-30)


def test_bf16_tracks_f32_as_closely_as_jax():
    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    (jo32, jp32, _), (to32, tp32, _) = _jax_and_port(None)
    (jo16, jp16, _), (to16, tp16, _) = _jax_and_port("bf16")
    assert rel(to16, to32) <= 2 * rel(jo16, jo32)
    for k in jp32:
        assert rel(tp16[k], tp32[k]) <= 2 * max(rel(jp16[k], jp32[k]),
                                                1e-7), k


# -------------------------------------------------------------- the twins
@pytest.mark.parametrize("script,argv", [
    ("train_cifar10", ["--network", "resnet-8", "--precision", "bf16",
                       "--batch-group", "4"]),
    ("train_cifar10", ["--network", "resnet-8", "--opt-state-dtype",
                       "bfloat16", "--remat", "dots_saveable"]),
    ("train_mnist", ["--network", "mlp", "--precision", "combined",
                     "--batch-group", "3"])])
def test_twins_take_precision_and_batch_group_flags(script, argv):
    import importlib
    mod = importlib.import_module("mxnet_tpu_torch.examples." + script)
    res = mod.main(["--cpu", "--num-epochs", "1", "--batch-size", "64"]
                   + argv)
    if script == "train_cifar10":
        trained = res["module"]
        assert trained.precision_mode in ("bf16",
                                          "custom(opt=bfloat16,remat=dots)")
        if "--batch-group" in argv:
            assert trained.grouped_train_engaged()
    with pytest.raises(SystemExit):
        mod.main(["--cpu", "--precision", "bf16", "--remat", "full"])
