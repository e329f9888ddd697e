"""The PyTorch port (mxnet_tpu_torch) vs the JAX package, on the CPU.

Every op of the port's first slice, forward and backward, against the JAX
op; a resnet-8 trained through both packages' ``Module`` from identical
parameters; symbol JSON and ``.params`` files read across packages; the
port's import boundary; and its refusal to fall back to the CPU. Inputs
are made with numpy from a seed and handed to both packages. Tolerances
are stated where used: the two frameworks reduce in different orders, so
float32 results agree to a few ulps per op and drift a little more over
training steps.
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
from mxnet_tpu import registry as jreg
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import registry as treg
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_RTOL, OP_ATOL = 1e-5, 1e-5


def _run_jax(name, attrs, ins, cots, is_train):
    op = jreg.get_op(name)
    attrs = jreg.parse_attrs(op, attrs)

    def f(*xs):
        return tuple(op.fcompute(attrs, list(xs),
                                 jreg.OpContext(is_train=is_train)))

    outs, vjp = jax.vjp(f, *[jnp.asarray(v) for v in ins])
    grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cots, outs)))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _run_torch(name, attrs, ins, cots, is_train):
    op = treg.get_op(name)
    attrs = treg.parse_attrs(op, attrs)
    ts = [torch.tensor(v, requires_grad=True) for v in ins]
    outs = op.fcompute(attrs, ts, treg.OpContext(is_train=is_train))
    pairs = [(o, torch.tensor(c)) for o, c in zip(outs, cots)
             if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs], ts,
                                [c for _, c in pairs], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, ts)]
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _case_inputs(name, rs):
    """(attrs, inputs) per op case; labels are float arrays as in MXNet."""
    if name.startswith("fc"):
        attrs = {"num_hidden": 6, "no_bias": name == "fc_nobias"}
        ins = [_rand(rs, 3, 4, 5), _rand(rs, 6, 20)]
        return "FullyConnected", attrs, ins + ([] if attrs["no_bias"]
                                               else [_rand(rs, 6)])
    if name.startswith("act_"):
        return "Activation", {"act_type": name[4:]}, [_rand(rs, 3, 7)]
    if name.startswith("softmax"):
        if name == "softmax_multi":
            lab = rs.randint(0, 3, (2, 4)).astype(np.float32)
            lab[0, 1] = -1.0
            return "SoftmaxOutput", {"multi_output": True, "use_ignore": True,
                                     "ignore_label": -1.0,
                                     "normalization": "valid"}, \
                [_rand(rs, 2, 3, 4), lab]
        lab = rs.randint(0, 10, (4,)).astype(np.float32)
        attrs = {} if name == "softmax" else \
            {"grad_scale": 0.5, "normalization": "batch"}
        return "SoftmaxOutput", attrs, [_rand(rs, 4, 10), lab]
    if name.startswith("conv"):
        if name == "conv_group":
            return "Convolution", {"kernel": (3, 3), "num_filter": 6,
                                   "num_group": 2, "pad": (1, 1)}, \
                [_rand(rs, 2, 4, 7, 7), _rand(rs, 6, 2, 3, 3), _rand(rs, 6)]
        if name == "conv_dilate":
            return "Convolution", {"kernel": (3, 3), "num_filter": 4,
                                   "dilate": (2, 2), "no_bias": True}, \
                [_rand(rs, 2, 3, 9, 9), _rand(rs, 4, 3, 3, 3)]
        return "Convolution", {"kernel": (3, 3), "num_filter": 4,
                               "stride": (2, 2), "pad": (1, 1)}, \
            [_rand(rs, 2, 3, 9, 9), _rand(rs, 4, 3, 3, 3), _rand(rs, 4)]
    if name.startswith("pool_"):
        _, ptype, conv = name.split("_")
        if conv == "global":
            attrs = {"pool_type": ptype, "global_pool": True,
                     "kernel": (7, 7)}
        else:
            attrs = {"pool_type": ptype, "kernel": (3, 3), "stride": (2, 2),
                     "pad": (1, 1), "pooling_convention": conv}
        return "Pooling", attrs, [_rand(rs, 2, 3, 8, 8)]
    if name == "flatten":
        return "Flatten", {}, [_rand(rs, 2, 3, 4, 5)]
    if name == "plus":
        return "_plus", {}, [_rand(rs, 2, 3, 4), _rand(rs, 2, 3, 4)]
    raise KeyError(name)


OP_CASES = ["fc", "fc_nobias", "act_relu", "act_sigmoid", "act_tanh",
            "act_softrelu", "softmax", "softmax_scaled", "softmax_multi",
            "conv", "conv_group", "conv_dilate", "pool_max_valid",
            "pool_avg_valid", "pool_sum_valid", "pool_max_full",
            "pool_avg_full", "pool_avg_global", "flatten", "plus"]


@pytest.mark.parametrize("case", OP_CASES)
def test_op_matches_jax(case):
    rs = np.random.RandomState(OP_CASES.index(case))
    name, attrs, ins = _case_inputs(case, rs)
    # cotangents shaped like the outputs, from the JAX forward
    op = jreg.get_op(name)
    pattrs = jreg.parse_attrs(op, attrs)
    jouts = op.fcompute(pattrs, [jnp.asarray(v) for v in ins],
                        jreg.OpContext(is_train=True))
    cots = [_rand(rs, *o.shape) for o in jouts]
    jo, jg = _run_jax(name, attrs, ins, cots, True)
    to, tg = _run_torch(name, attrs, ins, cots, True)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, rtol=OP_RTOL, atol=OP_ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=OP_RTOL, atol=OP_ATOL)


@pytest.mark.parametrize("mode", ["train", "train_relu", "eval",
                                  "global_stats"])
def test_batchnorm_op_matches_jax(mode):
    rs = np.random.RandomState(5)
    C = 4
    ins = [_rand(rs, 3, C, 5, 5, scale=2.0) + 1.0,
           (rs.rand(C) + 0.5).astype(np.float32), _rand(rs, C, scale=0.1),
           _rand(rs, C, scale=0.1), (rs.rand(C) + 0.5).astype(np.float32)]
    attrs = {"eps": 2e-5, "momentum": 0.9, "fix_gamma": False,
             "use_global_stats": mode == "global_stats",
             "_fused_relu": mode == "train_relu"}
    is_train = mode != "eval"
    cots = [_rand(rs, 3, C, 5, 5), np.zeros(C, np.float32),
            np.zeros(C, np.float32)]
    jo, jg = _run_jax("BatchNorm", attrs, ins, cots, is_train)
    to, tg = _run_torch("BatchNorm", attrs, ins, cots, is_train)
    for a, b in zip(to, jo):   # output + the two moving-stat updates
        np.testing.assert_allclose(a, b, rtol=OP_RTOL, atol=OP_ATOL)
    for a, b in zip(tg[:3], jg[:3]):   # data, gamma, beta
        np.testing.assert_allclose(a, b, rtol=OP_RTOL, atol=OP_ATOL)


@pytest.mark.parametrize("name", ["sgd_update", "sgd_mom_update"])
def test_optimizer_op_matches_jax(name):
    rs = np.random.RandomState(9)
    ins = [_rand(rs, 5, 3), _rand(rs, 5, 3)] + \
        ([_rand(rs, 5, 3)] if name == "sgd_mom_update" else [])
    attrs = {"lr": 0.1, "wd": 1e-4, "rescale_grad": 0.25, "momentum": 0.9,
             "clip_gradient": 0.3}
    op = jreg.get_op(name)
    jo = op.fcompute(jreg.parse_attrs(op, attrs),
                     [jnp.asarray(v) for v in ins], jreg.OpContext())
    top = treg.get_op(name)
    to = top.fcompute(treg.parse_attrs(top, attrs),
                      [torch.tensor(v) for v in ins], treg.OpContext())
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# resnet-8 through both packages' Module
# ---------------------------------------------------------------------------
BATCH = 4
MOD_RTOL, MOD_ATOL = 1e-4, 1e-5


def _resnet8(pkg, names):
    with names():
        return pkg.models.get_symbol("resnet-8", num_classes=10,
                                     image_shape=(3, 28, 28))


def _shared_params(sym, rs):
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(BATCH, 3, 28, 28),
                                                softmax_label=(BATCH,))
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("gamma"):
            args[name] = (rs.rand(*shape) + 0.5).astype(np.float32)
        elif name.endswith(("beta", "bias")):
            args[name] = _rand(rs, *shape, scale=0.1)
        else:
            fan = float(np.prod(shape[1:]))
            args[name] = _rand(rs, *shape, scale=np.sqrt(2.0 / fan))
    aux = {}
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = _rand(rs, *shape, scale=0.1) if name.endswith("mean") \
            else (rs.rand(*shape) + 0.5).astype(np.float32)
    return args, aux


def _batches(rs, n):
    return [(_rand(rs, BATCH, 3, 28, 28),
             rs.randint(0, 10, (BATCH,)).astype(np.float32))
            for _ in range(n)]


def _train(pkg, mod, ctx, batches, on_first):
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    for i, (x, y) in enumerate(batches):
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                 [pkg.nd.array(y, ctx=ctx)])
        mod.forward_backward(batch)
        if i == 0:
            grads = {n: g[0].asnumpy() for n, g in
                     zip(mod._param_names, mod._exec_group.grad_arrays)
                     if g is not None}
            on_first(mod.get_outputs()[0].asnumpy(), grads)
        mod.update()
    args, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def test_resnet8_module_matches_jax():
    jsym = _resnet8(jmx, JNameManager)
    tsym = _resnet8(tmx, TNameManager)
    assert tsym.list_arguments() == jsym.list_arguments()
    # A ReLU pre-activation within rounding distance of 0 flips its mask
    # between the frameworks (seed 0 has one at |y| = 2.4e-7 and moves one
    # channel's dβ by 6e-3), so the seed is one with no such element.
    rs = np.random.RandomState(3)
    args, aux = _shared_params(jsym, rs)
    batches = _batches(rs, 3)
    shapes = dict(data_shapes=[("data", (BATCH, 3, 28, 28))],
                  label_shapes=[("softmax_label", (BATCH,))])

    first = {}
    # the JAX package's classic per-executor group keeps per-step grads
    jmod = jmx.mod.Module(jsym, context=jmx.cpu(), _allow_fused=False)
    jmod.bind(**shapes)
    jmod.init_params(arg_params={k: jmx.nd.array(v) for k, v in args.items()},
                     aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
    jres = _train(jmx, jmod, jmx.cpu(), batches,
                  lambda o, g: first.update(jax=(o, g)))

    tctx = tmx.cpu()
    targs, taux = tmx.convert.params_from_numpy(args, aux, tctx)
    tmod = tmx.mod.Module(tsym, context=tctx)
    tmod.bind(**shapes)
    tmod.init_params(arg_params=targs, aux_params=taux)
    tres = _train(tmx, tmod, tctx, batches,
                  lambda o, g: first.update(torch=(o, g)))

    (jo, jg), (to, tg) = first["jax"], first["torch"]
    np.testing.assert_allclose(to, jo, rtol=MOD_RTOL, atol=MOD_ATOL)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=MOD_RTOL,
                                   atol=MOD_ATOL, err_msg=k)
    for tdict, jdict in zip(tres, jres):
        assert sorted(tdict) == sorted(jdict)
        for k in jdict:
            np.testing.assert_allclose(tdict[k], jdict[k], rtol=MOD_RTOL,
                                       atol=MOD_ATOL, err_msg=k)


def test_module_routes_batchnorm_through_fused_core():
    """8 BatchNorms in resnet-8, 7 of them fused with their ReLU."""
    sym = _resnet8(tmx, TNameManager)
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (2, 3, 28, 28))],
             label_shapes=[("softmax_label", (2,))])
    bns = [n for n in mod._exec_group.symbol._topo()
           if n.op is not None and n.op.name == "BatchNorm"]
    assert len(bns) == 8
    assert sum(bool(n.attrs.get("_fused_relu")) for n in bns) == 7
    assert not any(n.op is not None and n.op.name == "Activation"
                   for n in mod._exec_group.symbol._topo())


# ---------------------------------------------------------------------------
# files across packages
# ---------------------------------------------------------------------------
def test_symbol_json_round_trips_across_packages():
    jsym = _resnet8(jmx, JNameManager)
    tsym = _resnet8(tmx, TNameManager)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    from_j = tmx.sym.load_json(jsym.tojson())
    from_t = jmx.sym.load_json(tsym.tojson())
    for a, b in ((from_j, jsym), (from_t, tsym)):
        assert a.list_arguments() == b.list_arguments()
        assert a.list_auxiliary_states() == b.list_auxiliary_states()
        assert a.list_outputs() == b.list_outputs()
    shapes = dict(data=(2, 3, 28, 28), softmax_label=(2,))
    assert from_j.infer_shape(**shapes) == \
        tuple(list(map(tuple, s)) for s in jsym.infer_shape(**shapes))


def test_params_files_round_trip_across_packages(tmp_path):
    rs = np.random.RandomState(1)
    jsym = _resnet8(jmx, JNameManager)
    args, aux = _shared_params(jsym, rs)
    jprefix = str(tmp_path / "jax")
    jmx.model.save_checkpoint(jprefix, 3, jsym,
                              {k: jmx.nd.array(v) for k, v in args.items()},
                              {k: jmx.nd.array(v) for k, v in aux.items()})
    tsym, targs, taux = tmx.convert.load_jax_checkpoint(jprefix, 3,
                                                        tmx.cpu())
    assert tsym.list_arguments() == jsym.list_arguments()
    for src, dst in ((args, targs), (aux, taux)):
        assert sorted(src) == sorted(dst)
        for k in src:
            assert np.array_equal(dst[k].asnumpy(), src[k])

    tprefix = str(tmp_path / "torch")
    tmx.model.save_checkpoint(tprefix, 4, tsym, targs, taux)
    jsym2, jargs, jaux = jmx.model.load_checkpoint(tprefix, 4)
    assert jsym2.list_arguments() == jsym.list_arguments()
    for src, dst in ((args, jargs), (aux, jaux)):
        assert sorted(src) == sorted(dst)
        for k in src:
            assert np.array_equal(dst[k].asnumpy(), src[k])


# ---------------------------------------------------------------------------
# import boundary and device policy
# ---------------------------------------------------------------------------
def _forbidden(name):
    return name == "jax" or name.startswith("jax.") or \
        name == "mxnet_tpu" or name.startswith("mxnet_tpu.")


def test_port_imports_neither_jax_nor_mxnet_tpu():
    code = r"""
import importlib, pkgutil, sys
import mxnet_tpu_torch as mx
for m in pkgutil.walk_packages(mx.__path__, "mxnet_tpu_torch."):
    importlib.import_module(m.name)
sym = mx.models.get_symbol("resnet-8", num_classes=10, image_shape=(3, 28, 28))
mod = mx.mod.Module(sym, context=mx.cpu())
mod.bind(data_shapes=[("data", (1, 3, 28, 28))],
         label_shapes=[("softmax_label", (1,))])
mod.init_params(mx.init.Xavier())
mod.forward_backward(mx.io.DataBatch([mx.nd.zeros((1, 3, 28, 28), ctx=mx.cpu())],
                                     [mx.nd.zeros((1,), ctx=mx.cpu())]))
print("\n".join(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    loaded = out.split()
    assert "mxnet_tpu_torch.executor" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    # and every module is held to the same rule by its source
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) \
                    and node.level == 0 else []
                assert not [n for n in names if _forbidden(n)], (f, names)


def test_default_context_is_the_card():
    assert tmx.current_context() == tmx.gpu(0)
    assert tmx.tpu(0) == tmx.gpu(0)
    sym = _resnet8(tmx, TNameManager)
    if torch.cuda.is_available():
        assert tmx.nd.zeros((2,)).context == tmx.gpu(0)
        return
    with pytest.raises(tmx.MXNetError):
        tmx.nd.zeros((2,))
    with pytest.raises(tmx.MXNetError):
        tmx.mod.Module(sym)
    # an explicit CPU context runs
    assert tmx.nd.zeros((2,), ctx=tmx.cpu()).context == tmx.cpu()


# ---------------------------------------------------------------------------
# executor grad_req and NDArray basics
# ---------------------------------------------------------------------------
def _fc_net(pkg):
    data = pkg.sym.Variable("data")
    fc = pkg.sym.FullyConnected(data=data, num_hidden=3, name="fc")
    return pkg.sym.SoftmaxOutput(data=fc, name="softmax")


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_executor_grad_req_matches_jax(req):
    rs = np.random.RandomState(2)
    vals = {"data": _rand(rs, 4, 5), "fc_weight": _rand(rs, 3, 5),
            "fc_bias": _rand(rs, 3),
            "softmax_label": rs.randint(0, 3, (4,)).astype(np.float32)}
    grads = {}
    for pkg, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        ex = _fc_net(pkg).simple_bind(ctx, grad_req=req, data=(4, 5),
                                      softmax_label=(4,))
        for k, v in vals.items():
            ex.arg_dict[k][:] = v
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
        grads[pkg.__name__] = {k: None if g is None else g.asnumpy()
                               for k, g in ex.grad_dict.items()}
    jg, tg = grads["mxnet_tpu"], grads["mxnet_tpu_torch"]
    for k in ("fc_weight", "fc_bias"):
        if req == "null":
            assert jg[k] is None and tg[k] is None
        else:
            np.testing.assert_allclose(tg[k], jg[k], rtol=OP_RTOL,
                                       atol=OP_ATOL)


def test_ndarray_views_arithmetic_and_files(tmp_path):
    ctx = tmx.cpu()
    a = tmx.nd.array(np.arange(12).reshape(3, 4), ctx=ctx)
    b = tmx.nd.ones((3, 4), ctx=ctx)
    assert np.array_equal(((a + b) * 2 - 1).asnumpy(),
                          (np.arange(12).reshape(3, 4) + 1) * 2 - 1)
    row = a[1]
    row[:] = 7.0                      # a view writes through
    a.slice(2, 3)[:] = np.full((1, 4), 5.0)
    a /= 2
    want = np.arange(12, dtype=np.float32).reshape(3, 4)
    want[1], want[2] = 7.0, 5.0
    assert np.array_equal(a.asnumpy(), want / 2)
    c = a.copyto(ctx)
    c += 1
    assert np.array_equal(a.asnumpy(), want / 2)
    a.wait_to_read()
    # lists and dicts read across packages both ways
    f1, f2 = str(tmp_path / "t.nd"), str(tmp_path / "j.nd")
    tmx.nd.save(f1, [a, b])
    got = jmx.nd.load(f1)
    assert [x.asnumpy().tolist() for x in got] == \
        [a.asnumpy().tolist(), b.asnumpy().tolist()]
    jmx.nd.save(f2, {"w": jmx.nd.array(want)})
    assert np.array_equal(tmx.nd.load(f2, ctx=ctx)["w"].asnumpy(), want)
    with pytest.raises(tmx.MXNetError):
        tmx.nd.load(f2 + ".tmp")
