"""One training step of zoo networks in the PyTorch port (mxnet_tpu_torch
``models``, the fused route) against the JAX package's fused route, on
the CPU, from the same numpy-seeded parameters and batch: inception-bn
and resnext-50 on the 32² stem (as ``tests/test_train.py``'s resnext
step), and alexnet with its two Dropouts set to p = 0 through the JSON.
Parameters and moving statistics after the step, one SGD-momentum
update, are held by relative L2.

The tolerance. alexnet (no BatchNorm) is held to 1e-4. A deep
BatchNorm net at initialisation amplifies the rounding of its forward
by ~1e4 in the gradients of its early layers (the gradients grow with
depth through the BatchNorms and then cancel): the JAX package against
itself, with the one-pass statistics it trains with and with the
two-pass ones (``MXNET_BN_EXACT_STATS=1``, the same function rounded
otherwise), moves these parameters by ~2e-3 (inception-bn) and ~2e-2
(resnext-50) after one step. The port rounds differently again, so its
step is held to the larger of 1e-4 and four times that spread of the
JAX package, measured here in each run.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)

import mxnet_tpu_torch as tmx

torch.set_num_threads(2)

STEP_REL_L2 = 1e-4
SPREAD_FACTOR = 4.0
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
BATCH = 4


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _params(sym, shape, seed):
    """conv and FC weights at 1/fan-in variance, γ in [0.5, 1.5), β and
    biases small, moving variances near 1 (as ``test_torch_zoo.py``)."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args, aux = {}, {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("gamma"):
            v = rng.uniform(0.5, 1.5, s)
        elif n.endswith(("beta", "bias")):
            v = rng.uniform(-0.1, 0.1, s)
        else:
            v = rng.randn(*s) * np.sqrt(1.0 / np.prod(s[1:]))
        args[n] = v.astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        lo, hi = (0.5, 1.5) if n.endswith("var") else (-0.1, 0.1)
        aux[n] = rng.uniform(lo, hi, s).astype(np.float32)
    return args, aux


def _symbols(network):
    """(JAX symbol, port symbol, input side)."""
    if network == "alexnet-p0":
        nodes = json.loads(jmx.models.get_symbol(
            "alexnet", num_classes=10).tojson())
        drops = [n for n in nodes["nodes"] if n["op"] == "Dropout"]
        assert len(drops) == 2
        for n in drops:
            n["attrs"]["p"] = "0.0"
        text = json.dumps(nodes)
        return jmx.sym.load_json(text), tmx.sym.load_json(text), 67
    kw = {"image_shape": (3, 32, 32)}
    if network == "resnext-50":
        kw["num_group"] = 8     # as tests/test_train.py's cifar-stem step
    j = jmx.models.get_symbol(network, num_classes=10, **kw)
    return j, tmx.sym.load_json(j.tojson()), 32


def _step(pkg, sym, shape, args, aux, x, y):
    """Parameters and aux (numpy, by name) after one fused SGD step."""
    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))])
    assert type(mod._exec_group).__name__ == "MeshExecutorGroup"
    kw = {"ctx": ctx} if pkg is tmx else {}
    if pkg is jmx:
        mod.init_params(
            arg_params={k: jmx.nd.array(v) for k, v in args.items()},
            aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
    else:
        a, b = tmx.convert.params_from_numpy(args, aux, ctx)
        mod.init_params(arg_params=a, aux_params=b)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        OPT, rescale_grad=1.0 / shape[0]))
    mod.forward_backward(pkg.io.DataBatch([pkg.nd.array(x, **kw)],
                                          [pkg.nd.array(y, **kw)]))
    mod.update()
    a, b = mod.get_params()
    return {k: v.asnumpy() for k, v in list(a.items()) + list(b.items())}


@pytest.mark.parametrize("network", ["inception-bn", "resnext-50",
                                     "alexnet-p0"])
def test_training_step_matches_the_jax_fused_route(network, monkeypatch):
    jsym, tsym, side = _symbols(network)
    shape = (BATCH, 3, side, side)
    args, aux = _params(jsym, shape, seed=2)
    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randint(0, 10, BATCH).astype(np.float32)
    want = _step(jmx, jsym, shape, args, aux, x, y)
    mine = _step(tmx, tsym, shape, args, aux, x, y)
    has_bn = any(k.endswith("moving_var") for k in want)
    limit = STEP_REL_L2
    if has_bn:
        monkeypatch.setenv("MXNET_BN_EXACT_STATS", "1")
        exact = _step(jmx, jsym, shape, args, aux, x, y)
        spread = max(_rel(exact[k], want[k]) for k in want)
        limit = max(STEP_REL_L2, SPREAD_FACTOR * spread)
        assert limit < 0.2       # the step is still a test
    assert sorted(want) == sorted(mine)
    moved = 0
    for k in want:
        assert np.isfinite(mine[k]).all(), k
        assert _rel(mine[k], want[k]) < limit, (k, limit)
        before = args[k] if k in args else aux[k]
        moved += not np.array_equal(mine[k], before)
    assert moved > len(want) // 2
    # the layers next to the loss are well conditioned
    for k in ("fc1_weight", "fc3_weight"):
        if k in want:
            assert _rel(mine[k], want[k]) < 10 * STEP_REL_L2, k
