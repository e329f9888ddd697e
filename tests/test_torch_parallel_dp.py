"""The data-parallel half of mxnet_tpu_torch.parallel against the JAX
package: the dp mesh helpers, the pure SGD and Adam step functions, and
``DataParallelTrainStep`` (the port in one process on the global batch,
the JAX package on its 8-device virtual mesh, the batch sharded on
``dp``) within relative L2 1e-5 after several steps: float32 sums taken
in another order. The model-parallel names refuse, naming ROADMAP A8b.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.parallel import data_parallel as jdp
from mxnet_tpu.parallel import mesh as jmesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import data_parallel as tdp
from mxnet_tpu_torch.parallel import mesh as tmesh

STEP_REL_L2 = 1e-5


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def test_dp_mesh_and_a8b_refusals():
    tmx.dist.reset_runtime()
    m = tmesh.make_mesh({"dp": -1})
    assert m.shape == {"dp": 1} and m.axis_names == ("dp",)
    assert tmesh.data_parallel_mesh().size == 1
    assert tmesh.mesh_from_contexts([tmx.cpu()]).size == 1
    assert tmesh.make_mesh({"dp": 4}, list("abcd")).shape == {"dp": 4}
    assert tmesh.shard_bounds((slice(0, 4), slice(None)), (8, 3)) == \
        jmesh.shard_bounds((slice(0, 4), slice(None)), (8, 3))
    with pytest.raises(MXNetError, match="A8b"):
        tmesh.make_mesh({"dp": 1, "tp": 2})
    with pytest.raises(MXNetError, match="A8b"):
        tmesh.mesh_from_contexts([tmx.cpu(0), tmx.cpu(1)])
    for name in ("RingAttention", "ring_attention", "MoELayer",
                 "PipelineRunner", "column_parallel_dense",
                 "tensor_parallel"):
        with pytest.raises(MXNetError, match="A8b"):
            getattr(tmx.parallel, name)
    with pytest.raises(MXNetError, match="A8b"):
        tmx.mod.Module(_mlp(tmx), context=[tmx.cpu(0), tmx.cpu(1)])
    for kw in ({"mesh_axes": {"dp": 1, "tp": 2}},
               {"param_sharding": {"fc1_weight": ("tp", None)}},
               {"pipeline_microbatches": 4}):
        with pytest.raises(MXNetError, match="A8b"):
            tmx.mod.Module(_mlp(tmx), context=tmx.cpu(), **kw)


@pytest.mark.parametrize("which", ["sgd", "sgd_mom", "adam"])
def test_step_functions_equal_jax(which):
    rng = np.random.RandomState(4)
    p, g = rng.randn(6, 5).astype(np.float32), rng.randn(6, 5).astype(
        np.float32)
    kw = dict(wd=1e-3, rescale_grad=0.5, clip_gradient=0.8)
    if which == "adam":
        t_fn, j_fn = tdp.adam_step_fn(**kw), jdp.adam_step_fn(**kw)
    else:
        mom = 0.9 if which == "sgd_mom" else 0.0
        t_fn = tdp.sgd_step_fn(momentum=mom, **kw)
        j_fn = jdp.sgd_step_fn(momentum=mom, **kw)
    ts, js = t_fn[0](torch.from_numpy(p)), j_fn[0](p)
    tp, jp = torch.from_numpy(p), p
    for _ in range(3):
        tp, ts = t_fn[1](tp, torch.from_numpy(g), ts, 0.05)
        jp, js = j_fn[1](jp, g, js, 0.05)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


def _init(sym, shapes):
    rng = np.random.RandomState(2)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_data_parallel_train_step_matches_jax(opt):
    """The port's step (one process, all 16 rows) against the JAX
    package's on its 8-device mesh, 5 steps from the same parameters."""
    tmx.dist.reset_runtime()
    rng = np.random.RandomState(1)
    X = rng.randn(16, 8).astype(np.float32)
    y = rng.randint(0, 4, 16).astype(np.float32)
    init = _init(_mlp(tmx), {"data": (16, 8)})
    kw = {"rescale_grad": 1.0 / 16}
    if opt == "sgd":
        t_fn, j_fn = tdp.sgd_step_fn(momentum=0.9, **kw), \
            jdp.sgd_step_fn(momentum=0.9, **kw)
    else:
        t_fn, j_fn = tdp.adam_step_fn(**kw), jdp.adam_step_fn(**kw)

    tstep = tdp.DataParallelTrainStep(_mlp(tmx), tmesh.data_parallel_mesh(),
                                      t_fn, context=tmx.cpu())
    tp, ts, ta = tstep.init(tmx.initializer.Xavier(),
                            {"data": (16, 8), "softmax_label": (16,)})
    for k in tp:
        tp[k].copy_(torch.from_numpy(init[k]))
    ts = {n: t_fn[0](tp[n]) for n in tp}
    tin = tstep.shard_batch({"data": X, "softmax_label": y})

    import jax
    jstep = jdp.DataParallelTrainStep(_mlp(jmx),
                                      jmesh.data_parallel_mesh(8), j_fn)
    jp, js, ja = jstep.init(jmx.initializer.Xavier(), {"data": (16, 8)})
    jp = {k: jax.device_put(v, jstep._repl) for k, v in init.items()}
    js = {n: jax.jit(j_fn[0])(jp[n]) for n in jp}
    jin = jstep.shard_batch({"data": X, "softmax_label": y})
    for _ in range(5):
        tp, ts, ta, touts = tstep(tp, ts, ta, tin, 0.1)
        jp, js, ja, jouts = jstep(jp, js, ja, jin, 0.1)
    for k in init:
        assert _rel(tp[k].numpy(), np.asarray(jp[k])) < STEP_REL_L2, k
    assert _rel(touts[0].numpy(), np.asarray(jouts[0])) < STEP_REL_L2
    assert not np.array_equal(tp["fc1_weight"].numpy(), init["fc1_weight"])
    (probs,) = tstep.forward(tp, ta, tin)
    assert probs.shape == (16, 4)
