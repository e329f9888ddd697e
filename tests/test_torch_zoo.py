"""The model zoo of the PyTorch port (mxnet_tpu_torch ``models``) against
the JAX package's ``models``, on the CPU.

Per network of the reference's ``--network`` names: the port's symbol is
the JAX package's graph (the same JSON nodes: names, attributes, inputs;
so the same arguments, auxiliary states and inferred shapes at the
published input); one eval forward at batch 2, at the smallest input the
network infers at, from the same numpy-seeded parameters, lies within
relative L2 1e-5 of the JAX package's (the softmax outputs and the logits
under them). Also the ``-bf16`` names and their ``ValueError``, and
``lstm.get_unfused_symbol`` (with its DropoutCells) and the fused
``lstm.get_symbol`` against the JAX graphs. One training step of three of the networks against the JAX
package's fused route: ``test_torch_zoo_step.py``.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

# network -> (published input, smallest input it infers at)
NETWORKS = {
    "alexnet": ((3, 224, 224), 67),
    "vgg": ((3, 224, 224), 32),
    "googlenet": ((3, 224, 224), 61),
    "inception-bn": ((3, 224, 224), 16),
    "inception-v3": ((3, 299, 299), 75),
    "inception-resnet-v2": ((3, 299, 299), 75),
    "resnext-50": ((3, 224, 224), 16),
}
FWD_REL_L2 = 1e-5


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nodes(sym):
    return json.loads(sym.tojson())["nodes"]


@pytest.mark.parametrize("network", sorted(NETWORKS) + [
    "resnext-101", "resnet-50-bf16", "alexnet-bf16", "inception-v3-classes"])
def test_graph_equals_the_jax_graph(network):
    kw = {"num_classes": 1000}
    if network == "inception-v3-classes":
        network, kw = "inception-v3", {"num_classes": 17}
    shape = NETWORKS.get(network, ((3, 224, 224), 0))[0]
    # auto-named nodes (Flatten, Pooling, _plus...) count from 0 in both
    with JNameManager():
        j = jmx.models.get_symbol(network, image_shape=shape, **kw)
    with TNameManager():
        t = tmx.models.get_symbol(network, image_shape=shape, **kw)
    assert _nodes(t) == _nodes(j)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    ja = j.infer_shape(data=(32,) + shape)
    ta = t.infer_shape(data=(32,) + shape)
    for js, ts in zip(ja, ta):
        assert [tuple(s) for s in ts] == [tuple(s) for s in js]


def _params(sym, shape, seed):
    """Parameters and moving statistics from numpy: conv and FC weights
    at 1/fan-in variance (the logits stay O(1) through 100+ layers),
    γ in [0.5, 1.5), β and biases small, moving variances near 1."""
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


def _module(pkg, sym, shape, args, aux, for_training, label=False):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))] if label
             else None, for_training=for_training)
    if pkg is jmx:
        mod.init_params(
            arg_params={k: jmx.nd.array(v) for k, v in args.items()},
            aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
    else:
        a, x = tmx.convert.params_from_numpy(args, aux, ctx)
        mod.init_params(arg_params=a, aux_params=x)
    return mod


def _batch(pkg, x, y=None):
    kw = {"ctx": tmx.cpu()} if pkg is tmx else {}
    return pkg.io.DataBatch([pkg.nd.array(x, **kw)],
                            [] if y is None else [pkg.nd.array(y, **kw)])


@pytest.mark.parametrize("network", sorted(NETWORKS))
def test_forward_matches_jax(network):
    side = NETWORKS[network][1]
    shape = (2, 3, side, side)
    net = jmx.models.get_symbol(network, num_classes=10)
    head = _nodes(net)[_nodes(net)[-1]["inputs"][0][0]]["name"]
    jsym = jmx.sym.Group([net, net.get_internals()[head + "_output"]])
    tsym = tmx.sym.load_json(jsym.tojson())
    args, aux = _params(jsym, shape, seed=0)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    outs = {}
    for pkg, sym in ((jmx, jsym), (tmx, tsym)):
        mod = _module(pkg, sym, shape, args, aux, for_training=False)
        mod.forward(_batch(pkg, x), is_train=False)
        outs[pkg.__name__] = [o.asnumpy() for o in mod.get_outputs()]
    (jp, jl), (tp, tl) = outs["mxnet_tpu"], outs["mxnet_tpu_torch"]
    assert tp.shape == (2, 10) and np.isfinite(tl).all()
    # not saturated: the softmax rows are a test of the logits
    assert 0.01 < float(np.abs(jl).max()) < 10.0
    assert _rel(tl, jl) < FWD_REL_L2
    assert _rel(tp, jp) < FWD_REL_L2


def test_bf16_names_and_their_value_error():
    for name in ("resnet-50-bf16", "alexnet-bf16"):
        t = tmx.models.get_symbol(name, num_classes=10)
        casts = [n for n in _nodes(t) if n["op"] == "Cast"]
        assert [n["attrs"]["dtype"] for n in casts] == ["bfloat16",
                                                        "float32"]
    for name in ("vgg-bf16", "resnext-50-bf16", "inception-v3-bf16"):
        with pytest.raises(ValueError) as te:
            tmx.models.get_symbol(name)
        with pytest.raises(ValueError) as je:
            jmx.models.get_symbol(name)
        assert str(te.value) == str(je.value)


def test_lstm_unfused_symbol_equals_the_jax_graph():
    kw = dict(seq_len=5, vocab_size=11, num_hidden=8, num_embed=6,
              num_layers=3, dropout=0.2)
    # auto-named nodes (the cells' _plus, Dropout) count from 0 in both
    with JNameManager():
        j = jmx.models.lstm.get_unfused_symbol(**kw)
    with TNameManager():
        t = tmx.models.lstm.get_unfused_symbol(**kw)
    assert _nodes(t) == _nodes(j)
    assert sum(n["op"] == "Dropout" for n in _nodes(t)) == 2 * 5
    assert t.list_arguments() == j.list_arguments()
    # the fused builder (one RNN node) equals the JAX one too
    with JNameManager():
        j = jmx.models.lstm.get_symbol(**kw)
    with TNameManager():
        t = tmx.models.lstm.get_symbol(**kw)
    assert _nodes(t) == _nodes(j)
    assert sum(n["op"] == "RNN" for n in _nodes(t)) == 1
    cell = tmx.rnn.DropoutCell(0.5)
    assert cell.state_info == []
