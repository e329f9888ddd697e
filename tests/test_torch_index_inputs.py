"""Index-only inputs under the bfloat16 precision modes in the PyTorch port
(``mxnet_tpu_torch/precision/policy.py`` ``index_inputs``), against the
JAX package on the CPU.

bfloat16 keeps 8 significant bits, so it holds every integer only up to
256: an Embedding id of 8,221 cast to it reads row 8,192, and a sequence
length of 257 masks from step 256. The port keeps a variable in float32
when every path from it ends in an index argument (Embedding's ids, the
sequence ops' lengths), through any shape-only ops on the way (Reshape,
SwapAxis, ...). The JAX package casts every input but the labels, so its
own bf16 runs read the wrong rows; the port is held to the JAX package's
**float32** result, rounded to bfloat16 only where the data itself rounds
(the Embedding rows and the masked data under ``bf16``; nothing under
``combined``, which computes in float32). Held exactly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.precision.policy import index_inputs

torch.set_num_threads(2)

V, E = 10000, 8          # the PTB vocabulary: bfloat16 keeps multiples of 64
T, N = 5, 2
STEPS = 300
LENGTHS = (257, 299)     # bf16: 256, 300
MODES = ("bf16", "combined")


def _ids(rs):
    ids = rs.randint(0, V, (N, T)).astype(np.float32)
    ids[0, :3] = [257, 8221, V - 1]    # bf16: 256, 8192, 10,000
    return ids


def _embed_net(mx, names, shape_op):
    with names():
        data = mx.sym.Variable("data")
        if shape_op == "SwapAxis":     # rnn-time-major's rnn_cell_demo
            ids = mx.sym.SwapAxis(data, dim1=0, dim2=1)
        elif shape_op == "Reshape":
            ids = mx.sym.Reshape(data, shape=(-1,))
        else:
            ids = mx.sym.Flatten(mx.sym.transpose(data))
        return mx.sym.Embedding(ids, input_dim=V, output_dim=E,
                                name="embed")


def _run(mx, net, inputs, params=None, precision=None):
    """``net``'s eval output through ``Module`` at ``precision``."""
    ctx = mx.cpu()
    kw = {} if precision is None else {"precision": precision}
    mod = mx.mod.Module(net, data_names=[n for n, _ in inputs],
                        label_names=None, context=ctx, **kw)
    mod.bind(data_shapes=[(n, v.shape) for n, v in inputs],
             for_training=False)
    mod.init_params(arg_params={n: mx.nd.array(v, ctx=ctx)
                                for n, v in (params or {}).items()})
    mod.forward(mx.io.DataBatch([mx.nd.array(v, ctx=ctx)
                                 for _, v in inputs], None), is_train=False)
    return mod.get_outputs()[0].asnumpy()


def _bf16(x):
    return torch.tensor(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("shape_op", ["SwapAxis", "Reshape", "transpose"])
def test_embedding_reads_ids_through_a_shape_op(shape_op, precision):
    rs = np.random.RandomState(3)
    weight = rs.randn(V, E).astype(np.float32)
    inputs = [("data", _ids(rs))]
    params = {"embed_weight": weight}
    want = _run(jmx, _embed_net(jmx, JNameManager, shape_op), inputs,
                params)
    net = _embed_net(tmx, TNameManager, shape_op)
    assert index_inputs(net) == {"data"}
    got = _run(tmx, net, inputs, params, precision)
    if precision == "bf16":
        want = _bf16(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _seq_net(mx, names, op):
    with names():
        data, length = mx.sym.Variable("data"), mx.sym.Variable("length")
        return getattr(mx.sym, op)(data, length, use_sequence_length=True,
                                   name="seq")


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("op", ["SequenceMask", "SequenceLast",
                                "SequenceReverse"])
def test_sequence_lengths_above_256_are_exact(op, precision):
    rs = np.random.RandomState(4)
    # values in [1, 2): never the mask's 0, and exact in bf16 at 1 + k/128
    data = (1 + rs.randint(0, 128, (STEPS, N, 3)) / 128.0).astype(
        np.float32)
    inputs = [("data", data), ("length", np.array(LENGTHS, np.float32))]
    want = _run(jmx, _seq_net(jmx, JNameManager, op), inputs)
    net = _seq_net(tmx, TNameManager, op)
    assert index_inputs(net) == {"length"}
    got = _run(tmx, net, inputs, precision=precision)
    np.testing.assert_array_equal(got, want)
    if op == "SequenceMask":
        kept = (got != 0).all(axis=2).sum(axis=0)
        assert tuple(kept) == LENGTHS
    if op == "SequenceLast":
        np.testing.assert_array_equal(
            got, data[np.array(LENGTHS) - 1, np.arange(N)])


def _graphs(mx):
    """Named symbols for ``index_inputs``, each with the names it keeps."""
    S = mx.sym
    ids, x, n = S.Variable("ids"), S.Variable("x"), S.Variable("n")

    def emb(v, name):
        return S.Embedding(v, input_dim=V, output_dim=E, name=name)

    swapped = S.SwapAxis(ids, dim1=0, dim2=1)
    parts = S.SliceChannel(ids, num_outputs=2, axis=1)
    return {
        # a chain of shape ops, then the index argument
        "chain": (emb(S.expand_dims(S.slice_axis(
            S.Reshape(ids, shape=(-1,)), axis=0, begin=0, end=4),
            axis=0), "e"), {"ids"}),
        # the shape op's output also feeds FullyConnected: cast
        "shared_shape_op": (emb(swapped, "e") + S.FullyConnected(
            swapped, num_hidden=E, name="fc"), set()),
        # two paths, both to index arguments
        "two_paths": (emb(swapped, "e1") + emb(S.Flatten(ids), "e2"),
                      {"ids"}),
        # one of SliceChannel's outputs read as data: cast
        "slice_channel": (emb(parts[0], "e") + S.FullyConnected(
            parts[1], num_hidden=E, name="fc"), set()),
        # the shape op is an output of the symbol: cast
        "shape_op_is_output": (S.Group([emb(swapped, "e"), swapped]),
                               set()),
        # an index input of take through a slice; its data is cast
        "take": (S.take(x, S.slice(ids, begin=(0,), end=(2,))), {"ids"}),
        # lengths only under use_sequence_length
        "lengths": (S.SequenceLast(x, n, use_sequence_length=True), {"n"}),
        "lengths_through_reshape": (S.SequenceReverse(
            x, S.Reshape(n, shape=(-1,)), use_sequence_length=True), {"n"}),
        "no_lengths": (S.SequenceMask(x), set()),
        # the data argument of a sequence op is no index
        "data_of_sequence_op": (S.SequenceMask(emb(ids, "e"), n,
                                               use_sequence_length=True),
                                {"ids", "n"}),
    }


@pytest.mark.parametrize("case", [
    "chain", "shared_shape_op", "two_paths", "slice_channel",
    "shape_op_is_output", "take", "lengths", "lengths_through_reshape",
    "no_lengths", "data_of_sequence_op"])
def test_index_inputs_follow_shape_ops(case):
    with TNameManager():
        sym, want = _graphs(tmx)[case]
    assert index_inputs(sym) == want
