"""The fused ``RNN`` op under the bfloat16 precision modes in the PyTorch
port (mxnet_tpu_torch ``ops/rnn_op.py`` through ``Module(precision=)``),
against the JAX package on the CPU.

The net: Embedding -> a 2-layer ``FusedRNNCell`` (LSTM, and GRU) of 24
hidden -> FullyConnected -> SoftmaxOutput, one SGD step from the same
numpy-seeded parameters and batch in both packages, under ``bf16`` and
``combined`` (and ``f32``). The port's float32 masters and gradients
stay float32; under ``bf16`` the op runs on the bfloat16 views the group
casts (``combined`` computes in float32 and keeps its optimizer state in
bfloat16, so its outputs equal f32's in both packages). Held:

* the port's bf16 outputs and updated parameters no further (relative
  L2) from the port's own f32 run than twice the JAX package's
  bf16-vs-f32 distance on the same inputs, a bound that does not depend
  on how each framework rounds (as ``test_torch_precision.py``);
* the port's bf16 outputs within relative L2 2e-2 of the JAX package's
  bf16 outputs: both round to bfloat16's 8 significant bits, but in
  other places (cuDNN's and PyTorch's RNN keep the gate arithmetic of a
  step in float32 and round its results; the JAX scan rounds every
  product), and that differs by a few bf16 ulps a value;
* the updated parameters float32, the outputs float32, everything
  finite.

Token ids stay float32 under the compute dtype (bfloat16 holds every
integer only up to 256): at the PTB vocabulary of 10,000 the port's bf16
Embedding returns exactly the bfloat16 rounding of the rows that the JAX
package's float32 lookup returns.

The op itself: at bfloat16 inputs ``RNN``'s output is bfloat16 and
within relative L2 2e-2 of ``rnn_plain`` at the same inputs (the plain
loop rounds every step in bfloat16), for every mode.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import registry as treg
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.ops import rnn_op
from mxnet_tpu_torch.precision.policy import index_inputs

torch.set_num_threads(2)

V, E, H, T, N = 32, 16, 24, 8, 4
JAX_REL_L2 = 2e-2
OP_REL_L2 = 2e-2
V_BIG = 10000     # the PTB vocabulary: bfloat16 keeps only multiples of 64


def _net(mx, names, mode, vocab=V):
    with names():
        data = mx.sym.Variable("data")
        emb = mx.sym.Embedding(data, input_dim=vocab, output_dim=E,
                               name="embed")
        cell = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                   prefix="rnn_")
        out, _ = cell.unroll(T, inputs=emb, layout="NTC",
                             merge_outputs=True)
        pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, H)),
                                     num_hidden=vocab, name="pred")
        label = mx.sym.Reshape(mx.sym.Variable("softmax_label"),
                               shape=(-1,))
        return mx.sym.SoftmaxOutput(pred, label, name="softmax")


def _step(mx, names, mode, precision, vocab=V):
    """One SGD step: (training outputs, updated parameters by name)."""
    net = _net(mx, names, mode, vocab)
    ctx = mx.cpu()
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(N, T), softmax_label=(N, T))[0]))
    rs = np.random.RandomState(0)
    params = {n: (rs.randn(*s) * 0.1).astype(np.float32)
              for n, s in sorted(shapes.items())
              if n not in ("data", "softmax_label")}
    x = rs.randint(0, vocab, (N, T)).astype(np.float32)
    y = rs.randint(0, vocab, (N, T)).astype(np.float32)
    mod = mx.mod.Module(net, context=ctx, precision=precision)
    mod.bind(data_shapes=[("data", (N, T))],
             label_shapes=[("softmax_label", (N, T))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in params.items()},
                    allow_missing=True)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                [mx.nd.array(y, ctx=ctx)]), is_train=True)
    mod.backward()
    mod.update()
    out = mod.get_outputs()[0].asnumpy()
    args = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return out, args


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(params):
    return np.concatenate([params[k].ravel() for k in sorted(params)])


@pytest.mark.parametrize("precision", ["bf16", "combined"])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_bf16_step_against_jax_and_f32(mode, precision):
    t_out, t_par = _step(tmx, TNameManager, mode, precision)
    t_out32, t_par32 = _step(tmx, TNameManager, mode, "f32")
    j_out, j_par = _step(jmx, JNameManager, mode, precision)
    j_out32, j_par32 = _step(jmx, JNameManager, mode, "f32")
    assert t_out.dtype == np.float32 and t_out.shape == (N * T, V)
    assert all(v.dtype == np.float32 for v in t_par.values())
    assert np.isfinite(t_out).all() and np.isfinite(_flat(t_par)).all()
    assert sorted(t_par) == sorted(j_par)
    # the bf16 step moved away from f32 no more than the JAX package's did
    j_dist = _rel(j_out, j_out32)
    assert _rel(t_out, t_out32) <= 2 * j_dist, (_rel(t_out, t_out32),
                                                j_dist)
    # bf16 computes in bfloat16; combined keeps float32 compute
    assert (_rel(t_out, t_out32) > 0) == (precision == "bf16")
    jp_dist = _rel(_flat(j_par), _flat(j_par32))
    assert _rel(_flat(t_par), _flat(t_par32)) <= 2 * jp_dist
    assert _rel(t_out, j_out) <= JAX_REL_L2
    # the f32 runs agree as the f32 RNN tests hold them
    np.testing.assert_allclose(t_out32, j_out32, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_op_at_bfloat16_matches_the_plain_loop(mode):
    attrs = {"state_size": 6, "num_layers": 2, "bidirectional": True,
             "mode": mode, "state_outputs": True, "p": 0.0}
    rs = np.random.RandomState(1)
    size = rnn_op.rnn_param_size(2, 4, 6, True, mode)
    ins = [rs.randn(5, 3, 4), rs.randn(size) * 0.4, rs.randn(4, 3, 6)]
    if mode == "lstm":
        ins.append(rs.randn(4, 3, 6))
    ins = [torch.tensor(v, dtype=torch.float32).to(torch.bfloat16)
           for v in ins]
    octx = treg.OpContext()
    got = treg.get_op("RNN").fcompute(attrs, ins, octx)
    want = rnn_op.rnn_plain(attrs, ins, octx)
    assert [g.dtype for g in got] == [torch.bfloat16] * len(got)
    for g, w in zip(got, want):
        assert _rel(g.float().numpy(), w.float().numpy()) <= OP_REL_L2


def _lookup(mx, names, weight, ids, precision=None):
    """An Embedding's eval output through ``Module`` at ``precision``."""
    with names():
        net = mx.sym.Embedding(mx.sym.Variable("data"), input_dim=V_BIG,
                               output_dim=E, name="embed")
    ctx = mx.cpu()
    kw = {} if precision is None else {"precision": precision}
    mod = mx.mod.Module(net, label_names=None, context=ctx, **kw)
    mod.bind(data_shapes=[("data", ids.shape)], for_training=False)
    mod.init_params(arg_params={"embed_weight": mx.nd.array(weight,
                                                            ctx=ctx)})
    mod.forward(mx.io.DataBatch([mx.nd.array(ids, ctx=ctx)], None),
                is_train=False)
    return mod.get_outputs()[0].asnumpy()


@pytest.mark.parametrize("precision", ["bf16", "combined"])
def test_embedding_reads_ids_above_256_exactly(precision):
    rs = np.random.RandomState(2)
    weight = rs.randn(V_BIG, E).astype(np.float32)
    ids = rs.randint(0, V_BIG, (N, T)).astype(np.float32)
    ids[0, :3] = [257, 8221, V_BIG - 1]   # bf16: 256, 8192, 10,000
    want = _lookup(jmx, JNameManager, weight, ids)
    got = _lookup(tmx, TNameManager, weight, ids, precision)
    if precision == "bf16":
        want = torch.tensor(want).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_index_inputs_are_the_inputs_read_only_as_indices():
    with TNameManager():
        ids, x = tmx.sym.Variable("ids"), tmx.sym.Variable("x")
        emb = tmx.sym.Embedding(ids, input_dim=V, output_dim=E)
        both = tmx.sym.Embedding(x, input_dim=V, output_dim=E) + x
        pick = tmx.sym.pick(emb, tmx.sym.Variable("idx"), axis=-1)
    assert index_inputs(emb) == {"ids"}
    assert index_inputs(both) == set()
    assert index_inputs(pick) == {"ids", "idx"}
    assert index_inputs(_net(tmx, TNameManager, "lstm")) == {"data"}
