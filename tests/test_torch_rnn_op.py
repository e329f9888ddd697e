"""The fused recurrent path of the PyTorch port (mxnet_tpu_torch
``ops/rnn_op.py``, ``rnn.FusedRNNCell`` and the other cells of this
slice, ``initializer.FusedRNN``) against the JAX package's, on the CPU.

The ``RNN`` op over lstm, gru, rnn_tanh and rnn_relu, uni- and
bidirectional, 1 and 2 layers, with and without ``state_outputs``
(T=5, N=3, I=4, H=6): the forward and the gradients of data, the flat
parameters, the state and the cell state equal the JAX op's under a
random head gradient within rtol 1e-4, atol 1e-5, and ``rnn_plain`` (a
loop over time) equals the op within the same tolerance. With dropout
the op repeats bit for bit from one key and drops the expected share.
The fused cell's graph equals the JAX cell's node for node in NTC and
TNC and computes the same values; ``unpack_weights`` slices the flat
vector as the JAX op does and ``pack_weights`` rejoins it bit for bit;
``unfuse()`` computes the fused cell's outputs; ``FusedRNN`` with a
``One`` inner init equals the JAX initializer bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import registry as jreg
from mxnet_tpu.name import NameManager as JNameManager
from mxnet_tpu.ops import rnn_op as jrnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import random as mxr
from mxnet_tpu_torch import registry as treg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.ops import rnn_op

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
T, N, I, H = 5, 3, 4, 6


def _inputs(mode, bi, layers, seed=0):
    d = 2 if bi else 1
    rs = np.random.RandomState(seed)
    size = rnn_op.rnn_param_size(layers, I, H, bi, mode)
    ins = [rs.randn(T, N, I).astype(np.float32),
           (rs.randn(size) * 0.4).astype(np.float32),
           rs.randn(layers * d, N, H).astype(np.float32)]
    if mode == "lstm":
        ins.append(rs.randn(layers * d, N, H).astype(np.float32))
    return ins


def _attrs(mode, bi, layers, state_outputs, p=0.0):
    return {"state_size": H, "num_layers": layers, "bidirectional": bi,
            "mode": mode, "state_outputs": state_outputs, "p": p}


def _torch_run(fn, attrs, ins, cots, key=None, is_train=False):
    ts = [torch.tensor(v, requires_grad=True) for v in ins]
    outs = fn(attrs, ts, treg.OpContext(is_train=is_train, key=key))
    grads = torch.autograd.grad(outs, ts, [torch.tensor(c) for c in cots])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


CASES = [(m, bi, layers, so) for m in ("lstm", "gru", "rnn_tanh",
                                       "rnn_relu")
         for bi in (False, True) for layers in (1, 2)
         for so in (False, True)]


@pytest.mark.parametrize("mode,bi,layers,state_outputs", CASES)
def test_rnn_op_matches_jax_and_rnn_plain(mode, bi, layers, state_outputs):
    attrs = _attrs(mode, bi, layers, state_outputs)
    ins = _inputs(mode, bi, layers)
    jop = jreg.get_op("RNN")
    jattrs = jreg.parse_attrs(jop, attrs)

    def f(*xs):
        return tuple(jop.fcompute(jattrs, list(xs), jreg.OpContext(False)))

    # the scan unrolled eagerly: a 5-step scan compiles slower than it
    # runs op by op
    with jax.disable_jit():
        jouts, vjp = jax.vjp(f, *[jnp.asarray(v) for v in ins])
        rs = np.random.RandomState(1)
        cots = [rs.randn(*o.shape).astype(np.float32) for o in jouts]
        jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    op = treg.get_op("RNN")
    assert [tuple(s) for s in op.infer_shape(
        attrs, [ins[0].shape] + [None] * (len(ins) - 1))[1]] == \
        [tuple(o.shape) for o in jouts]
    touts, tgrads = _torch_run(op.fcompute, attrs, ins, cots)
    pouts, pgrads = _torch_run(rnn_op.rnn_plain, attrs, ins, cots)
    assert len(touts) == len(jouts) == (
        1 if not state_outputs else 3 if mode == "lstm" else 2)
    for j, t, p in zip(jouts, touts, pouts):
        np.testing.assert_allclose(t, np.asarray(j), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(p, t, rtol=RTOL, atol=ATOL)
    for j, t, p in zip(jgrads, tgrads, pgrads):
        np.testing.assert_allclose(t, np.asarray(j), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(p, t, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,bi", [("lstm", False), ("gru", True)])
def test_rnn_dropout_repeats_from_one_key(mode, bi):
    """p > 0 in training: the same key gives the same output bit for bit,
    another key another; the masked share of the first layer's output is
    near p; the plain loop draws the same masks; eval drops nothing."""
    layers, p = 3, 0.4
    attrs = _attrs(mode, bi, layers, True, p)
    ins = [torch.tensor(v) for v in _inputs(mode, bi, layers, seed=2)]
    op = treg.get_op("RNN")
    run = lambda fn, key, train=True: fn(attrs, ins, treg.OpContext(  # noqa
        is_train=train, key=key))
    a, b, c = run(op.fcompute, 7), run(op.fcompute, 7), run(op.fcompute, 8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    plain = run(rnn_op.rnn_plain, 7)
    for x, y in zip(a, plain):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                   atol=ATOL)
    shape = (T, N, H * (2 if bi else 1))
    keep = mxr.key_uniform(mxr.fold_in(7, 0), shape, torch.device("cpu")) \
        < 1 - p
    dropped = 1.0 - float(keep.float().mean())
    assert abs(dropped - p) < 4 * (p * (1 - p) / keep.numel()) ** 0.5
    evald = run(op.fcompute, None, train=False)
    nodrop = treg.get_op("RNN").fcompute(dict(attrs, p=0.0), ins,
                                         treg.OpContext(is_train=True))
    for x, y in zip(evald, nodrop):
        assert torch.equal(x, y)
    with pytest.raises(MXNetError, match="needs a key"):
        run(op.fcompute, None)


def test_rnn_param_size_and_clip_attrs_match_jax():
    for mode in ("lstm", "gru", "rnn_tanh"):
        for bi in (False, True):
            assert rnn_op.rnn_param_size(3, 7, 5, bi, mode) == \
                jrnn.rnn_param_size(3, 7, 5, bi, mode)
    attrs = dict(_attrs("lstm", False, 1, False), lstm_state_clip_min=-0.1,
                 lstm_state_clip_max=0.1)
    ins = [torch.tensor(v) for v in _inputs("lstm", False, 1)]
    ref = treg.get_op("RNN").fcompute(_attrs("lstm", False, 1, False), ins,
                                      treg.OpContext())
    out = treg.get_op("RNN").fcompute(attrs, ins, treg.OpContext())
    assert torch.equal(out[0], ref[0])      # accepted and ignored


# ---------------------------------------------------------------------------
# FusedRNNCell and the cells of this slice
# ---------------------------------------------------------------------------
def _nodes(sym):
    return [(n["op"], n["name"], sorted(n.get("attrs", n.get("param", {}))
                                        .items()), n["inputs"])
            for n in json.loads(sym.tojson())["nodes"]]


def _fused(pkg, names, mode, bi, layout, layers=2, next_state=True):
    with names():
        cell = pkg.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                    bidirectional=bi,
                                    get_next_state=next_state,
                                    prefix="%s_" % mode)
        out, states = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                                  layout=layout, merge_outputs=True)
        return cell, pkg.sym.Group([out] + list(states))


def _forward(pkg, sym, arrays):
    ctx = pkg.cpu()
    ex = sym.bind(ctx, {k: pkg.nd.array(v, ctx=ctx)
                        for k, v in arrays.items()})
    return [o.asnumpy() for o in ex.forward(is_train=False)]


def _fused_arrays(sym, mode, bi, layout, layers=2, seed=3):
    d = 2 if bi else 1
    data = (N, T, I) if layout == "NTC" else (T, N, I)
    rs = np.random.RandomState(seed)
    arrays = {}
    for name in sym.list_arguments():
        if name == "data":
            arrays[name] = rs.randn(*data).astype(np.float32)
        elif name.endswith("parameters"):
            arrays[name] = (rs.randn(rnn_op.rnn_param_size(
                layers, I, H, bi, mode)) * 0.4).astype(np.float32)
        else:
            arrays[name] = rs.randn(layers * d, N, H).astype(np.float32)
    return arrays


@pytest.mark.parametrize("mode,bi,layout", [("lstm", False, "NTC"),
                                            ("lstm", True, "TNC"),
                                            ("gru", True, "NTC"),
                                            ("rnn_tanh", False, "TNC")])
def test_fused_cell_unroll_matches_jax(mode, bi, layout):
    _, tsym = _fused(tmx, TNameManager, mode, bi, layout)
    _, jsym = _fused(jmx, JNameManager, mode, bi, layout)
    assert _nodes(tsym) == _nodes(jsym)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    arrays = _fused_arrays(jsym, mode, bi, layout)
    for t, j in zip(_forward(tmx, tsym, arrays), _forward(jmx, jsym,
                                                           arrays)):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,bi", [("lstm", True), ("gru", False),
                                     ("rnn_relu", True)])
def test_fused_weights_unpack_pack_and_unfuse(mode, bi):
    """``unpack_weights`` gives per-gate copies equal to the JAX op's
    own slices of the flat vector; ``pack_weights`` rejoins them bit for
    bit; ``unfuse()``, given them, computes the fused cell's output (in
    both packages: the JAX unfused stack packs them with its own
    ``pack_weights``)."""
    layers = 2
    tcell, tsym = _fused(tmx, TNameManager, mode, bi, "NTC", layers,
                         next_state=False)
    arrays = _fused_arrays(tsym, mode, bi, "NTC", layers)
    for name in arrays:      # the unfused cells start from zero states
        if "begin_state" in name:
            arrays[name] = np.zeros_like(arrays[name])
    pname = "%s_parameters" % mode
    flat = arrays[pname]
    cpu = tmx.cpu()
    args = {pname: tmx.nd.array(flat, ctx=cpu)}
    unpacked = tcell.unpack_weights(args)
    d = 2 if bi else 1
    g = rnn_op._gates(mode)
    views = jrnn._split_params(jnp, jnp.asarray(flat), layers, I, H, d, g)
    gates = tcell._gate_names
    for layer in range(layers):
        for di, direction in enumerate("lr"[:d]):
            w, r, bw, br = [np.asarray(v) for v in views[layer * d + di]]
            for k, gate in enumerate(gates):
                pre = "%s_%s%d_" % (mode, direction, layer)
                rows = slice(k * H, (k + 1) * H)
                for group, mat, bias in (("i2h", w, bw), ("h2h", r, br)):
                    np.testing.assert_array_equal(
                        unpacked[pre + group + gate + "_weight"].asnumpy(),
                        mat[rows])
                    np.testing.assert_array_equal(
                        unpacked[pre + group + gate + "_bias"].asnumpy(),
                        bias[rows])
    packed = tcell.pack_weights(unpacked)
    assert np.array_equal(packed[pname].asnumpy(), flat)

    fused_out = _forward(tmx, tsym, arrays)[0]
    for pkg, names in ((tmx, TNameManager), (jmx, JNameManager)):
        with names():
            cell = pkg.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                        bidirectional=bi,
                                        prefix="%s_" % mode)
            stack = cell.unfuse()
            out, _ = stack.unroll(T, inputs=pkg.sym.Variable("data"),
                                  layout="NTC", merge_outputs=True)
        per_gate = {k: pkg.nd.array(v.asnumpy(), ctx=pkg.cpu())
                    for k, v in unpacked.items() if k != pname}
        weights = stack.pack_weights(per_gate)
        feed = {"data": arrays["data"]}
        feed.update({k: v.asnumpy() for k, v in weights.items()})
        for name in out.list_arguments():
            if "begin_state" in name:
                feed[name] = np.zeros((N, H), np.float32)
        np.testing.assert_allclose(_forward(pkg, out, feed)[0], fused_out,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,bi,layers", [("lstm", True, 2),
                                            ("gru", False, 3),
                                            ("rnn_tanh", True, 1)])
def test_fused_rnn_initializer_matches_jax(mode, bi, layers):
    size = rnn_op.rnn_param_size(layers, I, H, bi, mode)
    tarr = tmx.nd.zeros((size,), ctx=tmx.cpu())
    jarr = jmx.nd.zeros((size,), ctx=jmx.cpu())
    tmx.init.FusedRNN(tmx.init.One(), H, layers, mode, bi, 0.8)(
        "x_weight", tarr)
    jmx.init.FusedRNN(jmx.init.One(), H, layers, mode, bi, 0.8)(
        "x_weight", jarr)
    np.testing.assert_array_equal(tarr.asnumpy(), jarr.asnumpy())
    if mode == "lstm":
        assert (tarr.asnumpy() == 0.4).sum() == 2 * layers * 2 * H
    # the cell's variable carries it, with Xavier inside, as in JAX
    with TNameManager():
        cell = tmx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                    bidirectional=bi, prefix="f_")
    with JNameManager():
        jcell = jmx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                     bidirectional=bi, prefix="f_")
    tinit = json.loads(cell._parameter.attr("__init__"))
    jinit = json.loads(jcell._parameter.attr("__init__"))
    assert tinit == jinit
    arr = tmx.nd.zeros((size,), ctx=tmx.cpu())
    tmx.init.Uniform()(tmx.init.InitDesc(
        "f_parameters", {"__init__": cell._parameter.attr("__init__")}), arr)
    assert np.isfinite(arr.asnumpy()).all() and arr.asnumpy().std() > 0


def _modified(pkg, names, kind):
    with names():
        if kind == "bidirectional":
            cell = pkg.rnn.BidirectionalCell(
                pkg.rnn.LSTMCell(H, prefix="l_"),
                pkg.rnn.GRUCell(H, prefix="r_"))
        elif kind == "residual":
            cell = pkg.rnn.ResidualCell(pkg.rnn.RNNCell(I, prefix="rr_"))
        else:
            # (zoneout_outputs would select against the JAX package's
            # zeros((0, 0)) placeholder at the first step, which neither
            # package's shapes accept)
            cell = pkg.rnn.ZoneoutCell(pkg.rnn.LSTMCell(H, prefix="z_"),
                                       zoneout_states=0.2)
        out, _ = cell.unroll(3, inputs=pkg.sym.Variable("data"),
                             layout="NTC", merge_outputs=True)
        return out


@pytest.mark.parametrize("kind", ["bidirectional", "residual", "zoneout"])
def test_modifier_and_bidirectional_cells_match_jax(kind):
    """The graphs node for node, and the eval forward's values (zoneout
    keeps the new values in eval)."""
    tsym, jsym = _modified(tmx, TNameManager, kind), \
        _modified(jmx, JNameManager, kind)
    assert _nodes(tsym) == _nodes(jsym)
    rs = np.random.RandomState(4)
    shapes = dict(data=(N, 3, I))
    shapes.update({n: (N, I if kind == "residual" else H)
                   for n in jsym.list_arguments() if "begin_state" in n})
    arg_shapes, _, _ = jsym.infer_shape(**shapes)
    arrays = {n: (rs.randn(*s) * 0.5).astype(np.float32)
              for n, s in zip(jsym.list_arguments(), arg_shapes)}
    for t, j in zip(_forward(tmx, tsym, arrays), _forward(jmx, jsym,
                                                           arrays)):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_rnn_under_bf16_modes_is_refused():
    """No longer refused: the bfloat16 modes bind a net with the RNN op
    and train it (``tests/test_torch_rnn_bf16.py`` holds the values to
    the JAX package), and the op runs at bfloat16 inputs, returning
    bfloat16."""
    with TNameManager():
        sym = tmx.models.lstm.get_symbol(seq_len=4, vocab_size=7,
                                         num_hidden=8, num_embed=4)
    for precision in ("bf16", "bf16_opt", "combined"):
        mod = tmx.mod.Module(sym, context=tmx.cpu(), precision=precision)
        mod.bind(data_shapes=[("data", (2, 4))],
                 label_shapes=[("softmax_label", (2, 4))])
        mod.init_params(tmx.init.Xavier())
        mod.init_optimizer(optimizer="sgd")
        batch = tmx.io.DataBatch(
            [tmx.nd.array(np.arange(8).reshape(2, 4) % 7, ctx=tmx.cpu())],
            [tmx.nd.array(np.ones((2, 4)), ctx=tmx.cpu())])
        mod.forward_backward(batch)
        mod.update()
        out = mod.get_outputs()[0].asnumpy()
        assert out.dtype == np.float32 and np.isfinite(out).all()
    outs = treg.get_op("RNN").fcompute(
        _attrs("gru", False, 1, False),
        [torch.tensor(v).to(torch.bfloat16) for v in
         _inputs("gru", False, 1)], treg.OpContext())
    assert outs[0].dtype == torch.bfloat16
    assert torch.isfinite(outs[0].float()).all()