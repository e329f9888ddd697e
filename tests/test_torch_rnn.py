"""The port's RNN slice (``mxnet_tpu_torch.rnn``, the operators its cells
and ``examples/decode_lm.py`` emit, ``Symbol`` arithmetic,
``metric.Perplexity``, the ``LSTMBias`` initializer) against the JAX
package on the CPU, float32, with the same numpy inputs.

Each new operator's forward and gradient (head gradients from numpy)
matches the JAX op within rtol 1e-5, atol 1e-5 (the op table's tolerance
in ``test_torch_port.py``); shape codes and indices match exactly. The
cells' unrolled graphs have the JAX package's parameter names and, bound
through each package's executor on the same parameters, give the same
outputs and gradients (rtol 1e-5, atol 1e-5). Three ``fit`` steps of the
decode example's char-LSTM land on JAX's parameters (rtol 1e-5, atol
1e-6).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import registry as jreg
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import registry as treg
from mxnet_tpu_torch.examples import decode_lm as tdecode_lm
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.ops.matrix import infer_reshape_shape

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _run_jax(name, attrs, ins, cots):
    op = jreg.get_op(name)
    attrs = jreg.parse_attrs(op, attrs)

    def f(*xs):
        return tuple(op.fcompute(attrs, list(xs), jreg.OpContext()))

    outs, vjp = jax.vjp(f, *[jnp.asarray(v) for v in ins])
    grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cots, outs)))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _run_torch(name, attrs, ins, cots):
    op = treg.get_op(name)
    attrs = treg.parse_attrs(op, attrs)
    ts = [torch.tensor(v, requires_grad=True) for v in ins]
    outs = op.fcompute(attrs, ts, treg.OpContext())
    grads = torch.autograd.grad(list(outs), ts,
                                [torch.tensor(c) for c in cots],
                                allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, ts)]
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _case(name, rs):
    """(op, attrs, inputs) of one case."""
    if name == "embedding":
        idx = rs.randint(0, 7, (3, 5)).astype(np.float32)
        idx[0, :2] = 4.0                    # repeated rows add up
        return "Embedding", {"input_dim": 7, "output_dim": 6}, \
            [idx, _rand(rs, 7, 6)]
    if name == "slice_channel":
        return "SliceChannel", {"num_outputs": 4}, [_rand(rs, 3, 8, 2)]
    if name == "slice_channel_squeeze":
        return "SliceChannel", {"num_outputs": 5, "axis": 1,
                                "squeeze_axis": True}, [_rand(rs, 2, 5, 3)]
    if name == "slice_channel_axis0":
        return "split", {"num_outputs": 2, "axis": 0}, [_rand(rs, 4, 3)]
    if name == "concat":
        return "Concat", {"dim": 1, "num_args": 3}, \
            [_rand(rs, 2, 1, 3), _rand(rs, 2, 4, 3), _rand(rs, 2, 2, 3)]
    if name == "concat_dim0":
        return "concat", {"dim": 0, "num_args": 2}, \
            [_rand(rs, 2, 3), _rand(rs, 1, 3)]
    if name == "expand_dims":
        return "expand_dims", {"axis": 1}, [_rand(rs, 3, 4)]
    if name == "reshape":
        return "Reshape", {"shape": (-1, 0)}, [_rand(rs, 4, 3, 2)]
    if name == "reshape_codes":
        return "Reshape", {"shape": (0, -3, -2)}, [_rand(rs, 2, 3, 4, 5)]
    if name == "reshape_split":
        return "reshape", {"shape": (-4, 2, -1, 0)}, [_rand(rs, 6, 5)]
    if name == "swapaxis":
        return "SwapAxis", {"dim1": 0, "dim2": 2}, [_rand(rs, 2, 3, 4)]
    if name in ("_minus", "_mul", "_div", "elemwise_mul"):
        b = _rand(rs, 3, 4)
        if name == "_div":
            b = np.abs(b) + 0.5
        return name, {}, [_rand(rs, 3, 4), b]
    if name.endswith("_scalar"):
        a = _rand(rs, 3, 4)
        if name == "_rdiv_scalar":
            a = np.abs(a) + 0.5
        return name, {"scalar": 1.7}, [a]
    raise KeyError(name)


OP_CASES = ["embedding", "slice_channel", "slice_channel_squeeze",
            "slice_channel_axis0", "concat", "concat_dim0", "expand_dims",
            "reshape", "reshape_codes", "reshape_split", "swapaxis",
            "_minus", "_mul", "_div", "elemwise_mul", "_plus_scalar",
            "_minus_scalar", "_rminus_scalar", "_mul_scalar",
            "_div_scalar", "_rdiv_scalar"]


@pytest.mark.parametrize("case", OP_CASES)
def test_op_forward_and_gradient_match_jax(case):
    rs = np.random.RandomState(OP_CASES.index(case))
    name, attrs, ins = _case(case, rs)
    jop = jreg.get_op(name)
    jouts = jop.fcompute(jreg.parse_attrs(jop, attrs),
                         [jnp.asarray(v) for v in ins], jreg.OpContext())
    cots = [_rand(rs, *o.shape) for o in jouts]
    jo, jg = _run_jax(name, attrs, ins, cots)
    to, tg = _run_torch(name, attrs, ins, cots)
    assert len(to) == len(jo)
    for a, b in zip(to, jo):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for i, (a, b) in enumerate(zip(tg, jg)):
        if name == "Embedding" and i == 0:
            continue                      # indices carry no gradient
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    top = treg.get_op(name)
    assert top.num_outputs(treg.parse_attrs(top, attrs)) == \
        jop.num_outputs(jreg.parse_attrs(jop, attrs))


def test_embedding_gradient_adds_repeated_rows():
    w = torch.zeros(4, 2, requires_grad=True)
    out = treg.get_op("Embedding").fcompute(
        {"input_dim": 4, "output_dim": 2},
        [torch.tensor([1.0, 1.0, 3.0]), w], treg.OpContext())[0]
    out.backward(torch.ones(3, 2))
    assert w.grad.tolist() == [[0, 0], [2, 2], [0, 0], [1, 1]]


def test_reshape_reverse():
    """``reverse`` matches the special codes from the right (the
    reference's example: (10, 5, 4) with (-1, 0) is (40, 5) forward and
    (50, 4) reversed)."""
    assert infer_reshape_shape((-1, 0), (10, 5, 4)) == (40, 5)
    assert infer_reshape_shape((-1, 0), (10, 5, 4), reverse=True) == (50, 4)
    x = torch.arange(200.0).reshape(10, 5, 4)
    out = treg.get_op("Reshape").fcompute(
        {"shape": (-1, 0), "reverse": True}, [x], treg.OpContext())[0]
    assert out.shape == (50, 4) and torch.equal(out.reshape(-1),
                                                x.reshape(-1))


def test_zeros_op_and_symbol():
    """``_zeros`` creates on the graph's device; ``mx.sym.zeros`` infers
    its shape without inputs."""
    out = treg.get_op("_zeros").fcompute({"shape": (2, 3)}, [],
                                         treg.OpContext())[0]
    assert out.shape == (2, 3) and out.dtype == torch.float32
    assert not out.any()
    z = tmx.sym.zeros(shape=(2, 3), name="z")
    assert z.infer_shape()[1] == [(2, 3)]
    s = tmx.sym.Variable("a") + z
    ex = s.bind(tmx.cpu(), {"a": tmx.nd.array(np.ones((2, 3)),
                                              ctx=tmx.cpu())})
    assert (ex.forward()[0].asnumpy() == 1).all()


def _bind_eval(pkg, sym, arrays, cot):
    """Forward (train) and backward through a package's executor:
    (outputs, {argument: gradient})."""
    ctx = pkg.cpu()
    args = {k: pkg.nd.array(v, ctx=ctx) for k, v in arrays.items()}
    grads = {k: pkg.nd.zeros(v.shape, ctx=ctx) for k, v in arrays.items()}
    ex = sym.bind(ctx, args, args_grad=grads, grad_req="write")
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward([pkg.nd.array(c, ctx=ctx) for c in cot])
    return outs, {k: g.asnumpy() for k, g in grads.items()}


def _arith(pkg):
    a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
    return pkg.sym.Group([a * b + 2.0 - a / b, -a, 1.0 - b, 3 * a,
                          a / 2.0, 2.0 / b, (a - b) * (b + 1), b + a])


def test_symbol_arithmetic_matches_jax():
    rs = np.random.RandomState(0)
    arrays = {"a": _rand(rs, 3, 4), "b": np.abs(_rand(rs, 3, 4)) + 0.5}
    tsym, jsym = _arith(tmx), _arith(jmx)
    assert len(tsym.list_outputs()) == 8
    cot = [_rand(rs, 3, 4) for _ in range(8)]
    to, tg = _bind_eval(tmx, tsym, arrays, cot)
    jo, jg = _bind_eval(jmx, jsym, arrays, cot)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for k in arrays:
        np.testing.assert_allclose(tg[k], jg[k], rtol=RTOL, atol=ATOL)
    ops = [n.op.name for n in tsym._topo() if n.op is not None]
    assert sorted(set(ops)) == sorted(set(
        n.op.name for n in jsym._topo() if n.op is not None))
    with pytest.raises(TypeError):
        tmx.sym.Variable("a") * "x"


def _cell(pkg, kind):
    if kind == "lstm":
        return pkg.rnn.LSTMCell(num_hidden=5, prefix="lstm_")
    if kind == "gru":
        return pkg.rnn.GRUCell(num_hidden=5, prefix="gru_")
    if kind == "rnn":
        return pkg.rnn.RNNCell(num_hidden=5, prefix="rnn_")
    stack = pkg.rnn.SequentialRNNCell()
    stack.add(pkg.rnn.LSTMCell(num_hidden=5, prefix="l0_"))
    stack.add(pkg.rnn.GRUCell(num_hidden=4, prefix="l1_"))
    return stack


def _unrolled(pkg, names, kind, layout):
    with names():
        cell = _cell(pkg, kind)
        out, states = cell.unroll(4, inputs=pkg.sym.Variable("data"),
                                  layout=layout, merge_outputs=True)
        return pkg.sym.Group([out] + list(states))


@pytest.mark.parametrize("kind,layout", [("lstm", "NTC"), ("lstm", "TNC"),
                                         ("gru", "NTC"), ("gru", "TNC"),
                                         ("rnn", "NTC"), ("stack", "NTC")])
def test_cell_unroll_matches_jax(kind, layout):
    """The unrolled graph through each package's executor, on the same
    parameters and initial states: outputs, last states and every
    gradient."""
    tsym = _unrolled(tmx, TNameManager, kind, layout)
    jsym = _unrolled(jmx, JNameManager, kind, layout)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    N, T, C = 3, 4, 6
    data = (N, T, C) if layout == "NTC" else (T, N, C)
    arg_shapes, out_shapes, _ = jsym.infer_shape(
        data=data, **{n: (N, 5 if "l1_" not in n else 4)
                      for n in jsym.list_arguments() if "begin_state" in n})
    rs = np.random.RandomState(1)
    arrays = {n: _rand(rs, *s, scale=0.5)
              for n, s in zip(jsym.list_arguments(), arg_shapes)}
    t_shapes = tsym.infer_shape(**{k: v.shape for k, v in arrays.items()})
    assert t_shapes[1] == [tuple(s) for s in out_shapes]
    cot = [_rand(rs, *s) for s in out_shapes]
    to, tg = _bind_eval(tmx, tsym, arrays, cot)
    jo, jg = _bind_eval(jmx, jsym, arrays, cot)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for k in arrays:
        np.testing.assert_allclose(tg[k], jg[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_cell_variables_and_weight_packing():
    """begin_state variables carry lr_mult 0, the LSTM i2h bias its
    LSTMBias initializer (the JAX package's attrs, value for value);
    unpack/pack_weights split and rejoin the gates."""
    tcell = tmx.rnn.LSTMCell(num_hidden=3, prefix="c_")
    jcell = jmx.rnn.LSTMCell(num_hidden=3, prefix="c_")
    ts, js = tcell.begin_state(), jcell.begin_state()
    assert [s.name for s in ts] == [s.name for s in js]
    assert ts[0].attr("__lr_mult__") == js[0].attr("__lr_mult__")
    tout, _ = tcell(tmx.sym.Variable("x"), ts)
    jout, _ = jcell(jmx.sym.Variable("x"), js)
    assert tout.attr_dict()["c_i2h_bias"] == jout.attr_dict()["c_i2h_bias"]
    rs = np.random.RandomState(2)
    args = {"c_i2h_weight": tmx.nd.array(_rand(rs, 12, 2), ctx=tmx.cpu()),
            "c_i2h_bias": tmx.nd.array(_rand(rs, 12), ctx=tmx.cpu()),
            "c_h2h_weight": tmx.nd.array(_rand(rs, 12, 3), ctx=tmx.cpu()),
            "c_h2h_bias": tmx.nd.array(_rand(rs, 12), ctx=tmx.cpu())}
    unpacked = tcell.unpack_weights(args)
    assert sorted(unpacked) == sorted(
        "c_%s%s_%s" % (g, gate, w) for g in ("i2h", "h2h")
        for gate in ("_i", "_f", "_c", "_o") for w in ("weight", "bias"))
    packed = tcell.pack_weights(unpacked)
    for k, v in args.items():
        assert np.array_equal(packed[k].asnumpy(), v.asnumpy())


def test_lstm_bias_initializer_matches_jax():
    """The default initializer honours the variable's own ``__init__``
    (LSTMBias: the forget gate's quarter 1.0, the rest 0), as the JAX
    package's does."""
    attrs = {"__init__": tmx.init.LSTMBias(forget_bias=1.0).dumps()}
    tarr = tmx.nd.zeros((8,), ctx=tmx.cpu())
    tmx.init.Uniform(0.1)(tmx.init.InitDesc("x_i2h_bias", attrs), tarr)
    jarr = jmx.nd.zeros((8,))
    jmx.init.Uniform(0.1)(jmx.init.InitDesc("x_i2h_bias", attrs), jarr)
    assert np.array_equal(tarr.asnumpy(), jarr.asnumpy())
    assert tarr.asnumpy().tolist() == [0, 0, 1, 1, 0, 0, 0, 0]
    assert tmx.init.create(attrs["__init__"]).forget_bias == 1.0


@pytest.mark.parametrize("ignore_label", [None, 0])
def test_perplexity_matches_jax(ignore_label):
    rs = np.random.RandomState(3)
    tm = tmx.metric.Perplexity(ignore_label=ignore_label)
    jm = jmx.metric.Perplexity(ignore_label=ignore_label)
    for _ in range(3):
        probs = rs.rand(4, 5, 7).astype(np.float32)
        probs /= probs.sum(-1, keepdims=True)
        labels = rs.randint(0, 7, (4, 5)).astype(np.float32)
        tm.update([tmx.nd.array(labels, ctx=tmx.cpu())],
                  [tmx.nd.array(probs.reshape(20, 7), ctx=tmx.cpu())])
        jm.update([jmx.nd.array(labels)], [jmx.nd.array(probs.reshape(20,
                                                                      7))])
    assert tm.get()[0] == jm.get()[0] == "Perplexity"
    np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-12)
    assert tm.num_inst == jm.num_inst
    assert isinstance(tmx.metric.create("perplexity", ignore_label=None),
                      tmx.metric.Perplexity)


def _jax_decode_lm():
    """The JAX example script as a module (its main() is not run)."""
    path = os.path.join(ROOT, "example", "rnn", "decode_lm.py")
    spec = importlib.util.spec_from_file_location("_jax_decode_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decode_lm_fit_three_steps_match_jax():
    """The decode example's make_net (seq 8, hidden 16, batch 4) through
    three ``fit`` steps of SGD (momentum 0.9, clip_gradient 5) from the
    same parameters, in both packages: the parameters after the steps
    and the training perplexity agree."""
    seq, hidden, embed, batch, vocab = 8, 16, 8, 4, 9
    jnet = _jax_decode_lm().make_net(seq, vocab, hidden, embed, batch)
    tnet = tdecode_lm.make_net(seq, vocab, hidden, embed, batch)
    assert tnet.list_arguments() == jnet.list_arguments()
    rs = np.random.RandomState(4)
    arg_shapes, _, _ = jnet.infer_shape(data=(batch, seq),
                                        softmax_label=(batch, seq))
    args = {n: _rand(rs, *s, scale=0.3)
            for n, s in zip(jnet.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    X = rs.randint(0, vocab, (3 * batch, seq)).astype(np.float32)
    Y = rs.randint(0, vocab, (3 * batch, seq)).astype(np.float32)

    def fit(pkg, net):
        it = pkg.io.NDArrayIter(X, Y, batch_size=batch)
        if pkg is jmx:
            mod = pkg.mod.Module(net, context=pkg.cpu(), _allow_fused=False)
            arg_params = {k: pkg.nd.array(v) for k, v in args.items()}
        else:
            mod = pkg.mod.Module(net, context=pkg.cpu())
            arg_params, _ = pkg.convert.params_from_numpy(args, {},
                                                          pkg.cpu())
        metric = pkg.metric.Perplexity(ignore_label=None)
        mod.fit(it, num_epoch=1, eval_metric=metric,
                arg_params=arg_params,
                optimizer_params={"learning_rate": 0.5, "momentum": 0.9,
                                  "clip_gradient": 5.0})
        got, _ = mod.get_params()
        return {k: v.asnumpy() for k, v in got.items()}, metric.get()[1]

    tp, tppl = fit(tmx, tnet)
    jp, jppl = fit(jmx, jnet)
    assert sorted(tp) == sorted(jp) == sorted(args)
    for k in jp:
        assert not np.array_equal(jp[k], args[k]), k    # the steps moved
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(tppl, jppl, rtol=1e-5)
