"""Training the recurrent models of the PyTorch port (mxnet_tpu_torch
``models.lstm.get_symbol``, ``rnn.BucketSentenceIter``,
``mod.BucketingModule``, ``optimizer.RMSProp``) against the JAX
package's, on the CPU.

One SGD step of the fused char-LSTM (sequence 8, 16 hidden, 2 layers,
vocabulary 12) from the JAX package's initial parameters, carried over
through ``checkpoint/serialize.py``: outputs and updated parameters
within rtol 1e-4 on both routes. ``BucketSentenceIter`` hands out the
JAX iterator's batches, bucket keys and padding from one seed; two
epochs of ``BucketingModule.fit`` over three buckets end within rtol
1e-4 of the JAX ``BucketingModule``'s parameters, every bucket computing
from the master's parameter and gradient storage. RMSProp (both forms)
updates as the JAX optimizer does, and its fused apply equals its
classic update bit for bit.
"""
import json
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401
from mxnet_tpu.checkpoint import serialize as jser
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.checkpoint import serialize as tser
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6
CPU = tmx.cpu()


def _carry(params, tmp_path):
    """JAX parameters into the port through the checkpoint array files."""
    out = {}
    for i, (name, arr) in enumerate(sorted(params.items())):
        path = str(tmp_path / ("p%d.npy" % i))
        meta = jser.write_array(path, arr.asnumpy())
        out[name] = tmx.nd.array(tser.read_array(path, meta), ctx=CPU)
    return out


def _close(t, j, what):
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=what)


LSTM_KW = dict(seq_len=8, vocab_size=12, num_hidden=16, num_embed=8,
               num_layers=2)
B = 4


def _lstm_batch(pkg, ctx, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 12, (B, 8)).astype(np.float32)
    y = rs.randint(0, 12, (B, 8)).astype(np.float32)
    return pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                            [pkg.nd.array(y, ctx=ctx)])


@pytest.mark.parametrize("fused", [True, False])
def test_lstm_get_symbol_one_sgd_step_matches_jax(fused, tmp_path):
    with JNameManager():
        jsym = jmx.models.lstm.get_symbol(**LSTM_KW)
    with TNameManager():
        tsym = tmx.models.lstm.get_symbol(**LSTM_KW)
    assert json.loads(tsym.tojson())["nodes"] == \
        json.loads(jsym.tojson())["nodes"]
    shapes = dict(data_shapes=[("data", (B, 8))],
                  label_shapes=[("softmax_label", (B, 8))])
    jmx.random.seed(0)
    jmod = jmx.mod.Module(jsym, context=jmx.cpu(), _allow_fused=False)
    jmod.bind(**shapes)
    jmod.init_params(jmx.init.Xavier())
    args = _carry(jmod.get_params()[0], tmp_path)
    tmod = tmx.mod.Module(tsym, context=CPU, _allow_fused=fused)
    tmod.bind(**shapes)
    tmod.init_params(arg_params=args)
    sgd = {"learning_rate": 0.1, "momentum": 0.9, "clip_gradient": 5.0}
    for m in (jmod, tmod):
        m.init_optimizer(optimizer="sgd", optimizer_params=sgd)
    jmod.forward_backward(_lstm_batch(jmx, jmx.cpu(), 1))
    tmod.forward_backward(_lstm_batch(tmx, CPU, 1))
    _close(tmod.get_outputs()[0].asnumpy(), jmod.get_outputs()[0].asnumpy(),
           "softmax")
    jmod.update()
    tmod.update()
    assert type(tmod._exec_group).__name__ == (
        "MeshExecutorGroup" if fused else "DataParallelExecutorGroup")
    jp, tp = jmod.get_params()[0], tmod.get_params()[0]
    for k in jp:
        _close(tp[k].asnumpy(), jp[k].asnumpy(), k)
    assert not np.array_equal(tp["lstm_parameters"].asnumpy(),
                              args["lstm_parameters"].asnumpy())


# ---------------------------------------------------------------------------
# BucketSentenceIter and BucketingModule
# ---------------------------------------------------------------------------
V, BUCKETS = 20, [4, 7, 10]


def _sentences(n=90, seed=0):
    rs = np.random.RandomState(seed)
    return [list(rs.randint(1, V, rs.randint(2, 11))) for _ in range(n)]


def _iters(layout="NTC", batch=6):
    its = []
    for pkg in (jmx, tmx):
        random.seed(3)
        np.random.seed(3)
        its.append(pkg.rnn.BucketSentenceIter(_sentences(), batch,
                                              buckets=BUCKETS,
                                              invalid_label=0,
                                              layout=layout))
    return its


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_bucket_sentence_iter_matches_jax(layout):
    jit, tit = _iters(layout)
    assert tit.default_bucket_key == jit.default_bucket_key == 10
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    for epoch in range(2):
        random.seed(10 + epoch)
        np.random.seed(10 + epoch)
        jit.reset()
        random.seed(10 + epoch)
        np.random.seed(10 + epoch)
        tit.reset()
        jb, tb = list(jit), list(tit)
        assert len(jb) == len(tb) > 0
        for j, t in zip(jb, tb):
            assert t.bucket_key == j.bucket_key and t.pad == j.pad == 0
            np.testing.assert_array_equal(t.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())
            assert t.data[0].context == CPU
            assert [tuple(d) for d in t.provide_data] == \
                [tuple(d) for d in j.provide_data]
        assert {b.bucket_key for b in tb} == set(BUCKETS)


def test_encode_sentences_matches_jax():
    sents = [["a", "b", "c"], ["c", "d"], ["a"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 0}):
        t = tmx.rnn.encode_sentences(sents, **kw)
        j = jmx.rnn.encode_sentences(sents, **kw)
        assert t == j
    with pytest.raises(ValueError):
        tmx.rnn.encode_sentences([["z"]], vocab={"a": 1})


def _sym_gen(pkg, names):
    def sym_gen(seq_len):
        with names():
            cell = pkg.rnn.FusedRNNCell(12, num_layers=1, mode="lstm",
                                        prefix="lstm_")
            data = pkg.sym.Variable("data")
            embed = pkg.sym.Embedding(data, input_dim=V, output_dim=6,
                                      name="embed")
            out, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                                 merge_outputs=True)
            pred = pkg.sym.Reshape(out, shape=(-1, 12))
            pred = pkg.sym.FullyConnected(pred, num_hidden=V, name="pred")
            label = pkg.sym.Reshape(pkg.sym.Variable("softmax_label"),
                                    shape=(-1,))
            pred = pkg.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def test_bucketing_module_fit_matches_jax(tmp_path):
    jit, tit = _iters()
    jmx.random.seed(0)
    jinit = jmx.mod.Module(_sym_gen(jmx, JNameManager)(10)[0],
                           context=jmx.cpu(), _allow_fused=False)
    jinit.bind(jit.provide_data, jit.provide_label)
    jinit.init_params(jmx.init.Xavier())
    jargs = {k: v.copy() for k, v in jinit.get_params()[0].items()}
    targs = _carry(jargs, tmp_path)
    mods = {}
    for pkg, names, it, args, ctx in (
            (jmx, JNameManager, jit, jargs, jmx.cpu()),
            (tmx, TNameManager, tit, targs, CPU)):
        mod = pkg.mod.BucketingModule(_sym_gen(pkg, names),
                                      default_bucket_key=10, context=ctx)
        random.seed(5)
        np.random.seed(5)
        mod.fit(it, num_epoch=2, arg_params=args,
                eval_metric=pkg.metric.Perplexity(ignore_label=0),
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "clip_gradient": 5.0})
        mods[pkg] = mod
    jp, tp = mods[jmx].get_params()[0], mods[tmx].get_params()[0]
    assert sorted(jp) == sorted(tp)
    for k in jp:
        _close(tp[k].asnumpy(), jp[k].asnumpy(), k)
        assert not np.array_equal(tp[k].asnumpy(), targs[k].asnumpy()) \
            or "begin_state" in k
    # every bucket bound, on the master's storage
    tmod = mods[tmx]
    assert sorted(tmod.buckets) == BUCKETS
    master = tmod.buckets[10]._exec_group.execs[0]
    for key, mod in tmod.buckets.items():
        grp = mod._exec_group
        assert type(grp).__name__ == "DataParallelExecutorGroup"
        ex = grp.execs[0]
        for name in ("lstm_parameters", "embed_weight", "pred_weight"):
            assert ex.arg_dict[name]._read().data_ptr() == \
                master.arg_dict[name]._read().data_ptr(), (key, name)
            assert ex.grad_dict[name]._read().data_ptr() == \
                master.grad_dict[name]._read().data_ptr(), (key, name)
        assert mod._updater is tmod.buckets[10]._updater


def test_shared_module_training_bind_rules():
    """A training bind shares on the classic route only; the fused route
    keeps its refusal."""
    sym, _, _ = _sym_gen(tmx, TNameManager)(4)
    shapes = dict(data_shapes=[("data", (3, 4))],
                  label_shapes=[("softmax_label", (3, 4))])
    master = tmx.mod.Module(sym, context=CPU, _allow_fused=False)
    master.bind(**shapes)
    master.init_params(tmx.init.Xavier())
    master.init_optimizer(optimizer="sgd")
    fused = tmx.mod.Module(sym, context=CPU)
    fused_master = tmx.mod.Module(sym, context=CPU)
    fused_master.bind(**shapes)
    fused_master.init_params(tmx.init.Xavier())
    with pytest.raises(tmx.MXNetError, match="classic route only"):
        fused.bind(shared_module=fused_master, **shapes)
    other = tmx.mod.Module(sym, context=CPU, _allow_fused=False)
    other.bind(shared_module=master, **shapes)
    assert other.optimizer_initialized and other._updater is master._updater


# ---------------------------------------------------------------------------
# RMSProp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("centered", [False, True])
def test_rmsprop_matches_jax_and_its_fused_apply(centered):
    rs = np.random.RandomState(0)
    w0 = rs.randn(5, 4).astype(np.float32)
    grads = [rs.randn(5, 4).astype(np.float32) for _ in range(3)]
    kw = dict(learning_rate=0.05, gamma1=0.8, gamma2=0.7, centered=centered,
              wd=0.01, rescale_grad=0.5, clip_gradient=1.0,
              clip_weights=2.0)
    results = []
    for pkg, ctx in ((jmx, jmx.cpu()), (tmx, CPU)):
        opt = pkg.optimizer.create("rmsprop", **kw)
        upd = pkg.optimizer.get_updater(opt)
        w = pkg.nd.array(w0, ctx=ctx)
        for g in grads:
            upd(0, pkg.nd.array(g, ctx=ctx), w)
        results.append(w.asnumpy())
    _close(results[1], results[0], "rmsprop")
    # the fused apply (the fused route's step) against the classic update
    opt = tmx.optimizer.create("rmsprop", **kw)
    upd = tmx.optimizer.get_updater(opt)
    assert upd.fused_apply_or_none() is not None
    p = torch.tensor(w0)
    state = tuple(torch.zeros_like(p) for _ in range(3 if centered else 1))
    for g in grads:
        p, state = opt._fused_apply(torch, p, torch.tensor(g), state, 0.05,
                                    0.01)
    assert np.array_equal(p.numpy(), results[1])
