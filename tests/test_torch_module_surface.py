"""The port's Module surface (mxnet_tpu_torch) against the JAX package, on
the CPU, on the same numpy inputs and carried weights.

A batch of a new shape re-binds through ``Module.reshape`` on one
parameter storage and gives the JAX package's outputs; the names the
port adds to ``Module``, ``NDArray``, ``Symbol`` and ``NDArrayIter`` agree
with the JAX package's; ``Monitor`` stats agree within rtol 1e-5;
optimizer states round trip with their update clock; ``mx.random.seed``
seeds the shuffle of ``NDArrayIter`` as in the JAX package; and
``MNISTIter`` reads idx files, plain and gzipped.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
BOUND = (4, 2, 8, 8)
OPT = {"learning_rate": 0.1, "momentum": 0.9}


def _net(pkg, names, bn=True):
    """conv (+BatchNorm) + ReLU + global pool + FC(3) + softmax: any
    spatial size binds."""
    with names():
        x = pkg.sym.Variable("data")
        x = pkg.sym.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1),
                                name="conv")
        if bn:
            x = pkg.sym.BatchNorm(x, fix_gamma=False, name="bn")
        x = pkg.sym.Activation(x, act_type="relu", name="relu")
        x = pkg.sym.Pooling(x, kernel=(1, 1), global_pool=True,
                            pool_type="avg", name="pool")
        x = pkg.sym.FullyConnected(pkg.sym.Flatten(x), num_hidden=3,
                                   name="fc")
        return pkg.sym.SoftmaxOutput(x, name="softmax")


def _pair(bn=True, jax_kwargs=None, **bind):
    """The same net bound at BOUND in both packages, the port carrying
    the JAX package's initial parameters; both with SGD + momentum."""
    jmx.random.seed(1)
    jm = jmx.mod.Module(_net(jmx, JNameManager, bn), context=jmx.cpu(),
                        **(jax_kwargs or {}))
    jm.bind([("data", BOUND)], [("softmax_label", (BOUND[0],))], **bind)
    jm.init_params(jmx.init.Xavier())
    jm.init_optimizer(optimizer_params=OPT)
    args, aux = [{k: v.asnumpy() for k, v in d.items()}
                 for d in jm.get_params()]
    tm = tmx.mod.Module(_net(tmx, TNameManager, bn), context=tmx.cpu())
    tm.bind([("data", BOUND)], [("softmax_label", (BOUND[0],))], **bind)
    tm.init_params(arg_params={k: _t(v) for k, v in args.items()},
                   aux_params={k: _t(v) for k, v in aux.items()})
    tm.init_optimizer(optimizer_params=OPT)
    return jm, tm


def _t(v):
    return tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype)


def _batch(pkg, x, y=None):
    ctx = pkg.cpu()
    return pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                            None if y is None else [pkg.nd.array(y, ctx=ctx)])


def _storage(mod):
    grp = mod._exec_group
    return [a[0]._read().data_ptr() for a in grp.param_arrays + grp.aux_arrays]


# ---------------------------------------------------------------------------
# ROADMAP C1: a batch of a new shape
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["train_2_rows", "eval_2x6x6",
                                  "eval_4x6x6"])
def test_new_batch_shape_matches_jax(case):
    jm, tm = _pair()
    ptrs = _storage(tm)
    rs = np.random.RandomState(3)
    if case == "train_2_rows":
        x = rs.randn(2, 2, 8, 8).astype(np.float32)
        y = np.array([0, 2], np.float32)
        for pkg, m in ((jmx, jm), (tmx, tm)):
            m.forward_backward(_batch(pkg, x, y))
            m.update()
        want_shape = (2, 3)
    else:
        shape = (2, 2, 6, 6) if case == "eval_2x6x6" else (4, 2, 6, 6)
        x = rs.randn(*shape).astype(np.float32)
        for pkg, m in ((jmx, jm), (tmx, tm)):
            m.forward(_batch(pkg, x), is_train=False)
        want_shape = (shape[0], 3)
    jo, to = jm.get_outputs()[0].asnumpy(), tm.get_outputs()[0].asnumpy()
    assert jo.shape == to.shape == want_shape
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    ja, jx = jm.get_params()
    ta, tx = tm.get_params()
    for k in ja:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert _storage(tm) == ptrs
    assert tm.data_shapes == [("data", x.shape)]
    assert tm._eval_pad_extra == 0


def test_reshape_keeps_one_parameter_storage():
    _, tm = _pair()
    ptrs = _storage(tm)
    grads = [g[0]._read().data_ptr() for g in tm._exec_group.grad_arrays]
    tm.reshape([("data", (2, 2, 5, 5))], [("softmax_label", (2,))])
    assert tm.data_shapes == [("data", (2, 2, 5, 5))]
    assert tm.label_shapes == [("softmax_label", (2,))]
    assert tm.output_shapes == [("softmax_output", (2, 3))]
    assert _storage(tm) == ptrs
    assert [g[0]._read().data_ptr()
            for g in tm._exec_group.grad_arrays] == grads
    # one set_params reaches the re-bound executor
    a, x = tm.get_params()
    a = {k: tmx.nd.array(v.asnumpy() + 1.0, ctx=tmx.cpu())
         for k, v in a.items()}
    tm.set_params(a, x)
    np.testing.assert_array_equal(
        tm._exec_group.execs[0].arg_dict["fc_bias"].asnumpy(),
        a["fc_bias"].asnumpy())
    # a short eval batch of the bound trailing shape still pads
    tm.reshape([("data", BOUND)], [("softmax_label", (BOUND[0],))])
    tm.forward(_batch(tmx, np.ones((3,) + BOUND[1:], np.float32)),
               is_train=False)
    assert tm._eval_pad_extra == 1 and tm.data_shapes == [("data", BOUND)]
    assert _storage(tm) == ptrs


# ---------------------------------------------------------------------------
# the names the port adds
# ---------------------------------------------------------------------------
def test_module_names_match_jax():
    jm, tm = _pair(inputs_need_grad=True,
                   jax_kwargs={"_allow_fused": False})
    for attr in ("data_names", "label_names", "output_names",
                 "data_shapes", "label_shapes"):
        assert [tuple(x) if isinstance(x, tuple) else x
                for x in getattr(tm, attr)] == \
            [tuple(x) if isinstance(x, tuple) else x
             for x in getattr(jm, attr)], attr
    rs = np.random.RandomState(5)
    x = rs.randn(*BOUND).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.float32)
    for pkg, m in ((jmx, jm), (tmx, tm)):
        m.forward_backward(_batch(pkg, x, y))
    assert tm.output_shapes == [tuple(s) for s in jm.output_shapes] == \
        [("softmax_output", (4, 3))]
    np.testing.assert_allclose(tm.get_input_grads()[0].asnumpy(),
                               jm.get_input_grads()[0].asnumpy(),
                               rtol=1e-4, atol=1e-6)
    # a second module over the same parameters trains with the first's
    # optimizer state
    other = tmx.mod.Module(_net(tmx, TNameManager), context=tmx.cpu())
    other.bind([("data", BOUND)], [("softmax_label", (4,))],
               for_training=False, shared_module=tm)
    other.borrow_optimizer(tm)
    assert other._updater is tm._updater
    serving_only = tmx.mod.Module(_net(tmx, TNameManager),
                                  context=tmx.cpu(), precision="int8_weight")
    with pytest.raises(ValueError, match="serving-only"):
        serving_only.bind([("data", BOUND)], [("softmax_label", (4,))])
    tmx.mod.Module(_net(tmx, TNameManager), context=tmx.cpu(),
                   precision=None)


def test_ndarray_and_symbol_names_match_jax():
    rs = np.random.RandomState(2)
    a = rs.randn(3, 4, 2).astype(np.float32)
    j = jmx.nd.array(a)
    t = tmx.nd.array(a, ctx=tmx.cpu())
    cases = [
        lambda m: m.sum(), lambda m: m.sum(axis=1),
        lambda m: m.mean(axis=(0, 2), keepdims=True), lambda m: m.max(),
        lambda m: m.min(axis=2), lambda m: m.argmax(axis=1),
        lambda m: m.transpose(axes=(2, 0, 1)), lambda m: m.T,
        lambda m: m.flatten(), lambda m: m.astype("int32"),
    ]
    for i, f in enumerate(cases):
        jv, tv = f(j).asnumpy(), f(t).asnumpy()
        assert jv.shape == tv.shape, i
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL,
                                   err_msg=str(i))
    assert tmx.nd.array([2.5], ctx=tmx.cpu()).asscalar() == \
        jmx.nd.array([2.5]).asscalar() == 2.5
    assert t.as_in_context(tmx.cpu()) is t
    assert t.astype("int32").dtype == np.int32
    with pytest.raises(ValueError):
        t.asscalar()
    syms = []
    for pkg, names in ((jmx, JNameManager), (tmx, TNameManager)):
        with names():
            d = pkg.sym.Variable("data", attr={"mood": "calm"})
            fc = pkg.sym.FullyConnected(d, num_hidden=3, name="fc")
            syms.append((d, fc))
    (jd, jfc), (td, tfc) = syms
    assert tfc.name == jfc.name == "fc" and td.name == jd.name == "data"
    assert td.attr("mood") == jd.attr("mood") == "calm"
    assert td.attr("none") is jd.attr("none") is None
    assert tfc.get_children().list_outputs() == \
        jfc.get_children().list_outputs()
    assert td.get_children() is None and jd.get_children() is None


def test_ndarrayiter_hard_reset_matches_jax():
    x = np.arange(10 * 2, dtype=np.float32).reshape(10, 2)
    rows = []
    for pkg in (jmx, tmx):
        it = pkg.io.NDArrayIter(x, np.arange(10, dtype=np.float32),
                                batch_size=4, last_batch_handle="roll_over")
        seen = [b.data[0].asnumpy() for b in it]
        it.hard_reset()
        first = next(iter(it)).data[0].asnumpy()
        rows.append((seen, first))
    (js, jf), (ts, tf) = rows
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jf, tf)
    np.testing.assert_array_equal(tf, x[:4])


def test_seed_gives_jax_shuffle_order():
    """mx.random.seed seeds numpy's generator, which
    NDArrayIter(shuffle=True) draws from, in both packages."""
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    orders = []
    for pkg in (jmx, tmx):
        np.random.seed(123)
        pkg.random.seed(7)
        it = pkg.io.NDArrayIter(x, np.arange(20, dtype=np.float32),
                                batch_size=5, shuffle=True)
        orders.append(np.concatenate([b.label[0].asnumpy() for b in it]))
    np.testing.assert_array_equal(orders[1], orders[0])
    assert not np.array_equal(orders[1], np.arange(20))


# ---------------------------------------------------------------------------
# Monitor and optimizer states
# ---------------------------------------------------------------------------
def test_monitor_stats_match_jax():
    jm, tm = _pair(bn=False)
    rs = np.random.RandomState(8)
    x = rs.randn(*BOUND).astype(np.float32)
    y = np.array([2, 0, 1, 1], np.float32)
    stats = []
    for pkg, m in ((jmx, jm), (tmx, tm)):
        mon = pkg.monitor.Monitor(2, pattern=".*")
        m.install_monitor(mon)
        rows = []
        for _ in range(3):
            mon.tic()
            m.forward_backward(_batch(pkg, x, y))
            m.update()
            rows.append(mon.toc())
        stats.append(rows)
    (jrows, trows) = stats
    assert [len(r) for r in trows] == [len(r) for r in jrows]
    assert not trows[1] and trows[0] and trows[2]
    for jr, tr in zip(jrows[::2], trows[::2]):
        jd = {name: float(v) for _, name, v in jr}
        td = {name: float(v) for _, name, v in tr}
        assert sorted(td) == sorted(jd)
        assert "conv_output" in td and "fc_weight" in td
        for k in jd:
            np.testing.assert_allclose(td[k], jd[k], rtol=RTOL, err_msg=k)


def test_optimizer_states_round_trip(tmp_path):
    _, tm = _pair()
    rs = np.random.RandomState(4)
    x = rs.randn(*BOUND).astype(np.float32)
    y = np.array([1, 0, 2, 1], np.float32)
    for _ in range(3):
        tm.forward_backward(_batch(tmx, x, y))
        tm.update()
    path = str(tmp_path / "m.states")
    tm.save_optimizer_states(path)
    _, other = _pair()
    other.load_optimizer_states(path)
    assert other._optimizer.num_update == tm._optimizer.num_update == 3
    assert other._optimizer._index_update_count == \
        tm._optimizer._index_update_count
    ta, tx = tm.get_params()
    other.set_params(ta, tx)
    for m in (tm, other):
        m.forward_backward(_batch(tmx, x, y))
        m.update()
    a, b = tm.get_params()[0], other.get_params()[0]
    for k in a:
        np.testing.assert_array_equal(a[k].asnumpy(), b[k].asnumpy(),
                                      err_msg=k)
    # the momentum went back onto the weight's device as an NDArray
    assert all(isinstance(s, tmx.nd.NDArray)
               for s in other._updater.states.values())


# ---------------------------------------------------------------------------
# MNISTIter
# ---------------------------------------------------------------------------
def _write_idx(path, arr, gz):
    header = struct.pack(">I", 0x0800 | arr.ndim) + \
        struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_mnistiter_reads_idx_files(tmp_path, gz):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (50, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 50).astype(np.uint8)
    suffix = ".gz" if gz else ""
    _write_idx(str(tmp_path / "img") + suffix, imgs, gz)
    _write_idx(str(tmp_path / "lbl") + suffix, labels, gz)
    got = []
    for pkg, flat in ((jmx, False), (tmx, False), (tmx, True)):
        it = pkg.io.MNISTIter(image=str(tmp_path / "img"),
                              label=str(tmp_path / "lbl"), batch_size=16,
                              flat=flat, seed=3)
        got.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                    for b in it])
    (jb, tb, fb) = got
    assert len(tb) == len(jb) == 3       # the last 2 rows are dropped
    assert tb[0][0].shape == (16, 1, 28, 28) and fb[0][0].shape == (16, 784)
    for (jx, jy), (tx, ty), (fx, _) in zip(jb, tb, fb):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(fx, tx.reshape(16, -1))
    perm = np.random.RandomState(3).permutation(50)
    np.testing.assert_array_equal(tb[0][1], labels[perm[:16]])
    with pytest.raises(MXNetError, match="not found"):
        tmx.io.MNISTIter(image=str(tmp_path / "missing"),
                         label=str(tmp_path / "lbl"))


def test_fit_taps_a_monitor_and_refuses_later_arguments(caplog):
    """fit(monitor=) taps every ``interval``-th batch and logs it (the
    fused module moves to the classic route for the taps); guardian is
    refused unless None (batch_group is held in test_torch_grouped.py,
    prefetch_to_device in test_torch_data_pipeline.py)."""
    rs = np.random.RandomState(6)
    x = rs.randn(16, *BOUND[1:]).astype(np.float32)
    y = rs.randint(0, 3, 16).astype(np.float32)
    mod = tmx.mod.Module(_net(tmx, TNameManager), context=tmx.cpu())
    mon = tmx.monitor.Monitor(3, pattern="fc_.*")
    with caplog.at_level("INFO"):
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                monitor=mon, optimizer_params=OPT)
    tapped = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("Batch:")]
    # batches 1 and 4 of 4: fc_output and fc_weight/fc_bias each time
    assert mon.step == 4 and len(tapped) == 2 * 3
    assert any("fc_output" in m for m in tapped)
    for kwarg in ({"guardian": "dir"},):
        with pytest.raises(MXNetError, match="slice"):
            tmx.mod.Module(_net(tmx, TNameManager), context=tmx.cpu()).fit(
                tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                **kwarg)
