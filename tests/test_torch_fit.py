"""``Module.fit`` in the PyTorch port (mxnet_tpu_torch) vs the JAX package,
on the CPU.

Both packages fit the same data from the same initial parameters (the JAX
package's, carried into the port with ``convert.py``): 2 epochs of SGD
with momentum under a ``FactorScheduler``, through the JAX package's
classic per-executor route, which the port's executor group mirrors. The
final parameters, the per-epoch training metrics and ``score`` agree
within rtol 1e-4: the two frameworks reduce in different orders, so
float32 results drift by a few ulps per step. Also held against the JAX
package: ``NDArrayIter`` batches under pad/discard/shuffle, ``predict``
with a padded last batch, and checkpoint files read across packages.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6
BATCH, NBATCH = 16, 4
SHAPES = {"mlp": (3, 8, 8), "lenet": (1, 28, 28)}


def _symbol(pkg, names, net):
    with names():
        return pkg.models.get_symbol(net, num_classes=10)


def _data(rs, n, shape):
    x = rs.randn(n, *shape).astype(np.float32)
    y = rs.randint(0, 10, (n,)).astype(np.float32)
    return x, y


def _jax_params(jsym, shape, seed):
    """The JAX package's Xavier initial parameters, as numpy arrays."""
    jmx.random.seed(seed)
    mod = jmx.mod.Module(jsym, context=jmx.cpu(), _allow_fused=False)
    mod.bind(data_shapes=[("data", (BATCH,) + shape)],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(jmx.init.Xavier(magnitude=2.0))
    args, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _fit(pkg, sym, ctx, args, aux, train, val, shuffle, epochs=2):
    """Fit from the given parameters; returns (final params, per-epoch
    training metrics, score, lr after the fit)."""
    if shuffle:
        np.random.seed(0)
    train_it = pkg.io.NDArrayIter(train[0], train[1], batch_size=BATCH,
                                  shuffle=shuffle)
    val_it = pkg.io.NDArrayIter(val[0], val[1], batch_size=BATCH)
    if pkg is jmx:
        mod = pkg.mod.Module(sym, context=ctx, _allow_fused=False)
        arg_params = {k: pkg.nd.array(v) for k, v in args.items()}
        aux_params = {k: pkg.nd.array(v) for k, v in aux.items()}
    else:
        mod = pkg.mod.Module(sym, context=ctx)
        arg_params, aux_params = pkg.convert.params_from_numpy(args, aux, ctx)
    metric = pkg.metric.create(["acc", "ce"])
    per_epoch = []
    sched = pkg.lr_scheduler.FactorScheduler(step=3, factor=0.5)
    mod.fit(train_it, eval_data=val_it, eval_metric=metric,
            epoch_end_callback=lambda *a: per_epoch.append(
                [v for _, v in metric.get_name_value()]),
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4, "lr_scheduler": sched},
            arg_params=arg_params, aux_params=aux_params, num_epoch=epochs)
    score = [v for _, v in mod.score(val_it, ["acc", "ce"])]
    a, x = mod.get_params()
    params = {k: v.asnumpy() for k, v in list(a.items()) + list(x.items())}
    return params, np.array(per_epoch), np.array(score), \
        mod._optimizer._get_lr(0), mod


@pytest.mark.parametrize("net,shuffle", [("mlp", False), ("lenet", False),
                                         ("mlp", True)])
def test_fit_matches_jax(net, shuffle):
    shape = SHAPES[net]
    jsym = _symbol(jmx, JNameManager, net)
    tsym = _symbol(tmx, TNameManager, net)
    assert tsym.list_arguments() == jsym.list_arguments()
    rs = np.random.RandomState(7)
    args, aux = _jax_params(jsym, shape, seed=3)
    train = _data(rs, BATCH * NBATCH, shape)
    val = _data(rs, BATCH + 4, shape)     # a padded last batch in score

    jp, jm, js, jlr, _ = _fit(jmx, jsym, jmx.cpu(), args, aux, train, val,
                              shuffle)
    tp, tm, ts, tlr, tmod = _fit(tmx, tsym, tmx.cpu(), args, aux, train, val,
                                 shuffle)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert jm.shape == (2, 2)
    np.testing.assert_allclose(tm, jm, rtol=RTOL)
    np.testing.assert_allclose(ts, js, rtol=RTOL)
    # 8 updates at step 3: the lr halves after updates 3 and 6
    assert tlr == pytest.approx(jlr) == pytest.approx(0.025)
    assert tmod._optimizer.num_update == 2 * NBATCH


@pytest.mark.parametrize("handle,n,shuffle", [("pad", 37, False),
                                              ("discard", 37, False),
                                              ("pad", 37, True),
                                              ("roll_over", 37, False)])
def test_ndarray_iter_matches_jax(handle, n, shuffle):
    rs = np.random.RandomState(1)
    x, y = _data(rs, n, (2, 3))
    epochs = {}
    for pkg in (jmx, tmx):
        if shuffle:
            np.random.seed(0)
        it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=shuffle,
                                last_batch_handle=handle)
        assert [tuple(d) for d in it.provide_data] == \
            [("data", (BATCH, 2, 3))]
        assert [tuple(d) for d in it.provide_label] == \
            [("softmax_label", (BATCH,))]
        runs = []
        for _ in range(2):
            runs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                         for b in it])
            it.reset()
        epochs[pkg.__name__] = runs
    jruns, truns = epochs["mxnet_tpu"], epochs["mxnet_tpu_torch"]
    assert [len(r) for r in truns] == [len(r) for r in jruns]
    for jr, tr in zip(jruns, truns):
        for (jx, jy, jpad), (tx, ty, tpad) in zip(jr, tr):
            assert tpad == jpad
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)


def _trained_mlp(rs):
    shape = SHAPES["mlp"]
    tsym = _symbol(tmx, TNameManager, "mlp")
    x, y = _data(rs, 20, shape)
    mod = tmx.mod.Module(tsym, context=tmx.cpu())
    it = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
    tmx.random.seed(0)
    mod.fit(it, num_epoch=1, initializer=tmx.init.Xavier(),
            optimizer_params={"learning_rate": 0.05})
    return mod, x, y


def test_predict_drops_padded_rows_like_jax():
    rs = np.random.RandomState(4)
    tmod, x, y = _trained_mlp(rs)
    args, aux = tmod.get_params()
    jmod = jmx.mod.Module(_symbol(jmx, JNameManager, "mlp"),
                          context=jmx.cpu(), _allow_fused=False)
    jmod.bind(data_shapes=[("data", (BATCH,) + SHAPES["mlp"])],
              label_shapes=[("softmax_label", (BATCH,))], for_training=False)
    jmod.init_params(arg_params={k: jmx.nd.array(v.asnumpy())
                                 for k, v in args.items()},
                     aux_params={k: jmx.nd.array(v.asnumpy())
                                 for k, v in aux.items()})
    outs = {}
    for pkg, mod in ((jmx, jmod), (tmx, tmod)):
        it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
        merged = mod.predict(it)
        per_batch = mod.predict(it, merge_batches=False)
        assert merged.shape == (20, 10)
        assert [p[0].shape for p in per_batch] == [(16, 10), (4, 10)]
        outs[pkg.__name__] = merged.asnumpy()
    np.testing.assert_allclose(outs["mxnet_tpu_torch"], outs["mxnet_tpu"],
                               rtol=RTOL, atol=ATOL)


def test_checkpoints_load_in_both_directions(tmp_path):
    rs = np.random.RandomState(5)
    tmod, x, y = _trained_mlp(rs)
    args, aux = tmod.get_params()
    tprefix = str(tmp_path / "port")
    tmx.callback.do_checkpoint(tprefix)(0, tmod.symbol, args, aux)
    assert os.path.exists(tprefix + "-0001.params")
    jsym, jargs, jaux = jmx.model.load_checkpoint(tprefix, 1)
    assert jsym.list_arguments() == tmod.symbol.list_arguments()
    for k, v in args.items():
        assert np.array_equal(jargs[k].asnumpy(), v.asnumpy())

    jprefix = str(tmp_path / "jax")
    jmx.callback.do_checkpoint(jprefix)(1, jsym, jargs, jaux)
    loaded = tmx.mod.Module.load(jprefix, 2, context=tmx.cpu())
    it = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
    loaded.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                for_training=False)
    np.testing.assert_array_equal(loaded.predict(it).asnumpy(),
                                  tmod.predict(it).asnumpy())
    tmx.callback.module_checkpoint(loaded, tprefix + "2")(2)
    _, args3, _ = tmx.model.load_checkpoint(tprefix + "2", 3, ctx=tmx.cpu())
    for k, v in args.items():
        assert np.array_equal(args3[k].asnumpy(), v.asnumpy())


def test_lr_schedulers_match_jax():
    for make in (lambda p: p.lr_scheduler.FactorScheduler(step=2, factor=0.7,
                                                          stop_factor_lr=0.02),
                 lambda p: p.lr_scheduler.MultiFactorScheduler(
                     step=[3, 5, 9], factor=0.5)):
        js, ts = make(jmx), make(tmx)
        js.base_lr = ts.base_lr = 0.1
        for n in range(14):
            assert ts(n) == pytest.approx(js(n)), n


@pytest.mark.parametrize("name", ["acc", "ce", "loss", "top_k_accuracy"])
def test_metrics_match_jax(name):
    rs = np.random.RandomState(2)
    kwargs = {"top_k": 3} if name == "top_k_accuracy" else {}
    probs = rs.rand(12, 5).astype(np.float32)
    probs /= probs.sum(axis=1, keepdims=True)
    probs[3, :] = 0.2          # a tie: numpy's argmax takes the first
    labels = rs.randint(0, 5, (12,)).astype(np.float32)
    got = {}
    for pkg in (jmx, tmx):
        m = pkg.metric.create(name, **kwargs)
        ctx = pkg.cpu()
        for sl in (slice(0, 7), slice(7, 12)):
            m.update([pkg.nd.array(labels[sl], ctx=ctx)],
                     [pkg.nd.array(probs[sl], ctx=ctx)])
        got[pkg.__name__] = m.get()
    assert got["mxnet_tpu_torch"][0] == got["mxnet_tpu"][0]
    assert got["mxnet_tpu_torch"][1] == pytest.approx(got["mxnet_tpu"][1],
                                                      rel=1e-6)


def test_speedometer_and_batch_callbacks_fire():
    rs = np.random.RandomState(6)
    x, y = _data(rs, BATCH * NBATCH, SHAPES["mlp"])
    mod = tmx.mod.Module(_symbol(tmx, TNameManager, "mlp"),
                         context=tmx.cpu())
    seen = []
    it = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod.fit(it, num_epoch=2, initializer=tmx.init.Xavier(),
            batch_end_callback=[tmx.callback.Speedometer(BATCH, 2),
                                tmx.callback.log_train_metric(2),
                                lambda p: seen.append((p.epoch, p.nbatch))])
    assert seen == [(e, b) for e in range(2) for b in range(NBATCH)]
