"""``mx.kv`` of the PyTorch port (mxnet_tpu_torch) against the JAX
package's store, on the CPU.

The ``local``/``device`` cases of ``tests/test_kvstore.py``
(lines 25–110) run through both stores on the same values: push/pull of
one key and of key lists, the sum of per-device lists (``cpu(i)``
contexts) in fixed order, a custom updater, ``set_optimizer`` (SGD, and
SGD with momentum over 3 pushes), pull into a list, the kinds and
``get_num_dead_node``; the pulled values agree within rtol 1e-5,
atol 1e-6 (float32) and the sums exactly. The optimizer states
round-trip through the port's v2 payload. The ``dist_*`` kinds work in
a world of one (rank 0, one worker, a free barrier; ``dist_async`` one
push late); their multi-process cases are
``tests/test_torch_dist_multiprocess.py``'s. ``Module.fit`` with a ``KVStore``
instance (the update on the store, by push and pull) gives the same
parameters, bit for bit, as ``kvstore="local"`` (no store on one device,
the fused step), and ``SequentialModule`` stages train on it too.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkvs

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import kvstore as tkvs

torch.set_num_threads(2)

SHAPE = (4, 4)
KEYS = [5, 7, 11]
RTOL, ATOL = 1e-5, 1e-6
PKGS = ((jmx, jkvs), (tmx, tkvs))


def _init_kv(mx, kvs, kind="local"):
    kv = kvs.create(kind)
    kv.init(3, mx.nd.zeros(SHAPE, ctx=mx.cpu()))
    kv.init(KEYS, [mx.nd.zeros(SHAPE, ctx=mx.cpu())] * len(KEYS))
    return kv


def _vals(rng_seed, n):
    rng = np.random.RandomState(rng_seed)
    return [rng.rand(*SHAPE).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("kind", ["local", "device"])
def test_single_kv_pair(kind):
    out = []
    for mx, kvs in PKGS:
        kv = _init_kv(mx, kvs, kind)
        kv.push(3, mx.nd.ones(SHAPE, ctx=mx.cpu()))
        val = mx.nd.empty(SHAPE, ctx=mx.cpu())
        kv.pull(3, out=val)
        out.append(val.asnumpy())
    np.testing.assert_array_equal(out[1], out[0])
    assert (out[1] == 1).all()


def test_aggregator_multi_devs():
    """Per-device values are summed in list order, the same on every run
    and in both packages."""
    vals = _vals(0, 4)
    got = []
    for mx, kvs in PKGS:
        kv = _init_kv(mx, kvs)
        devs = [mx.cpu(i) for i in range(4)]
        kv.push(3, [mx.nd.array(v, ctx=d) for v, d in zip(vals, devs)])
        out = mx.nd.empty(SHAPE, ctx=mx.cpu())
        kv.pull(3, out=out)
        kv.push(KEYS, [[mx.nd.array(v * 2.0, ctx=d)
                        for v, d in zip(vals, devs)]] * len(KEYS))
        outs = [mx.nd.empty(SHAPE, ctx=mx.cpu()) for _ in KEYS]
        kv.pull(KEYS, out=outs)
        got.append([out.asnumpy()] + [o.asnumpy() for o in outs])
    want = ((vals[0] + vals[1]) + vals[2]) + vals[3]
    np.testing.assert_array_equal(got[1][0], want)
    for j, t in zip(got[0], got[1]):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    for o in got[1][1:]:
        np.testing.assert_array_equal(o, 2 * want)


def test_push_sum_repeats_bit_for_bit():
    vals = _vals(1, 4)
    runs = []
    for _ in range(2):
        kv = _init_kv(tmx, tkvs)
        kv.push(3, [tmx.nd.array(v, ctx=tmx.cpu(i))
                    for i, v in enumerate(vals)])
        out = tmx.nd.empty(SHAPE, ctx=tmx.cpu())
        kv.pull(3, out=out)
        runs.append(out.asnumpy())
    assert runs[0].tobytes() == runs[1].tobytes()


def test_updater():
    got = []
    for mx, kvs in PKGS:
        kv = _init_kv(mx, kvs)

        def updater(key, recv, local):
            local += recv

        kv._set_updater(updater)
        kv.push(3, mx.nd.ones(SHAPE, ctx=mx.cpu()))
        kv.push(3, mx.nd.ones(SHAPE, ctx=mx.cpu()))
        val = mx.nd.empty(SHAPE, ctx=mx.cpu())
        kv.pull(3, out=val)
        got.append(val.asnumpy())
    np.testing.assert_array_equal(got[1], got[0])
    assert (got[1] == 2).all()


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_set_optimizer_updates_weights(momentum):
    grads = _vals(2, 3)
    got = []
    for mx, kvs in PKGS:
        kv = _init_kv(mx, kvs)
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1,
                                          momentum=momentum,
                                          rescale_grad=1.0))
        out = mx.nd.empty(SHAPE, ctx=mx.cpu())
        for g in grads:
            kv.push(3, mx.nd.array(g, ctx=mx.cpu()))
        kv.pull(3, out=out)
        got.append(out.asnumpy())
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)
    if momentum == 0.0:
        np.testing.assert_allclose(got[1], -0.1 * sum(grads), rtol=1e-5)


def test_pull_broadcast_multi_devs():
    for mx, kvs in PKGS:
        kv = _init_kv(mx, kvs)
        kv.push(3, mx.nd.ones(SHAPE, ctx=mx.cpu()) * 3)
        outs = [mx.nd.empty(SHAPE, ctx=mx.cpu(i)) for i in range(3)]
        kv.pull(3, out=outs)
        for o in outs:
            assert (o.asnumpy() == 3).all()


def test_kvstore_types_and_dist_refusals():
    """Every kind is created; in a world of one the dist kinds are rank 0
    of one worker with no dead node and a free barrier, dist_sync applies
    a push at once and dist_async one push later (the barrier applies
    the last). Only an unknown kind is refused."""
    for kind in ["local", "device", "local_allreduce_cpu",
                 "local_allreduce_device", "dist_sync", "dist_async",
                 "dist_device_sync", "dist"]:
        kv = tkvs.create(kind)
        assert kv.type == kind and kv.rank == 0 and kv.num_workers == 1
        assert kv.get_num_dead_node(0) == 0
        kv.barrier()
    for kind, lag in [("dist_sync", False), ("dist_async", True)]:
        kv = tkvs.create(kind)
        kv.init(3, tmx.nd.ones(SHAPE, ctx=tmx.cpu()))
        kv.push(3, tmx.nd.ones(SHAPE, ctx=tmx.cpu()) * 4)
        out = tmx.nd.zeros(SHAPE, ctx=tmx.cpu())
        kv.pull(3, out=out)
        assert (out.asnumpy() == (1.0 if lag else 4.0)).all(), kind
        kv.barrier()
        kv.pull(3, out=out)
        assert (out.asnumpy() == 4.0).all(), kind
    with pytest.raises(tmx.MXNetError):
        tkvs.create("bogus_type")
    assert tmx.kv is tkvs and tmx.kvstore is tkvs


def test_optimizer_states_roundtrip(tmp_path):
    kv = _init_kv(tmx, tkvs)
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    kv.push(3, tmx.nd.ones(SHAPE, ctx=tmx.cpu()))
    fname = str(tmp_path / "states.bin")
    kv.save_optimizer_states(fname)
    before = kv._updater.states[3].asnumpy()
    kv.push(3, tmx.nd.ones(SHAPE, ctx=tmx.cpu()))
    kv.load_optimizer_states(fname)
    kv.push(3, tmx.nd.ones(SHAPE, ctx=tmx.cpu()))
    kv2 = _init_kv(tmx, tkvs)
    kv2.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    kv2.load_optimizer_states(fname)
    np.testing.assert_array_equal(kv2._updater.states[3].asnumpy()
                                  if hasattr(kv2._updater.states[3],
                                             "asnumpy")
                                  else kv2._updater.states[3], before)
    assert kv._updater.optimizer.num_update == 2


def _net(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(d, num_hidden=8,
                                                name="fc1"),
                          act_type="relu", name="feat")
    h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _fit(kvstore):
    rng = np.random.RandomState(0)
    X = rng.rand(64, 6).astype(np.float32)
    y = rng.randint(0, 3, 64).astype(np.float32)
    tmx.random.seed(1)
    it = tmx.io.NDArrayIter(X, y, batch_size=16)
    mod = tmx.mod.Module(_net(tmx), context=tmx.cpu())
    mod.fit(it, num_epoch=2, kvstore=kvstore,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_fit_on_a_kvstore_equals_the_fused_step(tmp_path):
    plain_mod, plain = _fit("local")
    assert plain_mod._kvstore is None and plain_mod._exec_group._step_enabled
    kv = tkvs.create("local")
    kv_mod, on_kv = _fit(kv)
    assert kv_mod._update_on_kvstore and kv_mod._kvstore is kv
    assert not kv_mod._exec_group._step_enabled
    for k in plain:
        np.testing.assert_array_equal(on_kv[k], plain[k], err_msg=k)
    # the states live on the store and round-trip through the module
    fname = str(tmp_path / "mod.states")
    kv_mod.save_optimizer_states(fname)
    kv_mod.load_optimizer_states(fname)
    assert kv_mod._updater is None and kv._updater is not None
