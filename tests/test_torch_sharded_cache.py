"""ShardedCachedDataset of the port: the layout and the global order
against the JAX package, and tests/test_sharded_cache.py's contracts
within the port through the virtual-host harness:

* ``cache_row_of_pos`` and every epoch's global order equal the JAX
  package's (the order at two shard counts too);
* each shard holds only its row block; the per-shard tiers are recorded;
* a sharded fit equals the streaming (virtual feed) fit and the
  single-host CachedDataset fit bit for bit, in every tier (all on the
  device, one shard spilled to the host, the recordio re-stream), and the
  shuffled fit is the same at two shard counts;
* ``set_epoch`` replays an epoch's bytes, the capture epoch included;
* under a 2-rank gloo group each rank holds half the rows and the fit
  equals the ShardedDataIter fit of the same global stream bit for bit.
"""
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import dist
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.data import (CachedDataset, ShardedCachedDataset,
                                  cache_row_of_pos, global_shuffle_order)

CPU = tmx.cpu()
B = 32
ROWS = 256
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data():
    rng = np.random.RandomState(0)
    return (rng.rand(ROWS, 16).astype(np.float32),
            rng.randint(0, 10, ROWS).astype(np.float32))


X_GLOBAL, Y_GLOBAL = _data()


def _iter(pkg=tmx):
    return pkg.io.NDArrayIter(X_GLOBAL, Y_GLOBAL, batch_size=B,
                              label_name="softmax_label")


def _mlp():
    net = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(net, num_hidden=32, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return tmx.sym.SoftmaxOutput(net, name="softmax")


def _digest(mod):
    import hashlib
    h = hashlib.sha256()
    args, auxs = mod.get_params()
    for k in sorted(args):
        h.update(args[k].asnumpy().tobytes())
    for k in sorted(auxs):
        h.update(auxs[k].asnumpy().tobytes())
    return h.hexdigest()


FIT_KW = dict(optimizer="sgd",
              optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
              initializer=tmx.initializer.Xavier())
_STREAM = {}


def _fit_streaming(epochs=2):
    if epochs not in _STREAM:
        c = dist.VirtualCluster(4, context=CPU)
        mod = tmx.mod.Module(_mlp(), context=c.contexts())
        tmx.random.seed(3)
        mod.fit(c.feed(_iter(), module=mod), num_epoch=epochs, **FIT_KW)
        _STREAM[epochs] = _digest(mod)
    return _STREAM[epochs]


def _fit_sharded(epochs=2, n_hosts=4, **cache_kw):
    c = dist.VirtualCluster(n_hosts, context=CPU)
    mod = tmx.mod.Module(_mlp(), context=c.contexts())
    scd = ShardedCachedDataset(_iter(), cluster=c, module=mod, **cache_kw)
    tmx.random.seed(3)
    mod.fit(scd, num_epoch=epochs, **FIT_KW)
    return _digest(mod), scd


def _drain(it):
    out = []
    while True:
        try:
            out.append(it.next())
        except StopIteration:
            return out


# ------------------------------------------------- equal to the JAX package
@pytest.mark.parametrize("counts,shards,pad", [
    ([32, 32, 16], 4, None), ([32, 32, 16], 4, 24), ([12, 12, 6], 2, None),
    ([64] * 4, 8, None)])
def test_cache_row_of_pos_equals_jax(counts, shards, pad):
    from mxnet_tpu.data import cache_row_of_pos as jrow
    np.testing.assert_array_equal(cache_row_of_pos(counts, shards, pad),
                                  jrow(counts, shards, pad))
    m = cache_row_of_pos(counts, shards)
    assert len(set(m.tolist())) == sum(counts)
    with pytest.raises(MXNetError, match="not divisible"):
        cache_row_of_pos([30], 4)


def test_global_order_equals_jax_at_two_widths():
    """The epoch order of the port's sharded cache (at 4 and 2 shards)
    is the JAX package's global_shuffle_order for every epoch, and the
    capture epoch replays capture order."""
    from mxnet_tpu.data import global_shuffle_order as jorder
    caches = []
    for n in (4, 2):
        scd = ShardedCachedDataset(_iter(), cluster=dist.VirtualCluster(
            n, context=CPU), shuffle=True, seed=11)
        _drain(scd)
        scd.reset()
        caches.append(scd)
    for epoch in (1, 2, 5):
        want = jorder(11, epoch, ROWS)
        np.testing.assert_array_equal(global_shuffle_order(11, epoch, ROWS),
                                      want)
        for scd in caches:
            np.testing.assert_array_equal(scd.epoch_positions(epoch), want)
    np.testing.assert_array_equal(caches[0].epoch_positions(0),
                                  np.arange(ROWS))


# ------------------------------------------------------------- the layout
def test_each_shard_holds_only_its_row_block():
    c = dist.VirtualCluster(4, context=CPU)
    scd = ShardedCachedDataset(_iter(), cluster=c)
    batches = _drain(scd)
    np.testing.assert_array_equal(batches[0].data[0], X_GLOBAL[:B])
    scd.reset()
    info = scd.cache_info()
    assert info["tier"] == "hbm" and info["tiers"] == ["hbm"] * 4
    assert info["rows"] == ROWS and info["shard_rows"] == ROWS // 4
    assert info["shard_bytes"] * 4 == info["bytes"]
    cache = scd._dev_cache[0].numpy()
    rps = ROWS // 4
    for h in range(4):
        want = np.concatenate([X_GLOBAL[k * B + h * 8:k * B + (h + 1) * 8]
                               for k in range(ROWS // B)])
        np.testing.assert_array_equal(cache[h * rps:(h + 1) * rps], want)
    with pytest.raises(MXNetError):
        ShardedCachedDataset(tmx.io.NDArrayIter(
            X_GLOBAL, Y_GLOBAL, batch_size=30), cluster=c)


# ---------------------------------------------------------- serving parity
@pytest.mark.parametrize("tier", ["hbm", "host", "recordio"])
def test_sharded_fit_bitwise_vs_streaming_and_single_host(tier):
    kw = {"hbm": {}, "host": {"budget_mb": [64, 64, 1e-6, 64]},
          "recordio": {"tier": "recordio"}}[tier]
    d_shard, scd = _fit_sharded(**kw)
    assert d_shard == _fit_streaming()
    info = scd.cache_info()
    assert info["tier"] == tier
    if tier == "host":
        assert info["tiers"] == ["hbm", "hbm", "host", "hbm"]
        snap = tmx.telemetry.registry().snapshot()["gauges"]
        assert snap["data.cache_tier_hbm"] == 3
        assert snap["data.cache_tier_host"] == 1
        assert snap["data.cache_global_rows"] == ROWS
    if tier == "recordio":
        assert scd._dev_cache is None and scd._host_cache is None
    c = dist.VirtualCluster(4, context=CPU)
    mod = tmx.mod.Module(_mlp(), context=c.contexts())
    tmx.random.seed(3)
    mod.fit(CachedDataset(_iter(), module=mod), num_epoch=2, **FIT_KW)
    assert _digest(mod) == d_shard


def test_recordio_tier_refuses_shuffle_gracefully(caplog):
    scd = ShardedCachedDataset(_iter(), cluster=dist.VirtualCluster(
        4, context=CPU), tier="recordio", shuffle=True, seed=5)
    with caplog.at_level(logging.WARNING):
        scd.set_epoch(1)
        first = scd.next()
    assert any("shuffle is unavailable" in r.message for r in caplog.records)
    np.testing.assert_array_equal(first.data[0], X_GLOBAL[:B])
    np.testing.assert_array_equal(scd.epoch_positions(1), np.arange(ROWS))


def test_global_shuffle_width_stable_fit():
    d4, s4 = _fit_sharded(epochs=3, n_hosts=4, shuffle=True, seed=11)
    d2, s2 = _fit_sharded(epochs=3, n_hosts=2, shuffle=True, seed=11)
    assert d4 == d2
    np.testing.assert_array_equal(s4.epoch_positions(2),
                                  global_shuffle_order(11, 2, ROWS))


def test_set_epoch_replays_the_same_gathered_stream():
    scd = ShardedCachedDataset(_iter(), cluster=dist.VirtualCluster(
        4, context=CPU), shuffle=True, seed=7)

    def epoch_bytes(epoch):
        scd.set_epoch(epoch)
        return np.concatenate([np.asarray(b.data[0]) for b in _drain(scd)])

    first = epoch_bytes(0)
    scd.reset()
    e1 = epoch_bytes(1)
    np.testing.assert_array_equal(epoch_bytes(0), first)
    np.testing.assert_array_equal(first, X_GLOBAL)
    np.testing.assert_array_equal(epoch_bytes(1), e1)
    np.testing.assert_array_equal(
        e1, X_GLOBAL[global_shuffle_order(7, 1, ROWS)])
    scd.set_epoch(1)
    assert scd.skip_batches(3) == 3
    np.testing.assert_array_equal(np.asarray(scd.next().data[0]),
                                  e1[3 * B:4 * B])


# --------------------------------------------------- a real 2-rank group
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_RANK_SCRIPT = r"""
import hashlib, os, sys
sys.path.insert(0, %(root)r)
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import dist
rng = np.random.RandomState(0)
X = rng.rand(256, 16).astype(np.float32)
y = rng.randint(0, 10, 256).astype(np.float32)
rt = dist.get_runtime()

def net():
    n = mx.sym.Variable("data")
    n = mx.sym.FullyConnected(n, num_hidden=32, name="fc1")
    n = mx.sym.Activation(n, act_type="relu")
    n = mx.sym.FullyConnected(n, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(n, name="softmax")

def fit(data):
    mod = mx.mod.Module(net(), context=mx.cpu())
    mx.random.seed(3)
    mod.fit(data, num_epoch=3, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.initializer.Xavier())
    args, _ = mod.get_params()
    h = hashlib.sha256()
    for k in sorted(args):
        h.update(args[k].asnumpy().tobytes())
    return h.hexdigest()

it = lambda: mx.io.NDArrayIter(X, y, batch_size=32,
                               label_name="softmax_label")
a = fit(dist.ShardedDataIter(it()))
scd = mx.data.ShardedCachedDataset(it(), tier=os.environ["TIER"],
                                   ctx=mx.cpu())
b = fit(scd)
info = scd.cache_info()
assert info["num_shards"] == 2 and info["shard_rows"] == 128, info
if info["tier"] == "hbm":
    assert scd._dev_cache[0].shape[0] == 128
print("SCD rank=%%d stream=%%s cached=%%s tier=%%s"
      %% (rt.rank, a, b, info["tier"]), flush=True)
"""


@pytest.mark.parametrize("tier", ["hbm", "host"])
def test_two_rank_sharded_cache_fit_equals_sharded_iter(tmp_path, tier):
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT % {"root": ROOT})
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update({"DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": str(rank),
                    "DMLC_PS_ROOT_URI": "127.0.0.1",
                    "DMLC_PS_ROOT_PORT": str(port), "TIER": tier,
                    "OMP_NUM_THREADS": "1", "MXNET_DIST_BACKEND": "gloo"})
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=90)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for out, rc in outs:
        assert rc == 0, out
        lines.append([ln for ln in out.splitlines() if ln.startswith(
            "SCD ")][0])
    digests = {ln.split("stream=")[1].split()[0] for ln in lines} | \
        {ln.split("cached=")[1].split()[0] for ln in lines}
    assert len(digests) == 1, lines
    assert all("tier=%s" % tier in ln for ln in lines)


def test_elastic_resume_through_the_sharded_cache_bitwise(tmp_path):
    """4 virtual hosts training through a shuffled sharded cache, killed
    between commits (step 14, cadence 4) and resumed at width 2 through a
    freshly captured 2-shard cache, equal the continuous width-2 run from
    the same committed step (12) bit for bit; every cache drew the same
    global order for each shuffled epoch."""
    import os
    import shutil
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    built = []

    def cache_factory(world):
        scd = ShardedCachedDataset(_iter(), cluster=world, shuffle=True,
                                   seed=11)
        built.append(scd)
        return scd

    def module_factory(world):
        return tmx.mod.Module(_mlp(), context=world.contexts())

    tmp = str(tmp_path)
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    tmx.random.seed(3)
    tr = dist.ElasticTrainer(dist.VirtualCluster(4, context=CPU),
                             module_factory, cache_factory, mgr,
                             checkpoint_every_steps=4)
    try:
        mod = tr.fit(num_epoch=3, inject_fault=(14, (2, 3)), **FIT_KW)
    finally:
        tmx.telemetry.flight_recorder().disarm()
    done = [e for e in tr.transcript if e["event"] == "finished"][0]
    assert done["resume_step"] == 12 and done["dp_width"] == 2
    assert mod._optimizer.num_update == 24
    base = os.path.join(tmp, "baseline")
    shutil.copytree(os.path.join(tmp, "ckpt", "step_%08d" % 12),
                    os.path.join(base, "step_%08d" % 12))
    survivors = dist.VirtualCluster(4, context=CPU).shrink((2, 3))
    mod2 = module_factory(survivors)
    tmx.random.seed(99)
    mod2.fit(cache_factory(survivors), num_epoch=3,
             resume_from=CheckpointManager(base), **FIT_KW)
    assert _digest(mod) == _digest(mod2)
    ready = [s for s in built if s.cache_built_epoch is not None]
    assert {s.cache_info()["num_shards"] for s in ready} == {4, 2}
    for epoch in (1, 2):
        for scd in ready:
            np.testing.assert_array_equal(
                scd.epoch_positions(epoch),
                global_shuffle_order(11, epoch, ROWS))
