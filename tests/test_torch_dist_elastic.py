"""mxnet_tpu_torch.dist in one process: the slice rules against the JAX
package, and tests/test_dist_elastic.py's contracts within the port.

* ``shard_rows``, ``batch_seed``, ``coordination_env`` and
  ``ShardedDataIter``'s slices (pad and transform seeding included) equal
  the JAX package's output;
* the virtual-host feed assembles exactly the plain batch, and a fit
  through it equals a plain fit bit for bit;
* an elastic resume from 4 virtual hosts to 2 equals a continuous run at
  width 2 from the same committed step (params, momentum, num_update,
  RNG), at every commit boundary of a short run; a partial commit is
  never restored; the heartbeat monitor fires once per increase; a width
  below the minimum is refused;
* the bootstrap's bounded connect retry on a real ``gloo`` world of one.
"""
import glob
import hashlib
import os
import shutil
import socket

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import dist
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager

CPU = tmx.cpu()
B = 32
ROWS = 256


@pytest.fixture(autouse=True)
def _disarm_flight_recorder():
    yield
    tmx.telemetry.flight_recorder().disarm()
    tmx.telemetry.flight_recorder().pop_last_dump()


def _data():
    rng = np.random.RandomState(0)
    return (rng.rand(ROWS, 16).astype(np.float32),
            rng.randint(0, 10, ROWS).astype(np.float32))


X_GLOBAL, Y_GLOBAL = _data()


def _iter(pkg=tmx, X=X_GLOBAL, Y=Y_GLOBAL):
    return pkg.io.NDArrayIter(X, Y, batch_size=B,
                              label_name="softmax_label")


def _mlp():
    net = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(net, num_hidden=32, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return tmx.sym.SoftmaxOutput(net, name="softmax")


def _module_factory(world):
    return tmx.mod.Module(_mlp(), context=world.contexts())


def _data_factory(world):
    return world.feed(_iter())


def _digest(mod):
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


# ------------------------------------------------- equal to the JAX package
def test_shard_rows_and_batch_seed_equal_jax():
    arr = np.arange(96).reshape(24, 4)
    for n in (1, 2, 3, 4, 6):
        for r in range(n):
            np.testing.assert_array_equal(
                dist.shard_rows(arr, r, n), jmx.dist.shard_rows(arr, r, n))
    with pytest.raises(MXNetError):
        dist.shard_rows(arr, 0, 5)
    rng = np.random.RandomState(1)
    for _ in range(200):
        c = [int(v) for v in rng.randint(0, 2 ** 31, 4)]
        assert dist.batch_seed(*c) == jmx.dist.batch_seed(*c)
    a = dist.batch_seed(7, 2, 5, 1)
    assert len({a, dist.batch_seed(8, 2, 5, 1), dist.batch_seed(7, 3, 5, 1),
                dist.batch_seed(7, 2, 6, 1),
                dist.batch_seed(7, 2, 5, 2)}) == 5


@pytest.mark.parametrize("env", [
    {},
    {"DMLC_NUM_WORKER": "4", "DMLC_WORKER_ID": "2",
     "DMLC_PS_ROOT_URI": "10.0.0.1", "DMLC_PS_ROOT_PORT": "9999"},
    {"DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": "1",
     "MXNET_KVSTORE_HEARTBEAT_TIMEOUT": "12"},
    {"DMLC_NUM_WORKER": "4", "DMLC_WORKER_ID": "2",
     "JAX_COORDINATOR_ADDRESS": "10.0.0.2:1234", "JAX_NUM_PROCESSES": "8",
     "JAX_PROCESS_ID": "5"},
])
def test_coordination_env_equals_jax(env):
    assert dist.coordination_env(env) == jmx.dist.coordination_env(env)


def test_sharded_iter_slices_equal_jax():
    """Every rank's slices, local pad and transform draws equal the JAX
    package's ShardedDataIter on the same global stream (40 rows at 32:
    a padded tail)."""
    def noise(parts, rng):
        parts["data"] = [np.asarray(d) + rng.rand(*d.shape).astype(
            np.float32) for d in parts["data"]]
        return parts

    X, Y = X_GLOBAL[:40], Y_GLOBAL[:40]
    for transform in (None, noise):
        for r in range(4):
            mine = dist.ShardedDataIter(_iter(tmx, X, Y), rank=r,
                                        num_shards=4, seed=9,
                                        transform=transform)
            want = jmx.dist.ShardedDataIter(_iter(jmx, X, Y), rank=r,
                                            num_shards=4, seed=9,
                                            transform=transform)
            mine.set_epoch(3)
            want.set_epoch(3)
            assert mine.provide_data[0][1] == (B, 16)
            assert mine.local_provide_data[0][1] == (B // 4, 16)
            for _ in range(2):
                a, b = mine.next(), want.next()
                np.testing.assert_array_equal(a.data[0].asnumpy(),
                                              b.data[0].asnumpy())
                np.testing.assert_array_equal(a.label[0].asnumpy(),
                                              b.label[0].asnumpy())
                assert a.pad == b.pad
    # the union of the rank slices is the global batch, in rank order
    got = np.concatenate([
        dist.ShardedDataIter(_iter(), rank=r, num_shards=4).next()
        .data[0].asnumpy() for r in range(4)])
    np.testing.assert_array_equal(got, X_GLOBAL[:B])


# ------------------------------------------------------------ virtual hosts
def test_virtual_cluster_partition_and_shrink():
    c = dist.VirtualCluster(4, devices_per_host=2, context=CPU)
    assert c.n_hosts == 4 and c.device_count == 8
    assert c.contexts() == [CPU]
    s = c.shrink((1, 3))
    assert s.n_hosts == 2 and s.device_count == 4
    assert s.devices == c.hosts[0] + c.hosts[2]
    assert c.shrink((), dead_count=1).hosts == c.hosts[:3]
    with pytest.raises(MXNetError):
        c.shrink((9,))
    with pytest.raises(MXNetError):
        c.shrink((0, 1, 2, 3))
    assert s.describe()["dp_width"] == 4


def test_virtual_feed_assembly_and_straggler_clock():
    c = dist.VirtualCluster(4, context=CPU)
    feed = c.feed(_iter())
    batch = feed.next()
    np.testing.assert_array_equal(batch.data[0].asnumpy(), X_GLOBAL[:B])
    np.testing.assert_array_equal(batch.label[0].asnumpy(), Y_GLOBAL[:B])
    assert len(feed.host_clocks_ms()) == 4
    assert feed.straggler_ratio() >= 1.0
    snap = tmx.telemetry.registry().snapshot()["gauges"]
    assert "dist.straggler_ratio" in snap


def test_virtual_fit_bitwise_vs_plain():
    def run(feed):
        c = dist.VirtualCluster(4, context=CPU)
        mod = _module_factory(c)
        data = c.feed(_iter(), module=mod) if feed else _iter()
        tmx.random.seed(3)
        np.random.seed(3)
        mod.fit(data, num_epoch=2, **FIT_KW)
        return _digest(mod)

    assert run(False) == run(True)


# ------------------------------------------------------------------ elastic
def _run_elastic(tmp, fault_at, dead_hosts=(2, 3), every=4, epochs=3):
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    cluster = dist.VirtualCluster(4, context=CPU)
    tmx.random.seed(3)
    np.random.seed(3)
    tr = dist.ElasticTrainer(cluster, _module_factory, _data_factory, mgr,
                             checkpoint_every_steps=every)
    mod = tr.fit(num_epoch=epochs, inject_fault=(fault_at, dead_hosts),
                 **FIT_KW)
    return tr, mod, mgr


def _continuous(tmp, resume_step, epochs, data_factory=_data_factory):
    src = os.path.join(tmp, "ckpt", "step_%08d" % resume_step)
    dst = os.path.join(tmp, "baseline")
    shutil.copytree(src, os.path.join(dst, "step_%08d" % resume_step))
    cluster2 = dist.VirtualCluster(4, context=CPU).shrink((2, 3))
    mod2 = _module_factory(cluster2)
    tmx.random.seed(99)     # must not matter: the RNG comes back
    np.random.seed(99)
    mod2.fit(data_factory(cluster2), num_epoch=epochs,
             resume_from=CheckpointManager(dst), **FIT_KW)
    return mod2


def test_elastic_resume_bitwise_4_to_2(tmp_path):
    """Kill at step 14 at width 4, resume at width 2 from the last
    committed step (12): params, momentum and num_update equal a
    continuous width-2 run from that entry, bit for bit."""
    tmp = str(tmp_path)
    tr, mod, mgr = _run_elastic(tmp, fault_at=14)
    lost = [e for e in tr.transcript if e["event"] == "worker_lost"]
    done = [e for e in tr.transcript if e["event"] == "finished"]
    assert len(lost) == 1 and len(done) == 1
    assert lost[0]["dp_width"] == 4 and done[0]["dp_width"] == 2
    assert done[0]["resume_step"] == 12
    assert mod._optimizer.num_update == 24
    mod2 = _continuous(tmp, 12, 3)
    assert _digest(mod) == _digest(mod2)
    assert mod2._optimizer.num_update == 24
    sa, sb = mod._updater.states, mod2._updater.states
    assert sorted(sa) == sorted(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k].asnumpy(), sb[k].asnumpy())
    meta = mgr.step_metadata(12)
    assert meta["dp_width"] == 4 and meta["num_update"] == 12
    assert meta["epoch"] == 1 and meta["nbatch"] == 3
    assert mgr.step_metadata()["dp_width"] == 2


def test_elastic_kill_sweep_every_commit_boundary(tmp_path):
    """Kill at every step after the first commit of a short run; every
    resume equals the continuous width-2 run from its committed entry."""
    rng = np.random.RandomState(1)
    Xs = rng.rand(128, 16).astype(np.float32)
    ys = rng.randint(0, 10, 128).astype(np.float32)

    def data_factory(world):
        return world.feed(_iter(tmx, Xs, ys))

    EVERY, EPOCHS, STEPS = 3, 2, 8
    for k in range(EVERY, STEPS + 1):
        tmp = os.path.join(str(tmp_path), "k%d" % k)
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        tmx.random.seed(3)
        np.random.seed(3)
        tr = dist.ElasticTrainer(dist.VirtualCluster(4, context=CPU),
                                 _module_factory, data_factory, mgr,
                                 checkpoint_every_steps=EVERY)
        mod = tr.fit(num_epoch=EPOCHS, inject_fault=(k, (2, 3)), **FIT_KW)
        resume = [e for e in tr.transcript
                  if e["event"] == "finished"][0]["resume_step"]
        assert resume is not None and resume <= k, (k, resume)
        assert mod._optimizer.num_update == STEPS
        mod2 = _continuous(tmp, resume, EPOCHS, data_factory)
        assert _digest(mod) == _digest(mod2), (k, resume)


def test_crash_between_commit_never_restores_partial(tmp_path):
    tmp = str(tmp_path)
    tr, mod, mgr = _run_elastic(tmp, fault_at=14, epochs=2)
    mgr.wait_until_finished()
    committed = mgr.all_steps()
    partial = os.path.join(tmp, "ckpt", ".tmp-step_00000099-deadbeef")
    os.makedirs(partial)
    with open(os.path.join(partial, "a00000_s00.npy"), "wb") as f:
        f.write(b"\x00" * 17)
    assert mgr.latest() == committed[-1]
    with pytest.raises(MXNetError):
        mgr.restore(99)
    cluster2 = dist.VirtualCluster(4, context=CPU).shrink((2, 3))
    mod2 = _module_factory(cluster2)
    mod2.fit(_data_factory(cluster2), num_epoch=2,
             resume_from=CheckpointManager(os.path.join(tmp, "ckpt")),
             **FIT_KW)
    assert mod2._optimizer.num_update == 16


def test_elastic_refuses_below_min_width(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    tr = dist.ElasticTrainer(dist.VirtualCluster(4, context=CPU),
                             _module_factory, _data_factory, mgr,
                             checkpoint_every_steps=4, min_dp_width=3)
    with pytest.raises(MXNetError, match="min_dp_width"):
        tr.fit(num_epoch=2, inject_fault=(6, (2, 3)), **FIT_KW)


def test_elastic_postmortem_and_plan_driven_loss(tmp_path):
    """A plan-driven worker_lost (faults.WorkerLost IS dist.WorkerLost)
    drives the whole chain and leaves a committed postmortem."""
    assert tmx.faults.WorkerLost is dist.WorkerLost
    tmx.faults.arm("dist.worker:worker_lost@num_update=6,dead=2", seed=1)
    try:
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        tmx.random.seed(3)
        tr = dist.ElasticTrainer(dist.VirtualCluster(4, context=CPU),
                                 _module_factory, _data_factory, mgr,
                                 checkpoint_every_steps=2)
        mod = tr.fit(num_epoch=2, **FIT_KW)
    finally:
        tmx.faults.disarm()
    events = [e["event"] for e in tr.transcript]
    assert events == ["worker_lost", "finished"]
    assert tr.transcript[0]["at_num_update"] == 6
    assert tr.transcript[1]["dp_width"] == 2
    assert mod._optimizer.num_update == 16
    pm = tr.transcript[0]["postmortem"]
    assert pm and os.path.exists(pm)
    assert not glob.glob(os.path.join(os.path.dirname(pm), "*.tmp-*"))


class _FakeRuntime:
    def __init__(self):
        self.dead = 0

    def num_dead_nodes(self, timeout=60):
        return self.dead


def test_heartbeat_monitor_fires_once_per_increase():
    rt = _FakeRuntime()
    seen = []
    mon = dist.HeartbeatMonitor(runtime=rt, interval_s=3600,
                                on_dead=seen.append)
    assert mon._probe_once() == 0 and seen == []
    rt.dead = 2
    assert mon._probe_once() == 2 and seen == [2]
    assert mon._probe_once() == 2 and seen == [2]
    rt.dead = 3
    mon._probe_once()
    assert seen == [2, 3] and mon.dead_count == 3
    assert mon.unacknowledged == 3
    mon.acknowledge()
    assert mon.unacknowledged == 0
    with mon:
        assert not mon._thread.name.startswith("mxtpu-")
    snap = tmx.telemetry.registry().snapshot()["gauges"]
    assert snap["dist.dead_nodes"] == 3


def test_elastic_recovers_from_heartbeat_detection(tmp_path):
    rt = _FakeRuntime()
    mon = dist.HeartbeatMonitor(runtime=rt, interval_s=3600)
    fired = []

    def flip_dead(param):
        if not fired and param.nbatch == 2:
            rt.dead = 2
            mon._probe_once()
            fired.append(True)

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    tmx.random.seed(3)
    tr = dist.ElasticTrainer(dist.VirtualCluster(4, context=CPU),
                             _module_factory, _data_factory, mgr,
                             checkpoint_every_steps=2)
    mod = tr.fit(num_epoch=2, monitor=mon, batch_end_callback=[flip_dead],
                 **FIT_KW)
    assert [e["event"] for e in tr.transcript] == ["worker_lost",
                                                   "finished"]
    assert tr.transcript[1]["dp_width"] == 2
    assert mod._optimizer.num_update == 16
    assert mon.unacknowledged == 0


def test_process_world_shrink_requests_relaunch(tmp_path, monkeypatch):
    world = dist.ProcessWorld(runtime=dist.DistRuntime(rank=1, size=4))
    with pytest.raises(dist.RestartRequired) as ei:
        world.shrink((), dead_count=1)
    assert ei.value.num_processes == 3
    path = str(tmp_path / "relaunch.json")
    monkeypatch.setenv("MXNET_RELAUNCH_FILE", path)
    codes = []

    def fn():
        world.shrink((2,))

    dist.run_with_relaunch(fn, exit_fn=codes.append)
    assert codes == [dist.RELAUNCH_EXIT_CODE] == [77]
    import json
    with open(path) as f:
        assert json.load(f)["num_processes"] == 3
    monkeypatch.setenv("MXNET_VIRTUAL_HOSTS", "3")
    assert dist.virtual_world_from_env(context=CPU).n_hosts == 3


# ---------------------------------------------------------------- bootstrap
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_bootstrap_retry_backoff_on_a_gloo_world_of_one(monkeypatch):
    """The connect retries with the exponential backoff schedule, then a
    real gloo group of one comes up (rank, size, telemetry, an identity
    all-reduce, a free barrier); with every attempt refused it gives up
    loudly after 1 + retries attempts."""
    import torch
    from mxnet_tpu_torch.dist import bootstrap
    calls, delays = [], []
    monkeypatch.setattr(bootstrap.time, "sleep", delays.append)
    real = bootstrap._connect

    def flaky(*a):
        calls.append(a)
        if len(calls) < 3:
            raise RuntimeError("connect refused")
        return real(*a)

    monkeypatch.setattr(bootstrap, "_connect", flaky)
    dist.reset_runtime()
    rt = dist.initialize(coordinator_address="127.0.0.1:%d" % _free_port(),
                         num_processes=1, process_id=0, backend="gloo",
                         connect_retries=5, connect_backoff_s=0.25)
    try:
        assert len(calls) == 3 and delays == [0.25, 0.5]
        assert rt.rank == 0 and rt.size == 1 and rt.backend == "gloo"
        assert dist.get_runtime() is rt
        t = torch.ones(3)
        rt.allreduce_(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
        assert rt.barrier() == 0.0
        snap = tmx.telemetry.registry().snapshot()
        assert snap["gauges"]["dist.world_size"] == 1
        assert snap["counters"]["dist.bootstrap_ms"] > 0
    finally:
        rt.shutdown()
        dist.reset_runtime()

    calls.clear()
    delays.clear()

    def dead(*a):
        calls.append(a)
        raise RuntimeError("connect refused")

    monkeypatch.setattr(bootstrap, "_connect", dead)
    with pytest.raises(RuntimeError, match="could not join"):
        dist.initialize(coordinator_address="127.0.0.1:1",
                        num_processes=2, process_id=1, backend="gloo",
                        connect_retries=2, connect_backoff_s=0.1)
    assert len(calls) == 3
    dist.reset_runtime()


def test_backend_is_explicit(monkeypatch):
    from mxnet_tpu_torch.dist.bootstrap import resolve_backend
    monkeypatch.delenv("MXNET_DIST_BACKEND", raising=False)
    assert resolve_backend(None, 2) == "gloo"      # no CUDA here
    assert resolve_backend("gloo", 2) == "gloo"
    with pytest.raises(MXNetError, match="nccl"):
        resolve_backend("nccl", 1)
    with pytest.raises(MXNetError):
        resolve_backend("mpi", 1)
    monkeypatch.setenv("MXNET_DIST_BACKEND", "nccl")
    with pytest.raises(MXNetError):
        resolve_backend(None, 1)


def test_kvstore_dist_rides_the_runtime():
    dist.reset_runtime()
    kv = tmx.kv.create("dist_sync")
    assert isinstance(kv._dist, dist.DistRuntime)
    assert kv.rank == 0 and kv.num_workers == 1
    assert tmx.parallel.dist.get_runtime() is kv._dist
    snap = tmx.telemetry.registry().snapshot()["gauges"]
    assert snap["dist.world_size"] == 1 and snap["dist.rank"] == 0


@pytest.mark.parametrize("role", ["server", "scheduler", "worker"])
def test_kvstore_server_roles(role):
    """A server or scheduler role serves nothing and exits 0 at import,
    as the JAX package's; a worker returns to the script."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch.kvstore_server; "
         "print('WORKER_CONTINUES')"],
        env=dict(os.environ, DMLC_ROLE=role, PYTHONPATH=root),
        capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr[-2000:]
    assert ("WORKER_CONTINUES" in res.stdout) == (role == "worker")
