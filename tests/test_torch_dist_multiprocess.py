"""Real multi-process data parallelism of the port on the CPU.

``mxnet_tpu_torch.tools.dist_worker`` runs as 2 or 3 OS processes that join
one ``gloo`` process group through the DMLC_* environment of
tools/launch.py (the JAX package's tests/test_dist_multiprocess.py skips
the same runs on XLA:CPU, which has no cross-process collectives):

* push/pull sums exact on every rank, ``dist_async`` one push late;
* a killed rank found dead through the store's heartbeats within 60 s;
* ``Module.fit`` with a dist store: one checksum on every rank and
  across repeats, ``dist_async`` different from ``dist_sync``;
* a 2-rank fit of a BatchNorm net on one global batch of 16 held to the
  JAX package's fit of the same parameters and data on its 8-device
  virtual mesh (``VirtualCluster``), and the 2-rank
  ``DataParallelTrainStep`` to the port's own one-process step.

Every spawn has its own subprocess timeout and its own rendezvous port
(``bind(0)``), so parallel test workers never share a coordinator.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from mxnet_tpu_torch.tools import dist_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPAWN_TIMEOUT = 90
STEP_REL_L2 = 1e-4
SPREAD_FACTOR = 4.0


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(mode, n=3, extra_env=None, timeout=SPAWN_TIMEOUT):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env.update({"DMLC_ROLE": "worker", "DMLC_NUM_WORKER": str(n),
                    "DMLC_WORKER_ID": str(rank),
                    "DMLC_PS_ROOT_URI": "127.0.0.1",
                    "DMLC_PS_ROOT_PORT": str(port),
                    "OMP_NUM_THREADS": "1", "MXNET_DIST_BACKEND": "gloo",
                    "PYTHONPATH": ROOT})
        env.update(extra_env or {})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.dist_worker",
             mode], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _ok(outs, what):
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, "rank %d (%s) failed:\n%s" % (rank, what, out)


@pytest.mark.parametrize("kv_type", ["dist_sync", "dist_async"])
def test_dist_push_pull_three_workers(kv_type):
    """run_sync's exact values on 3 ranks; dist_async applies each push
    one step late and its barrier applies the last."""
    outs = _spawn("sync", extra_env={"DIST_KV_TYPE": kv_type})
    _ok(outs, kv_type)
    for rc, out in outs:
        assert "DIST_WORKER_OK" in out and "nworker=3" in out


def test_dist_fit_checksums_sync_and_async():
    """Module.fit with a dist store, each rank on its shard: the same
    parameters on every rank; dist_async the same across repeats and
    different from dist_sync (one step late)."""
    def run(kv_type):
        outs = _spawn("fit", extra_env={"DIST_KV_TYPE": kv_type})
        _ok(outs, kv_type)
        sums = set()
        accs = set()
        for _, out in outs:
            line = [ln for ln in out.splitlines()
                    if "DIST_FIT_CHECKSUM" in ln][0]
            assert "type=%s" % kv_type in line
            sums.add(line.split("sum=")[1].strip())
            acc = [ln for ln in out.splitlines() if "DIST_FIT_ACC" in ln][0]
            accs.add(acc.split("acc=")[1])
        assert len(sums) == 1 and len(accs) == 1, (kv_type, sums, accs)
        return sums.pop()

    sync = run("dist_sync")
    async_a = run("dist_async")
    async_b = run("dist_async")
    assert async_a == async_b
    assert async_a != sync


def test_dist_dead_node_detection():
    """A rank that dies without a word is counted dead by the others
    within 60 s (heartbeats through rank 0's store)."""
    victim = 2
    outs = _spawn("crash", extra_env={
        "DIST_CRASH_RANK": str(victim),
        "MXNET_KVSTORE_HEARTBEAT_TIMEOUT": "8"})
    for rank, (rc, out) in enumerate(outs):
        if rank == victim:
            continue
        assert rc == 0, "survivor %d failed:\n%s" % (rank, out)
        assert "DIST_DEAD_DETECTED" in out


def _init_npz(path):
    """numpy-seeded parameters of the BatchNorm net (shared by both
    packages), written for the ranks."""
    sym = W.bn_net()
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(16, 3, 8, 8))
    rng = np.random.RandomState(2)
    args, aux = {}, {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("gamma"):
            v = rng.uniform(0.5, 1.5, s)
        elif n.endswith(("beta", "bias")):
            v = rng.uniform(-0.1, 0.1, s)
        else:
            v = rng.randn(*s) * np.sqrt(1.0 / np.prod(s[1:]))
        args[n] = v.astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        lo, hi = (0.5, 1.5) if n.endswith("var") else (-0.1, 0.1)
        aux[n] = rng.uniform(lo, hi, s).astype(np.float32)
    np.savez(path, **{"arg:" + k: v for k, v in args.items()},
             **{"aux:" + k: v for k, v in aux.items()})
    return args, aux


def _load(path):
    z = np.load(path)
    return {k.split(":", 1)[1]: z[k] for k in z.files}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_virtual_fit(args, aux):
    """The JAX package's fit of the same net, parameters and data on
    its 8-device virtual mesh (2 virtual hosts)."""
    X, y = W._bn_data()
    cluster = jmx.dist.VirtualCluster(2)
    sym = jmx.sym.load_json(W.bn_net().tojson())
    mod = jmx.mod.Module(sym, context=cluster.contexts())
    feed = cluster.feed(jmx.io.NDArrayIter(X, y, batch_size=16,
                                           label_name="softmax_label"),
                        module=mod)
    mod.fit(feed, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: jmx.nd.array(v) for k, v in args.items()},
            aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
    a, b = mod.get_params()
    return {k: v.asnumpy() for k, v in list(a.items()) + list(b.items())}


def test_two_rank_bn_fit_matches_jax_virtual_mesh(tmp_path, monkeypatch):
    """2 gloo ranks, global batch 16 (8 rows a rank through
    ShardedDataIter), BatchNorm over the global batch through the
    cross-rank split: after 4 SGD-momentum steps the parameters and
    moving statistics are held to the JAX package's virtual-mesh fit
    (relative L2 within max(1e-4, 4x the JAX package's own one-pass vs
    exact-statistics spread), as tests/test_torch_zoo_step.py holds a
    step); both ranks end on one digest."""
    init = str(tmp_path / "init.npz")
    out = str(tmp_path / "out.npz")
    args, aux = _init_npz(init)
    outs = _spawn("bnfit", n=2, extra_env={"DIST_INIT": init,
                                           "DIST_OUT": out})
    _ok(outs, "bnfit")
    digests = {[ln for ln in o.splitlines() if "DIST_BNFIT" in ln][0]
               .split("digest=")[1] for _, o in outs}
    assert len(digests) == 1
    mine = _load(out)
    want = _jax_virtual_fit(args, aux)
    monkeypatch.setenv("MXNET_BN_EXACT_STATS", "1")
    exact = _jax_virtual_fit(args, aux)
    spread = max(_rel(exact[k], want[k]) for k in want)
    limit = max(STEP_REL_L2, SPREAD_FACTOR * spread)
    assert limit < 0.05, limit
    assert sorted(mine) == sorted(want)
    for k in want:
        assert np.isfinite(mine[k]).all(), k
        assert _rel(mine[k], want[k]) < limit, (k, _rel(mine[k], want[k]),
                                                limit)
    assert not np.array_equal(mine["fc_weight"], args["fc_weight"])


def test_two_rank_dp_step_matches_one_process(tmp_path):
    """DataParallelTrainStep over 2 gloo ranks (8 rows each, gradients
    summed, BatchNorm over the 16 rows) against the same step in one
    process on all 16 rows: 4 steps within relative L2 1e-5 (float32
    sums taken in another order)."""
    init = str(tmp_path / "init.npz")
    out = str(tmp_path / "out.npz")
    _init_npz(init)
    _ok(_spawn("dpstep", n=2, extra_env={"DIST_INIT": init,
                                         "DIST_OUT": out}), "dpstep")
    mine = _load(out)
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.parallel import data_parallel as dp
    from mxnet_tpu_torch.parallel.mesh import make_mesh
    import torch
    dist.reset_runtime()
    X, y = W._bn_data()
    z = np.load(init)
    step = dp.DataParallelTrainStep(
        W.bn_net(), make_mesh({"dp": 1}, ["cpu"]),
        dp.sgd_step_fn(momentum=0.9, rescale_grad=1.0 / 16),
        context=tmx.cpu())
    params, states, aux = step.init(tmx.initializer.Xavier(),
                                    {"data": (16, 3, 8, 8),
                                     "softmax_label": (16,)})
    for k in params:
        params[k].copy_(torch.from_numpy(z["arg:" + k]))
    for k in aux:
        aux[k].copy_(torch.from_numpy(z["aux:" + k]))
    for i in range(4):
        batch = step.shard_batch({"data": X[16 * i:16 * (i + 1)],
                                  "softmax_label": y[16 * i:16 * (i + 1)]})
        params, states, aux, _ = step(params, states, aux, batch, 0.1)
    want = {k: v.numpy() for k, v in list(params.items())
            + list(aux.items())}
    assert sorted(mine) == sorted(want)
    for k in want:
        assert _rel(mine[k], want[k]) < 1e-5, (k, _rel(mine[k], want[k]))


def test_checkpoint_carries_dp_width_and_resumes_at_width_one(tmp_path):
    """Two ranks fit an MLP for two epochs over one global batch of 16,
    rank 0 committing an entry per epoch (``dp_width`` 2 in its
    metadata); one process resumed from the first entry at width one
    (the same global batch, now all on one rank) ends within relative
    L2 1e-5 of the two ranks' parameters (float32 sums in another
    order), with the update count continued."""
    import shutil
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    ckpt = str(tmp_path / "ckpt")
    out = str(tmp_path / "out.npz")
    _ok(_spawn("ckpt", n=2, extra_env={"DIST_CKPT": ckpt,
                                       "DIST_OUT": out}), "ckpt")
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [0, 1]
    assert mgr.step_metadata(0)["dp_width"] == 2
    base = str(tmp_path / "base")
    shutil.copytree(os.path.join(ckpt, "step_%08d" % 0),
                    os.path.join(base, "step_%08d" % 0))
    from mxnet_tpu_torch import dist
    dist.reset_runtime()
    X, y = W.fit_data()
    mod = tmx.mod.Module(W.mlp_net(), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=16,
                               label_name="softmax_label"),
            num_epoch=2, resume_from=CheckpointManager(base),
            initializer=tmx.initializer.Xavier(), **W.CKPT_FIT)
    assert mod._optimizer.num_update == 12
    mine = _load(out)
    args, _ = mod.get_params()
    for k, v in args.items():
        assert _rel(v.asnumpy(), mine[k]) < 1e-5, k


def test_replicated_global_batch_is_cut_to_the_rank_block():
    """A module bound at the rank's rows and fed the whole global batch
    trains its row block of it: bit for bit the ShardedDataIter fit, on
    both ranks."""
    outs = _spawn("replicated", n=2)
    _ok(outs, "replicated")
    digests = set()
    for _, out in outs:
        line = [ln for ln in out.splitlines()
                if ln.startswith("DIST_REPLICATED")][0]
        sharded = line.split("sharded=")[1].split()[0]
        replicated = line.split("replicated=")[1].split()[0]
        assert sharded == replicated, line
        digests.add(sharded)
    assert len(digests) == 1
