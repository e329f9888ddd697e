"""Multi-process checks of the port's dist runtime (the twin of the JAX
package's tests/dist_worker.py): every rank runs

    python -m mxnet_tpu_torch.tools.dist_worker <mode>

with the DMLC_* environment of tools/launch.py (the CPU tests spawn
``gloo`` ranks; chip_smoke.py runs ``sync`` with ``DIST_CTX=gpu``, card
tensors over ``gloo``).

Modes (argv[1]):
  sync   - push/pull of rank-dependent values, exact sums (dist_sync) or
           one push late (dist_async), a big key, barrier
  crash  - rank DIST_CRASH_RANK dies without a word; the others find it
           through the store's heartbeats (kv.get_num_dead_node)
  fit    - Module.fit with a dist kvstore, each rank on its shard; prints
           a bitwise parameter checksum and the full-data accuracy
  bnfit  - a BatchNorm net trained on one global batch across the ranks
           (ShardedDataIter), parameters written to DIST_OUT (npz, rank 0)
  dpstep - DataParallelTrainStep on the global batch, DIST_OUT as bnfit
  replicated - the MLP bound at the rank's rows, trained by hand on
           replicated global batches (Module.forward cuts the rank's
           block), against a ShardedDataIter fit: one digest
  ckpt   - an MLP fit over the global batch (ShardedDataIter), an entry
           per epoch in the CheckpointManager at DIST_CKPT (rank 0
           writes), parameters to DIST_OUT
"""
import hashlib
import os
import sys
import time

import numpy as onp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import optimizer as opt

# the device of the push/pull arrays: the CPU, or the card (DIST_CTX=gpu)
CPU = mx.gpu(0) if os.environ.get("DIST_CTX") == "gpu" else mx.cpu()


def check_exact(arr, x):
    a = arr.asnumpy()
    assert onp.sum(onp.abs(a - x)) == 0.0, (a.ravel()[:4], x)


def run_sync(kv):
    rank, nworker = kv.rank, kv.num_workers
    shape, big_shape = (2, 2), (600, 600)
    rate, nrepeat = 2, 3

    kv.init([3, 5, 7], [mx.nd.ones(shape, ctx=CPU)] * 3)
    kv.init(99, mx.nd.ones(big_shape, ctx=CPU))
    kv.set_optimizer(opt.Test(learning_rate=-float(rate), rescale_grad=1.0))

    for _ in range(nrepeat):
        kv.push(3, mx.nd.ones(shape, ctx=CPU) * (rank + 1))
        kv.push(99, mx.nd.ones(big_shape, ctx=CPU) * (rank + 1))

    # dist_async applies each push one step late: nrepeat - 1 applied
    applied = nrepeat - 1 if kv.type == "dist_async" else nrepeat
    num = (nworker + 1) * nworker * rate / 2 * applied + 1
    val = mx.nd.zeros(shape, ctx=CPU)
    kv.pull(3, out=val)
    check_exact(val, num)
    val2 = mx.nd.zeros(big_shape, ctx=CPU)
    kv.pull(99, out=val2)
    check_exact(val2, num)

    val3 = mx.nd.zeros(shape, ctx=CPU)
    kv.pull(5, out=val3)
    check_exact(val3, 1.0)

    a = mx.nd.zeros(big_shape, ctx=CPU)
    b = mx.nd.zeros(big_shape, ctx=CPU)
    kv.pull(99, out=a)
    kv.pull(99, out=b)
    assert (a.asnumpy() == b.asnumpy()).all()

    kv.barrier()
    if kv.type == "dist_async":
        # the barrier applied the last reduction
        kv.pull(3, out=val)
        check_exact(val, (nworker + 1) * nworker * rate / 2 * nrepeat + 1)
    print("DIST_WORKER_OK rank=%d nworker=%d" % (rank, nworker), flush=True)


def run_crash(kv):
    rank = kv.rank
    victim = int(os.environ["DIST_CRASH_RANK"])
    assert kv.get_num_dead_node(-1, timeout=5) == 0
    kv.barrier()  # everyone connected before the crash
    if rank == victim:
        os._exit(0)  # die without telling anyone
    t0 = time.time()
    deadline = t0 + 60
    dead = 0
    while time.time() < deadline:
        dead = kv.get_num_dead_node(-1, timeout=5)
        if dead >= 1:
            break
        time.sleep(0.5)
    assert dead >= 1, "dead peer not detected within 60s"
    print("DIST_DEAD_DETECTED rank=%d dead=%d after=%.1fs"
          % (rank, dead, time.time() - t0), flush=True)
    # exit order: rank 0 holds the store; the other survivors report
    # their detection through it and rank 0 leaves after them
    from mxnet_tpu_torch.dist import get_runtime
    store = get_runtime().store
    survivors = [r for r in range(kv.num_workers) if r not in (victim, 0)]
    if rank != 0:
        store.set("crash_detected_r%d" % rank, "1")
    else:
        import datetime
        store.set_timeout(datetime.timedelta(seconds=60))
        store.wait(["crash_detected_r%d" % r for r in survivors])
    # no shutdown protocol with a peer dead
    os._exit(0)


def _digest(mod):
    args, auxs = mod.get_params()
    h = hashlib.sha1()
    for name in sorted(args):
        h.update(args[name].asnumpy().tobytes())
    for name in sorted(auxs):
        h.update(auxs[name].asnumpy().tobytes())
    return h.hexdigest()


def run_fit(kv):
    rank, nworker = kv.rank, kv.num_workers
    onp.random.seed(7)
    X = onp.random.rand(96, 8).astype(onp.float32)
    W = onp.random.rand(8, 4).astype(onp.float32)
    y = (X @ W).argmax(axis=1).astype(onp.float32)
    Xr, yr = X[rank::nworker], y[rank::nworker]

    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="tanh")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    it = mx.io.NDArrayIter(Xr, yr, batch_size=8, label_name="softmax_label")
    mod = mx.mod.Module(net, context=CPU)
    mx.random.seed(11 + rank)    # rank 0's init reaches every rank
    epochs = int(os.environ.get("DIST_FIT_EPOCHS", "3"))
    mod.fit(it, num_epoch=epochs, kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=mx.initializer.Xavier())
    kv.barrier()
    print("DIST_FIT_CHECKSUM rank=%d type=%s sum=%s"
          % (rank, kv.type, _digest(mod)), flush=True)
    score_it = mx.io.NDArrayIter(X, y, batch_size=8,
                                 label_name="softmax_label")
    acc = mod.score(score_it, mx.metric.Accuracy())[0][1]
    print("DIST_FIT_ACC rank=%d type=%s acc=%.4f" % (rank, kv.type, acc),
          flush=True)


def _bn_data():
    rng = onp.random.RandomState(5)
    X = rng.rand(64, 3, 8, 8).astype(onp.float32)
    y = rng.randint(0, 4, 64).astype(onp.float32)
    return X, y


def bn_net():
    """A small conv net with BatchNorm(+ReLU), shared with the test."""
    net = mx.sym.Variable("data")
    net = mx.sym.Convolution(net, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             name="conv1")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Convolution(net, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             name="conv2")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn2")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, global_pool=True, kernel=(1, 1),
                         pool_type="avg")
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _save(mod_or_params, path):
    args, auxs = mod_or_params
    onp.savez(path, **{"arg:" + k: v.asnumpy() for k, v in args.items()},
              **{"aux:" + k: v.asnumpy() for k, v in auxs.items()})


def run_bnfit(kv_type):
    from mxnet_tpu_torch import dist
    rt = dist.get_runtime()
    X, y = _bn_data()
    init = onp.load(os.environ["DIST_INIT"])
    args = {k[4:]: mx.nd.array(v, ctx=CPU) for k, v in init.items()
            if k.startswith("arg:")}
    auxs = {k[4:]: mx.nd.array(v, ctx=CPU) for k, v in init.items()
            if k.startswith("aux:")}
    it = dist.ShardedDataIter(
        mx.io.NDArrayIter(X, y, batch_size=16, label_name="softmax_label"))
    mod = mx.mod.Module(bn_net(), context=CPU)
    mod.fit(it, num_epoch=1, kvstore=kv_type, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params=args, aux_params=auxs)
    print("DIST_BNFIT rank=%d world=%d digest=%s"
          % (rt.rank, rt.size, _digest(mod)), flush=True)
    if rt.rank == 0:
        _save(mod.get_params(), os.environ["DIST_OUT"])


def run_dpstep():
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.parallel import data_parallel as dp
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh
    rt = dist.get_runtime()
    X, y = _bn_data()
    init = onp.load(os.environ["DIST_INIT"])
    step = dp.DataParallelTrainStep(
        bn_net(), data_parallel_mesh(),
        dp.sgd_step_fn(momentum=0.9, rescale_grad=1.0 / 16), context=CPU)
    params, states, aux = step.init(
        mx.initializer.Xavier(), {"data": (16 // rt.size, 3, 8, 8),
                                  "softmax_label": (16 // rt.size,)})
    import torch
    for k in params:
        params[k].copy_(torch.from_numpy(init["arg:" + k]))
    for k in aux:
        aux[k].copy_(torch.from_numpy(init["aux:" + k]))
    for i in range(4):
        batch = step.shard_batch({"data": X[16 * i:16 * (i + 1)],
                                  "softmax_label": y[16 * i:16 * (i + 1)]})
        params, states, aux, _ = step(params, states, aux, batch, 0.1)
    print("DIST_DPSTEP rank=%d world=%d" % (rt.rank, rt.size), flush=True)
    if rt.rank == 0:
        wrap = {k: mx.nd.NDArray(v) for k, v in params.items()}
        _save((wrap, {k: mx.nd.NDArray(v) for k, v in aux.items()}),
              os.environ["DIST_OUT"])


def mlp_net():
    """The MLP of ``ckpt`` (and of its resume in the test)."""
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="tanh")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def fit_data():
    rng = onp.random.RandomState(7)
    X = rng.rand(96, 8).astype(onp.float32)
    y = (X @ rng.rand(8, 4).astype(onp.float32)).argmax(axis=1)
    return X, y.astype(onp.float32)


CKPT_FIT = {"optimizer": "sgd",
            "optimizer_params": {"learning_rate": 0.1, "momentum": 0.9}}


def run_ckpt():
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    X, y = fit_data()
    it = dist.ShardedDataIter(mx.io.NDArrayIter(
        X, y, batch_size=16, label_name="softmax_label"))
    mod = mx.mod.Module(mlp_net(), context=CPU)
    mgr = CheckpointManager(os.environ["DIST_CKPT"])
    mx.random.seed(11)
    mod.fit(it, num_epoch=2, kvstore="dist_sync",
            initializer=mx.initializer.Xavier(),
            epoch_end_callback=mx.callback.module_checkpoint(
                mod, save_optimizer_states=True, manager=mgr), **CKPT_FIT)
    mgr.wait_until_finished()
    rt = dist.get_runtime()
    rt.barrier()
    print("DIST_CKPT rank=%d" % rt.rank, flush=True)
    if rt.rank == 0:
        _save(mod.get_params(), os.environ["DIST_OUT"])


def run_replicated():
    from mxnet_tpu_torch import dist
    rt = dist.get_runtime()
    X, y = fit_data()
    digests = []
    for replicated in (False, True):
        it = mx.io.NDArrayIter(X, y, batch_size=16,
                               label_name="softmax_label")
        mod = mx.mod.Module(mlp_net(), context=CPU)
        mx.random.seed(11)
        if replicated:
            m = 16 // rt.size
            mod.bind(data_shapes=[("data", (m, 8))],
                     label_shapes=[("softmax_label", (m,))])
            mod.init_params(mx.initializer.Xavier())
            mod.init_optimizer(kvstore="dist_sync", **CKPT_FIT)
            for batch in it:
                mod.forward_backward(batch)
                mod.update()
        else:
            mod.fit(dist.ShardedDataIter(it), num_epoch=1,
                    kvstore="dist_sync", initializer=mx.initializer.Xavier(),
                    **CKPT_FIT)
        digests.append(_digest(mod))
    print("DIST_REPLICATED rank=%d sharded=%s replicated=%s"
          % (rt.rank, digests[0], digests[1]), flush=True)


def main():
    mode = sys.argv[1]
    if mode == "replicated":
        run_replicated()
        return
    if mode == "ckpt":
        run_ckpt()
        return
    if mode == "bnfit":
        run_bnfit(os.environ.get("DIST_KV_TYPE", "dist_sync"))
        return
    if mode == "dpstep":
        run_dpstep()
        return
    kv = mx.kv.create(os.environ.get("DIST_KV_TYPE", "dist_sync"))
    if mode == "sync":
        run_sync(kv)
    elif mode == "crash":
        run_crash(kv)
    elif mode == "fit":
        run_fit(kv)
    else:
        raise SystemExit("unknown mode %s" % mode)


if __name__ == "__main__":
    main()
