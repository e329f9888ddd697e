"""Elastic training over virtual hosts, in one process: the port's twin of
``example/distributed-training/elastic_virtual_hosts.py``.

    python -m mxnet_tpu_torch.examples.elastic_virtual_hosts [--cpu]
        [--num-epochs 3] [--network mlp|resnet-20]

Trains over a 4-host virtual cluster (``dist.VirtualCluster``: each
host's rows cut with ``shard_rows``, the global batch assembled on the
one device), kills two hosts mid-training and watches
``dist.ElasticTrainer`` resume from the last committed checkpoint at
width 2; then asserts, as the JAX script does, that the resumed
trajectory is bit for bit that of a fresh width-2 run started from the
same committed step, and (for the MLP, the JAX script's net) that the
final train accuracy is above 0.9. Prints ``ELASTIC_DEMO_OK``.

Differences from the JAX script: the twin trains on ``gpu(0)`` (or the
card of ``--gpus``/``--tpus``) unless ``--cpu`` is given; its virtual
hosts have one virtual device each (width 4, then 2, where the JAX
script's 8 virtual CPU devices give 8, then 4); ``--network resnet-20``
trains the CIFAR twin's resnet-20 (28² crops) on class-centred images
instead of the MLP. ``main(argv)`` returns the run's results.
"""
import argparse
import hashlib
import os
import shutil
import tempfile

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import dist, models
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.examples.common import device_context

IMAGE = (3, 28, 28)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--checkpoint-every", type=int, default=4)
    p.add_argument("--fail-at-step", type=int, default=14)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--network", default="mlp", choices=["mlp", "resnet-20"])
    p.add_argument("--tpus", "--gpus", dest="tpus", default=None)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def make_data(seed=0, rows=512, shape=(16,)):
    """Separable synthetic 10-class problem (learnable in 3 epochs): the
    JAX script's data at ``shape`` (16,); images at ``IMAGE``."""
    rng = np.random.RandomState(seed)
    dim = int(np.prod(shape))
    centers = rng.randn(10, dim).astype(np.float32) * 2.0
    y = rng.randint(0, 10, rows).astype(np.float32)
    X = centers[y.astype(int)] + rng.randn(rows, dim).astype(np.float32)
    return X.reshape((rows,) + tuple(shape)), y


def make_net(network):
    if network == "resnet-20":
        return models.get_symbol("resnet-20", num_classes=10,
                                 image_shape=IMAGE)
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=64, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def digest(mod):
    h = hashlib.sha256()
    arg_params, aux_params = mod.get_params()
    for k in sorted(arg_params):
        h.update(arg_params[k].asnumpy().tobytes())
    for k in sorted(aux_params):
        h.update(aux_params[k].asnumpy().tobytes())
    return h.hexdigest()


def main(argv=None):
    args = parse_args(argv)
    ctx = device_context(args)
    X, y = make_data(shape=IMAGE if args.network == "resnet-20" else (16,))

    def make_iter():
        return mx.io.NDArrayIter(X, y, batch_size=args.batch_size,
                                 label_name="softmax_label")

    def module_factory(world):
        return mx.mod.Module(make_net(args.network),
                             context=world.contexts())

    def data_factory(world):
        return world.feed(make_iter())

    fit_kw = dict(optimizer="sgd",
                  optimizer_params={"learning_rate": args.lr,
                                    "momentum": 0.9},
                  initializer=mx.initializer.Xavier())

    tmp = tempfile.mkdtemp(prefix="elastic_demo_")
    try:
        cluster = dist.VirtualCluster(4, context=ctx)
        print("cluster: %d hosts x %d devices -> dp=%d"
              % (cluster.n_hosts, len(cluster.hosts[0]),
                 cluster.device_count))
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        mx.random.seed(3)
        np.random.seed(3)
        trainer = dist.ElasticTrainer(
            cluster, module_factory, data_factory, mgr,
            checkpoint_every_steps=args.checkpoint_every)
        mod = trainer.fit(num_epoch=args.num_epochs,
                          inject_fault=(args.fail_at_step, (2, 3)),
                          **fit_kw)
        for e in trainer.transcript:
            print("attempt %d: dp=%d %s (resume step %s)"
                  % (e["attempt"], e["dp_width"], e["event"],
                     e["resume_step"]))
        d_elastic = digest(mod)

        # the contract: bit for bit a continuous run at the surviving
        # width from the same committed step
        done = [e for e in trainer.transcript
                if e["event"] == "finished"][0]
        resume_step = done["resume_step"]
        base = os.path.join(tmp, "baseline")
        shutil.copytree(
            os.path.join(tmp, "ckpt", "step_%08d" % resume_step),
            os.path.join(base, "step_%08d" % resume_step))
        survivors = dist.VirtualCluster(4, context=ctx).shrink((2, 3))
        mod2 = module_factory(survivors)
        mod2.fit(data_factory(survivors), num_epoch=args.num_epochs,
                 resume_from=CheckpointManager(base), **fit_kw)
        assert digest(mod2) == d_elastic, \
            "elastic resume diverged from the continuous run"
        print("elastic == continuous: bitwise OK (sha256 %s...)"
              % d_elastic[:16])

        acc = mod.score(data_factory(trainer.world), "acc")[0][1]
        print("final train accuracy: %.3f" % acc)
        if args.network == "mlp":
            assert acc > 0.90, "did not learn: acc=%.3f" % acc
        print("ELASTIC_DEMO_OK")
        return {"digest": d_elastic, "accuracy": acc,
                "resume_step": resume_step,
                "transcript": trainer.transcript,
                "num_update": mod._optimizer.num_update}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
