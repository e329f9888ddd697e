"""The Module API walkthrough: the port's twin of
``example/module/mnist_mlp.py``.

    python -m mxnet_tpu_torch.examples.mnist_mlp [--cpu]

On the JAX script's prototype data (4,096 rows of 64 features around 10
prototypes, ``RandomState(0)``) it trains a 64-relu-10 MLP three ways:
(1) the fit loop written out (bind, init_params, init_optimizer,
forward, backward, update, update_metric), (2) a checkpoint saved and
``Module.load``-ed, then scored, and (3) a ``SequentialModule`` of a
feature module and a head module (``take_labels``, ``auto_wiring``)
through ``fit``. Each must pass the JAX script's assert (accuracy above
0.95). It trains on ``gpu(0)`` (or ``--gpus``/``--tpus``) unless
``--cpu`` is given; ``main(argv)`` returns the three accuracies, the
sequential module and its fit ms a step.
"""
import argparse
import logging
import os
import tempfile

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import StepTimer, device_context


def make_data(rng, n=4096, dim=64):
    protos = rng.rand(10, dim).astype(np.float32)
    y = rng.randint(0, 10, n)
    X = protos[y] + 0.2 * rng.rand(n, dim).astype(np.float32)
    return X, y.astype(np.float32)


def make_net():
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=64, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Module API tour")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--num-epoch", type=int, default=6)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle
    rng = np.random.RandomState(0)
    X, y = make_data(rng)
    it = mx.io.NDArrayIter(X, y, batch_size=args.batch_size, shuffle=True,
                           label_name="softmax_label")

    # --- 1. the fit loop, written out --------------------------------
    mod = mx.mod.Module(make_net(), context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    metric = mx.metric.Accuracy()
    for epoch in range(args.num_epoch):
        it.reset()
        metric.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            mod.update_metric(metric, batch.label)
        logging.info("epoch %d train-acc %.3f", epoch, metric.get()[1])
    assert metric.get()[1] > 0.95

    # --- 2. checkpoint + resume --------------------------------------
    tmp = tempfile.mkdtemp(prefix="module_demo_")
    prefix = os.path.join(tmp, "mlp")
    mod.save_checkpoint(prefix, args.num_epoch)
    resumed = mx.mod.Module.load(prefix, args.num_epoch, context=ctx)
    resumed.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
    score = resumed.score(it, mx.metric.Accuracy())
    acc = dict(score)["accuracy"]
    logging.info("resumed score %.3f", acc)
    assert acc > 0.95

    # --- 3. SequentialModule composition ------------------------------
    feat = mx.sym.Variable("data")
    feat = mx.sym.FullyConnected(feat, num_hidden=64, name="fc1")
    feat = mx.sym.Activation(feat, act_type="relu", name="feat_out")
    head = mx.sym.Variable("data")
    head = mx.sym.FullyConnected(head, num_hidden=10, name="fc2")
    head = mx.sym.SoftmaxOutput(head, name="softmax")
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(feat, label_names=(), context=ctx))
    seq.add(mx.mod.Module(head, context=ctx), take_labels=True,
            auto_wiring=True)
    metric2 = mx.metric.Accuracy()
    with StepTimer(ctx) as timer:
        seq.fit(it, num_epoch=args.num_epoch, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                initializer=mx.initializer.Xavier(), eval_metric=metric2)
    timer.steps = args.num_epoch * -(-len(X) // args.batch_size)
    logging.info("sequential train-acc %.3f", metric2.get()[1])
    assert metric2.get()[1] > 0.95

    print("module walkthrough OK: imperative %.3f resumed %.3f seq %.3f"
          % (metric.get()[1], acc, metric2.get()[1]))
    return {"accuracy": metric.get()[1], "resumed_accuracy": acc,
            "sequential_accuracy": metric2.get()[1], "module": seq,
            "ms_per_step": timer.ms_per_step, "steps": timer.steps}


if __name__ == "__main__":
    main()
