"""Train MNIST: the port's twin of ``example/image-classification/
train_mnist.py``.

    python -m mxnet_tpu_torch.examples.train_mnist [--network lenet] [--cpu]

Uses real MNIST idx files (plain or gzipped) when ``--data-dir`` has
them, else the JAX script's synthetic MNIST-shaped data. Unlike the JAX
script, which trains on the CPU unless ``--tpus`` is given, the twin
trains on ``gpu(0)`` (or ``--gpus``/``--tpus``) unless ``--cpu`` is given,
as every entry point of the port does.
"""
import argparse
import logging
import os

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models
from mxnet_tpu_torch.examples.common import (add_precision_args,
                                             check_grouped, device_context,
                                             precision_policy)


def get_iters(args):
    img_shape = (1, 28, 28) if args.network == "lenet" else (784,)
    flat = args.network != "lenet"
    train_img = os.path.join(args.data_dir, "train-images-idx3-ubyte")
    if os.path.exists(train_img) or os.path.exists(train_img + ".gz"):
        train = mx.io.MNISTIter(
            image=train_img,
            label=os.path.join(args.data_dir, "train-labels-idx1-ubyte"),
            batch_size=args.batch_size, flat=flat)
        val = mx.io.MNISTIter(
            image=os.path.join(args.data_dir, "t10k-images-idx3-ubyte"),
            label=os.path.join(args.data_dir, "t10k-labels-idx1-ubyte"),
            batch_size=args.batch_size, flat=flat)
        return train, val
    logging.warning("MNIST files not found in %s; using synthetic data",
                    args.data_dir)
    rng = np.random.RandomState(0)
    n = 2048
    protos = rng.rand(10, *img_shape).astype(np.float32)
    y = rng.randint(0, 10, n)
    X = protos[y] + rng.rand(n, *img_shape).astype(np.float32) * 0.3
    train = mx.io.NDArrayIter(X, y.astype(np.float32),
                              batch_size=args.batch_size, shuffle=True)
    val = mx.io.NDArrayIter(X[:512], y[:512].astype(np.float32),
                            batch_size=args.batch_size)
    return train, val


def main(argv=None):
    parser = argparse.ArgumentParser(description="train mnist")
    parser.add_argument("--network", default="mlp",
                        choices=["mlp", "lenet"])
    parser.add_argument("--data-dir", default="mnist/")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--model-prefix", default=None)
    add_precision_args(parser)
    args = parser.parse_args(argv)
    policy = precision_policy(parser, args)

    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    net = models.get_symbol(args.network, num_classes=10)
    train, val = get_iters(args)
    mod = mx.mod.Module(net, context=ctx, precision=policy)
    checkpoint = None
    if args.model_prefix:
        checkpoint = mx.callback.do_checkpoint(args.model_prefix)
    mod.fit(train, eval_data=val, num_epoch=args.num_epochs,
            kvstore=args.kv_store,
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            batch_end_callback=mx.callback.Speedometer(args.batch_size, 20),
            epoch_end_callback=checkpoint, batch_group=args.batch_group)
    check_grouped(mod, args.batch_group)
    score = mod.score(val, "acc")
    print("final validation:", score)
    return score


if __name__ == "__main__":
    main()
