"""An MLP autoencoder: the port's twin of
``example/autoencoder/autoencoder.py``.

    python -m mxnet_tpu_torch.examples.autoencoder [--cpu]

A 64-32-4-32-64 encoder-decoder (``LinearRegressionOutput``, the input
as its own target) trains through ``fit`` with Adam on the JAX script's
rank-4 data (2,048 rows of 64, ``RandomState(0)``), scored by
``metric.MSE`` (a host metric: each batch's outputs are read back) with
a ``Speedometer``. The JAX script's assert: the training MSE below a
quarter of the data's power. It trains on ``gpu(0)`` (or
``--gpus``/``--tpus``) unless ``--cpu`` is given; ``main(argv)``
returns the MSE, the data power and fit ms a step.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import StepTimer, device_context


def make_ae(dims):
    x = mx.sym.Variable("data")
    h = x
    for i, d in enumerate(dims[1:]):
        h = mx.sym.FullyConnected(h, num_hidden=d, name="enc%d" % i)
        h = mx.sym.Activation(h, act_type="relu")
    for i, d in enumerate(reversed(dims[:-1])):
        h = mx.sym.FullyConnected(h, num_hidden=d, name="dec%d" % i)
        if i < len(dims) - 2:
            h = mx.sym.Activation(h, act_type="relu")
    return mx.sym.LinearRegressionOutput(h, name="rec")


def main(argv=None):
    parser = argparse.ArgumentParser(description="train an autoencoder")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-epoch", type=int, default=10)
    parser.add_argument("--lr", type=float, default=0.005)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle

    rng = np.random.RandomState(0)
    n, dim, rank = 2048, 64, 4
    basis = rng.randn(rank, dim).astype(np.float32)
    codes = rng.randn(n, rank).astype(np.float32)
    X = codes @ basis + 0.01 * rng.randn(n, dim).astype(np.float32)

    it = mx.io.NDArrayIter(X, X.copy(), batch_size=args.batch_size,
                           shuffle=True, label_name="rec_label")
    mod = mx.mod.Module(make_ae([dim, 32, rank]),
                        label_names=("rec_label",), context=ctx)
    metric = mx.metric.MSE()
    with StepTimer(ctx) as timer:
        mod.fit(it, num_epoch=args.num_epoch, optimizer="adam",
                optimizer_params={"learning_rate": args.lr},
                initializer=mx.initializer.Xavier(), eval_metric=metric,
                batch_end_callback=mx.callback.Speedometer(args.batch_size,
                                                           frequent=50))
    timer.steps = args.num_epoch * -(-n // args.batch_size)
    mse = metric.get()[1]
    base = float((X ** 2).mean())
    print("reconstruction MSE %.4f (data power %.4f)" % (mse, base))
    assert mse < 0.25 * base, "autoencoder failed to learn"
    return {"mse": mse, "data_power": base, "module": mod,
            "ms_per_step": timer.ms_per_step, "steps": timer.steps}


if __name__ == "__main__":
    main()
