"""Multi-task training: the port's twin of
``example/multi-task/multitask.py``.

    python -m mxnet_tpu_torch.examples.multitask [--cpu]

One trunk and two softmax heads (the digit class and its parity),
grouped with ``mx.sym.Group`` and trained through one Module with two
labels, scored by a custom ``EvalMetric`` with ``num=2`` (a host metric)
on the JAX script's prototype data (4,096 rows, ``RandomState(0)``).
The JAX script's assert: both heads' accuracy above 0.9. It trains on
``gpu(0)`` (or ``--gpus``/``--tpus``) unless ``--cpu`` is given;
``main(argv)`` returns both accuracies and fit ms a step.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import StepTimer, device_context


def make_net():
    x = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(x, num_hidden=64, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    digit = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(h, num_hidden=10, name="fc_digit"),
        name="digit")
    parity = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(h, num_hidden=2, name="fc_parity"),
        name="parity")
    return mx.sym.Group([digit, parity])


class MultiAccuracy(mx.metric.EvalMetric):
    """Per-head accuracy through the base class's multi-output mode."""

    def __init__(self):
        super(MultiAccuracy, self).__init__("acc", num=2)

    def update(self, labels, preds):
        for i in range(self.num):
            pred = preds[i].asnumpy().argmax(axis=1)
            label = labels[i].asnumpy().astype(int)
            self.sum_metric[i] += float((pred == label).sum())
            self.num_inst[i] += len(label)


def main(argv=None):
    parser = argparse.ArgumentParser(description="multi-task training")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--num-epoch", type=int, default=25)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle

    rng = np.random.RandomState(0)
    n, dim = 4096, 64
    protos = rng.rand(10, dim).astype(np.float32)
    y = rng.randint(0, 10, n)
    X = protos[y] + 0.2 * rng.rand(n, dim).astype(np.float32)
    y_par = (y % 2).astype(np.float32)

    it = mx.io.NDArrayIter(
        X, {"digit_label": y.astype(np.float32), "parity_label": y_par},
        batch_size=args.batch_size, shuffle=True)
    mod = mx.mod.Module(make_net(),
                        label_names=("digit_label", "parity_label"),
                        context=ctx)
    metric = MultiAccuracy()
    with StepTimer(ctx) as timer:
        mod.fit(it, num_epoch=args.num_epoch, optimizer="sgd",
                optimizer_params={"learning_rate": 0.2},
                initializer=mx.initializer.Xavier(), eval_metric=metric)
    timer.steps = args.num_epoch * -(-n // args.batch_size)
    names, accs = metric.get()
    print(" ".join("%s=%.3f" % (nm, v) for nm, v in zip(names, accs)))
    assert min(accs) > 0.9, "both heads should learn"
    return {"accuracy": accs, "module": mod,
            "ms_per_step": timer.ms_per_step, "steps": timer.steps}


if __name__ == "__main__":
    main()
