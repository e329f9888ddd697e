"""A softmax loss written as a Python operator: the port's twin of
``example/numpy-ops/custom_softmax.py``.

    python -m mxnet_tpu_torch.examples.custom_softmax [--cpu]

``Softmax`` (a ``mx.operator.CustomOp``) computes the softmax and its
gradient in numpy; registered as ``demo_softmax`` it heads a 64-relu-10
MLP through ``mx.sym.Custom``, and the same MLP with the built-in
``SoftmaxOutput`` trains beside it on the JAX script's prototype data
(2,048 rows, ``RandomState(0)``). The JAX script's assert: the custom
net's accuracy above 0.9 and within 0.1 of the built-in's. The op's
forward and backward run on the host (``operator.py``): each call copies
its inputs off the card and its results back. It trains on ``gpu(0)``
(or ``--gpus``/``--tpus``) unless ``--cpu`` is given; ``main(argv)``
returns both accuracies and fit ms a step.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import StepTimer, device_context


class Softmax(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0].asnumpy()
        e = np.exp(x - x.max(axis=1, keepdims=True))
        self.assign(out_data[0], req[0], mx.nd.array(
            e / e.sum(axis=1, keepdims=True), ctx=mx.cpu()))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        lab = in_data[1].asnumpy().ravel().astype(np.int32)
        y = out_data[0].asnumpy().copy()
        y[np.arange(lab.shape[0]), lab] -= 1.0
        # no batch normalization — SoftmaxOutput's default
        # normalization='null', so both heads train at the same rate
        self.assign(in_grad[0], req[0], mx.nd.array(y, ctx=mx.cpu()))


@mx.operator.register("demo_softmax")
class SoftmaxProp(mx.operator.CustomOpProp):
    def __init__(self):
        super(SoftmaxProp, self).__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return Softmax()


def make_net(use_custom):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=64, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=10, name="fc2")
    if use_custom:
        label = mx.sym.Variable("softmax_label")
        return mx.sym.Custom(data=h, label=label, op_type="demo_softmax",
                             name="softmax")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def make_data():
    rng = np.random.RandomState(0)
    n, dim = 2048, 64
    protos = rng.rand(10, dim).astype(np.float32)
    y = rng.randint(0, 10, n)
    X = protos[y] + 0.2 * rng.rand(n, dim).astype(np.float32)
    return X, y


def run(use_custom, X, y, args, ctx):
    mx.random.seed(0)      # both nets from the same draws
    it = mx.io.NDArrayIter(X, y.astype(np.float32),
                           batch_size=args.batch_size, shuffle=True,
                           label_name="softmax_label")
    mod = mx.mod.Module(make_net(use_custom), context=ctx)
    metric = mx.metric.Accuracy()
    with StepTimer(ctx) as timer:
        mod.fit(it, num_epoch=args.num_epoch, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                initializer=mx.initializer.Xavier(), eval_metric=metric)
    timer.steps = args.num_epoch * -(-len(X) // args.batch_size)
    return metric.get()[1], timer


def main(argv=None):
    parser = argparse.ArgumentParser(description="CustomOp softmax demo")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--num-epoch", type=int, default=6)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    X, y = make_data()
    acc_custom, timer = run(True, X, y, args, ctx)
    acc_builtin, builtin = run(False, X, y, args, ctx)
    print("custom-op accuracy %.3f, built-in accuracy %.3f"
          % (acc_custom, acc_builtin))
    assert acc_custom > 0.9 and abs(acc_custom - acc_builtin) < 0.1
    return {"accuracy": acc_custom, "accuracy_builtin": acc_builtin,
            "ms_per_step": timer.ms_per_step, "steps": timer.steps,
            "ms_per_step_builtin": builtin.ms_per_step}


if __name__ == "__main__":
    main()
