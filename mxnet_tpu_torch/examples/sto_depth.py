"""Stochastic-depth residual training: the port's twin of
``example/stochastic-depth/sto_depth.py``.

    python -m mxnet_tpu_torch.examples.sto_depth [--cpu]

Each of ``--blocks`` residual blocks computes x + gate · F(x), where the
gate is a 0/1 input variable (``lr_mult=0``) redrawn every epoch with a
survival probability falling linearly with depth to ``--p-final``, and
set through ``set_params``; ``initializer.Mixed`` starts the gates at
``One`` and everything else at ``Xavier``; Adam trains the rest. At test
time the gates are their survival probabilities, and the JAX script's
assert holds the accuracy above 0.9. The data is the JAX script's
(4,096 rows around 10 prototypes, ``RandomState(0)``). It trains on
``gpu(0)`` (or ``--gpus``/``--tpus``) unless ``--cpu`` is given;
``main(argv)`` returns the test-mode accuracy and the ms a step.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import StepTimer, device_context


def make_net(num_blocks, hidden):
    x = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(x, num_hidden=hidden, name="stem")
    h = mx.sym.Activation(h, act_type="relu")
    for i in range(num_blocks):
        # a 0/1 draw an epoch, frozen by lr_mult=0 (its shape is given:
        # broadcast cannot infer it backwards)
        gate = mx.sym.Variable("gate%d" % i, shape=(1,), lr_mult=0.0)
        f = mx.sym.FullyConnected(h, num_hidden=hidden,
                                  name="block%d_fc" % i)
        f = mx.sym.Activation(f, act_type="relu")
        h = h + mx.sym.broadcast_mul(f, mx.sym.Reshape(gate,
                                                       shape=(1, 1)))
    out = mx.sym.FullyConnected(h, num_hidden=10, name="head")
    return mx.sym.SoftmaxOutput(out, name="softmax")


def main(argv=None):
    parser = argparse.ArgumentParser(description="stochastic depth MLP")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--num-epoch", type=int, default=15)
    parser.add_argument("--blocks", type=int, default=6)
    parser.add_argument("--p-final", type=float, default=0.5)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle
    host = mx.cpu()

    rng = np.random.RandomState(0)
    n, dim = 4096, 64
    protos = rng.rand(10, dim).astype(np.float32)
    y = rng.randint(0, 10, n)
    X = protos[y] + 0.2 * rng.rand(n, dim).astype(np.float32)

    L = args.blocks
    survival = 1.0 - (np.arange(1, L + 1) / float(L)) * \
        (1.0 - args.p_final)  # linear decay, p_1≈1 .. p_L=p_final

    net = make_net(L, 64)
    gate_names = ["gate%d" % i for i in range(L)]
    it = mx.io.NDArrayIter(X, y.astype(np.float32),
                           batch_size=args.batch_size, shuffle=True,
                           label_name="softmax_label")
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    # gates start at 1 (every branch alive); Mixed routes them past the
    # weight initializer's name patterns
    mod.init_params(mx.initializer.Mixed(
        ["gate.*", ".*"], [mx.initializer.One(), mx.initializer.Xavier()]))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.002})
    metric = mx.metric.Accuracy()
    timer = StepTimer(ctx)
    for epoch in range(args.num_epoch):
        gates = (rng.rand(L) < survival).astype(np.float32)
        arg, aux = mod.get_params()
        arg = dict(arg)
        for nm, g in zip(gate_names, gates):
            arg[nm] = mx.nd.array(np.array([g], np.float32), ctx=host)
        mod.set_params(arg, aux, allow_missing=True)
        it.reset()
        metric.reset()
        with timer:
            for b in it:
                mod.forward_backward(b)
                mod.update()
                mod.update_metric(metric, b.label)
                timer.steps += 1
        logging.info("epoch %d gates=%s acc=%.3f", epoch,
                     gates.astype(int).tolist(), metric.get()[1])

    # inference: the gates at their survival probabilities
    arg, aux = mod.get_params()
    arg = dict(arg)
    for nm, p in zip(gate_names, survival):
        arg[nm] = mx.nd.array(np.array([p], np.float32), ctx=host)
    mod.set_params(arg, aux, allow_missing=True)
    it.reset()
    metric.reset()
    for b in it:
        mod.forward(b, is_train=False)
        mod.update_metric(metric, b.label)
    acc = metric.get()[1]
    print("test-mode accuracy (expected gates): %.3f" % acc)
    assert acc > 0.9, "stochastic-depth net should classify"
    return {"accuracy": acc, "module": mod, "ms_per_step": timer.ms_per_step,
            "steps": timer.steps}


if __name__ == "__main__":
    main()
