"""Fast Gradient Sign Method adversarial examples: the port's twin of
``example/adversary/fgsm.py``.

    python -m mxnet_tpu_torch.examples.fgsm [--cpu]

A 64-relu-10 MLP trains through ``fit`` on the JAX script's prototype
data (4,096 rows, ``RandomState(0)``), on the fused route. A second
module bound with ``inputs_need_grad=True`` (which takes the classic
route) receives its parameters, and every input is moved by
``--epsilon`` along the sign of the loss gradient with respect to the
data (``get_input_grads``). The JAX script's assert: clean accuracy
above 0.9 and the adversarial accuracy at least 0.2 below it. The twin
also re-binds the trained module itself with ``inputs_need_grad=True``:
it must leave the fused route for the classic one with its trained
parameters, bit for bit those the second module received. It trains on
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
    h = mx.sym.FullyConnected(h, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def accuracy(mod, X, y, batch, ctx):
    correct = 0
    for i in range(0, len(X), batch):
        xb = mx.nd.array(X[i:i + batch], ctx=ctx)
        mod.forward(mx.io.DataBatch(data=[xb], label=[]), is_train=False)
        pred = mod.get_outputs()[0].asnumpy().argmax(axis=1)
        correct += int((pred == y[i:i + batch]).sum())
    return correct / float(len(X))


def rebind_check(mod, adv, shapes):
    """Re-bind the trained (fused) module with inputs_need_grad: classic
    route, the trained parameters carried across bit for bit."""
    fused = type(mod._exec_group).__name__
    mod.bind(data_shapes=shapes[0], label_shapes=shapes[1],
             inputs_need_grad=True, force_rebind=True)
    classic = type(mod._exec_group).__name__
    mine, theirs = mod.get_params()[0], adv.get_params()[0]
    same = all(np.array_equal(mine[k].asnumpy(), theirs[k].asnumpy())
               for k in theirs)
    assert fused == "MeshExecutorGroup" and \
        classic == "DataParallelExecutorGroup" and same, \
        (fused, classic, same)
    return {"route_before": fused, "route_after": classic,
            "params_carried": same}


def main(argv=None):
    parser = argparse.ArgumentParser(description="FGSM demo")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--num-epoch", type=int, default=8)
    parser.add_argument("--epsilon", type=float, default=0.3)
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

    it = mx.io.NDArrayIter(X, y.astype(np.float32),
                           batch_size=args.batch_size, shuffle=True,
                           label_name="softmax_label")
    mod = mx.mod.Module(make_net(), context=ctx)
    with StepTimer(ctx) as timer:
        mod.fit(it, num_epoch=args.num_epoch, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                initializer=mx.initializer.Xavier())
    timer.steps = args.num_epoch * -(-n // args.batch_size)

    # bind again with inputs_need_grad to reach d(loss)/d(data)
    shapes = ([("data", (args.batch_size, dim))],
              [("softmax_label", (args.batch_size,))])
    adv = mx.mod.Module(make_net(), context=ctx)
    adv.bind(data_shapes=shapes[0], label_shapes=shapes[1],
             inputs_need_grad=True)
    adv.set_params(*mod.get_params())

    clean_acc = accuracy(adv, X, y, args.batch_size, ctx)

    X_adv = X.copy()
    for i in range(0, n, args.batch_size):
        xb = mx.nd.array(X[i:i + args.batch_size], ctx=ctx)
        yb = mx.nd.array(y[i:i + args.batch_size].astype(np.float32),
                         ctx=ctx)
        adv.forward(mx.io.DataBatch(data=[xb], label=[yb]), is_train=True)
        adv.backward()
        g = adv.get_input_grads()[0].asnumpy()
        X_adv[i:i + args.batch_size] += args.epsilon * np.sign(g)

    adv_acc = accuracy(adv, X_adv, y, args.batch_size, ctx)
    print("clean accuracy %.3f -> adversarial accuracy %.3f (eps=%.2f)"
          % (clean_acc, adv_acc, args.epsilon))
    assert clean_acc > 0.9 and adv_acc < clean_acc - 0.2, \
        "FGSM should collapse accuracy"
    rebind = rebind_check(mod, adv, shapes)
    return {"accuracy": clean_acc, "adversarial_accuracy": adv_acc,
            "rebind": rebind, "ms_per_step": timer.ms_per_step,
            "steps": timer.steps}


if __name__ == "__main__":
    main()
