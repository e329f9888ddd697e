"""An MLP built from TorchModule layers: the port's twin of
``example/torch/torch_module.py``.

    python -m mxnet_tpu_torch.examples.torch_module [--use-torch-criterion]
        [--cpu]

The same symbols as the JAX script: ``nn.Linear``/``nn.ReLU`` layers
through the ``TorchModule`` op, which in the port runs the PyTorch
module where the graph's tensors are (on the card, with autograd
through it), and ``--use-torch-criterion`` swaps the SoftmaxOutput head
for ``nn.LogSoftmax`` + ``nn.NLLLoss`` through ``TorchCriterion``. The
JAX script's synthetic 8x8 "digits" and its assert: train accuracy above
0.8. It trains on ``gpu(0)`` (or ``--gpus``/``--tpus``) unless ``--cpu``
is given; ``main(argv)`` returns the accuracy and the module.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import device_context


def mlp_symbol(use_torch_criterion):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.TorchModule(data_0=data, lua_string="nn.Linear(64, 32)",
                             num_data=1, num_params=2, num_outputs=1,
                             name="fc1")
    act1 = mx.sym.TorchModule(data_0=fc1, lua_string="nn.ReLU()",
                              num_data=1, num_params=0, num_outputs=1,
                              name="relu1")
    fc2 = mx.sym.TorchModule(data_0=act1, lua_string="nn.Linear(32, 10)",
                             num_data=1, num_params=2, num_outputs=1,
                             name="fc2")
    if use_torch_criterion:
        logsoftmax = mx.sym.TorchModule(
            data_0=fc2, lua_string="nn.LogSoftmax(dim=1)", num_data=1,
            num_params=0, num_outputs=1, name="logsoftmax")
        return mx.sym.TorchCriterion(
            data=logsoftmax, label=mx.sym.Variable("softmax_label"),
            lua_string="nn.NLLLoss()", name="softmax")
    return mx.sym.SoftmaxOutput(data=fc2, name="softmax")


def main(argv=None):
    parser = argparse.ArgumentParser(description="torch-layer MLP")
    parser.add_argument("--num-epoch", type=int, default=15)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--use-torch-criterion", action="store_true")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    np.random.seed(0)
    mx.random.seed(0)

    # synthetic 8x8 "digits": class = argmax over 10 fixed projections
    X = np.random.rand(512, 64).astype(np.float32)
    W = np.random.RandomState(1).rand(64, 10).astype(np.float32)
    y = (X @ W).argmax(axis=1).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=args.batch_size, shuffle=True,
                           label_name="softmax_label")

    mlp = mlp_symbol(args.use_torch_criterion)
    mod = mx.mod.Module(mlp, context=ctx)
    mod.fit(it, num_epoch=args.num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2, "momentum": 0.9,
                              "wd": 1e-5},
            initializer=mx.initializer.Xavier(),
            batch_end_callback=mx.callback.Speedometer(args.batch_size,
                                                       50))

    # score with the plain softmax head (the criterion outputs a loss)
    score_mod = mod
    if args.use_torch_criterion:
        score_mod = mx.mod.Module(mlp_symbol(False), context=ctx)
        score_mod.bind(data_shapes=it.provide_data,
                       label_shapes=it.provide_label, for_training=False)
        score_mod.set_params(*mod.get_params())
    it.reset()
    acc = dict(score_mod.score(it, "acc"))["accuracy"]
    print("train accuracy: %.4f" % acc)
    assert acc > 0.8, "torch-layer MLP failed to learn (acc %.3f)" % acc
    return {"accuracy": float(acc), "module": mod}


if __name__ == "__main__":
    main()
