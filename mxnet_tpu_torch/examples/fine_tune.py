"""Fine-tune a pretrained checkpoint on a new task: the port's twin of
``example/image-classification/fine_tune.py`` (the reference's
fine-tune.py: ``get_fine_tune_model`` + fit with a loaded symbol and
parameters).

    python -m mxnet_tpu_torch.examples.fine_tune [--cpu]
        [--batch-size 128] [--pretrain-epochs 6] [--tune-epochs 35]

Pretrain a small net on task A, save a checkpoint, chop the head off
through ``get_internals()``, attach a fresh FC for task B's classes,
warm-start the trunk from the checkpoint (``init_params(...,
allow_missing=True)`` for the new head), and train with
``fit(force_init=False)``. The tasks are the JAX script's synthetic ones:
A is 10-way prototype classification, B a 4-way superclass relabelling
of A's classes, so the pretrained trunk's features are discriminative for
B by construction. The script's two asserts check the workflow: the
trunk weights carry over, and the warm-started model trains above 0.85
accuracy on task B.

As every entry point of the port, it runs on ``gpu(0)`` (or the card of
``--gpus``/``--tpus``) unless ``--cpu`` is given. ``main(argv)`` returns
the task-B accuracy.
"""
import argparse
import logging
import os
import shutil
import tempfile

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import device_context


def make_net(num_classes):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=64, name="fc1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(h, num_hidden=32, name="fc2")
    h = mx.sym.Activation(h, act_type="relu", name="relu2")
    out = mx.sym.FullyConnected(h, num_hidden=num_classes, name="fc_out")
    return mx.sym.SoftmaxOutput(out, name="softmax")


def get_fine_tune_model(symbol, arg_params, num_classes,
                        layer_name="relu2"):
    """The trunk up to ``layer_name`` with a fresh head; the old head's
    parameters dropped from the warm-start dict."""
    all_layers = symbol.get_internals()
    net = all_layers[layer_name + "_output"]
    net = mx.sym.FullyConnected(net, num_hidden=num_classes,
                                name="fc_new")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    new_args = {k: v for k, v in arg_params.items()
                if not k.startswith("fc_out")}
    return net, new_args


def make_data(rng, protos, n, noise=0.2):
    y = rng.randint(0, len(protos), n)
    X = protos[y] + noise * rng.rand(n, protos.shape[1]).astype(
        np.float32)
    return X, y.astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description="fine-tune demo")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--pretrain-epochs", type=int, default=6)
    parser.add_argument("--tune-epochs", type=int, default=35)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)

    rng = np.random.RandomState(0)
    mx.random.seed(0)   # the initializers' draws and the iterators' shuffle
    dim = 64
    basis = rng.rand(16, dim).astype(np.float32)
    protos_a = basis[rng.randint(0, 16, (10, 4))].sum(axis=1)

    # --- pretrain on task A and checkpoint ---------------------------
    Xa, ya = make_data(rng, protos_a, 4096)
    ita = mx.io.NDArrayIter(Xa, ya, batch_size=args.batch_size,
                            shuffle=True, label_name="softmax_label")
    mod = mx.mod.Module(make_net(10), context=ctx)
    mod.fit(ita, num_epoch=args.pretrain_epochs, optimizer="adam",
            optimizer_params={"learning_rate": 0.002},
            initializer=mx.initializer.Xavier())
    tmp = tempfile.mkdtemp(prefix="finetune_")
    try:
        prefix = os.path.join(tmp, "taskA")
        mod.save_checkpoint(prefix, args.pretrain_epochs)

        # --- load, swap head, warm-start, fine-tune on task B --------
        symbol, arg_params, aux_params = mx.model.load_checkpoint(
            prefix, args.pretrain_epochs, ctx=ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    net, warm_args = get_fine_tune_model(symbol, arg_params, 4)

    # few-shot task B: 4 superclasses of A, heavier noise
    yb_fine = rng.randint(0, 10, 128)
    Xb = protos_a[yb_fine] + 0.5 * rng.rand(128, dim).astype(np.float32)
    yb = (yb_fine % 4).astype(np.float32)
    itb = mx.io.NDArrayIter(Xb, yb, batch_size=64, shuffle=True,
                            label_name="softmax_label")
    tuned = mx.mod.Module(net, context=ctx)
    tuned.bind(data_shapes=itb.provide_data,
               label_shapes=itb.provide_label)
    tuned.init_params(mx.initializer.Xavier(), arg_params=warm_args,
                      aux_params=aux_params, allow_missing=True)
    # the checkpointed trunk must actually be in the bound module
    got = tuned.get_params()[0]["fc1_weight"].asnumpy()
    want = arg_params["fc1_weight"].asnumpy()
    assert np.allclose(got, want), "trunk weights were not transferred"

    metric = mx.metric.Accuracy()
    # the parameters are warm-initialised (and asserted) above, so fit
    # must not initialise them again: force_init=False trains that state
    tuned.fit(itb, num_epoch=args.tune_epochs, optimizer="adam",
              optimizer_params={"learning_rate": 0.002},
              initializer=mx.initializer.Xavier(),
              eval_metric=metric, force_rebind=False, force_init=False)
    warm_acc = metric.get()[1]

    print("fine-tuned accuracy on task B: %.3f" % warm_acc)
    assert warm_acc > 0.85, "warm-started model should master task B"
    return warm_acc


if __name__ == "__main__":
    main()
