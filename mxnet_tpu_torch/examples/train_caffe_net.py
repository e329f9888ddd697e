"""Networks described with Caffe layer prototxts, trained through the
Caffe plugin: the port's twin of ``example/caffe/train_caffe_net.py``.

    python -m mxnet_tpu_torch.examples.train_caffe_net [--network lenet]
        [--use-caffe-loss] [--cpu]

``mx.sym.CaffeOp`` lowers each prototxt layer onto the port's operators
(no libcaffe, no protobuf), so the net trains through ``Module.fit``.
The JAX script's synthetic MNIST-shaped data and its assert: validation
accuracy above 0.5. It trains on ``gpu(0)`` (or ``--gpus``/``--tpus``)
unless ``--cpu`` is given; ``main(argv)`` returns the accuracy and the
module.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import device_context


def get_mlp(use_caffe_loss):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.CaffeOp(data, num_weight=2, name="fc1",
                         prototxt='layer{type:"InnerProduct" '
                                  'inner_product_param{num_output: 128}}')
    act1 = mx.sym.CaffeOp(fc1, prototxt='layer{type:"TanH"}')
    fc2 = mx.sym.CaffeOp(act1, num_weight=2, name="fc2",
                         prototxt='layer{type:"InnerProduct" '
                                  'inner_product_param{num_output: 64}}')
    act2 = mx.sym.CaffeOp(fc2, prototxt='layer{type:"TanH"}')
    fc3 = mx.sym.CaffeOp(act2, num_weight=2, name="fc3",
                         prototxt='layer{type:"InnerProduct" '
                                  'inner_product_param{num_output: 10}}')
    if use_caffe_loss:
        label = mx.sym.Variable("softmax_label")
        return mx.plugin.CaffeLoss(fc3, label, name="softmax")
    return mx.sym.SoftmaxOutput(data=fc3, name="softmax")


def get_lenet(use_caffe_loss):
    data = mx.sym.Variable("data")
    conv1 = mx.sym.CaffeOp(data, num_weight=2, name="conv1",
                           prototxt='layer{type:"Convolution" '
                                    'convolution_param{num_output: 20 '
                                    'kernel_size: 5}}')
    pool1 = mx.sym.CaffeOp(conv1, prototxt='layer{type:"Pooling" '
                           'pooling_param{pool: MAX kernel_size: 2 '
                           'stride: 2}}')
    conv2 = mx.sym.CaffeOp(pool1, num_weight=2, name="conv2",
                           prototxt='layer{type:"Convolution" '
                                    'convolution_param{num_output: 50 '
                                    'kernel_size: 5}}')
    pool2 = mx.sym.CaffeOp(conv2, prototxt='layer{type:"Pooling" '
                           'pooling_param{pool: MAX kernel_size: 2 '
                           'stride: 2}}')
    flat = mx.sym.Flatten(data=pool2)
    fc1 = mx.sym.CaffeOp(flat, num_weight=2, name="fc1",
                         prototxt='layer{type:"InnerProduct" '
                                  'inner_product_param{num_output: 500}}')
    act = mx.sym.CaffeOp(fc1, prototxt='layer{type:"TanH"}')
    fc2 = mx.sym.CaffeOp(act, num_weight=2, name="fc2",
                         prototxt='layer{type:"InnerProduct" '
                                  'inner_product_param{num_output: 10}}')
    if use_caffe_loss:
        label = mx.sym.Variable("softmax_label")
        return mx.plugin.CaffeLoss(fc2, label, name="softmax")
    return mx.sym.SoftmaxOutput(data=fc2, name="softmax")


def synthetic_mnist(n, shape, nclass=10, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, nclass, n).astype(np.float32)
    X = rng.rand(n, *shape).astype(np.float32) * 0.1
    for i in range(n):  # a class-dependent blob, so the net can learn
        c = int(y[i])
        X[i].reshape(-1)[c::nclass] += 0.8
    return X, y


def main(argv=None):
    ap = argparse.ArgumentParser(description="Caffe-layer nets")
    ap.add_argument("--network", default="mlp", choices=["mlp", "lenet"])
    ap.add_argument("--use-caffe-loss", action="store_true")
    ap.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                    help="the card's id (one device)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--num-epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.1)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)

    shape = (784,) if args.network == "mlp" else (1, 28, 28)
    net = (get_mlp if args.network == "mlp" else get_lenet)(
        args.use_caffe_loss)
    X, y = synthetic_mnist(2048, shape)
    Xv, yv = synthetic_mnist(512, shape, seed=1)
    train = mx.io.NDArrayIter(X, y, batch_size=args.batch_size,
                              shuffle=True)
    val = mx.io.NDArrayIter(Xv, yv, batch_size=args.batch_size)

    mod = mx.mod.Module(net, context=ctx)
    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            initializer=mx.init.Xavier(), num_epoch=args.num_epochs,
            batch_end_callback=mx.callback.Speedometer(args.batch_size, 10))
    acc = dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]
    print("final validation accuracy: %.3f" % acc)
    assert acc > 0.5, "the Caffe-layer net failed to learn (acc %.3f)" % acc
    return {"accuracy": float(acc), "module": mod}


if __name__ == "__main__":
    main()
