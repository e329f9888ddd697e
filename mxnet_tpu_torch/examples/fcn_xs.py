"""Fully-convolutional segmentation, FCN-8s style: the port's twin of
``example/fcn-xs/fcn_xs.py``.

    python -m mxnet_tpu_torch.examples.fcn_xs [--cpu]

The JAX script's net: a conv encoder, a 1×1 score head, a learnable 2×
``Deconvolution`` back to the input size, ``Crop`` to the data's shape
and a per-pixel softmax (``multi_output``), trained through ``fit``
(Adam, lr 0.01, 10 epochs) on its synthetic task (bright rectangles to
segment, ``RandomState(0)``). The JAX script's assert holds the pixel
accuracy above 0.95 and the foreground IoU above 0.5. It trains on
``gpu(0)`` (or ``--gpus``/``--tpus``) unless ``--cpu`` is given;
``main(argv)`` returns the accuracy, the IoU, the module and the ms a
step.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import (EpochClock, card_sync,
                                             device_context)


def make_fcn(num_classes):
    data = mx.sym.Variable("data")
    c1 = mx.sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=8,
                            name="conv1")
    a1 = mx.sym.Activation(c1, act_type="relu")
    p1 = mx.sym.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                        name="pool1")
    c2 = mx.sym.Convolution(p1, kernel=(3, 3), pad=(1, 1), num_filter=16,
                            name="conv2")
    a2 = mx.sym.Activation(c2, act_type="relu")
    # 1x1 score head, then learnable 2x upsampling back to input size
    score = mx.sym.Convolution(a2, kernel=(1, 1), num_filter=num_classes,
                               name="score")
    up = mx.sym.Deconvolution(score, kernel=(4, 4), stride=(2, 2),
                              num_filter=num_classes, adj=(0, 0),
                              name="up2")
    crop = mx.sym.Crop(up, data, num_args=2, name="crop")
    return mx.sym.SoftmaxOutput(crop, multi_output=True, name="softmax")


def main(argv=None):
    parser = argparse.ArgumentParser(description="FCN segmentation")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-epoch", type=int, default=10)
    parser.add_argument("--img", type=int, default=32)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle

    rng = np.random.RandomState(0)
    n, img = 512, args.img
    X = rng.rand(n, 1, img, img).astype(np.float32) * 0.2
    Y = np.zeros((n, img, img), np.float32)
    for i in range(n):
        r, c = rng.randint(4, img - 12, 2)
        h, w = rng.randint(6, 12, 2)
        X[i, 0, r:r + h, c:c + w] += 0.8
        Y[i, r:r + h, c:c + w] = 1.0

    it = mx.io.NDArrayIter(X, Y, batch_size=args.batch_size, shuffle=True,
                           label_name="softmax_label")
    mod = mx.mod.Module(make_fcn(2), context=ctx)
    clock = EpochClock(card_sync(ctx))
    mod.fit(it, num_epoch=args.num_epoch, optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            initializer=mx.initializer.Xavier(),
            batch_end_callback=clock.batch_end,
            epoch_end_callback=clock.epoch_end)

    # pixel accuracy on a held-out-style pass
    it.reset()
    b = next(it)
    mod.forward(b, is_train=False)
    pred = mod.get_outputs()[0].asnumpy().argmax(axis=1)
    label = b.label[0].asnumpy()
    acc = float((pred == label).mean())
    iou = float(((pred == 1) & (label == 1)).sum() /
                max(1, ((pred == 1) | (label == 1)).sum()))
    print("pixel accuracy %.3f  foreground IoU %.3f" % (acc, iou))
    assert acc > 0.95 and iou > 0.5, "FCN should segment the squares"
    rows = clock.rows
    return {"accuracy": acc, "iou": iou, "module": mod,
            "ms_per_step": sum(r["ms_per_step"] for r in rows) / len(rows),
            "steps": sum(r["batches"] for r in rows)}


if __name__ == "__main__":
    main()
