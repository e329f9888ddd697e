"""SSD single-shot detector: the port's twin of
``example/ssd/train_ssd.py``.

    python -m mxnet_tpu_torch.examples.train_ssd [--cpu] [--use-recordio]

The JAX script's compact SSD from the detection ops: a small conv
backbone gives two feature scales (8² and 4² on 32² images); per scale,
``_contrib_MultiBoxPrior`` lays anchors and conv heads predict class
scores and box offsets; ``_contrib_MultiBoxTarget`` makes the training
targets in the graph, and ``build_detector`` decodes and suppresses with
``_contrib_MultiBoxDetection`` (greedy NMS through the hand-written
kernels on the card). It trains on the JAX script's synthetic "bright
square on a dark field" images (``RandomState(0)``), fed by
``NDArrayIter`` or, with ``--use-recordio``, packed into a detection
RecordIO and read back through ``ImageDetRecordIter`` (mirror and
constrained crops). It logs ``loc-loss`` by epoch, as the JAX script
does, which has no assert. It trains on ``gpu(0)`` (or
``--gpus``/``--tpus``) unless ``--cpu`` is given; ``main(argv)`` returns
the module, the losses by epoch and the ms a step, and ``detect`` runs
the trained parameters through ``build_detector``.
"""
import argparse
import logging
import os
import tempfile

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import StepTimer, device_context


def conv_act(data, num_filter, name, stride=(1, 1)):
    c = mx.sym.Convolution(data, kernel=(3, 3), stride=stride, pad=(1, 1),
                           num_filter=num_filter, name="conv_" + name)
    return mx.sym.Activation(c, act_type="relu", name="relu_" + name)


def multibox_layer(feat, num_classes, sizes, ratios, name):
    """Anchors + per-anchor class scores and location offsets for one
    feature scale (reference example/ssd/symbol/common.py multibox_layer)."""
    num_anchors = len(sizes) + len(ratios) - 1
    anchors = mx.sym._contrib_MultiBoxPrior(
        feat, sizes=tuple(sizes), ratios=tuple(ratios),
        name="anchors_" + name)
    cls = mx.sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                             num_filter=num_anchors * (num_classes + 1),
                             name="clspred_" + name)
    cls = mx.sym.transpose(cls, axes=(0, 2, 3, 1))
    cls = mx.sym.Reshape(cls, shape=(0, -1, num_classes + 1))
    loc = mx.sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                             num_filter=num_anchors * 4,
                             name="locpred_" + name)
    loc = mx.sym.transpose(loc, axes=(0, 2, 3, 1))
    loc = mx.sym.Reshape(loc, shape=(0, -1))
    return anchors, cls, loc


def build_ssd(num_classes=1):
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("label")
    # backbone: 32x32 -> 8x8 -> 4x4
    body = conv_act(data, 16, "1a")
    body = mx.sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                          pool_type="max", name="pool1")
    body = conv_act(body, 32, "2a")
    feat1 = mx.sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                           pool_type="max", name="pool2")   # 8x8
    feat2 = conv_act(feat1, 32, "3a", stride=(2, 2))        # 4x4

    anchors, cls_preds, loc_preds = [], [], []
    for feat, sizes, name in ((feat1, (0.3, 0.4), "s8"),
                              (feat2, (0.6, 0.8), "s4")):
        a, c, l = multibox_layer(feat, num_classes, sizes, (1.0, 2.0), name)
        anchors.append(a)
        cls_preds.append(c)
        loc_preds.append(l)
    anchors = mx.sym.Concat(*anchors, dim=1, name="anchors")
    cls_preds = mx.sym.Concat(*cls_preds, dim=1, name="cls_preds")
    loc_preds = mx.sym.Concat(*loc_preds, dim=1, name="loc_preds")

    # training branch: targets in-graph, then softmax + smooth-l1 losses
    cls_preds_t = mx.sym.transpose(cls_preds, axes=(0, 2, 1))
    target = mx.sym._contrib_MultiBoxTarget(
        anchors, label, cls_preds_t, overlap_threshold=0.5,
        negative_mining_ratio=3.0, name="target")
    loc_t, loc_mask, cls_t = target[0], target[1], target[2]
    cls_prob = mx.sym.SoftmaxOutput(cls_preds_t, cls_t, multi_output=True,
                                    use_ignore=True, ignore_label=-1.0,
                                    normalization="valid", name="cls_prob")
    loc_diff = mx.sym.smooth_l1(loc_mask * (loc_preds - loc_t), scalar=1.0)
    # normalised by the number of positive anchor coordinates: a plain
    # mean dilutes the regression gradient by the masked-out negatives
    num_pos = mx.sym.maximum(mx.sym.sum(loc_mask), 1.0)
    loc_loss = mx.sym.MakeLoss(
        mx.sym.broadcast_div(mx.sym.sum(loc_diff), num_pos),
        name="loc_loss")
    return mx.sym.Group([cls_prob, loc_loss]), anchors, cls_preds, loc_preds


def build_detector(num_classes=1):
    """Inference graph: decode + NMS via _contrib_MultiBoxDetection."""
    group, anchors, cls_preds, loc_preds = build_ssd(num_classes)
    cls_prob = mx.sym.softmax(mx.sym.transpose(cls_preds, axes=(0, 2, 1)),
                              axis=1)
    return mx.sym._contrib_MultiBoxDetection(
        cls_prob, loc_preds, anchors, nms_threshold=0.5,
        force_suppress=True, name="det")


def synth_batch(rng, n, size=32):
    """Images with one bright square; labels (n, 1, 5): [cls, x0,y0,x1,y1]."""
    imgs = rng.rand(n, 3, size, size).astype(np.float32) * 0.2
    labels = np.zeros((n, 1, 5), np.float32)
    for i in range(n):
        w = rng.randint(8, 20)
        x0, y0 = rng.randint(0, size - w, 2)
        imgs[i, :, y0:y0 + w, x0:x0 + w] = 1.0
        labels[i, 0] = [0, x0 / size, y0 / size, (x0 + w) / size,
                        (y0 + w) / size]
    return imgs, labels


def write_det_recordio(path, imgs, labels):
    """Pack the synthetic set as a detection RecordIO: label wire format
    [header_width=2, object_width=5, id, x0, y0, x1, y1] per object
    (src/io/image_det_aug_default.cc:238)."""
    try:  # pack_img's cv2 encoder expects BGR; the others take RGB
        import cv2  # noqa: F401
        to_wire = lambda a: a[:, :, ::-1]  # noqa: E731
    except ImportError:
        to_wire = lambda a: a  # noqa: E731
    writer = mx.recordio.MXRecordIO(path, "w")
    for i in range(len(imgs)):
        hwc = to_wire((imgs[i].transpose(1, 2, 0) * 255).astype(np.uint8))
        det = np.concatenate([[2, 5], labels[i].ravel()]).astype(np.float32)
        header = mx.recordio.IRHeader(0, det, i, 0)
        writer.write(mx.recordio.pack_img(header, hwc, img_fmt=".png"))
    writer.close()


def detect(arg_params, aux_params, imgs, ctx):
    """``build_detector`` bound with trained parameters, one forward of
    ``imgs`` (B, 3, 32, 32): the (B, A, 6) detections as numpy."""
    det = mx.mod.Module(build_detector(), data_names=["data"],
                        label_names=None, context=ctx)
    det.bind(data_shapes=[("data", imgs.shape)], for_training=False)
    det.set_params(arg_params, aux_params, allow_missing=True)
    det.forward(mx.io.DataBatch([mx.nd.array(imgs, ctx=mx.cpu())]),
                is_train=False)
    return det.get_outputs()[0].asnumpy()


def main(argv=None):
    parser = argparse.ArgumentParser(description="train toy ssd")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-epochs", type=int, default=3)
    parser.add_argument("--num-examples", type=int, default=512)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--use-recordio", action="store_true",
                        help="feed through ImageDetRecordIter (box-aware "
                        "augmentation pipeline) instead of NDArrayIter")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle

    rng = np.random.RandomState(0)
    imgs, labels = synth_batch(rng, args.num_examples)
    rec_path = None
    if args.use_recordio:
        fd, rec_path = tempfile.mkstemp(suffix=".rec", prefix="ssd_train_")
        os.close(fd)
        write_det_recordio(rec_path, imgs, labels)
        train = mx.image.ImageDetRecordIter(
            rec_path, data_shape=(3, 32, 32), batch_size=args.batch_size,
            shuffle=True, scale=1.0 / 255,
            rand_mirror_prob=0.5, rand_crop_prob=0.5,
            min_crop_scales=0.7, max_crop_scales=1.0,
            min_crop_object_coverages=0.75, label_name="label")
    else:
        train = mx.io.NDArrayIter(imgs, label=labels.reshape(len(labels),
                                                             -1),
                                  batch_size=args.batch_size, shuffle=True,
                                  label_name="label")

    net, _, _, _ = build_ssd()
    mod = mx.mod.Module(net, data_names=["data"], label_names=["label"],
                        context=ctx)
    label_shapes = train.provide_label if args.use_recordio \
        else [("label", (args.batch_size, 1, 5))]
    mod.bind(data_shapes=train.provide_data, label_shapes=label_shapes)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": args.lr,
                                         "momentum": 0.9})
    metric = mx.metric.Loss()
    timer = StepTimer(ctx)
    losses = []
    try:
        for epoch in range(args.num_epochs):
            train.reset()
            metric.reset()
            with timer:
                for batch in train:
                    if not args.use_recordio:
                        batch.label = [batch.label[0].reshape((-1, 1, 5))]
                    mod.forward_backward(batch)
                    mod.update()
                    metric.update(None, [mod.get_outputs()[1]])
                    timer.steps += 1
            losses.append(metric.get()[1])
            logging.info("epoch %d loc-loss %.4f", epoch, losses[-1])
    finally:
        if rec_path is not None:
            train.close()
            os.remove(rec_path)
    logging.info("done; run detection with build_detector() + "
                 "_contrib_MultiBoxDetection")
    return {"module": mod, "losses": losses, "images": imgs[:8],
            "ms_per_step": timer.ms_per_step, "steps": timer.steps}


if __name__ == "__main__":
    main()
