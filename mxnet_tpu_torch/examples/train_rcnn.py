"""Faster R-CNN style detector: the port's twin of
``example/rcnn/train_rcnn.py``.

    python -m mxnet_tpu_torch.examples.train_rcnn [--cpu]

The JAX script's compact two-stage pipeline from the detection ops: a
conv backbone feeds an RPN (objectness and box-delta convolutions),
trained end to end on synthetic box images (``RandomState(0)``) with a
softmax and a smooth-L1 loss; then the inference demo binds the test
graph through ``simple_bind`` with the trained RPN weights:
``_contrib_Proposal`` decodes anchors and deltas and suppresses them
into ROIs (greedy NMS through the hand-written kernels on the card),
``ROIPooling`` (its kernel on the card) crops per-ROI features for the
Fast R-CNN head. It logs ``rpn-bbox-loss`` by epoch, as the JAX script
does, which has no assert. It trains on ``gpu(0)`` (or
``--gpus``/``--tpus``) unless ``--cpu`` is given; ``main(argv)`` returns
the module, the losses by epoch, the demo's outputs and the ms a step.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import StepTimer, device_context


def build_backbone(data):
    body = mx.sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=16,
                              name="conv1")
    body = mx.sym.Activation(body, act_type="relu", name="relu1")
    body = mx.sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                          pool_type="max", name="pool1")
    body = mx.sym.Convolution(body, kernel=(3, 3), pad=(1, 1), num_filter=32,
                              name="conv2")
    body = mx.sym.Activation(body, act_type="relu", name="relu2")
    return mx.sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                          pool_type="max", name="pool2")  # stride 4


def build_rpn_train(num_anchors=9):
    """RPN training graph: objectness softmax + bbox-delta smooth-l1."""
    data = mx.sym.Variable("data")
    rpn_label = mx.sym.Variable("rpn_label")        # (n, A*h*w)
    rpn_bbox_target = mx.sym.Variable("rpn_bbox_target")
    rpn_bbox_weight = mx.sym.Variable("rpn_bbox_weight")
    feat = build_backbone(data)
    rpn = mx.sym.Convolution(feat, kernel=(3, 3), pad=(1, 1), num_filter=32,
                             name="rpn_conv")
    rpn = mx.sym.Activation(rpn, act_type="relu", name="rpn_relu")
    cls = mx.sym.Convolution(rpn, kernel=(1, 1), num_filter=2 * num_anchors,
                             name="rpn_cls_score")
    cls = mx.sym.Reshape(cls, shape=(0, 2, -1), name="rpn_cls_reshape")
    cls_prob = mx.sym.SoftmaxOutput(cls, rpn_label, multi_output=True,
                                    use_ignore=True, ignore_label=-1.0,
                                    normalization="valid",
                                    name="rpn_cls_prob")
    bbox = mx.sym.Convolution(rpn, kernel=(1, 1), num_filter=4 * num_anchors,
                              name="rpn_bbox_pred")
    bbox_l1 = mx.sym.smooth_l1(rpn_bbox_weight * (bbox - rpn_bbox_target),
                               scalar=3.0)
    bbox_loss = mx.sym.MakeLoss(mx.sym.mean(bbox_l1), name="rpn_bbox_loss")
    return mx.sym.Group([cls_prob, bbox_loss])


def build_test_graph(num_anchors=9, num_classes=2):
    """Inference: RPN -> Proposal -> ROIPooling -> Fast R-CNN head."""
    data = mx.sym.Variable("data")
    im_info = mx.sym.Variable("im_info")
    feat = build_backbone(data)
    rpn = mx.sym.Convolution(feat, kernel=(3, 3), pad=(1, 1), num_filter=32,
                             name="rpn_conv")
    rpn = mx.sym.Activation(rpn, act_type="relu", name="rpn_relu")
    cls = mx.sym.Convolution(rpn, kernel=(1, 1), num_filter=2 * num_anchors,
                             name="rpn_cls_score")
    cls_act = mx.sym.Reshape(cls, shape=(0, 2, -1))
    cls_act = mx.sym.softmax(cls_act, axis=1)
    # back to (n, 2A, h, w); h = w = 8 for 32px input at stride 4
    cls_act = mx.sym.Reshape(cls_act, shape=(0, 2 * num_anchors, 8, 8),
                             name="rpn_cls_act")
    bbox = mx.sym.Convolution(rpn, kernel=(1, 1), num_filter=4 * num_anchors,
                              name="rpn_bbox_pred")
    rois = mx.sym._contrib_Proposal(
        cls_act, bbox, im_info, feature_stride=4,
        scales=(2.0, 4.0, 8.0), ratios=(0.5, 1.0, 2.0),
        rpn_pre_nms_top_n=64, rpn_post_nms_top_n=16, threshold=0.7,
        name="rois")
    pooled = mx.sym.ROIPooling(feat, rois, pooled_size=(4, 4),
                               spatial_scale=0.25, name="roi_pool")
    flat = mx.sym.Flatten(pooled)
    fc = mx.sym.FullyConnected(flat, num_hidden=64, name="fc6")
    fc = mx.sym.Activation(fc, act_type="relu", name="fc6_relu")
    cls_score = mx.sym.FullyConnected(fc, num_hidden=num_classes,
                                      name="cls_score")
    cls_out = mx.sym.softmax(cls_score, axis=-1)
    bbox_pred = mx.sym.FullyConnected(fc, num_hidden=4 * num_classes,
                                      name="bbox_pred")
    return mx.sym.Group([rois, cls_out, bbox_pred])


def synth_rpn_batch(rng, n, size=32, stride=4, num_anchors=9):
    """Images with one bright square + dense RPN labels.

    Anchor at the square's center gets label 1, a ring of sampled negatives
    gets 0, the rest stay -1 (ignore) — the reference's AnchorLoader
    sampling scheme in miniature.
    """
    h = w = size // stride
    imgs = rng.rand(n, 3, size, size).astype(np.float32) * 0.2
    labels = np.full((n, num_anchors * h * w), -1.0, np.float32)
    bbox_t = np.zeros((n, 4 * num_anchors, h, w), np.float32)
    bbox_w = np.zeros_like(bbox_t)
    for i in range(n):
        bw = rng.randint(8, 16)
        x0, y0 = rng.randint(0, size - bw, 2)
        imgs[i, :, y0:y0 + bw, x0:x0 + bw] = 1.0
        cy, cx = (y0 + bw // 2) // stride, (x0 + bw // 2) // stride
        a = rng.randint(num_anchors)
        labels[i, a * h * w + cy * w + cx] = 1.0
        bbox_w[i, 4 * a:4 * a + 4, cy, cx] = 1.0
        # box-delta target: offset of the square center from the anchor cell
        bbox_t[i, 4 * a:4 * a + 4, cy, cx] = [
            (x0 + bw / 2.0) / stride - cx, (y0 + bw / 2.0) / stride - cy,
            np.log(bw / float(stride)), np.log(bw / float(stride))]
        for _ in range(8):  # sampled negatives
            ny, nx = rng.randint(h), rng.randint(w)
            if abs(ny - cy) + abs(nx - cx) > 3:
                labels[i, a * h * w + ny * w + nx] = 0.0
    return imgs, labels, bbox_t, bbox_w


def demo(arg_params, image, ctx):
    """The two-stage inference demo: the test graph bound through
    ``simple_bind`` with the trained RPN weights, one forward of
    ``image`` (1, 3, 32, 32): (rois, cls_out, bbox_pred) NDArrays."""
    test_net = build_test_graph()
    ex = test_net.simple_bind(ctx, data=(1, 3, 32, 32), im_info=(1, 3),
                              grad_req="null")
    # share the trained RPN weights
    for name, arr in arg_params.items():
        if name in ex.arg_dict:
            arr.copyto(ex.arg_dict[name])
    ex.arg_dict["im_info"][:] = mx.nd.array(
        np.array([[32.0, 32.0, 1.0]], np.float32), ctx=ctx)
    ex.arg_dict["data"][:] = mx.nd.array(image, ctx=ctx)
    return ex.forward()


def main(argv=None):
    parser = argparse.ArgumentParser(description="train toy faster-rcnn rpn")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-epochs", type=int, default=3)
    parser.add_argument("--num-examples", type=int, default=256)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle

    rng = np.random.RandomState(0)
    imgs, labels, bbox_t, bbox_w = synth_rpn_batch(rng, args.num_examples)
    train = mx.io.NDArrayIter(
        {"data": imgs},
        {"rpn_label": labels, "rpn_bbox_target": bbox_t,
         "rpn_bbox_weight": bbox_w},
        batch_size=args.batch_size, shuffle=True)

    net = build_rpn_train()
    mod = mx.mod.Module(net, data_names=["data"],
                        label_names=["rpn_label", "rpn_bbox_target",
                                     "rpn_bbox_weight"], context=ctx)
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": args.lr,
                                         "momentum": 0.9})
    metric = mx.metric.Loss()
    timer = StepTimer(ctx)
    losses = []
    for epoch in range(args.num_epochs):
        train.reset()
        metric.reset()
        with timer:
            for batch in train:
                mod.forward_backward(batch)
                mod.update()
                metric.update(None, [mod.get_outputs()[1]])
                timer.steps += 1
        losses.append(metric.get()[1])
        logging.info("epoch %d rpn-bbox-loss %.4f", epoch, losses[-1])

    # two-stage inference demo: Proposal -> ROIPooling -> head
    rois, cls_out, bbox_pred = demo(mod.get_params()[0], imgs[:1], ctx)
    logging.info("proposals %s, cls %s, bbox %s",
                 rois.shape, cls_out.shape, bbox_pred.shape)
    return {"module": mod, "losses": losses,
            "demo": {"rois": rois.asnumpy(), "cls": cls_out.asnumpy(),
                     "bbox": bbox_pred.asnumpy()},
            "ms_per_step": timer.ms_per_step, "steps": timer.steps}


if __name__ == "__main__":
    main()
