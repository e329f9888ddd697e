"""Train an ImageNet-class network from RecordIO packs: the port's twin of
``example/image-classification/train_imagenet.py``.

    python -m mxnet_tpu_torch.examples.train_imagenet [--network resnet-50]
        [--data-train train.rec [--data-val val.rec]] [--cpu]
        [--batch-size 32] [--num-epochs 1] [--dtype bfloat16] ...

Reads ``--data-train``/``--data-val`` packs through
``mx.io.ImageRecordIter`` (shuffle, random mirror, the ImageNet mean);
without ``--data-train`` it synthesizes the JAX script's labelled-JPEG
pack (through PIL) at ``--image-shape`` in a temporary directory.
``--network`` takes any name of the zoo (``models.get_symbol``),
``-bf16`` variants included; the inception networks take
``--image-shape 3,299,299``. Trains with SGD momentum
and Xavier-gaussian initialisation through ``fit``, ``do_checkpoint``
with ``--model-prefix`` and ``Speedometer``; ``--dtype bfloat16`` computes
in bfloat16 with float32 master weights (``compute_dtype=``). Prints
``TRAIN_IMAGENET_DONE`` at the end.

Differences from the JAX script: the twin trains on ``gpu(0)`` (or the
one card of ``--gpus``/``--tpus``) unless ``--cpu`` is given; a
``--kv-store`` other than ``local`` raises ``MXNetError`` naming the
slice that brings it, and a ``--network`` the zoo does not have raises
``MXNetError`` at the argument check.
``main(argv)`` returns the run's results.
"""
import argparse
import logging
import os
import shutil
import tempfile
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models, recordio
from mxnet_tpu_torch.examples.common import device_context

IMAGENET_MEAN = (123.68, 116.28, 103.53)


def synth_rec(path, n, hw, classes, rng):
    """The JAX script's labelled JPEG pack at ``hw`` = (height, width):
    each class is a distinct colour blob plus noise."""
    try:
        from PIL import Image
    except ImportError:
        raise mx.MXNetError("synthesizing the JPEG pack needs PIL "
                            "(Pillow); pass --data-train instead")
    import io as pyio

    rec = recordio.MXRecordIO(path, "w")
    for i in range(n):
        cls = i % classes
        base = np.zeros(tuple(hw) + (3,), np.uint8)
        base[..., cls % 3] = 60 + 37 * (cls // 3)
        noise = rng.randint(0, 60, tuple(hw) + (3,)).astype(np.uint8)
        buf = pyio.BytesIO()
        Image.fromarray(base + noise).save(buf, format="JPEG")
        rec.write(recordio.pack(
            recordio.IRHeader(0, float(cls), i, 0), buf.getvalue()))
    rec.close()


def check_network(name):
    """Refuse a name the zoo's ``models.get_symbol`` does not take: the
    registry's names, resnet-N and resnext-N, each with ``-bf16`` where
    the zoo has that variant (resnet-N and alexnet)."""
    base = name[:-len("-bf16")] if name.endswith("-bf16") else name
    known = base.startswith(("resnet", "resnext")) or base in models._MODELS
    has_bf16 = base == "alexnet" or (base.startswith("resnet")
                                     and not base.startswith("resnext"))
    if known and (base == name or has_bf16):
        return
    raise mx.MXNetError("--network %s is not a name of the zoo (%s, "
                        "resnet-N, resnext-N; -bf16 for resnet-N and "
                        "alexnet)" % (name, ", ".join(sorted(models._MODELS))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="train imagenet")
    parser.add_argument("--network", default="resnet-50")
    parser.add_argument("--data-train", default=None)
    parser.add_argument("--data-val", default=None)
    parser.add_argument("--image-shape", default="3,224,224")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--mom", type=float, default=0.9)
    parser.add_argument("--wd", type=float, default=1e-4)
    parser.add_argument("--dtype", default=None,
                        choices=[None, "bfloat16", "float32"])
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--model-prefix", default=None)
    parser.add_argument("--synthetic-images", type=int, default=256,
                        help="rec size when --data-train is absent")
    args = parser.parse_args(argv)
    check_network(args.network)
    if args.kv_store != "local":
        raise mx.MXNetError("--kv-store %s comes with the dist slice of "
                            "the port; this slice trains on one device "
                            "(local)" % args.kv_store)
    return args


def main(argv=None):
    """Train; returns a dict of the results (``module``, ``train_accuracy``,
    ``fit_s``, ``fit_img_per_s`` over each epoch's batches after its
    first, ``steps``)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)

    shape = tuple(int(x) for x in args.image_shape.split(","))
    tmp = None
    if args.data_train is None:
        tmp = tempfile.mkdtemp(prefix="imagenet_synth_")
        args.data_train = os.path.join(tmp, "train.rec")
        args.num_classes = min(args.num_classes, 8)
        synth_rec(args.data_train, args.synthetic_images, shape[1:],
                  args.num_classes, np.random.RandomState(0))
        logging.info("no --data-train: synthesized %d-image rec at %s",
                     args.synthetic_images, args.data_train)
    mean = dict(zip(("mean_r", "mean_g", "mean_b"), IMAGENET_MEAN))
    train = mx.io.ImageRecordIter(
        path_imgrec=args.data_train, data_shape=shape,
        batch_size=args.batch_size, shuffle=True, rand_mirror=True,
        preprocess_threads=4, label_name="softmax_label", **mean)
    val = None
    if args.data_val:
        val = mx.io.ImageRecordIter(
            path_imgrec=args.data_val, data_shape=shape,
            batch_size=args.batch_size, label_name="softmax_label",
            **mean)

    net = models.get_symbol(args.network, num_classes=args.num_classes,
                            image_shape=args.image_shape)
    mod = mx.mod.Module(net, context=ctx, compute_dtype=args.dtype)
    metric = mx.metric.Accuracy()
    stamps = {}   # epoch -> batch-end host times

    def _stamp(param):
        stamps.setdefault(param.epoch, []).append(time.perf_counter())

    epoch_cb = (mx.callback.do_checkpoint(args.model_prefix)
                if args.model_prefix else None)
    t0 = time.perf_counter()
    try:
        mod.fit(train, eval_data=val, num_epoch=args.num_epochs,
                optimizer="sgd",
                optimizer_params={"learning_rate": args.lr,
                                  "momentum": args.mom, "wd": args.wd,
                                  "rescale_grad": 1.0 / args.batch_size},
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                eval_metric=metric, kvstore=args.kv_store,
                batch_end_callback=[
                    mx.callback.Speedometer(args.batch_size, 10), _stamp],
                epoch_end_callback=epoch_cb)
    finally:
        train.close()
        if val is not None:
            val.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    result = {"module": mod, "fit_s": time.perf_counter() - t0,
              "train_accuracy": metric.get()[1],
              "steps": sum(len(t) for t in stamps.values())}
    span = sum(t[-1] - t[0] for t in stamps.values() if len(t) > 1)
    if span > 0:
        result["fit_img_per_s"] = sum(
            len(t) - 1 for t in stamps.values()) * args.batch_size / span
    logging.info("final train accuracy: %.3f", result["train_accuracy"])
    print("TRAIN_IMAGENET_DONE")
    return result


if __name__ == "__main__":
    main()
