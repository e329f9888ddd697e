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

Distributed training: ``--kv-store dist_sync`` (or ``dist_device_sync``,
``dist``, ``dist_async``) under ``tools/launch.py -n N`` trains one global
batch of N × ``--batch-size`` rows: every rank reads the same pack (the
same shuffle) at the global batch and trains its row block
(``dist.ShardedDataIter``), gradients summed over the ranks, BatchNorm
over the global batch. ``--seed`` seeds the initialisation (rank 0's is
broadcast); ``--save-params`` writes the final parameters (rank 0, npz of
``arg:``/``aux:`` names); every rank prints a ``DIST_TWIN`` line with its
rank, steps, step time, all-reduce time and every kernel's launch count
(JSON).

Differences from the JAX script: the twin trains on ``gpu(0)`` (or the
one card of ``--gpus``/``--tpus``; under an NCCL group the rank's own
card) unless ``--cpu`` is given, and a ``--network`` the zoo does not
have raises ``MXNetError`` at the argument check.
``main(argv)`` returns the run's results.
"""
import argparse
import json
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


def kernel_launches():
    """Every hand-written kernel's launch count in this process."""
    from mxnet_tpu_torch.kernels import batchnorm as K
    from mxnet_tpu_torch.kernels import copy as C
    from mxnet_tpu_torch.kernels import nms as NM
    from mxnet_tpu_torch.kernels import roi_pooling as RP
    from mxnet_tpu_torch.kernels import rtc as R
    counts = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches,
              "copy": C.copy.launches, "rtc": R.rtc_kernel.launches,
              "nms_mask": NM.nms_mask.launches,
              "nms_scan": NM.nms_scan.launches,
              "roi_pool_fwd": RP.roi_pool_fwd.launches,
              "roi_pool_bwd": RP.roi_pool_bwd.launches}
    counts.update({n: getattr(K, n).launches for n in K.SPLIT_KERNELS})
    return counts


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
    parser.add_argument("--seed", type=int, default=None,
                        help="seed the initialisation")
    parser.add_argument("--save-params", default=None,
                        help="write the final parameters here (npz)")
    args = parser.parse_args(argv)
    check_network(args.network)
    return args


def main(argv=None):
    """Train; returns a dict of the results (``module``, ``train_accuracy``,
    ``fit_s``, ``fit_img_per_s`` over each epoch's batches after its
    first, ``steps``)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.seed is not None:
        mx.random.seed(args.seed)
        np.random.seed(args.seed)
    kv = mx.kv.create(args.kv_store)
    workers = kv.num_workers
    ctx = device_context(args)
    rt = mx.dist.get_runtime() if args.kv_store.startswith("dist") \
        else None
    if rt is not None and rt.backend == "nccl" and not args.cpu:
        ctx = mx.gpu(rt.device.index)

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
        batch_size=args.batch_size * workers, shuffle=True, rand_mirror=True,
        preprocess_threads=4, label_name="softmax_label", **mean)
    if workers > 1:
        # every rank reads the global stream and trains its row block
        train_src = train
        train = mx.dist.ShardedDataIter(train_src, kv.rank, workers)
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
    # the global batch's rescale, except for dist_async, which the
    # reference scales by the rank's own batch
    global_batch = args.batch_size * (
        1 if args.kv_store == "dist_async" else workers)
    tel = mx.telemetry.registry().scope("dist")
    ar0 = tel.counter("allreduce_ms").value
    t0 = time.perf_counter()
    try:
        mod.fit(train, eval_data=val, num_epoch=args.num_epochs,
                optimizer="sgd",
                optimizer_params={"learning_rate": args.lr,
                                  "momentum": args.mom, "wd": args.wd,
                                  "rescale_grad": 1.0 / global_batch},
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                eval_metric=metric,
                kvstore=kv if args.kv_store.startswith("dist")
                else args.kv_store,
                batch_end_callback=[
                    mx.callback.Speedometer(args.batch_size, 10), _stamp],
                epoch_end_callback=epoch_cb)
    finally:
        (train_src if workers > 1 else train).close()
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
    if args.save_params and kv.rank == 0:
        arg_p, aux_p = mod.get_params()
        np.savez(args.save_params,
                 **{"arg:" + k: v.asnumpy() for k, v in arg_p.items()},
                 **{"aux:" + k: v.asnumpy() for k, v in aux_p.items()})
    if args.kv_store.startswith("dist"):
        steps = result["steps"]
        result["allreduce_ms"] = tel.counter("allreduce_ms").value - ar0
        timed = sum(len(t) - 1 for t in stamps.values())
        print("DIST_TWIN " + json.dumps({
            "rank": kv.rank, "world": workers, "steps": steps,
            "step_ms": span * 1000.0 / timed if timed else None,
            "allreduce_ms_per_step": result["allreduce_ms"] / max(steps, 1),
            "launches": kernel_launches()}), flush=True)
    print("TRAIN_IMAGENET_DONE")
    return result


if __name__ == "__main__":
    main()
