"""Inference throughput of the zoo's networks: the port's twin of
``example/image-classification/benchmark_score.py`` (the reference's
numbers table: docs/how_to/perf.md:116-148).

    python -m mxnet_tpu_torch.examples.benchmark_score
        [--networks resnet-50,inception-v3] [--batch-size 32]
        [--num-batches 10] [--batch-group 1] [--dtype float32] [--cpu]

Binds each network for inference (299² input for inception-v3, 224²
otherwise, 1000 classes, Xavier weights) and scores one batch that
stays resident on the device: ``--batch-group`` K > 1 scores K batches
a call through ``score_stacked``. Each timed window ends in a 4-byte
readback of the last output's sum; the rate is the two-window slope
(``tools/timing.py``). Logs ``network: %s, batch %d, group %d: %.1f
images/sec`` per network.

As every entry point of the port, it runs on ``gpu(0)`` (or the card of
``--gpus``/``--tpus``) unless ``--cpu`` is given. With ``--dtype`` unset
it computes in bfloat16 on the card, as the JAX script does on its
accelerator, and in float32 on the CPU. ``main(argv)`` returns
``{network: (images/s, group)}``.
"""
import argparse
import logging
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models
from mxnet_tpu_torch.examples.common import device_context
from mxnet_tpu_torch.tools.timing import two_window_slope


def data_shape(network, batch_size):
    side = 299 if network == "inception-v3" else 224
    return (batch_size, 3, side, side)


def score(network, ctx, batch_size, num_batches, batch_group=1,
          compute_dtype=None):
    """(images/s, batches a call) of ``network`` scored on ``ctx``."""
    shape = data_shape(network, batch_size)
    sym = models.get_symbol(network, num_classes=1000)
    if compute_dtype is None and ctx.device_type == "gpu":
        compute_dtype = "bfloat16"
    mod = mx.mod.Module(sym, context=ctx, label_names=["softmax_label"],
                        compute_dtype=compute_dtype)
    mod.bind(for_training=False, inputs_need_grad=False,
             data_shapes=[("data", shape)], label_shapes=None)
    mod.init_params(initializer=mx.init.Xavier(magnitude=2.0))
    X = np.random.rand(*shape).astype(np.float32)
    # the batch is resident on the device: scoring measures the model,
    # not the host's copy
    batch = mx.io.DataBatch([mx.nd.array(X, ctx=ctx)], [])
    eg = mod._exec_group
    grouped = batch_group > 1 and getattr(eg, "fused", False)
    if grouped:
        if num_batches % batch_group:
            raise ValueError("--num-batches must be a multiple of "
                             "--batch-group")
        Xg = batch.data[0]._read().unsqueeze(0).expand(
            (batch_group,) + shape).contiguous()

        def dispatch():
            return eg.score_stacked({"data": Xg})[0]
    else:
        def dispatch():
            mod.forward(batch, is_train=False)
            return mod.get_outputs()[0]._read()

    def barrier(out):
        # a 4-byte readback that depends on the output: the window's
        # one wait for the device
        return float(torch.sum(out.float()))

    for _ in range(2):        # warm up (cuDNN algorithm choice)
        out = dispatch()
    barrier(out)
    launches = num_batches // batch_group if grouped else num_batches

    def window(n):
        tic = time.perf_counter()
        out = None
        for _ in range(n):
            out = dispatch()
        barrier(out)
        return time.perf_counter() - tic

    sl = two_window_slope(window, launches, max(1, launches // 4), reps=3)
    eff_batch = batch_size * (batch_group if grouped else 1)
    return sl["n_slope"] * eff_batch / sl["dt"], \
        (batch_group if grouped else 1)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="score the zoo")
    parser.add_argument("--networks", default="resnet-50")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="score on the CPU instead of the card")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-batches", type=int, default=10)
    parser.add_argument("--batch-group", type=int, default=1,
                        help="batches scored per call (score_stacked)")
    parser.add_argument("--dtype", default=None,
                        choices=[None, "bfloat16", "float32"],
                        help="compute dtype (default: bfloat16 on the "
                             "card, float32 on the CPU)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    rates = {}
    for net in args.networks.split(","):
        speed, group = score(net, ctx, args.batch_size, args.num_batches,
                             args.batch_group, compute_dtype=args.dtype)
        logging.info("network: %s, batch %d, group %d: %.1f images/sec",
                     net, args.batch_size, group, speed)
        rates[net] = (speed, group)
    return rates


if __name__ == "__main__":
    main()
