"""Debugging a convolution: the port's twin of
``example/python-howto/debug_conv.py``.

    python -m mxnet_tpu_torch.examples.debug_conv [--cpu]

The reference sets a gdb breakpoint in its convolution; here, as in the
JAX script, the same visibility comes from ``Executor.debug_str()`` (the
graph, op by op) and a per-op monitor callback, which sees the
convolution's output. The JAX script's asserts: the callback tapped an
output of ``conv1``. It runs on ``gpu(0)`` (or ``--gpus``/``--tpus``)
unless ``--cpu`` is given; ``main(argv)`` returns the debug string and
the tapped names and shapes.
"""
import argparse

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import device_context


def main(argv=None):
    parser = argparse.ArgumentParser(description="debug a convolution")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card to run on (one id)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU")
    args = parser.parse_args(argv)
    ctx = device_context(args)

    data = mx.sym.Variable("data")
    conv = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                              pad=(1, 1), name="conv1")
    net = mx.sym.SoftmaxOutput(mx.sym.Flatten(conv), name="softmax")

    ex = net.simple_bind(ctx=ctx, data=(2, 1, 8, 8), softmax_label=(2,))
    # 1) the graph picture the reference reads out of gdb frames
    text = ex.debug_str()
    print(text[:400])
    # 2) tap the conv output itself (per-op callback)
    taps = {}
    ex.set_monitor_callback(lambda name, arr: taps.setdefault(
        name, tuple(arr.shape)))
    ex.forward(is_train=False,
               data=mx.nd.array(np.random.rand(2, 1, 8, 8), ctx=ctx))
    conv_taps = [k for k in taps if "conv1" in k]
    print("tapped:", sorted(taps)[:4])
    assert conv_taps, taps
    print("debug_conv OK")
    return {"debug_str": text, "taps": taps}


if __name__ == "__main__":
    main()
