"""Profiler demo: the port's twin of ``example/profiler/profiler_demo.py``.

    python -m mxnet_tpu_torch.examples.profiler_demo [--cpu]
        [--iter-num 20] [--size 512] [--output profile_matmul.json]

The reference profiling API (``profiler_set_config``/``set_state``/
``dump_profile``) over the port's profiler: the ``Scope`` regions, the
engine's per-op stamps and the ``torch.profiler`` bridge's events (the
card's kernels on the card; PyTorch's host operators on the CPU in mode
``"all"``) go into one Chrome-trace JSON (chrome://tracing or Perfetto).
As in the JAX script, ``iter-num`` matrix products of ``size``² run
under one ``Scope`` each; the JAX script only logs, and the twin also
asserts that every scope is in the file and reports the kernel events
(a ``torch.profiler`` session on the card has been seen to record none,
as ``chip_smoke.py``'s ``profile_busy`` allows for). It runs on
``gpu(0)`` (or ``--gpus``/``--tpus``) unless ``--cpu`` is given;
``main(argv)`` returns the trace's events and the kernel count.
"""
import argparse
import json
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import device_context


def main(argv=None):
    parser = argparse.ArgumentParser(description="profiler demo")
    parser.add_argument("--iter-num", type=int, default=20)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--output", default="profile_matmul.json")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card to run on (one id)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)

    rng = np.random.RandomState(0)
    a = mx.nd.array(rng.rand(args.size, args.size).astype(np.float32),
                    ctx=ctx)
    b = mx.nd.array(rng.rand(args.size, args.size).astype(np.float32),
                    ctx=ctx)
    mx.nd.dot(a, b).wait_to_read()      # the card's first product: warm
    mx.profiler.profiler_set_config(mode="all", filename=args.output)
    mx.profiler.profiler_set_state("run")
    for i in range(args.iter_num):
        with mx.profiler.Scope("matmul_%d" % i):
            c = mx.nd.dot(a, b)
            c.wait_to_read()
    mx.profiler.profiler_set_state("stop")
    mx.profiler.dump_profile()

    with open(args.output) as f:
        events = json.load(f)["traceEvents"]
    logging.info("wrote %s with %d trace events (open in chrome://tracing)",
                 args.output, len(events))
    names = {e["name"] for e in events}
    missing = ["matmul_%d" % i for i in range(args.iter_num)
               if "matmul_%d" % i not in names]
    assert not missing, missing
    kernels = [e for e in events if e.get("cat") == "kernel"]
    print("profiler_demo OK: %d events, %d kernel events"
          % (len(events), len(kernels)))
    return {"events": events, "kernels": len(kernels)}


if __name__ == "__main__":
    main()
