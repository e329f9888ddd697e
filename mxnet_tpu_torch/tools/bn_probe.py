"""Copy-bandwidth probe on the card (PyTorch counterpart of
``tools/bn_pallas_probe.py``'s ``copy_sweep`` and ``main``, :288-359).

    python -m mxnet_tpu_torch.tools.bn_probe --copy-sweep

copies the reference probe's array, (128, 256·3136) bfloat16 (205.5 MB),
with the port's CUDA copy kernel (``kernels/copy.py``, the streaming
engine's copy) at each number of 16-byte vectors per thread of
``COPY_SWEEP``, and with
``Tensor.copy_``. For each it prints one JSON line: the call time
(median of CUDA-event pairs around one call, host enqueue included), the
device time (``graph_ms``), the host enqueue time (``enqueue_us``), the
device rate in GB/s (2·bytes/s: every byte is read and written) and its
share of the H100's 3.35 TB/s. The best device rate is the port's
measured copy roofline, against which the streaming kernels are judged.
It needs a CUDA card and fails without one. The BatchNorm kernels themselves are timed by
``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..base import MXNetError
from ..kernels import copy as copy_kernel

__all__ = ["COPY_SHAPE", "HBM_BYTES_PER_S", "GRAPH_CALLS", "copy_plan",
           "copy_sweep", "cuda_time", "enqueue_us", "graph_ms", "main"]

COPY_SHAPE = (128, 256 * 3136)     # the reference probe's array, bf16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
GRAPH_CALLS = 20                   # calls in one timed CUDA graph


def copy_plan():
    """Bytes of the array, the byte bound in ms, and per swept number of
    vectors per thread the kernel's launch plan (``stream.Plan``)."""
    n_bytes = COPY_SHAPE[0] * COPY_SHAPE[1] * 2     # bfloat16
    bound_ms = 1e3 * 2 * n_bytes / HBM_BYTES_PER_S
    return n_bytes, bound_ms, {u: copy_kernel.plan(n_bytes, u)
                               for u in copy_kernel.COPY_SWEEP}


def cuda_time(fn, reps=20, warm=3):
    """Median milliseconds of ``fn`` on the card: one CUDA-event pair per
    repetition, after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fns, reps=5):
    """Device milliseconds of one call: the calls ``fns`` captured in one
    CUDA graph after warm-up, the replay timed with CUDA events (median of
    ``reps``), divided by their number. For operands below the card's 50
    MB L2, give each call its own copy of the inputs and keep the outputs
    alive through the capture, so that the other calls between two
    replays of one call move more bytes than L2 holds and no call finds
    its operands there; operands far above 50 MB need one set. Where
    capture fails, the sum of the kernels' durations in a
    ``torch.profiler`` trace of the calls instead. Returns (ms, method)."""
    calls = len(fns)
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fns[0]()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [fn() for fn in fns]
    except RuntimeError:
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            outs = [fn() for fn in fns]
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0)
                 for e in prof.key_averages())
        return us / 1e3 / calls, "profiler"
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph, outs
    return statistics.median(times), "graph"


def enqueue_us(fn, reps=20):
    """Median host microseconds of one call of ``fn`` with the card idle
    before it and no synchronise in the timed span: the host's cost of
    enqueuing the call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def copy_sweep(reps=20):
    """Time the copy kernel at every swept configuration and ``copy_`` on
    the reference's array; returns one dict per row. Each row's output is
    checked bit for bit against the input."""
    if not torch.cuda.is_available():
        raise MXNetError("bn_probe: the copy sweep measures a CUDA card and "
                         "none is available")
    n_bytes, bound_ms, plans = copy_plan()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(COPY_SHAPE, device="cuda", generator=gen).to(
        torch.bfloat16)
    out = torch.empty_like(x)
    runs = [("kernel", u, (lambda u=u: copy_kernel.copy(x, out, u)))
            for u in copy_kernel.COPY_SWEEP]
    runs.append(("copy_", None, lambda: copy_kernel.copy_plain(x, out)))
    rows = []
    for route, config, fn in runs:
        out.zero_()
        fn()
        torch.cuda.synchronize()
        exact = bool(torch.equal(out.view(torch.int16), x.view(torch.int16)))
        ms = cuda_time(fn, reps=reps)
        # the operands are far above L2: one set of inputs for the graph
        device_ms, method = graph_ms([fn] * GRAPH_CALLS)
        gbps = 2 * n_bytes / (device_ms * 1e-3) / 1e9
        row = {"route": route,
               "config": None if config is None else {
                   "unroll": config, "bytes_per_thread": 16 * config},
               "bytes": n_bytes,
               "ms": ms, "device_ms": device_ms, "device_ms_by": method,
               "enqueue_us": enqueue_us(fn), "gb_per_s": gbps,
               "call_gb_per_s": 2 * n_bytes / (ms * 1e-3) / 1e9,
               "share_of_3_35_tb_per_s": gbps * 1e9 / HBM_BYTES_PER_S,
               "bound_ms": bound_ms, "bitwise_equal": exact}
        if config is not None:
            row["blocks"] = plans[config].grid
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--copy-sweep", action="store_true",
                    help="time the copy kernel at each swept number "
                         "of vectors per thread, and copy_, on the reference "
                         "probe's array")
    args = ap.parse_args(argv)
    if not args.copy_sweep:
        ap.error("only --copy-sweep is ported; chip_smoke.py times the "
                 "BatchNorm kernels")
    print(json.dumps({"device": torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else None}))
    rows = copy_sweep()
    for row in rows:
        print(json.dumps(row))
    best = max(rows, key=lambda r: r["gb_per_s"])
    print(json.dumps({"measured_copy_roofline_gb_per_s": best["gb_per_s"],
                      "route": best["route"], "config": best["config"]}))
    if not all(r["bitwise_equal"] for r in rows):
        raise MXNetError("bn_probe: a copy was not bit for bit equal")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
