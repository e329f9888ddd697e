"""Copy-bandwidth probe on the card (PyTorch counterpart of
``tools/bn_pallas_probe.py``'s ``copy_sweep`` and ``main``, :288-359).

    python -m mxnet_tpu_torch.tools.bn_probe --copy-sweep

copies the reference probe's array, (128, 256·3136) bfloat16 (205.5 MB),
with the port's CUDA copy kernel (``kernels/copy.py``) at each tile size,
and with ``Tensor.copy_``. For each it prints one JSON line: the median
milliseconds of CUDA-event timings, the rate in GB/s (2·bytes/s: every
byte is read and written) and its share of the H100's 3.35 TB/s. The best
measured rate is the port's measured copy roofline, against which the
streaming kernels (BatchNorm) are judged. It needs a CUDA card and fails
without one. The BatchNorm kernels themselves are timed by
``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..base import MXNetError
from ..kernels import copy as copy_kernel

__all__ = ["COPY_SHAPE", "HBM_BYTES_PER_S", "copy_plan", "copy_sweep",
           "cuda_time", "main"]

COPY_SHAPE = (128, 256 * 3136)     # the reference probe's array, bf16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet


def copy_plan():
    """Bytes of the array, the byte bound in ms, and per tile size the
    kernel's launch plan (vectors, tail bytes, blocks)."""
    n_bytes = COPY_SHAPE[0] * COPY_SHAPE[1] * 2     # bfloat16
    bound_ms = 1e3 * 2 * n_bytes / HBM_BYTES_PER_S
    return n_bytes, bound_ms, {t: copy_kernel.plan(n_bytes, t)
                               for t in copy_kernel.TILE_BYTES}


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


def copy_sweep(reps=20):
    """Time the copy kernel at every tile size and ``copy_`` on the
    reference's array; returns one dict per row. Each row's output is
    checked bit for bit against the input."""
    if not torch.cuda.is_available():
        raise MXNetError("bn_probe: the copy sweep measures a CUDA card and "
                         "none is available")
    n_bytes, bound_ms, plans = copy_plan()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(COPY_SHAPE, device="cuda", generator=gen).to(
        torch.bfloat16)
    out = torch.empty_like(x)
    runs = [("kernel", t, (lambda t=t: copy_kernel.copy(x, out, t)))
            for t in copy_kernel.TILE_BYTES]
    runs.append(("copy_", None, lambda: copy_kernel.copy_plain(x, out)))
    rows = []
    for route, tile, fn in runs:
        out.zero_()
        fn()
        torch.cuda.synchronize()
        exact = bool(torch.equal(out.view(torch.int16), x.view(torch.int16)))
        ms = cuda_time(fn, reps=reps)
        gbps = 2 * n_bytes / (ms * 1e-3) / 1e9
        row = {"route": route, "tile_bytes": tile, "bytes": n_bytes,
               "ms": ms, "gb_per_s": gbps,
               "share_of_3_35_tb_per_s": gbps * 1e9 / HBM_BYTES_PER_S,
               "bound_ms": bound_ms, "bitwise_equal": exact}
        if tile is not None:
            row["blocks"] = plans[tile][2]
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--copy-sweep", action="store_true",
                    help="time the copy kernel at each tile size, and "
                         "copy_, on the reference probe's array")
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
                      "route": best["route"],
                      "tile_bytes": best["tile_bytes"]}))
    if not all(r["bitwise_equal"] for r in rows):
        raise MXNetError("bn_probe: a copy was not bit for bit equal")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
