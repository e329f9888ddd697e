"""Design probe of greedy NMS's two kernels (``kernels/csrc/nms.cu``) on
the card, at the two shapes ``chip_smoke.py`` phase 16 times them:
SSD300's 32 × 8,732 boxes (MultiBoxDetection's own, threshold 0.45) and
Proposal's 1 × 6,000 (Faster R-CNN's RPN boxes, threshold 0.7).

    python -m mxnet_tpu_torch.tools.nms_probe [--out FILE] [--rounds 2]

run from the root of the checkout (it takes the inputs from
``chip_smoke.py``). It builds ``csrc/nms.cu`` as shipped and with the
source's probe macros, all builds at once:

* ``mask_rows``: ``nms_mask`` with a 64 × 64 tile a block, one row a
  thread (``-DMX_NMS_MASK_ROWS=1``), and with a 128 × 128 tile, two rows
  a thread (``-DMX_NMS_MASK_ROWS=2``), against the shipped build, which
  takes the wide tile where the batch gives every SM 24 such blocks; at
  both shapes and on the first 1, 2, 4 and 8 of SSD300's images;
* ``scan_walk``: ``nms_scan`` settling a tile over its free rows in order
  (shipped) against jumping from one kept bit to the next with
  ``__ffsll`` (``-DMX_NMS_SCAN_FFS``);
* ``scan_trace``: each of the two walks built with
  ``-DMX_NMS_SCAN_TRACE``, which reads the settler's ``clock64`` around
  each tile: the cycles it waits for the far warps, walks the tile's rows
  and does the rest (the kept list, the near ORs, the release), against
  the block's own cycles from its start to its last keep flag. The chain
  of tiles is the settler's walk and rest; where they fill the block's
  cycles, the kernel runs at that chain's latency.

Device ms are ``bn_probe.graph_ms`` of ``GRAPH_CALLS`` calls in one CUDA
graph (L2-warm at Proposal's shape, whose words fit in L2), read in turns
A B B A, ``--rounds`` times. Every variant's mask words and keep flags are
held bit for bit against the shipped build's, and the probe fails if one
differs. It prints one JSON object a line (each line also to ``--out``),
each with the card's ``nvidia-smi`` name and power limit. It needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..base import MXNetError
from ..kernels import build
from ..kernels import nms as NM
from . import bn_probe

__all__ = ["VARIANTS", "TRACE_FIELDS", "load", "main"]

VARIANTS = {
    "shipped": (),
    "rows1": ("-DMX_NMS_MASK_ROWS=1",),
    "rows2": ("-DMX_NMS_MASK_ROWS=2",),
    "ffs": ("-DMX_NMS_SCAN_FFS",),
    "trace": ("-DMX_NMS_SCAN_TRACE",),
    "trace_ffs": ("-DMX_NMS_SCAN_FFS", "-DMX_NMS_SCAN_TRACE"),
}
# csrc/nms.cu's TraceField, in order
TRACE_FIELDS = ("block", "settler", "wait", "walk", "rest", "visits",
                "kept")
TRACE_BLOCKS = 64
GRAPH_CALLS = 10


def load(flags):
    """Build ``csrc/nms.cu`` with ``flags`` (once per set of inputs) and
    return the library with its entries typed."""
    src = os.path.join(build.CSRC, "nms.cu")
    with open(src) as f:
        tag = build.digest(f.read(), flags)[:16]
    lib = build.nvcc_library(
        src, build.library_path("mxnet_tpu_torch_nms_probe", tag), flags)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mx_nms_mask.argtypes = [P, P, I, I, ctypes.c_float, I, P]
    lib.mx_nms_scan.argtypes = [P, P, I, I, I, P]
    lib.mx_nms_mask.restype = lib.mx_nms_scan.restype = I
    if "-DMX_NMS_SCAN_TRACE" in flags:
        lib.mx_nms_scan_trace.argtypes = [P, I]
        lib.mx_nms_scan_trace.restype = I
    return lib


def _mask(lib, boxes, thresh):
    B, n = boxes.shape[:2]
    dev = boxes.get_device()
    out = torch.empty((B, n, (n + NM.BITS - 1) // NM.BITS),
                      dtype=torch.int64, device=boxes.device)
    build.raise_if(lib.mx_nms_mask(boxes.data_ptr(), out.data_ptr(), B, n,
                                   float(thresh), dev,
                                   build.current_stream(dev)), "nms_mask")
    return out


def _scan(lib, mask, n):
    B = mask.shape[0]
    dev = mask.get_device()
    keep = torch.empty((B, n), dtype=torch.bool, device=mask.device)
    build.raise_if(lib.mx_nms_scan(mask.data_ptr(), keep.data_ptr(), B, n,
                                   dev, build.current_stream(dev)),
                   "nms_scan")
    return keep


def _turns(fns, rounds):
    """Device ms of each named call, read in turns A B B A per round."""
    names = list(fns)
    reads = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            ms, _ = bn_probe.graph_ms([fns[k]] * GRAPH_CALLS)
            reads[k].append(ms)
    return {k: {"device_ms": v, "median": statistics.median(v)}
            for k, v in reads.items()}


def _trace(lib, mask, n):
    """The settler trace of one scan: the fields summed over the traced
    images, the slowest block's cycles, and the ratios."""
    _scan(lib, mask, n)
    torch.cuda.synchronize()
    blocks = min(mask.shape[0], TRACE_BLOCKS)
    buf = (ctypes.c_longlong * (blocks * len(TRACE_FIELDS)))()
    build.raise_if(lib.mx_nms_scan_trace(ctypes.addressof(buf), blocks),
                   "nms_scan_trace")
    rows = [buf[i * len(TRACE_FIELDS):(i + 1) * len(TRACE_FIELDS)]
            for i in range(blocks)]
    total = {f: sum(r[i] for r in rows) for i, f in enumerate(TRACE_FIELDS)}
    chain = total["walk"] + total["rest"]
    return {"images": blocks, "cycles": total,
            "block_cycles_max": max(r[0] for r in rows),
            "chain_cycles": chain,
            "chain_share_of_block": chain / total["block"],
            "wait_share_of_block": total["wait"] / total["block"],
            "walk_cycles_per_visited_row": total["walk"] / total["visits"],
            "walk_cycles_per_kept_row": total["walk"] / total["kept"],
            "chain_cycles_per_tile": chain / (
                blocks * ((n + NM.BITS - 1) // NM.BITS))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise MXNetError("nms_probe needs a CUDA card")
    import chip_smoke as cs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(dict(obj, card=card))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(load, VARIANTS.values())))
    ssd = cs.ssd_inputs(cs.vision_gen(160))
    shapes = [("ssd300_detection", cs.ssd_sorted_boxes(ssd[3], ssd[4],
                                                       ssd[0]), cs.SSD_NMS),
              ("proposal_rpn", cs.proposal_sorted_boxes(
                  cs.rpn_inputs(cs.vision_gen(161))), cs.RCNN_NMS)]
    failed = []
    for at, boxes, thresh in shapes:
        B, n = boxes.shape[:2]
        mask = _mask(libs["shipped"], boxes, thresh)
        keep = _scan(libs["shipped"], mask, n)
        equal = {}
        for v, lib in libs.items():
            equal[v] = {"mask": torch.equal(_mask(lib, boxes, thresh), mask),
                        "keep": torch.equal(_scan(lib, mask, n), keep)}
            if not all(equal[v].values()):
                failed.append("%s %s" % (at, v))
        emit({"phase": "nms_probe_equal", "at": at, "shape": [B, n],
              "thresh": thresh, "equal": equal,
              "kept_per_image_mean": float(keep.sum(1).float().mean())})
        subsets = [B] if B == 1 else [1, 2, 4, 8, B]
        for b in subsets:
            sub = boxes[:b]
            emit({"phase": "nms_probe_mask_rows", "at": at,
                  "shape": [b, n],
                  **_turns({v: functools.partial(_mask, libs[v], sub,
                                                 thresh)
                            for v in ("shipped", "rows1", "rows2")},
                           args.rounds)})
        emit({"phase": "nms_probe_scan_walk", "at": at, "shape": [B, n],
              **_turns({"free_rows_shipped": lambda: _scan(libs["shipped"],
                                                           mask, n),
                        "ffs": lambda: _scan(libs["ffs"], mask, n),
                        "free_rows_traced": lambda: _scan(libs["trace"],
                                                          mask, n),
                        "ffs_traced": lambda: _scan(libs["trace_ffs"],
                                                    mask, n)},
                       args.rounds)})
        for v in ("trace", "trace_ffs"):
            emit({"phase": "nms_probe_scan_trace", "at": at,
                  "shape": [B, n],
                  "walk": "ffs" if v == "trace_ffs" else "free_rows",
                  **_trace(libs[v], mask, n)})
    emit({"phase": "nms_probe", "ok": not failed, "failed": failed})
    if out:
        out.close()
    return 0 if not failed else 1


if __name__ == "__main__":
    raise SystemExit(main())
