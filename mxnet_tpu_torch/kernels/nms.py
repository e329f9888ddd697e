"""Greedy non-maximum suppression for Hopper: ``nms_mask`` and
``nms_scan`` (``csrc/nms.cu``), each beside its plain PyTorch version.

What they replace: no TPU kernel. They are the counterpart of
``_nms_suppress`` (``mxnet_tpu/ops/detection.py:114``) and of its IoU,
``_iou_matrix`` (``:21``), which the JAX package left to XLA as a dense
IoU matrix and a ``fori_loop`` of N dependent steps. Eager PyTorch has no
op for greedy NMS (torchvision, which has one, is a package of finished
kernels), and the loop written out costs ~3 launches a box: ~26,000 an
image at SSD300's 8,732 anchors.

* ``nms_mask(boxes, thresh)``: boxes (B, N, 4) float32, each image's
  already sorted by score. Returns (B, N, ⌈N/64⌉) int64 words: bit j of
  word w of row i says ``iou(i, 64·w + j) > thresh`` for 64·w + j > i
  (0 elsewhere, and in the padding past N). Blocks only for the tiles on
  or above the diagonal (each writes its mirror tile's zeros), 128 × 128
  pairs a block of 64 threads where the batch fills the card (64 × 64 at
  a single image), each box's area once. A pair is decided without a division where the sign of
  ``inter − α_a − α_b``, α = area·thresh/(1 + thresh) a box (that of
  ``inter − union·thresh`` over 1 + thresh), settles it
  (:func:`pair_decision`); the rest round every line as ``_iou_matrix``
  does in float32, in its order, with no fma contraction and IEEE
  division, so a pair at the threshold decides as it does there.
* ``nms_scan(mask, n)``: one block an image walks the sorted order 64
  boxes at a time. One warp settles the tiles on words staged ahead in
  shared memory, over each tile's free rows in order (a free row still
  free when reached is kept); the other warps OR the kept rows' later
  words off that chain (:func:`nms_scan_walk`).
  Returns (B, N) bool keep flags: box i is kept iff no kept box before it
  suppresses it (the JAX loop's rule).
* ``nms(boxes, scores, thresh)``: the op-level function: a stable sort of
  −scores (``jnp.argsort``'s order), the two kernels, and the keep flags
  put back in the boxes' order.

Both kernels take a whole batch in one launch each. Bound: the mask by
operations (14 float32 operations an IoU pair above the diagonal, 4 a
box for its area), the scan by its dependent walk. Deterministic: no
atomics in the mask; the scan's ORs commute.

:func:`pair_decision` and :func:`nms_scan_walk` mirror the two kernels'
decisions in plain PyTorch for the CPU tests; nothing on the card's path
calls them. ``nms_mask_plain`` and ``nms_scan_plain`` define the function.

Dispatch: the plain versions run only for tensors on the CPU. A CUDA
tensor launches the kernel or raises ``MXNetError``; nothing falls back.
``nms_mask.launches`` and ``nms_scan.launches`` count calls that launched.
Build: ``kernels/build.py`` compiles ``csrc/nms.cu`` with ``nvcc`` for
``sm_90a`` at first use, loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..base import MXNetError
from .build import cuda_library, current_stream, raise_if

__all__ = ["iou_matrix", "nms_mask", "nms_scan", "nms", "nms_mask_plain",
           "nms_scan_plain", "pair_decision", "nms_scan_walk", "BITS"]

BITS = 64
# csrc/nms.cu's constants: the band is (tp·2^-BAND_SHIFT + 2^-22) of each
# box's area plus HALF_FLOOR (inf for an area of AREA_CAP or more), tp =
# thresh/(1 + thresh); the settler ORs NEAR_WORDS words past a tile itself
BAND_SHIFT = 19
HALF_FLOOR = 2.0 ** -101
AREA_CAP = 2.0 ** 127
NEAR_WORDS = 6
_LIB = []


def _library():
    """Build (once per process) and load the kernels' shared library."""
    if _LIB:
        return _LIB[0]
    lib = cuda_library("mxnet_tpu_torch_nms", "nms.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mx_nms_mask.argtypes = [P, P, I, I, ctypes.c_float, I, P]
    lib.mx_nms_scan.argtypes = [P, P, I, I, I, P]
    lib.mx_nms_mask.restype = lib.mx_nms_scan.restype = I
    _LIB.append(lib)
    return lib


def _words(n):
    return (n + BITS - 1) // BITS


def iou_matrix(a, b):
    """IoU between (..., N, 4) and (..., M, 4) corner-format boxes ->
    (..., N, M), line by line as ``_iou_matrix`` rounds it."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, k] for k in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, k] for k in range(4))
    iw = torch.clamp_min(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                         0.0)
    ih = torch.clamp_min(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                         0.0)
    inter = iw * ih
    area_a = torch.clamp_min((ax2 - ax1) * (ay2 - ay1), 0.0)
    area_b = torch.clamp_min((bx2 - bx1) * (by2 - by1), 0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _pack(bits):
    """(..., N) bool -> (..., ⌈N/64⌉) int64 words, bit j of word w for
    position 64·w + j."""
    n = bits.shape[-1]
    pad = _words(n) * BITS - n
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    shifts = torch.arange(BITS, device=bits.device, dtype=torch.int64)
    words = bits.reshape(bits.shape[:-1] + (-1, BITS)).to(torch.int64)
    return (words << shifts).sum(-1)


def _unpack(words, n):
    shifts = torch.arange(BITS, device=words.device, dtype=torch.int64)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n].bool()


def nms_mask_plain(boxes, thresh):
    """Plain PyTorch ``nms_mask``: the IoU matrix, thresholded above the
    diagonal, packed into words."""
    n = boxes.shape[-2]
    idx = torch.arange(n, device=boxes.device)
    above = idx[None, :] > idx[:, None]
    return _pack((iou_matrix(boxes, boxes) > thresh) & above)


def nms_scan_plain(mask, n):
    """Plain PyTorch ``nms_scan``: the JAX package's loop over the sorted
    order, on the unpacked words."""
    sup = _unpack(mask, n)                      # (B, N, N), j > i only
    keep = torch.ones(mask.shape[0], n, dtype=torch.bool,
                      device=mask.device)
    for i in range(n):
        keep &= ~(sup[:, i] & keep[:, i:i + 1])
    return keep


def _fast_consts(thresh):
    """(fast, t, tp, tb) as ``mx_nms_mask`` computes them: the fast
    decision needs a finite normal t > 0; tp = t / (1 + t) rounded to
    float32, tb = tp·2^-19 + 2^-22 rounded up."""
    t = np.float32(thresh)
    f32 = np.finfo(np.float32)
    fast = bool(f32.tiny <= t <= f32.max)
    q = float(t) / (1.0 + float(t))
    want = q * 2.0 ** -BAND_SHIFT + 2.0 ** -22
    tb = np.float32(want)
    if float(tb) < want:
        tb = np.nextafter(tb, np.float32(np.inf))
    return fast, t, np.float32(q), tb


def pair_decision(a, b, thresh):
    """``csrc/nms.cu``'s decision of ``iou(a, b) > thresh`` for boxes a, b
    (..., 4) float32, line by line: (bit, sure), where ``sure`` marks the
    pairs the fast test settles and the rest take the exact decision
    (inter == 0 at once, else the IEEE division).

    The fast test, for a finite normal t > 0: ``sc = fl(inter −
    fl(α_a + α_b))``, ``α = fl(area·tp)``, tp = t/(1 + t), is settled
    where ``|sc| > band``, ``band = fl(β_a + β_b)``, ``β = fl(fl(area·tb)
    + 2^-101)``, tb ≥ tp·2^-19 + 2^-22. Why that is exact (u = 2^-24; fl is
    monotone; a product or sum rounds to x(1 ± u) ± 2^-150): where the
    boxes overlap, inter ≤ each area, so S = area_a + area_b ≥ 2·inter,
    and (inter − t·union)/(1 + t) = inter − tp·S up to the union's two
    roundings; sc is that within u·S·(1/2 + 6·tp) + 2^-149. The band
    exceeds that error by more than tp·S·2^-20 (the 2^-22 covers u/2 for a
    small t, the floor the 2^-149), so |sc| > band puts inter/union more
    than t·2^-20 from t, and the rounded quotient lands on the side of t
    that sc's sign says: above t·(1 + 2^-20) it is past the half ulp
    (≤ t·2^-24) above t, below t it cannot round above it. The width goes
    unclamped into inter: a negative one gives inter ≤ 0, so sc ≤ 0 and
    the bit is 0, as the clamp's inter of 0 decides for t > 0. A box of
    area ≥ 2^127 gets β = inf, so a pair whose area_a + area_b (and with it
    the union) may overflow is unsure; below that the sum of two areas is
    finite. An overflow of inter or of an area, or a union of 0, makes sc
    or band inf or NaN, or sc 0, and the pair unsure."""
    fast, t, tp, tb = _fast_consts(thresh)
    a, b = torch.broadcast_tensors(a, b)
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    area_a = torch.clamp_min((ax2 - ax1) * (ay2 - ay1), 0.0)
    area_b = torch.clamp_min((bx2 - bx1) * (by2 - by1), 0.0)
    dw = torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)
    ih = torch.clamp_min(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                         0.0)
    inter = torch.clamp_min(dw, 0.0) * ih
    union = (area_a + area_b) - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(union))
    exact = torch.where(inter == 0, torch.full_like(iou, 0.0) > float(t),
                        iou > float(t))
    if not fast:
        return exact, torch.zeros_like(exact)
    tpf, tbf, floor = (torch.tensor(v, dtype=torch.float32)
                       for v in (tp, tb, HALF_FLOOR))
    sc = dw * ih - (area_a * tpf + area_b * tpf)
    inf = torch.tensor(float("inf"))

    def beta(area):
        return torch.where(area >= AREA_CAP, inf, area * tbf + floor)

    band = beta(area_a) + beta(area_b)
    sure = sc.abs() > band
    return torch.where(sure, sc > 0, exact), sure


def nms_scan_walk(mask, n, near=NEAR_WORDS):
    """``csrc/nms.cu``'s scan on the words of ``nms_mask``: tile by tile,
    over the tile's free rows in order (those no earlier tile removed),
    each one still free when reached kept and its diagonal word ANDed out
    of the rest; each kept row's next ``near`` words ORed in at once (the
    settler's) and its later words into a second set of removed words (the
    far warps'), read together when the walk reaches them."""
    words = _words(n)
    keep = torch.zeros((mask.shape[0], n), dtype=torch.bool)
    for b, img in enumerate(mask.cpu().numpy().astype(np.uint64)):
        rows = [[int(x) for x in row] for row in img]
        near_w, far_w = [0] * words, [0] * words
        for s in range(words):
            base = s * BITS
            cnt = min(BITS, n - base)
            free = ~(near_w[s] | far_w[s]) & ((1 << cnt) - 1)
            for j in range(cnt):
                if not (free >> j) & 1:
                    continue
                keep[b, base + j] = True
                free &= ~rows[base + j][s]
                for w in range(s + 1, words):
                    acc = near_w if w <= s + near else far_w
                    acc[w] |= rows[base + j][w]
    return keep


def nms_mask(boxes, thresh):
    """Suppression words of score-sorted boxes (B, N, 4) float32: the
    kernel for a CUDA tensor, the plain version for a CPU one."""
    if boxes.device.type == "cpu":
        return nms_mask_plain(boxes, thresh)
    if not boxes.is_cuda or boxes.dtype != torch.float32 or \
            boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise MXNetError("nms_mask: boxes must be (B, N, 4) float32 on a "
                         "CUDA device, got %s %s on %s"
                         % (boxes.dtype, tuple(boxes.shape), boxes.device))
    B, n = boxes.shape[0], boxes.shape[1]
    mask = torch.empty((B, n, _words(n)), dtype=torch.int64,
                       device=boxes.device)
    if B == 0 or n == 0:
        return mask
    boxes = boxes.contiguous()
    lib = _library()
    dev = boxes.get_device()
    raise_if(lib.mx_nms_mask(boxes.data_ptr(), mask.data_ptr(), B, n,
                             float(thresh), dev, current_stream(dev)),
             "nms_mask")
    nms_mask.launches += 1
    return mask


def nms_scan(mask, n):
    """Keep flags (B, n) bool of the greedy walk over ``nms_mask``'s
    words: the kernel for a CUDA tensor, the plain version for a CPU
    one."""
    if mask.device.type == "cpu":
        return nms_scan_plain(mask, n)
    if not mask.is_cuda or mask.dtype != torch.int64 or mask.dim() != 3 \
            or mask.shape[1:] != (n, _words(n)):
        raise MXNetError("nms_scan: mask must be (B, %d, %d) int64 on a "
                         "CUDA device, got %s %s on %s"
                         % (n, _words(n), mask.dtype, tuple(mask.shape),
                            mask.device))
    B = mask.shape[0]
    keep = torch.empty((B, n), dtype=torch.bool, device=mask.device)
    if B == 0 or n == 0:
        return keep
    mask = mask.contiguous()
    lib = _library()
    dev = mask.get_device()
    raise_if(lib.mx_nms_scan(mask.data_ptr(), keep.data_ptr(), B, n, dev,
                             current_stream(dev)), "nms_scan")
    nms_scan.launches += 1
    return keep


nms_mask.launches = 0
nms_scan.launches = 0


def nms(boxes, scores, thresh):
    """Greedy NMS of each image's boxes (B, N, 4) by scores (B, N): keep
    flags (B, N) bool in the boxes' order. Ties in score keep index order
    (a stable sort of −scores, as ``jnp.argsort`` sorts)."""
    order = torch.sort(-scores, dim=-1, stable=True).indices
    boxes_s = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    keep_s = nms_scan(nms_mask(boxes_s.float(), thresh), boxes.shape[1])
    return torch.zeros_like(keep_s).scatter_(1, order, keep_s)
