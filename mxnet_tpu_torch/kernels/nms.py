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
  (0 elsewhere, and in the padding past N). The IoU rounds every line as
  ``_iou_matrix`` does in float32, in its order, with no fma contraction
  and IEEE division, so a pair at the threshold decides as it does there.
* ``nms_scan(mask, n)``: one block per image walks the sorted order with
  the removed bits in shared memory. Returns (B, N) bool keep flags: box i
  is kept iff no kept box before it suppresses it (the JAX loop's rule).
* ``nms(boxes, scores, thresh)``: the op-level function: a stable sort of
  −scores (``jnp.argsort``'s order), the two kernels, and the keep flags
  put back in the boxes' order.

Both kernels take a whole batch in one launch each. Bound: the mask by
operations (14 float32 operations an IoU pair above the diagonal, 4 a
box for its area), the scan by its dependent walk. Deterministic: no atomics.

Dispatch: the plain versions run only for tensors on the CPU. A CUDA
tensor launches the kernel or raises ``MXNetError``; nothing falls back.
``nms_mask.launches`` and ``nms_scan.launches`` count calls that launched.
Build: ``kernels/build.py`` compiles ``csrc/nms.cu`` with ``nvcc`` for
``sm_90a`` at first use, loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from .build import cuda_library, current_stream, raise_if

__all__ = ["iou_matrix", "nms_mask", "nms_scan", "nms", "nms_mask_plain",
           "nms_scan_plain", "BITS"]

BITS = 64
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
