"""ROI max pooling for Hopper: ``roi_pool_fwd`` and ``roi_pool_bwd``
(``csrc/roi_pooling.cu``), each beside its plain PyTorch version, and
``roi_pooling``, their ``torch.autograd.Function``.

What they replace: no TPU kernel. They are the counterpart of
``_roi_pooling`` (``mxnet_tpu/ops/conv.py:341``), which the JAX package
computes by masks over the whole feature map, one per output bin:
R·ph·pw·C·H·W compares, 1.8·10¹⁰ at Faster R-CNN's test shape (300 ROIs,
7×7 bins, 512 channels, a 38×63 map), and a 240 MB mask an ROI. Its
"planned fast path" Pallas kernel was never written.

* ``roi_pool_fwd(data, rois, pooled, scale)``: one thread per (roi, c,
  iy, ix). The bin is the JAX op's, rounded as it rounds it (the ROI's
  corners ``round(roi·scale)`` half to even, ``bin_h = rh/ph``,
  ``floor(y1 + iy·bin_h)`` and ``ceil(y1 + (iy+1)·bin_h)`` with one
  float32 rounding each). Returns (out, count): the bin's max (0 for an
  empty bin) and how many of its positions equal it, both (R, C, ph, pw).
* ``roi_pool_bwd(grad, data, rois, out, count, pooled, scale)``: one
  thread per input element. It walks the ROIs of its image in index order
  and the bins that hold it, and adds ``g / count`` where it equals the
  bin's max: the VJP of ``jnp.max``, which splits the gradient equally
  among ties (post-ReLU maps are full of zero ties, where a backward that
  gave all to one argmax would differ).

Deterministic: no atomics; each output has one writer. An ROI's batch
index is truncated to an integer and clamped into [0, N). Dispatch: the
plain versions run only for tensors on the CPU. A CUDA tensor launches
the kernel or raises ``MXNetError``; nothing falls back.
``roi_pool_fwd.launches`` and ``roi_pool_bwd.launches`` count calls that
launched. Build: ``kernels/build.py`` compiles ``csrc/roi_pooling.cu``
with ``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from .build import cuda_library, current_stream, raise_if

__all__ = ["roi_pool_fwd", "roi_pool_bwd", "roi_pool_fwd_plain",
           "roi_pool_bwd_plain", "roi_pooling"]

NEG = -1e30          # the JAX op's fill outside a bin
_LIB = []


def _library():
    """Build (once per process) and load the kernels' shared library."""
    if _LIB:
        return _LIB[0]
    lib = cuda_library("mxnet_tpu_torch_roi_pooling", "roi_pooling.cu")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mx_roi_pool_fwd.argtypes = [P] * 4 + [I] * 7 + [F, I, P]
    lib.mx_roi_pool_bwd.argtypes = [P] * 6 + [I] * 7 + [F, I, P]
    lib.mx_roi_pool_fwd.restype = lib.mx_roi_pool_bwd.restype = I
    _LIB.append(lib)
    return lib


def _bins(rois, scale, pooled, n):
    """Each ROI's image and bin edges, as the JAX op rounds them:
    (batch (R,), hstart, hend (R, ph), wstart, wend (R, pw))."""
    ph, pw = pooled
    batch = rois[:, 0].to(torch.int64).clamp(0, n - 1)
    x1, y1, x2, y2 = (torch.round(rois[:, k] * scale) for k in range(1, 5))
    # divisors as tensors: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, an ulp off the IEEE quotient that the
    # kernel and the JAX op take
    ph_t, pw_t = (torch.full((), float(p), dtype=rois.dtype,
                             device=rois.device) for p in (ph, pw))
    bin_h = torch.clamp_min(y2 - y1 + 1.0, 1.0) / ph_t
    bin_w = torch.clamp_min(x2 - x1 + 1.0, 1.0) / pw_t
    iy = torch.arange(ph, dtype=rois.dtype, device=rois.device)
    ix = torch.arange(pw, dtype=rois.dtype, device=rois.device)
    return (batch,
            torch.floor(y1[:, None] + iy * bin_h[:, None]),
            torch.ceil(y1[:, None] + (iy + 1) * bin_h[:, None]),
            torch.floor(x1[:, None] + ix * bin_w[:, None]),
            torch.ceil(x1[:, None] + (ix + 1) * bin_w[:, None]))


def _one_roi(data, bins, r):
    """The JAX op's mask formulation for ROI r: (out, count), each
    (C, ph, pw); differentiable in data (``amax`` splits ties evenly)."""
    batch, hs, he, ws, we = bins
    H, W = data.shape[2], data.shape[3]
    ys = torch.arange(H, dtype=data.dtype, device=data.device)
    xs = torch.arange(W, dtype=data.dtype, device=data.device)
    my = (ys >= hs[r, :, None]) & (ys < he[r, :, None])          # (ph, H)
    mx = (xs >= ws[r, :, None]) & (xs < we[r, :, None])          # (pw, W)
    mask = my[:, None, :, None] & mx[None, :, None, :]       # (ph, pw, H, W)
    fmap = data[batch[r]][:, None, None]                     # (C, 1, 1, H, W)
    vals = torch.where(mask, fmap, torch.full((), NEG, dtype=data.dtype,
                                              device=data.device))
    m = vals.amax(dim=(3, 4))
    nonempty = mask.any(dim=(2, 3))
    out = torch.where(nonempty, m, torch.zeros((), dtype=data.dtype,
                                               device=data.device))
    count = ((vals == m[..., None, None]) & mask).sum(dim=(3, 4))
    return out, (count * nonempty).to(torch.int32)


def roi_pool_fwd_plain(data, rois, pooled, scale):
    """Plain PyTorch forward, one ROI at a time: (out, count)."""
    R, C = rois.shape[0], data.shape[1]
    if R == 0:
        return (data.new_zeros((0, C) + tuple(pooled)),
                torch.zeros((0, C) + tuple(pooled), dtype=torch.int32,
                            device=data.device))
    bins = _bins(rois, scale, pooled, data.shape[0])
    outs, counts = zip(*(_one_roi(data, bins, r) for r in range(R)))
    return torch.stack(outs), torch.stack(counts)


def roi_pool_bwd_plain(grad, data, rois, pooled, scale):
    """Plain PyTorch input gradient: autograd of the mask formulation,
    one ROI at a time, summed in ROI order."""
    bins = _bins(rois, scale, pooled, data.shape[0])
    dx = torch.zeros_like(data)
    with torch.enable_grad():
        for r in range(rois.shape[0]):
            d = data.detach().requires_grad_(True)
            out, _ = _one_roi(d, bins, r)
            dx += torch.autograd.grad(out, d, grad[r])[0]
    return dx


def _check(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if not t.is_cuda or t.device != dev or t.dtype != dt:
            raise MXNetError("%s: inputs must be %s on one CUDA device, "
                             "got %s on %s" % (name, [str(d) for d in dtypes],
                                               [str(t.dtype) for t in tensors],
                                               [str(t.device) for t in
                                                tensors]))


def _dims(data, rois, pooled, scale):
    N, C, H, W = data.shape
    return (N, C, H, W, rois.shape[0], int(pooled[0]), int(pooled[1]),
            float(scale))


def roi_pool_fwd(data, rois, pooled, scale):
    """ROI max pooling of data (N, C, H, W) float32 over rois (R, 5):
    (out, count), each (R, C, ph, pw), count int32."""
    if data.device.type == "cpu":
        return roi_pool_fwd_plain(data, rois, pooled, scale)
    _check("roi_pool_fwd", (data, rois), (torch.float32, torch.float32))
    if data.dim() != 4 or rois.dim() != 2 or rois.shape[1] != 5:
        raise MXNetError("roi_pool_fwd: data must be (N, C, H, W) and rois "
                         "(R, 5), got %s and %s"
                         % (tuple(data.shape), tuple(rois.shape)))
    dims = _dims(data, rois, pooled, scale)
    shape = (rois.shape[0], data.shape[1]) + tuple(int(p) for p in pooled)
    out = torch.empty(shape, dtype=torch.float32, device=data.device)
    count = torch.empty(shape, dtype=torch.int32, device=data.device)
    if out.numel() == 0 or data.numel() == 0:
        return out.zero_(), count.zero_()
    data, rois = data.contiguous(), rois.contiguous()
    lib = _library()
    dev = data.get_device()
    raise_if(lib.mx_roi_pool_fwd(data.data_ptr(), rois.data_ptr(),
                                 out.data_ptr(), count.data_ptr(), *dims,
                                 dev, current_stream(dev)), "roi_pool_fwd")
    roi_pool_fwd.launches += 1
    return out, count


def roi_pool_bwd(grad, data, rois, out, count, pooled, scale):
    """Input gradient (N, C, H, W) of ROI max pooling from the head
    gradient and the forward's out and count."""
    if data.device.type == "cpu":
        return roi_pool_bwd_plain(grad, data, rois, pooled, scale)
    _check("roi_pool_bwd", (grad, data, rois, out, count),
           (torch.float32,) * 4 + (torch.int32,))
    dims = _dims(data, rois, pooled, scale)
    dx = torch.empty_like(data, memory_format=torch.contiguous_format)
    if out.numel() == 0 or data.numel() == 0:
        return dx.zero_()
    grad, data, rois = grad.contiguous(), data.contiguous(), rois.contiguous()
    lib = _library()
    dev = data.get_device()
    raise_if(lib.mx_roi_pool_bwd(grad.data_ptr(), data.data_ptr(),
                                 rois.data_ptr(), out.contiguous().data_ptr(),
                                 count.contiguous().data_ptr(),
                                 dx.data_ptr(), *dims, dev,
                                 current_stream(dev)), "roi_pool_bwd")
    roi_pool_bwd.launches += 1
    return dx


roi_pool_fwd.launches = 0
roi_pool_bwd.launches = 0


class _ROIPool(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient; the
    ROIs get none (the JAX op's ``round``/``floor`` pass none)."""

    @staticmethod
    def forward(ctx, data, rois, pooled, scale):
        out, count = roi_pool_fwd(data, rois, pooled, scale)
        ctx.save_for_backward(data, rois, out, count)
        ctx.pooled, ctx.scale = pooled, scale
        return out

    @staticmethod
    def backward(ctx, g):
        data, rois, out, count = ctx.saved_tensors
        dx = roi_pool_bwd(g.contiguous(), data, rois, out, count,
                          ctx.pooled, ctx.scale)
        return dx, None, None, None


def roi_pooling(data, rois, pooled, scale):
    """ROIPooling's output (R, C, ph, pw), differentiable in data."""
    return _ROIPool.apply(data, rois.detach(), tuple(pooled), float(scale))
