"""BatchNorm(+ReLU) train core for Hopper: forward and backward CUDA
kernels (``csrc/batchnorm.cu``), each beside its plain PyTorch version.

What they replace:

* ``bn_bwd`` is the counterpart of the TPU kernel ``bn_bwd_onepass``
  (``tools/bn_pallas_probe.py:76``, ``pl.pallas_call`` at ``:142``) and of
  the jnp hand-VJP backward ``_bwd`` (``mxnet_tpu/ops/nn.py:519``): it
  recomputes x̂ = (x − mean)·rstd and the ReLU mask from the forward's own
  affine (y = x·scale + shift), reduces dβ = Σdu and dγ = Σdu·x̂ per
  channel, and writes dx = (du − dβ/n − x̂·dγ/n)·scale, or no dx at all
  when the caller needs none (``need_dx=False``: the data's BatchNorm).
* ``bn_fwd`` is the counterpart of the jnp forward ``_fwd``
  (``mxnet_tpu/ops/nn.py:460``): centred one-pass statistics
  (m1 = Σ(x−c)/n, m2 = Σ(x−c)²/n, mean = c + m1, var = max(m2 − m1², 0)),
  or the two-pass mean-then-var under ``exact``; then rstd, scale, shift,
  y = x·scale + shift and the optional ReLU. It returns scale and shift
  so that the backward recomputes the mask from the very same per-channel
  values, and both kernels evaluate y with one ``fma``, so the mask never
  flips between them.

What bounds them on the H100: bytes. Per channel the work is a few flops
per element, far below the card's ~295 flops/byte balance point. The least
traffic is 2 activation sweeps for the forward (read x, write y) and 3 for
the backward (read x and du, write dx); the (C,) f32 statistics are noise.

What the design does about it: like K1, which held a channel group's
whole (N, k·HW) slab in VMEM across both of its phases, each kernel reads
a channel's slab (its N planes of HW contiguous elements) from device
memory once and keeps it on chip. ``plan`` picks one of three layouts by
the slab's bytes (x in the forward, x and du in the backward):

* ``block``: the slab fits one block's shared memory, 227 KB less 1 KB
  of scratch (``SLAB_BYTES``): one block per channel;
* ``cluster``: it fits a cluster of 2, 4 or 8 blocks (the portable
  sizes), each holding a share; the blocks' partial sums are exchanged
  through distributed shared memory;
* ``split``: anything larger (at batch 32: the data's BatchNorm, and the
  backward at 112²): a partial-sums kernel over (chunk, channel) with one
  fixed slot each, then a kernel that reduces a channel's slots and makes
  the elementwise pass.

Block and cluster take one launch, 2 sweeps in the forward (``exact``
included: its second pass runs from shared memory) and 3 in the
backward; split takes two launches (three under ``exact``), 3 and 5
sweeps. Addressing walks each plane in 16-byte units where a plane's
bytes allow it (``plan(...).aligned``), else in 4- or 2-byte units, with
no division per element.

Deterministic: every sum runs in an order fixed by the plan alone (per
thread, then a shuffle tree per warp, then warps, cluster ranks 0…k−1 or
chunks in index order). No atomics, so repeat runs are bit for bit
identical, and with ``need_dx=False`` dβ and dγ are the bits of the full
call.

Build: ``kernels/build.py`` compiles ``csrc/batchnorm.cu`` with ``nvcc``
for ``sm_90a`` at first use into ``build/cuda/mxnet_tpu_torch_batchnorm``
(no PyTorch header; seconds), loaded with ``ctypes``; each call is one
``ctypes`` call on PyTorch's current stream.

Dispatch: the plain version runs only for tensors on the CPU. A CUDA
tensor launches the kernels or raises ``MXNetError`` (a dtype, shape or
layout they do not take, a failed build, a refused launch); nothing falls
back. ``bn_fwd.launches`` and ``bn_bwd.launches`` count calls that
launched, never plain runs; ``launches_bf16`` counts those of them on
bfloat16 activations.

Program analysis (``telemetry.introspect``): while a first run is being
counted, each call adds its own work — ~7 float32 operations an element
and x read + y written forward, ~16 operations and x and du read (+ dx
written) backward, as ``chip_smoke.py`` bounds the kernels — and hides
the aten ops around or instead of it, so the CPU and the card count the
same.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..base import MXNetError
from ..telemetry.introspect import active_counter, kernel_work
from .build import cuda_library, current_stream, raise_if

__all__ = ["bn_fwd", "bn_bwd", "bn_fwd_plain", "bn_bwd_plain", "plan",
           "Plan", "SLAB_BYTES"]


def _red_axes(x):
    return [0] + list(range(2, x.dim()))


def _bshape(x):
    return (1, -1) + (1,) * (x.dim() - 2)


def _affine(xf, scale, shift, bshape):
    """x·scale + shift rounded once, as the kernels' fma rounds it: the
    float32 product is exact in float64, so only the sum rounds (and its
    sign, hence the ReLU mask, is the exact one, as fma's is)."""
    f64 = torch.float64
    return (xf.to(f64) * scale.to(f64).reshape(bshape)
            + shift.to(f64).reshape(bshape)).to(torch.float32)


def bn_fwd_plain(x, gamma, beta, c, eps, fix_gamma, relu, exact):
    """Plain PyTorch forward: returns (y, mean, var, rstd, scale, shift),
    y in x's dtype and the (C,) statistics in float32."""
    f32 = torch.float32
    axes, bshape = _red_axes(x), _bshape(x)
    n = x.numel() // x.shape[1]
    xf = x.to(f32)
    if exact:
        mean = xf.mean(axes)
        var = torch.square(xf - mean.reshape(bshape)).mean(axes)
    else:
        xc = xf - c.to(f32).reshape(bshape)
        m1 = xc.sum(axes) / n
        m2 = (xc * xc).sum(axes) / n
        mean = c.to(f32) + m1
        var = torch.clamp_min(m2 - m1 * m1, 0.0)
    rstd = torch.rsqrt(var + eps)
    g = torch.ones_like(rstd) if fix_gamma else gamma.to(f32)
    scale = g * rstd
    shift = beta.to(f32) - mean * scale
    y = _affine(xf, scale, shift, bshape)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype), mean, var, rstd, scale, shift


def bn_bwd_plain(du, x, rstd, mean, scale, shift, relu, need_dx=True):
    """Plain PyTorch backward (the argument order of K1 and of the
    probe's ``bn_bwd_jnp``): returns (dx, dbeta, dgamma), dx None unless
    ``need_dx``."""
    f32 = torch.float32
    axes, bshape = _red_axes(x), _bshape(x)
    n = x.numel() // x.shape[1]
    xf = x.to(f32)
    xhat = (xf - mean.reshape(bshape)) * rstd.reshape(bshape)
    duf = du.to(f32)
    if relu:
        y = _affine(xf, scale, shift, bshape)
        duf = torch.where(y > 0, duf, torch.zeros_like(duf))
    dbeta = duf.sum(axes)
    dgamma = (duf * xhat).sum(axes)
    if not need_dx:
        return None, dbeta, dgamma
    dx = (duf - (dbeta / n).reshape(bshape)
          - xhat * (dgamma / n).reshape(bshape)) * scale.reshape(bshape)
    return dx.to(x.dtype), dbeta, dgamma


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------
SMEM_BYTES = 232448             # shared memory of one H100 block (227 KB)
SLAB_BYTES = SMEM_BYTES - 1024  # less the kernels' static scratch
CLUSTERS = (1, 2, 4, 8)         # the portable cluster sizes
SPLIT_THREADS = 256
SPLIT_UNITS = 4096              # least units of a split chunk
MAX_CHUNKS = 1024
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


class Plan(NamedTuple):
    """How one call runs: ``kind`` block, cluster or split; ``cluster``
    blocks per channel (1 unless a cluster); ``threads`` per block;
    ``unit_bytes`` (16, 4 or 2) of each load and store; ``smem`` dynamic
    shared memory per block in bytes; ``share`` units a block holds (or a
    split chunk has); ``chunks`` per channel (1 unless split)."""
    kind: str
    cluster: int
    threads: int
    unit_bytes: int
    smem: int
    share: int
    chunks: int

    @property
    def aligned(self):
        """Whether planes move in 16-byte units."""
        return self.unit_bytes == 16


def _cdiv(a, b):
    return -(-a // b)


def _slab_threads(share):
    """128 to 1024 threads, at least 8 units each where the share allows."""
    t = 128
    while t < 1024 and t * 16 <= share:
        t *= 2
    return t


def plan(op, shape, dtype, need_dx=True, align=16):
    """The plan of ``op`` ("fwd" or "bwd") on an (N, C, ...) tensor of
    ``dtype`` whose pointers are all ``align``-byte aligned. The slab is
    x in the forward and x and du in the backward; a backward without dx
    keeps nothing on chip (``smem`` 0) but takes the same layout."""
    if op not in ("fwd", "bwd"):
        raise MXNetError("plan: op must be 'fwd' or 'bwd', not %r" % (op,))
    if dtype not in _ESIZE:
        raise MXNetError("plan: dtype %s is not supported" % dtype)
    es = _ESIZE[dtype]
    N, C = shape[0], shape[1]
    hw = 1
    for d in shape[2:]:
        hw *= d
    ub = next(u for u in (16, 4, 2)
              if u >= es and (hw * es) % u == 0 and align % u == 0)
    units = N * hw * es // ub
    arrays = 1 if op == "fwd" else 2
    kept = arrays if (op == "fwd" or need_dx) else 0
    for k in CLUSTERS:
        share = _cdiv(units, k)
        if share * ub * arrays <= SLAB_BYTES:
            return Plan("block" if k == 1 else "cluster", k,
                        _slab_threads(share), ub, share * ub * kept, share,
                        1)
    if C > 65535:
        raise MXNetError("plan: %d channels do not fit a split grid" % C)
    share = max(SPLIT_UNITS, _cdiv(units, MAX_CHUNKS))
    return Plan("split", 1, SPLIT_THREADS, ub, 0, share,
                _cdiv(units, share))


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------
_LIB = []      # the loaded library, once built
_CALLS = {}    # (op, shape, dtype, flag, align) -> _Call
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_KIND = {"block": 0, "cluster": 1, "split": 2}


class _Call(NamedTuple):
    """What one kind of call hands the C function, computed once: the
    plan packed as 11 C ints (``ints``, kept alive here; ``plan_ptr`` its
    address), and the per-channel buffer as ``rows`` rows of C floats whose
    first 5 (forward) or 2 (backward) are the results and whose row
    ``scratch_row`` on (16-byte aligned) is the split plan's scratch."""
    ints: object
    plan_ptr: int
    rows: int
    scratch_row: int


def _library():
    """Build (once per process) and load the kernels' shared library."""
    if _LIB:
        return _LIB[0]
    lib = cuda_library("mxnet_tpu_torch_batchnorm", "batchnorm.cu")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mx_bn_fwd.argtypes = [P] * 8 + [F] + [I] * 4 + [P]
    lib.mx_bn_bwd.argtypes = [P] * 10 + [I] * 2 + [P]
    lib.mx_bn_fwd.restype = lib.mx_bn_bwd.restype = I
    _LIB.append(lib)
    return lib


def _align(*ptrs):
    """The largest power of two up to 16 that divides every address."""
    a = 0
    for p in ptrs:
        a |= p
    return min(16, a & -a) if a else 16


def _call(op, x, flag, align):
    """The ``_Call`` of ``op`` on x, cached per key. ``flag`` is ``exact``
    for the forward and ``need_dx`` for the backward."""
    key = (op, x.shape, x.dtype, flag, align)
    hit = _CALLS.get(key)
    if hit is None:
        p = plan(op, x.shape, x.dtype, need_dx=flag if op == "bwd" else True,
                 align=align)
        N, C = x.shape[0], x.shape[1]
        results, scratch_row = (5, 8) if op == "fwd" else (2, 4)
        parts = 2 if (op == "fwd" and flag) else 1
        rows = scratch_row + 2 * p.chunks * parts if p.kind == "split" \
            else results
        ints = (ctypes.c_int * 11)(
            _DTYPE[x.dtype], p.unit_bytes, _KIND[p.kind], p.cluster,
            p.threads, p.smem, p.share, p.chunks, N, C,
            x.numel() // (N * C))
        hit = _CALLS[key] = _Call(ints, ctypes.addressof(ints), rows,
                                  scratch_row)
    return hit


def _check_cuda(name, acts, vecs):
    """Raise unless the activation-shaped tensors ``acts`` are contiguous
    float32/bfloat16 on one CUDA device (int32 offsets) and the per-channel
    ``vecs`` have one entry per channel on the same device."""
    x = acts[0]
    if not x.is_cuda:
        raise MXNetError("%s: tensors on %s are not supported" %
                         (name, x.device))
    if x.dtype not in _DTYPE:
        raise MXNetError("%s: dtype %s is not supported" % (name, x.dtype))
    if x.dim() < 2 or x.numel() == 0 or x.numel() >= 2 ** 31:
        raise MXNetError("%s: shape %s is not supported" %
                         (name, tuple(x.shape)))
    dev, C = x.get_device(), x.shape[1]
    for t in acts:
        if t.get_device() != dev or not t.is_contiguous() \
                or t.shape != x.shape or t.dtype != x.dtype:
            raise MXNetError("%s: activations must be contiguous %s %s on "
                             "%s" % (name, x.dtype, tuple(x.shape), x.device))
    for t in vecs:
        if t.get_device() != dev or t.numel() != C:
            raise MXNetError("%s: per-channel inputs must have %d entries "
                             "on %s" % (name, C, x.device))


def _vec(v):
    if v.dtype == torch.float32 and v.is_contiguous():
        return v
    return v.detach().to(torch.float32).contiguous()


def bn_fwd(x, gamma, beta, c, eps, fix_gamma, relu, exact):
    """BatchNorm(+ReLU) train forward: (y, mean, var, rstd, scale, shift).

    x is (N, C, ...) in float32 or bfloat16; gamma, beta and the centre c
    are (C,). y comes back in x's dtype, the statistics in float32."""
    if active_counter() is not None:
        with kernel_work(7 * x.numel(), 2 * x.numel() * x.element_size()):
            return _bn_fwd(x, gamma, beta, c, eps, fix_gamma, relu, exact)
    return _bn_fwd(x, gamma, beta, c, eps, fix_gamma, relu, exact)


def _bn_fwd(x, gamma, beta, c, eps, fix_gamma, relu, exact):
    if x.device.type == "cpu":
        return bn_fwd_plain(x, gamma, beta, c, eps, fix_gamma, relu, exact)
    _check_cuda("bn_fwd", (x,), (gamma, beta, c))
    lib = _library()
    xp = x.data_ptr()
    call = _call("fwd", x, bool(exact), _align(xp))
    dev = x.get_device()
    g, b, cc = _vec(gamma), _vec(beta), _vec(c)
    y = torch.empty_like(x)
    buf = torch.empty((call.rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    ptr = buf.data_ptr()
    raise_if(lib.mx_bn_fwd(
        xp, y.data_ptr(), g.data_ptr(), b.data_ptr(), cc.data_ptr(), ptr,
        ptr + 4 * call.scratch_row * x.shape[1], call.plan_ptr, eps,
        bool(fix_gamma), bool(relu), bool(exact), dev,
        current_stream(dev)), "bn_fwd")
    bn_fwd.launches += 1
    bn_fwd.launches_bf16 += x.dtype == torch.bfloat16
    stats = buf if call.rows == 5 else buf[:5]
    mean, var, rstd, scale, shift = stats.unbind(0)
    return y, mean, var, rstd, scale, shift


def bn_bwd(du, x, rstd, mean, scale, shift, relu, need_dx=True):
    """BatchNorm(+ReLU) backward from the forward's statistics and affine:
    (dx, dbeta, dgamma); dx in x's dtype (None unless ``need_dx``), dbeta
    and dgamma (C,) float32."""
    if active_counter() is not None:
        sweeps = 3 if need_dx else 2
        with kernel_work(16 * x.numel(),
                         sweeps * x.numel() * x.element_size()):
            return _bn_bwd(du, x, rstd, mean, scale, shift, relu, need_dx)
    return _bn_bwd(du, x, rstd, mean, scale, shift, relu, need_dx)


def _bn_bwd(du, x, rstd, mean, scale, shift, relu, need_dx):
    if x.device.type == "cpu":
        return bn_bwd_plain(du, x, rstd, mean, scale, shift, relu, need_dx)
    _check_cuda("bn_bwd", (x, du), (rstd, mean, scale, shift))
    lib = _library()
    need_dx = bool(need_dx)
    xp, dup = x.data_ptr(), du.data_ptr()
    call = _call("bwd", x, need_dx, _align(xp, dup))
    dev = x.get_device()
    mu, rs, sc, sh = _vec(mean), _vec(rstd), _vec(scale), _vec(shift)
    dx = torch.empty_like(x) if need_dx else None
    buf = torch.empty((call.rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    ptr = buf.data_ptr()
    raise_if(lib.mx_bn_bwd(
        dup, xp, dx.data_ptr() if need_dx else None,
        mu.data_ptr(), rs.data_ptr(), sc.data_ptr(), sh.data_ptr(), ptr,
        ptr + 4 * call.scratch_row * x.shape[1], call.plan_ptr, bool(relu),
        dev, current_stream(dev)), "bn_bwd")
    bn_bwd.launches += 1
    bn_bwd.launches_bf16 += x.dtype == torch.bfloat16
    dbeta, dgamma = (buf if call.rows == 2 else buf[:2]).unbind(0)
    return dx, dbeta, dgamma


bn_fwd.launches = bn_fwd.launches_bf16 = 0
bn_bwd.launches = bn_bwd.launches_bf16 = 0
