"""BatchNorm(+ReLU) train core for Hopper: forward and backward kernels,
each beside its plain PyTorch version.

What they replace:

* ``bn_bwd`` is the counterpart of the TPU kernel ``bn_bwd_onepass``
  (``tools/bn_pallas_probe.py:76``, ``pl.pallas_call`` at ``:142``) and of
  the jnp hand-VJP backward ``_bwd`` (``mxnet_tpu/ops/nn.py:519``): it
  recomputes x̂ = (x − mean)·rstd and the ReLU mask from the forward's own
  affine (y = x·scale + shift), reduces dβ = Σdu and dγ = Σdu·x̂ per
  channel, and writes dx = (du − dβ/n − x̂·dγ/n)·scale.
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

What the design does about it, and what it leaves: each function is a
partial-sum kernel over (channel, chunk of the N·HW elements of that
channel) writing a fixed-order f32 partials buffer, then a
finalize-and-apply kernel that reduces the channel's partials in the same
fixed order and makes the elementwise pass. No atomics, so repeat runs are
bit for bit identical. The price is one extra read of the inputs: 3
sweeps for the forward (4 under ``exact``) and 5 for the backward, against
K1's ~3.06, which held a channel group's whole (N, k·HW) slab in VMEM
across both phases. Holding a channel slab in shared memory the same way
is later work. K1's (N, C·HW) channel-group layout with
k = 128/gcd(HW, 128) existed for the TPU's 128 lanes and is not kept:
here each program walks its channel's N planes of HW contiguous elements
through a flat index, with masked block loads at the ragged edge.

Dispatch: the plain version runs only for tensors on the CPU. A CUDA
tensor launches the Triton kernels or raises; nothing falls back.
``bn_fwd.launches`` and ``bn_bwd.launches`` count kernel launches (one per
call that launched), never plain runs.
"""
from __future__ import annotations

import os

import torch

from ..base import MXNetError

__all__ = ["bn_fwd", "bn_bwd", "bn_fwd_plain", "bn_bwd_plain"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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


def bn_bwd_plain(du, x, rstd, mean, scale, shift, relu):
    """Plain PyTorch backward (the argument order of K1 and of the
    probe's ``bn_bwd_jnp``): returns (dx, dbeta, dgamma)."""
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
    dx = (duf - (dbeta / n).reshape(bshape)
          - xhat * (dgamma / n).reshape(bshape)) * scale.reshape(bshape)
    return dx.to(x.dtype), dbeta, dgamma


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------
_BLOCK = 1024       # elements per tile: 8 per thread at 4 warps
_MAX_CHUNKS = 512   # partials per channel; one masked load finalizes them


def _triton_module():
    """Import the Triton kernels, with Triton's cache inside the checkout
    (``build/triton``, git-ignored) unless the caller chose one."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(_REPO_ROOT, "build", "triton"))
    from . import batchnorm_triton
    return batchnorm_triton


def _cdiv(a, b):
    return -(-a // b)


def _plan(x):
    """(HW, CHW, NHW, tiles per chunk, chunks S, S rounded up to a power
    of two) for an NC... tensor."""
    N, C = x.shape[0], x.shape[1]
    hw = x.numel() // (N * C)
    nhw = N * hw
    tiles = max(min(4, _cdiv(nhw, _BLOCK)), _cdiv(nhw, _BLOCK * _MAX_CHUNKS))
    s = _cdiv(nhw, _BLOCK * tiles)
    s_block = max(16, 1 << (s - 1).bit_length())
    return hw, C * hw, nhw, tiles, s, s_block


def _check_cuda(name, acts, vecs):
    """Raise unless the activation-shaped tensors ``acts`` are contiguous
    float32/bfloat16 on one CUDA device (int32 offsets) and the per-channel
    ``vecs`` have one entry per channel on the same device."""
    x = acts[0]
    if x.device.type != "cuda":
        raise MXNetError("%s: tensors on %s are not supported" %
                         (name, x.device))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise MXNetError("%s: dtype %s is not supported" % (name, x.dtype))
    if x.dim() < 2 or x.numel() == 0 or x.numel() >= 2 ** 31:
        raise MXNetError("%s: shape %s is not supported" %
                         (name, tuple(x.shape)))
    for t in acts:
        if t.device != x.device or not t.is_contiguous() \
                or t.shape != x.shape or t.dtype != x.dtype:
            raise MXNetError("%s: activations must be contiguous %s %s on "
                             "%s" % (name, x.dtype, tuple(x.shape), x.device))
    for t in vecs:
        if t.device != x.device or t.numel() != x.shape[1]:
            raise MXNetError("%s: per-channel inputs must have %d entries "
                             "on %s" % (name, x.shape[1], x.device))


def _vec(v):
    return v.detach().to(torch.float32).contiguous()


def bn_fwd(x, gamma, beta, c, eps, fix_gamma, relu, exact):
    """BatchNorm(+ReLU) train forward: (y, mean, var, rstd, scale, shift).

    x is (N, C, ...) in float32 or bfloat16; gamma, beta and the centre c
    are (C,). y comes back in x's dtype, the statistics in float32."""
    if x.device.type == "cpu":
        return bn_fwd_plain(x, gamma, beta, c, eps, fix_gamma, relu, exact)
    _check_cuda("bn_fwd", (x,), (gamma, beta, c))
    k = _triton_module()
    hw, chw, nhw, tiles, s, s_block = _plan(x)
    C = x.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    g, b, cc = _vec(gamma), _vec(beta), _vec(c)
    stats = torch.empty((5, C), **f32)   # mean, var, rstd, scale, shift
    part = torch.empty((C, s, 2), **f32)
    y = torch.empty_like(x)
    grid = (C, s)
    if exact:
        # pass 1: Σx (centre 0) -> mean; pass 2 centres on that mean
        prev = torch.empty((C, s, 2), **f32)
        k.bn_fwd_partials[grid](x, torch.zeros_like(cc), prev, prev,
                                hw, chw, nhw, s, tiles, float(nhw),
                                CENTER_FROM_PREV=False, BLOCK=_BLOCK,
                                S_BLOCK=s_block, num_warps=4)
        k.bn_fwd_partials[grid](x, cc, prev, part, hw, chw, nhw, s, tiles,
                                float(nhw), CENTER_FROM_PREV=True,
                                BLOCK=_BLOCK, S_BLOCK=s_block, num_warps=4)
    else:
        prev = part
        k.bn_fwd_partials[grid](x, cc, part, part, hw, chw, nhw, s, tiles,
                                float(nhw), CENTER_FROM_PREV=False,
                                BLOCK=_BLOCK, S_BLOCK=s_block, num_warps=4)
    k.bn_fwd_apply[grid](x, y, part, prev, cc, g, b, stats, C,
                         hw, chw, nhw, s, tiles, float(nhw), float(eps),
                         EXACT=bool(exact), FIX_GAMMA=bool(fix_gamma),
                         RELU=bool(relu), BLOCK=_BLOCK, S_BLOCK=s_block,
                         num_warps=4)
    bn_fwd.launches += 1
    mean, var, rstd, scale, shift = stats.unbind(0)
    return y, mean, var, rstd, scale, shift


def bn_bwd(du, x, rstd, mean, scale, shift, relu):
    """BatchNorm(+ReLU) backward from the forward's statistics and affine:
    (dx, dbeta, dgamma); dx in x's dtype, dbeta and dgamma (C,) float32."""
    if x.device.type == "cpu":
        return bn_bwd_plain(du, x, rstd, mean, scale, shift, relu)
    _check_cuda("bn_bwd", (x, du), (rstd, mean, scale, shift))
    k = _triton_module()
    hw, chw, nhw, tiles, s, s_block = _plan(x)
    C = x.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    mu, rs, sc, sh = _vec(mean), _vec(rstd), _vec(scale), _vec(shift)
    part = torch.empty((C, s, 2), **f32)
    grads = torch.empty((2, C), **f32)   # dbeta, dgamma
    dx = torch.empty_like(x)
    grid = (C, s)
    k.bn_bwd_partials[grid](x, du, mu, rs, sc, sh, part, hw, chw, nhw, s,
                            tiles, RELU=bool(relu), BLOCK=_BLOCK,
                            num_warps=4)
    k.bn_bwd_apply[grid](x, du, dx, mu, rs, sc, sh, part, grads, C, hw, chw,
                         nhw, s, tiles, float(nhw), RELU=bool(relu),
                         BLOCK=_BLOCK, S_BLOCK=s_block, num_warps=4)
    bn_bwd.launches += 1
    dbeta, dgamma = grads.unbind(0)
    return dx, dbeta, dgamma


bn_fwd.launches = 0
bn_bwd.launches = 0
