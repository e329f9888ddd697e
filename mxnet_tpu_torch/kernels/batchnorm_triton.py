"""Triton kernels of the BatchNorm(+ReLU) train core (sm_90a, H100).

Imported only by the launching wrappers in ``batchnorm.py`` (never when
the package is imported), so the package loads where Triton is absent.
The design and what it replaces are set out there. Every program owns one
(channel, chunk) pair: a chunk is ``TILES`` tiles of ``BLOCK`` elements of
the channel's flat index space i in [0, N·HW), at address
(i // HW)·C·HW + c·HW + i % HW of the NC(HW) tensor.

Determinism: each program sums its tiles in order into a per-lane f32
accumulator and reduces it with ``tl.sum``; the finalize step reduces a
channel's partials with one fixed-shape ``tl.sum``. No atomics.
"""
import triton
import triton.language as tl


@triton.jit
def _chunk_offsets(c, s, t, HW, CHW, NHW, TILES, BLOCK: tl.constexpr):
    i = (s * TILES + t) * BLOCK + tl.arange(0, BLOCK)
    mask = i < NHW
    n = i // HW
    return n * CHW + c * HW + (i - n * HW), mask


@triton.jit
def _channel_sums(part_ptr, c, S, S_BLOCK: tl.constexpr):
    """(Σ partial[c, :, 0], Σ partial[c, :, 1]) in a fixed order."""
    j = tl.arange(0, S_BLOCK)
    m = j < S
    p0 = tl.load(part_ptr + (c * S + j) * 2, mask=m, other=0.0)
    p1 = tl.load(part_ptr + (c * S + j) * 2 + 1, mask=m, other=0.0)
    return tl.sum(p0, axis=0), tl.sum(p1, axis=0)


@triton.jit
def bn_fwd_partials(x_ptr, center_ptr, prev_ptr, part_ptr, HW, CHW, NHW, S,
                    TILES, n_f, CENTER_FROM_PREV: tl.constexpr,
                    BLOCK: tl.constexpr, S_BLOCK: tl.constexpr):
    """partial[c, s] = (Σ(x − centre), Σ(x − centre)²) over the chunk. The
    centre is center[c], or under CENTER_FROM_PREV the mean Σx/n from the
    first pass's partials (the two-pass exact form)."""
    c = tl.program_id(0)
    s = tl.program_id(1)
    if CENTER_FROM_PREV:
        sx, _unused = _channel_sums(prev_ptr, c, S, S_BLOCK)
        cc = sx / n_f
    else:
        cc = tl.load(center_ptr + c)
    acc1 = tl.zeros([BLOCK], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK], dtype=tl.float32)
    for t in range(0, TILES):
        off, mask = _chunk_offsets(c, s, t, HW, CHW, NHW, TILES, BLOCK)
        xv = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        xc = tl.where(mask, xv - cc, 0.0)
        acc1 += xc
        acc2 += xc * xc
    tl.store(part_ptr + (c * S + s) * 2, tl.sum(acc1, axis=0))
    tl.store(part_ptr + (c * S + s) * 2 + 1, tl.sum(acc2, axis=0))


@triton.jit
def bn_fwd_apply(x_ptr, y_ptr, part_ptr, prev_ptr, center_ptr, gamma_ptr,
                 beta_ptr, stats_ptr, C, HW, CHW, NHW, S, TILES, n_f, eps,
                 EXACT: tl.constexpr, FIX_GAMMA: tl.constexpr,
                 RELU: tl.constexpr, BLOCK: tl.constexpr,
                 S_BLOCK: tl.constexpr):
    """Finalize the channel's statistics, then y = fma(x, scale, shift)
    (+ ReLU). Chunk 0 of each channel writes stats[:, c] =
    (mean, var, rstd, scale, shift)."""
    c = tl.program_id(0)
    s = tl.program_id(1)
    s1, s2 = _channel_sums(part_ptr, c, S, S_BLOCK)
    m1 = s1 / n_f
    m2 = s2 / n_f
    if EXACT:
        sx, _unused = _channel_sums(prev_ptr, c, S, S_BLOCK)
        mean = sx / n_f
        var = m2
    else:
        mean = tl.load(center_ptr + c) + m1
        var = tl.maximum(m2 - m1 * m1, 0.0)
    rstd = tl.rsqrt(var + eps)
    if FIX_GAMMA:
        scale = rstd
    else:
        scale = tl.load(gamma_ptr + c) * rstd
    shift = tl.load(beta_ptr + c) - mean * scale
    if s == 0:
        tl.store(stats_ptr + c, mean)
        tl.store(stats_ptr + C + c, var)
        tl.store(stats_ptr + 2 * C + c, rstd)
        tl.store(stats_ptr + 3 * C + c, scale)
        tl.store(stats_ptr + 4 * C + c, shift)
    for t in range(0, TILES):
        off, mask = _chunk_offsets(c, s, t, HW, CHW, NHW, TILES, BLOCK)
        xv = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        y = tl.fma(xv, scale, shift)
        if RELU:
            y = tl.maximum(y, 0.0)
        tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=mask)


@triton.jit
def bn_bwd_partials(x_ptr, du_ptr, mean_ptr, rstd_ptr, scale_ptr, shift_ptr,
                    part_ptr, HW, CHW, NHW, S, TILES, RELU: tl.constexpr,
                    BLOCK: tl.constexpr):
    """partial[c, s] = (Σdu, Σdu·x̂) over the chunk, du masked by the ReLU
    recomputed as fma(x, scale, shift) > 0 — the forward's expression."""
    c = tl.program_id(0)
    s = tl.program_id(1)
    mu = tl.load(mean_ptr + c)
    rs = tl.load(rstd_ptr + c)
    sc = tl.load(scale_ptr + c)
    sh = tl.load(shift_ptr + c)
    acc1 = tl.zeros([BLOCK], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK], dtype=tl.float32)
    for t in range(0, TILES):
        off, mask = _chunk_offsets(c, s, t, HW, CHW, NHW, TILES, BLOCK)
        xv = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        dv = tl.load(du_ptr + off, mask=mask, other=0.0).to(tl.float32)
        if RELU:
            dv = tl.where(tl.fma(xv, sc, sh) > 0, dv, 0.0)
        xhat = (xv - mu) * rs
        acc1 += dv
        acc2 += dv * xhat
    tl.store(part_ptr + (c * S + s) * 2, tl.sum(acc1, axis=0))
    tl.store(part_ptr + (c * S + s) * 2 + 1, tl.sum(acc2, axis=0))


@triton.jit
def bn_bwd_apply(x_ptr, du_ptr, dx_ptr, mean_ptr, rstd_ptr, scale_ptr,
                 shift_ptr, part_ptr, grads_ptr, C, HW, CHW, NHW, S, TILES,
                 n_f, RELU: tl.constexpr, BLOCK: tl.constexpr,
                 S_BLOCK: tl.constexpr):
    """dx = (du − dβ/n − x̂·dγ/n)·scale. Chunk 0 of each channel writes
    grads[:, c] = (dβ, dγ)."""
    c = tl.program_id(0)
    s = tl.program_id(1)
    dbeta, dgamma = _channel_sums(part_ptr, c, S, S_BLOCK)
    if s == 0:
        tl.store(grads_ptr + c, dbeta)
        tl.store(grads_ptr + C + c, dgamma)
    db_n = dbeta / n_f
    dg_n = dgamma / n_f
    mu = tl.load(mean_ptr + c)
    rs = tl.load(rstd_ptr + c)
    sc = tl.load(scale_ptr + c)
    sh = tl.load(shift_ptr + c)
    for t in range(0, TILES):
        off, mask = _chunk_offsets(c, s, t, HW, CHW, NHW, TILES, BLOCK)
        xv = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        dv = tl.load(du_ptr + off, mask=mask, other=0.0).to(tl.float32)
        if RELU:
            dv = tl.where(tl.fma(xv, sc, sh) > 0, dv, 0.0)
        xhat = (xv - mu) * rs
        dx = (dv - db_n - xhat * dg_n) * sc
        tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=mask)
