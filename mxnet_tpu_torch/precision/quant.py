"""Native low-bit compute: weight-only int8 storage, post-training
activation calibration, and the narrow-math GEMM seam (PyTorch
counterpart of ``mxnet_tpu/precision/quant.py``).

The ``int8_act``/``fp8`` modes fake-quantize values but compute and store
wide. This module supplies the three pieces behind the ``int8_weight`` /
``int8_serve`` / ``fp8_native`` modes (policy.py):

1. **Weight-only int8** (:func:`quantize_params` / :func:`dequant_params`):
   parameters stored as per-channel symmetric int8 with float32 scales and
   widened at each use. The decode engine re-reads every weight byte per
   token, so int8 storage is a ~4x cut in the bytes a step receives
   (``DecodeEngine.step_argument_bytes``).

2. **Post-training activation calibration** (:func:`calibrate` /
   :class:`CalibrationTable`): a short eval pass with the GEMM scope in
   collect mode observes each site's input ``amax`` into telemetry
   histograms (a power-of-two bucket ladder); the table reads the upper
   edge of the highest occupied bucket per site. The table's JSON and
   digest are the JAX package's: a table saved by either loads in the
   other.

3. **Narrow GEMM seam** (:func:`narrow_dot` / :func:`narrow_conv` +
   :func:`trace_gemm_scope`): the FullyConnected and Convolution ops
   consult a thread-local scope. Sites are named in evaluation order
   (``fc0``, ``conv1``, ...); the executor evaluates nodes in the
   symbol's topological order and the scope's counters restart at every
   eval forward, so one graph names its sites alike in calibration, in
   serving and in the JAX package's trace. In ``int8`` mode a site runs
   an int8 x int8 -> int32 product (``torch._int_mm`` on the card: exact
   integer accumulation) and rescales; in ``fp8`` mode a dot takes e4m3
   operands with a float32 accumulator (``torch._scaled_mm``). There is
   no fallback to wide math on the card: a shape either library call
   refuses is an error. On the CPU the same sums run as plain
   ``torch.mm`` (float64 for the integer ones: exact), which is what the
   tests hold against the JAX package. An fp8 convolution is the
   fake-quantized round trip of both operands, as in the JAX package.

Everything here is serving-only: ``Module.bind(for_training=True)``
refuses the policies that use it.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from contextlib import contextmanager
from typing import NamedTuple

import numpy as onp
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .policy import _const, fake_cast, to_e4m3

__all__ = ["QuantLeaf", "quantize_weight", "quantize_params", "dequant_params",
           "dequant_array", "is_quantized", "tree_bytes",
           "CalibrationTable", "calibrate", "collecting",
           "trace_gemm_scope", "narrow_dot", "narrow_conv",
           "quant_tolerance", "calib_batches", "tolerance_check",
           "CALIB_PREFIX", "CALIB_BUCKETS", "GEMM_CALLS", "int8_mm",
           "fp8_mm", "int8_conv"]

# geometric ladder wide enough for any sane activation amax; the +Inf
# overflow bucket should stay empty (from_telemetry clamps it)
CALIB_BUCKETS = tuple(2.0 ** e for e in range(-12, 17))
CALIB_PREFIX = "quant.calib"

# library GEMM calls made on the card, by kind: one per torch._int_mm /
# torch._scaled_mm call (the CPU's plain products are not counted)
GEMM_CALLS = {"int_mm": 0, "scaled_mm": 0}


def quant_tolerance():
    """Max tolerated |int8_serve - f32| / max|f32| on probe outputs
    (``MXNET_QUANT_TOLERANCE``, default 0.05)."""
    return float(os.environ.get("MXNET_QUANT_TOLERANCE", "0.05"))


def calib_batches(default=8):
    """Calibration-pass length (``MXNET_PRECISION_CALIB_BATCHES``)."""
    return int(os.environ.get("MXNET_PRECISION_CALIB_BATCHES",
                              str(default)))


# ---------------------------------------------------------------------------
# weight-only int8: per-channel symmetric storage, dequantised at each use
# ---------------------------------------------------------------------------
class QuantLeaf(NamedTuple):
    """One int8-stored weight: ``q`` int8 with the original shape, ``s``
    float32 per-channel scales along axis 0 (numpy arrays on the host,
    tensors once staged on a device)."""
    q: object
    s: object


def quantize_weight(arr, axis=0):
    """Per-channel symmetric int8 quantization of one weight array, in
    float64 on the host (the JAX package's numpy code).

    Returns ``(q, s)``: ``q`` int8 with ``arr``'s shape, ``s`` float32 of
    shape ``(arr.shape[axis],)``. All-zero channels get scale 1.0 so the
    dequant is an exact 0.0, never a 0/0 NaN."""
    arr = onp.asarray(arr)
    if arr.ndim < 1:
        raise MXNetError("quantize_weight needs ndim >= 1 (got scalar)")
    axes = tuple(i for i in range(arr.ndim) if i != axis)
    amax = onp.max(onp.abs(arr.astype(onp.float64)), axis=axes) \
        if axes else onp.abs(arr.astype(onp.float64))
    s = onp.where(amax > 0, amax / 127.0, 1.0).astype(onp.float32)
    shape = tuple(arr.shape[axis] if i == axis else 1
                  for i in range(arr.ndim))
    q = onp.clip(onp.round(arr.astype(onp.float64)
                           / s.astype(onp.float64).reshape(shape)),
                 -127, 127).astype(onp.int8)
    return q, s


def is_quantized(v):
    """True for one :class:`QuantLeaf`."""
    return isinstance(v, QuantLeaf)


def _host(v):
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return onp.asarray(v)


def quantize_params(params, min_ndim=2):
    """Quantize a ``{name: array}`` tree for int8 storage (numpy, NDArray
    or tensor values; numpy out).

    Floating arrays with ``ndim >= min_ndim`` (the GEMM and convolution
    weights, where the bytes are) become :class:`QuantLeaf` pairs; biases,
    gains and integer tables pass through untouched."""
    out = {}
    for name, v in params.items():
        a = _host(v)
        if a.ndim >= min_ndim and onp.issubdtype(a.dtype, onp.floating):
            q, s = quantize_weight(a, axis=0)
            out[name] = QuantLeaf(q=q, s=s)
        else:
            out[name] = a
    return out


def dequant_array(leaf, dtype):
    """Dense tensor for one quantized leaf of tensors: ``q * s`` along
    axis 0 in float32, then ``dtype``."""
    q, s = leaf.q, leaf.s
    shape = (q.shape[0],) + (1,) * (q.dim() - 1)
    return (q.float() * s.reshape(shape)).to(dtype)


def dequant_params(tree, dtype):
    """Dense ``{name: tensor}`` view of a (possibly) quantized tree of
    tensors: each :class:`QuantLeaf` widened by :func:`dequant_array`,
    every other value as it is."""
    return {name: dequant_array(v, dtype) if is_quantized(v) else v
            for name, v in tree.items()}


def _nbytes(a):
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(a.size) * int(onp.dtype(a.dtype).itemsize)


def tree_bytes(tree):
    """Total stored bytes of a params tree (quantized leaves count their
    int8 payload and float32 scales)."""
    total = 0
    for v in tree.values():
        for a in ([v.q, v.s] if is_quantized(v) else [v]):
            total += _nbytes(a)
    return int(total)


# ---------------------------------------------------------------------------
# calibration: harvest per-site activation ranges from telemetry
# ---------------------------------------------------------------------------
class CalibrationTable(object):
    """Static per-GEMM-site activation ranges from a calibration pass.

    ``ranges`` maps site names (``fc0``, ``conv2``, ...) to the input
    ``amax`` harvested for that site. The digest is the JAX package's
    (sha256 of the sorted, compact JSON of the ranges, 16 hex digits) and
    lands in the policy's description."""

    __slots__ = ("ranges",)

    def __init__(self, ranges):
        self.ranges = {str(k): float(v) for k, v in ranges.items()}
        for k, v in self.ranges.items():
            if not (v > 0) or not onp.isfinite(v):
                raise MXNetError(
                    "calibration range for %r must be finite and > 0 "
                    "(got %r)" % (k, v))

    def amax(self, site):
        return self.ranges.get(site)

    def scale(self, site):
        """The static int8 scale for a site (amax mapped to 127), or None
        when the site was never observed (the GEMM then takes a dynamic
        per-tensor scale)."""
        a = self.ranges.get(site)
        return None if a is None else a / 127.0

    def digest(self):
        payload = json.dumps(self.ranges, sort_keys=True,
                             separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def to_json(self):
        return {"version": 1, "ranges": dict(self.ranges),
                "digest": self.digest()}

    @classmethod
    def from_json(cls, obj):
        return cls(obj["ranges"])

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_json(json.load(f))

    @classmethod
    def from_telemetry(cls, prefix=CALIB_PREFIX):
        """Build the table from the ``<prefix>.<site>.x_amax`` histograms
        a collect-mode pass populated: each site's range is the upper edge
        of the highest occupied finite bucket (never under-covers an
        observed value; overflow observations clamp to the top edge)."""
        from ..telemetry import registry as _reg
        strip, suffix = prefix + ".", ".x_amax"
        ranges = {}
        for name, inst in _reg().instruments().items():
            if not (name.startswith(strip) and name.endswith(suffix)
                    and inst.kind == "histogram"):
                continue
            site = name[len(strip):-len(suffix)]
            val = inst.value
            counts, edges = val["counts"], val["buckets"]
            hi = None
            for i, c in enumerate(counts):
                if c:
                    hi = edges[min(i, len(edges) - 1)]
            if hi is not None:
                ranges[site] = hi
        if not ranges:
            raise MXNetError(
                "no %s.*%s histograms found — run a forward pass under "
                "quant.collecting() first" % (prefix, suffix))
        return cls(ranges)

    def __repr__(self):
        return "CalibrationTable(%d sites, digest=%s)" % (
            len(self.ranges), self.digest())


def tolerance_check(ref, got, tol=None):
    """The accuracy gate of quantized serving: max |got - ref| over
    max|ref| must stay under the tolerance (``MXNET_QUANT_TOLERANCE``).
    Returns the report dict; raises MXNetError when the gate fails."""
    tol = quant_tolerance() if tol is None else float(tol)
    ref = onp.asarray(ref, dtype=onp.float64)
    got = onp.asarray(got, dtype=onp.float64)
    denom = float(onp.max(onp.abs(ref)))
    denom = denom if denom > 0 else 1.0
    err = float(onp.max(onp.abs(got - ref))) / denom
    report = {"max_rel_err": err, "tolerance": tol, "passed": err <= tol}
    if not report["passed"]:
        raise MXNetError(
            "quantized serving failed the tolerance gate: max relative "
            "error %.4g > %.4g (MXNET_QUANT_TOLERANCE)" % (err, tol))
    return report


# ---------------------------------------------------------------------------
# the GEMM scope (consulted by ops/nn.py and ops/conv.py)
# ---------------------------------------------------------------------------
class _GemmScope(threading.local):
    mode = None      # None | "collect" | "int8" | "fp8"
    table = None     # CalibrationTable in "int8" mode
    counts = None    # kind -> next site index


_SCOPE = _GemmScope()
_COLLECT = threading.local()


@contextmanager
def collecting():
    """Mark a calibration pass: every eval forward inside this block
    observes per-site input amax into the ``quant.calib.*`` histograms."""
    prev = getattr(_COLLECT, "on", False)
    _COLLECT.on = True
    try:
        yield
    finally:
        _COLLECT.on = prev


def collect_active():
    return getattr(_COLLECT, "on", False)


@contextmanager
def trace_gemm_scope(policy):
    """Entered by the executor around every eval forward, with fresh site
    counters. The mode resolves on entry: a collect pass wins, else the
    policy's ``narrow_math``, else a no-op passthrough."""
    if collect_active():
        mode, table = "collect", None
    else:
        mode = getattr(policy, "narrow_math", None) if policy else None
        table = getattr(policy, "calibration", None) if policy else None
    prev = (_SCOPE.mode, _SCOPE.table, _SCOPE.counts)
    _SCOPE.mode, _SCOPE.table, _SCOPE.counts = mode, table, {}
    try:
        yield
    finally:
        _SCOPE.mode, _SCOPE.table, _SCOPE.counts = prev


def _next_site(kind):
    i = _SCOPE.counts.get(kind, 0)
    _SCOPE.counts[kind] = i + 1
    return "%s%d" % (kind, i)


def _observe_amax(x, site):
    """One amax observation, read back at once (the eager counterpart of
    the JAX package's in-program callback)."""
    from ..telemetry import registry as _reg
    amax = float(x.float().abs().amax().item())
    _reg().histogram("%s.%s.x_amax" % (CALIB_PREFIX, site),
                     buckets=CALIB_BUCKETS).observe(amax)


def _x_scale(x, site):
    """Static scale from the calibration table when the site was
    observed, else a dynamic per-tensor scale (zero-guarded): a float32
    0-d tensor on ``x``'s device."""
    table = _SCOPE.table
    s = table.scale(site) if table is not None else None
    if s is not None:
        return _const(float(onp.float32(s)), x.device)
    amax = x.float().abs().amax()
    return torch.where(amax > 0, amax / _const(127.0, x.device),
                       _const(1.0, x.device))


def _quantize(v, scale):
    """``clip(round(v / scale), -127, 127)`` as int8 (float32 division,
    round half to even)."""
    return torch.clamp(torch.round(v.float() / scale), -127.0,
                       127.0).to(torch.int8)


def _channel_scale(w):
    """Per-output-channel (axis 0) weight scale, zero-channel guarded."""
    wf = w.float()
    wmax = wf.abs().amax(dim=tuple(range(1, w.dim())))
    return torch.where(wmax > 0, wmax / _const(127.0, w.device),
                       _const(1.0, w.device))


def _pad2(a, rows, cols):
    """``a`` zero-padded at the end to at least ``rows`` x ``cols``."""
    pr, pc = rows - a.shape[0], cols - a.shape[1]
    if pr <= 0 and pc <= 0:
        return a.contiguous()
    return F.pad(a, (0, max(pc, 0), 0, max(pr, 0)))


def _up(n, m):
    return -(-n // m) * m


def int8_mm(a, b):
    """``a @ b.T`` of int8 ``a`` (M, K) and ``b`` (N, K), exact in int32.

    On the card, ``torch._int_mm`` (cuBLASLt IMMA) with its operands
    zero-padded to its rules (more than 16 rows, depth and width multiples
    of 8; zero rows and columns add nothing to an integer sum) and the
    result sliced back; ``b`` goes in column-major. On the CPU the plain
    product of the same padded operands, in float64 (exact: every partial
    sum is an integer below 2^53 for any depth under 5e11)."""
    M, N, K = a.shape[0], b.shape[0], a.shape[1]
    ap = _pad2(a, max(M, 17), _up(K, 8))
    bp = _pad2(b, _up(N, 8), _up(K, 8))
    if a.device.type == "cuda":
        GEMM_CALLS["int_mm"] += 1
        out = torch._int_mm(ap, bp.t())
    else:
        out = torch.mm(ap.double(), bp.double().t()).to(torch.int32)
    return out[:M, :N]


def fp8_mm(a, b):
    """``a @ b.T`` of e4m3 ``a`` (M, K) and ``b`` (N, K), float32 out.

    On the card, ``torch._scaled_mm`` (scales 1.0, float32 out, no fast
    accumulation) with the operands zero-padded to multiples of 16 in
    rows, depth and width and the result sliced back; ``b`` goes in
    column-major. On the CPU the float32 product of the widened
    operands."""
    M, N, K = a.shape[0], b.shape[0], a.shape[1]
    if a.device.type == "cuda":
        ap = _pad2(a.view(torch.uint8), _up(M, 16),
                   _up(K, 16)).view(torch.float8_e4m3fn)
        bp = _pad2(b.view(torch.uint8), _up(N, 16),
                   _up(K, 16)).view(torch.float8_e4m3fn)
        one = _const(1.0, a.device)
        GEMM_CALLS["scaled_mm"] += 1
        out = torch._scaled_mm(ap, bp.t(), scale_a=one, scale_b=one,
                               out_dtype=torch.float32,
                               use_fast_accum=False)
        return out[:M, :N]
    return torch.mm(a.float(), b.float().t())


def narrow_dot(x2, w):
    """The FullyConnected GEMM under an active scope: ``x2`` (B, K),
    ``w`` (C, K), result (B, C) in ``x2``'s dtype. Returns None when the
    scope is inactive or collecting (the caller keeps its wide product)."""
    mode = _SCOPE.mode
    if mode is None:
        return None
    if mode == "collect":
        _observe_amax(x2, _next_site("fc"))
        return None
    if mode == "int8":
        sx = _x_scale(x2, _next_site("fc"))
        sw = _channel_scale(w)
        acc = int8_mm(_quantize(x2, sx), _quantize(w, sw[:, None]))
        return (acc.float() * sx * sw[None, :]).to(x2.dtype)
    if mode == "fp8":
        _next_site("fc")
        return fp8_mm(to_e4m3(x2), to_e4m3(w)).to(x2.dtype)
    raise MXNetError("unknown gemm-scope mode %r" % (mode,))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _im2col(q, kernel, stride, pad, dilate):
    """Columns of ``q`` (N, C, *spatial) for a convolution: (N·L, C·K)
    with L the output positions and K the kernel's taps (channel-major,
    taps inner, as the weight (O, C, *kernel) flattens), and the output's
    spatial shape. Views and one copy; any dtype."""
    nd = len(kernel)
    widths = []
    for i in reversed(range(nd)):
        widths += [pad[i], pad[i]]
    if any(widths):
        q = F.pad(q, widths)
    for i in range(nd):
        span = dilate[i] * (kernel[i] - 1) + 1
        q = q.unfold(2 + i, span, stride[i])
        if dilate[i] > 1:
            q = q[..., ::dilate[i]]
    n, c = q.shape[:2]
    out_sp = tuple(q.shape[2:2 + nd])
    perm = (0,) + tuple(range(2, 2 + nd)) + (1,) + \
        tuple(range(2 + nd, 2 + 2 * nd))
    cols = q.permute(perm).reshape(n * int(onp.prod(out_sp)), -1)
    return cols, out_sp


def int8_conv(qx, qw, stride, pad, dilate, groups):
    """The convolution of int8 ``qx`` (N, C, *spatial) by int8 ``qw``
    (O, C/groups, *kernel), exact in int32: im2col and one
    :func:`int8_mm` per group. Returns (N, O, *out_spatial) int32."""
    nd = qx.dim() - 2
    kernel = tuple(qw.shape[2:])
    cols, out_sp = _im2col(qx, kernel, stride, pad, dilate)
    O = qw.shape[0]
    og, ck = O // groups, cols.shape[1] // groups
    wg = qw.reshape(groups, og, ck)
    acc = torch.cat([int8_mm(cols[:, g * ck:(g + 1) * ck], wg[g])
                     for g in range(groups)], dim=1)
    n = qx.shape[0]
    return acc.reshape((n,) + out_sp + (O,)).permute(
        (0, 1 + nd) + tuple(range(1, 1 + nd)))


def narrow_conv(x, w, conv_args):
    """The Convolution under an active scope; ``conv_args`` are the
    caller's ``stride``, ``padding``, ``dilation`` and ``groups``
    (tuples of the spatial rank, and an int). Returns None when the scope
    is inactive or collecting."""
    mode = _SCOPE.mode
    if mode is None:
        return None
    if mode == "collect":
        _observe_amax(x, _next_site("conv"))
        return None
    if mode == "int8":
        sx = _x_scale(x, _next_site("conv"))
        sw = _channel_scale(w)
        nd = x.dim() - 2
        acc = int8_conv(_quantize(x, sx),
                        _quantize(w, sw.reshape((-1,) + (1,) * (nd + 1))),
                        conv_args["stride"], conv_args["padding"],
                        conv_args["dilation"], conv_args["groups"])
        return (acc.float() * sx
                * sw.reshape((1, -1) + (1,) * nd)).to(x.dtype)
    if mode == "fp8":
        # no native fp8 convolution (nor in the JAX package): the
        # fake-quantized round trip of both operands, computed wide
        _next_site("conv")
        return _CONV[x.dim() - 2](fake_cast(x, "fp8"), fake_cast(w, "fp8"),
                                  None, **conv_args)
    raise MXNetError("unknown gemm-scope mode %r" % (mode,))


# ---------------------------------------------------------------------------
# the calibration pass
# ---------------------------------------------------------------------------
def calibrate(module, data_iter, num_batches=None, prefix=CALIB_PREFIX):
    """Post-training calibration: forward ``num_batches`` batches (default
    ``MXNET_PRECISION_CALIB_BATCHES``) through a bound module with the
    GEMM scope collecting, then read the harvested histograms into a
    :class:`CalibrationTable`::

        mod = mx.mod.Module(net, context=mx.gpu(0))
        mod.bind(data_shapes=it.provide_data, for_training=False)
        mod.set_params(arg_params, aux_params)
        table = quant.calibrate(mod, it)
    """
    from ..telemetry import registry as _reg
    n = calib_batches() if num_batches is None else int(num_batches)
    if n <= 0:
        raise MXNetError("calibration needs num_batches >= 1")
    # drop stale harvests so the table reflects THIS pass only
    _reg().drop_scope(prefix)
    data_iter.reset()
    seen = 0
    with collecting():
        for batch in data_iter:
            module.forward(batch, is_train=False)
            seen += 1
            if seen >= n:
                break
    if seen == 0:
        raise MXNetError("calibration iterator yielded no batches")
    return CalibrationTable.from_telemetry(prefix=prefix)
