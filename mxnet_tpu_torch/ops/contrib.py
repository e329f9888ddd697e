"""Contrib operators: fft/ifft, count_sketch, MultiBoxPrior and
quantize/dequantize, under the ``_contrib_`` prefix like the reference.

PyTorch counterpart of ``mxnet_tpu/ops/contrib.py``. The transforms run
on ``torch.fft`` with the reference's interleaved [re, im] layout; the
anchors of ``MultiBoxPrior`` are a host numpy constant, as in the JAX
package, cached per shape and attributes.
"""
from __future__ import annotations


import numpy as onp
import torch

from ..registry import register


def _fft_infer(attrs, in_shapes, aux):
    d = in_shapes[0]
    if d is None:
        return in_shapes, None, aux
    return in_shapes, [tuple(d[:-1]) + (d[-1] * 2,)], aux


@register("_contrib_fft", attr_types={"compute_size": int},
          infer_shape=_fft_infer, alias=("fft",))
def _fft(attrs, ins, octx):
    """FFT over the last dim; the complex output interleaved as [re, im]
    pairs (src/operator/contrib/fft-inl.h)."""
    x = ins[0]
    c = torch.fft.fft(x.to(torch.float32), dim=-1)
    out = torch.stack([c.real, c.imag], dim=-1)
    return [out.reshape(x.shape[:-1] + (x.shape[-1] * 2,)).to(x.dtype)]


def _ifft_infer(attrs, in_shapes, aux):
    d = in_shapes[0]
    if d is None:
        return in_shapes, None, aux
    return in_shapes, [tuple(d[:-1]) + (d[-1] // 2,)], aux


@register("_contrib_ifft", attr_types={"compute_size": int},
          infer_shape=_ifft_infer, alias=("ifft",))
def _ifft(attrs, ins, octx):
    """Inverse FFT of interleaved [re, im] pairs, real part out. Unscaled,
    as cuFFT's inverse is: a round trip gains N."""
    x = ins[0]
    n = x.shape[-1] // 2
    pairs = x.reshape(x.shape[:-1] + (n, 2))
    c = torch.complex(pairs[..., 0], pairs[..., 1])
    return [(torch.fft.ifft(c, dim=-1) * n).real.to(x.dtype)]


@register("_contrib_count_sketch", arg_names=("data", "h", "s"),
          attr_types={"out_dim": int, "processing_batch_size": int})
def _count_sketch(attrs, ins, octx):
    """Count-sketch projection (src/operator/contrib/count_sketch-inl.h):
    out[:, h[j]] += data[:, j]·s[j], as the product with the signed
    one-hot (in_dim, out_dim) matrix, so that the card adds in a fixed
    order (``index_add_`` on CUDA floats does not)."""
    data, h, s = ins
    out_dim = int(attrs["out_dim"])
    hot = torch.nn.functional.one_hot(h.reshape(-1).long(), out_dim)
    return [data @ (hot.to(data.dtype) * s.reshape(-1, 1))]


_ANCHORS = {}    # (grid, sizes, ..., device) -> the anchors on the device


def _prior_anchors(*key):
    """The cached anchors of ``_prior_anchors_on(*key)``. A tensor made
    under a trace (``torch.export``'s fake tensors) is never cached."""
    from torch._subclasses.fake_tensor import is_fake
    t = _ANCHORS.get(key)
    if t is None:
        t = _prior_anchors_on(*key)
        if not is_fake(t) and len(_ANCHORS) < 64:
            _ANCHORS[key] = t
    return t


def _prior_anchors_on(h, w, sizes, ratios, steps, offsets, clip, device):
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (onp.arange(h) + offsets[0]) * step_y
    cx = (onp.arange(w) + offsets[1]) * step_x
    # the reference enumerates (size_i, ratio_0), then (size_0, ratio_j>0)
    combos = [(s, ratios[0]) for s in sizes] + \
             [(sizes[0], r) for r in ratios[1:]]
    boxes = []
    for yy in cy:
        for xx in cx:
            for s, r in combos:
                sr = onp.sqrt(r)
                bw, bh = s * sr / 2, s / sr / 2
                boxes.append([xx - bw, yy - bh, xx + bw, yy + bh])
    out = onp.asarray(boxes, dtype=onp.float32)
    if clip:
        out = onp.clip(out, 0.0, 1.0)
    return torch.from_numpy(out[None]).to(device)


@register("_contrib_MultiBoxPrior", arg_names=("data",),
          attr_types={"sizes": tuple, "ratios": tuple, "clip": bool,
                      "steps": tuple, "offsets": tuple})
def _multibox_prior(attrs, ins, octx):
    """Anchor boxes (1, h·w·num_anchors, 4) in normalised corner
    coordinates (src/operator/contrib/multibox_prior-inl.h); one tensor
    per device, shape and attributes, made once."""
    x = ins[0]
    sizes = attrs.get("sizes", (1.0,))
    ratios = attrs.get("ratios", (1.0,))
    sizes = (sizes,) if isinstance(sizes, float) else tuple(sizes)
    ratios = (ratios,) if isinstance(ratios, float) else tuple(ratios)
    anchors = _prior_anchors(
        int(x.shape[2]), int(x.shape[3]), sizes, ratios,
        tuple(attrs.get("steps", (-1.0, -1.0))),
        tuple(attrs.get("offsets", (0.5, 0.5))),
        bool(attrs.get("clip", False)), x.device)
    return [anchors]


def _range_infer(attrs, in_shapes, aux, quantized):
    d = in_shapes[0]
    if in_shapes[1] is None:
        in_shapes[1] = (1,)
    if in_shapes[2] is None:
        in_shapes[2] = (1,)
    if d is None:
        return in_shapes, None, aux
    return in_shapes, [tuple(d), (1,), (1,)] if quantized else [tuple(d)], \
        aux


_INT = {"uint8": torch.uint8, "int8": torch.int8}


@register("_contrib_quantize", arg_names=("data", "min_range", "max_range"),
          out_names=("output", "min_output", "max_output"),
          attr_types={"out_type": str},
          infer_shape=lambda a, i, x: _range_infer(a, i, x, True),
          alias=("quantize",))
def _quantize(attrs, ins, octx):
    """Affine quantization (src/operator/contrib/quantize-inl.h:29):
    out = (in − min)·(lim_max − lim_min)/(max − min) + lim_min + .5,
    clipped and truncated to ``out_type`` (uint8, or int8 as the JAX
    package's extension), the range carried through."""
    data, mn, mx = ins
    out_type = attrs.get("out_type", "uint8")
    if out_type not in _INT:
        raise ValueError("unsupported quantize out_type %s" % out_type)
    info = torch.iinfo(_INT[out_type])
    bshape = (1,) * data.dim()
    scale = (float(info.max) - float(info.min)) / (mx - mn)
    q = (data - mn.reshape(bshape)) * scale.reshape(bshape) \
        + float(info.min) + 0.5
    return [torch.clamp(q, info.min, info.max).to(_INT[out_type]), mn, mx]


@register("_contrib_dequantize", arg_names=("data", "min_range", "max_range"),
          attr_types={"out_type": str},
          infer_shape=lambda a, i, x: _range_infer(a, i, x, False),
          alias=("dequantize",))
def _dequantize(attrs, ins, octx):
    """Quantized integers back to float32
    (src/operator/contrib/dequantize-inl.h); the input's dtype gives the
    integer limits."""
    data, mn, mx = ins
    info = torch.iinfo(data.dtype)
    bshape = (1,) * data.dim()
    scale = (mx - mn) / (float(info.max) - float(info.min))
    return [(data.to(torch.float32) - float(info.min)) * scale.reshape(bshape)
            + mn.reshape(bshape)]
