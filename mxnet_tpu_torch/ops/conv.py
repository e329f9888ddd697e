"""Convolution, pooling and the spatial operators.

PyTorch counterpart of ``mxnet_tpu/ops/conv.py``. The JAX package leaves
these to XLA (``lax.conv_general_dilated``, ``lax.reduce_window``,
``jax.image.resize``, gathers), so the port leaves them to PyTorch's ops
where one computes the same function (cuDNN's convolution and
transposed convolution, ``interpolate``, ``grid_sample``). ROIPooling,
which PyTorch has no op for, runs the hand-written kernels of
``kernels/roi_pooling.py``. Layout is NCHW, as in the reference. A
narrow-math eval forward (``precision.quant``) takes the convolution
through its int8 / fp8 seam.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import roi_pooling as _roi
from ..precision import quant as _quant
from ..registry import register


def _tup(v, n):
    if isinstance(v, (int, float)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _conv_args(attrs):
    return ("data", "weight") if attrs.get("no_bias", False) else \
        ("data", "weight", "bias")


def _conv_out_dim(i, k, p, s, d):
    return (i + 2 * p - d * (k - 1) - 1) // s + 1


def _conv_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    nd = len(data) - 2
    kernel = _tup(attrs["kernel"], nd)
    stride = _tup(attrs.get("stride", 1), nd)
    pad = _tup(attrs.get("pad", 0), nd)
    dilate = _tup(attrs.get("dilate", 1), nd)
    nf = int(attrs["num_filter"])
    ng = int(attrs.get("num_group", 1))
    in_shapes[1] = (nf, data[1] // ng) + kernel
    if not attrs.get("no_bias", False) and len(in_shapes) > 2:
        in_shapes[2] = (nf,)
    out_sp = tuple(_conv_out_dim(data[2 + i], kernel[i], pad[i], stride[i],
                                 dilate[i]) for i in range(nd))
    return in_shapes, [(data[0], nf) + out_sp], aux


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", arg_names=_conv_args,
          attr_types={"kernel": tuple, "stride": tuple, "dilate": tuple,
                      "pad": tuple, "num_filter": int, "num_group": int,
                      "workspace": int, "no_bias": bool, "cudnn_tune": str,
                      "cudnn_off": bool, "layout": str},
          infer_shape=_conv_infer, alias=("Convolution_v1",))
def _convolution(attrs, ins, octx):
    """Under an active GEMM scope (``precision.quant``) the convolution
    goes through ``narrow_conv`` and the bias is added after it, in the
    output's dtype."""
    x, w = ins[0], ins[1].to(ins[0].dtype)
    nd = x.dim() - 2
    conv_args = dict(stride=_tup(attrs.get("stride", 1), nd),
                     padding=_tup(attrs.get("pad", 0), nd),
                     dilation=_tup(attrs.get("dilate", 1), nd),
                     groups=int(attrs.get("num_group", 1)))
    y = _quant.narrow_conv(x, w, conv_args)
    if y is None:
        b = None if attrs.get("no_bias", False) else ins[2].to(x.dtype)
        return [_CONV[nd](x, w, b, **conv_args)]
    if not attrs.get("no_bias", False):
        y = y + ins[2].to(y.dtype).reshape((1, -1) + (1,) * nd)
    return [y]


def _pool_out_dim(i, k, p, s, convention):
    if convention == "full":
        return int(math.ceil(float(i + 2 * p - k) / s)) + 1
    return (i + 2 * p - k) // s + 1


def _pool_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    if attrs.get("global_pool", False):
        return in_shapes, [tuple(data[:2]) + (1,) * (len(data) - 2)], aux
    nd = len(data) - 2
    kernel = _tup(attrs["kernel"], nd)
    stride = _tup(attrs.get("stride", 1), nd)
    pad = _tup(attrs.get("pad", 0), nd)
    conv = attrs.get("pooling_convention", "valid")
    out_sp = tuple(_pool_out_dim(data[2 + i], kernel[i], pad[i], stride[i],
                                 conv) for i in range(nd))
    return in_shapes, [tuple(data[:2]) + out_sp], aux


@register("Pooling",
          attr_types={"kernel": tuple, "stride": tuple, "pad": tuple,
                      "pool_type": str, "global_pool": bool,
                      "pooling_convention": str, "cudnn_off": bool},
          infer_shape=_pool_infer, alias=("Pooling_v1",))
def _pooling(attrs, ins, octx):
    """max/avg/sum pooling. Max pads with −inf; avg divides by the full
    window including padding; ``pooling_convention="full"`` pads the high
    side so the last window covers the input (the JAX package's rules)."""
    x = ins[0]
    nd = x.dim() - 2
    ptype = attrs.get("pool_type", "max")
    if attrs.get("global_pool", False):
        kernel, stride, pad = tuple(x.shape[2:]), (1,) * nd, (0,) * nd
    else:
        kernel = _tup(attrs["kernel"], nd)
        stride = _tup(attrs.get("stride", 1), nd)
        pad = _tup(attrs.get("pad", 0), nd)
    conv = attrs.get("pooling_convention", "valid")
    hi = list(pad)
    if conv == "full":
        for i in range(nd):
            out = _pool_out_dim(x.shape[2 + i], kernel[i], pad[i], stride[i],
                                "full")
            hi[i] = max((out - 1) * stride[i] + kernel[i]
                        - x.shape[2 + i] - pad[i], 0)
    # padding is explicit (F.pad takes the last dim first), so every window
    # lies inside the padded input and the pool itself pads nothing
    widths = []
    for i in reversed(range(nd)):
        widths += [pad[i], hi[i]]
    fill = -math.inf if ptype == "max" else 0.0
    if any(widths):
        x = F.pad(x, widths, value=fill)
    if ptype == "max":
        return [getattr(F, "max_pool%dd" % nd)(x, kernel, stride)]
    y = getattr(F, "avg_pool%dd" % nd)(x, kernel, stride)
    if ptype == "sum":
        y = y * math.prod(kernel)
    return [y]


def _deconv_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    nd = len(data) - 2
    kernel = _tup(attrs["kernel"], nd)
    stride = _tup(attrs.get("stride", 1), nd)
    pad = _tup(attrs.get("pad", 0), nd)
    adj = _tup(attrs.get("adj", 0), nd)
    nf = int(attrs["num_filter"])
    ng = int(attrs.get("num_group", 1))
    in_shapes[1] = (data[1], nf // ng) + kernel
    if not attrs.get("no_bias", True) and len(in_shapes) > 2:
        in_shapes[2] = (nf,)
    out_sp = tuple((data[2 + i] - 1) * stride[i] - 2 * pad[i] + kernel[i]
                   + adj[i] for i in range(nd))
    return in_shapes, [(data[0], nf) + out_sp], aux


def _deconv_args(attrs):
    # Deconvolution's no_bias defaults to True in the reference
    return ("data", "weight") if attrs.get("no_bias", True) else \
        ("data", "weight", "bias")


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution", arg_names=_deconv_args,
          attr_types={"kernel": tuple, "stride": tuple, "pad": tuple,
                      "adj": tuple, "target_shape": tuple, "num_filter": int,
                      "num_group": int, "workspace": int, "no_bias": bool},
          infer_shape=_deconv_infer)
def _deconvolution(attrs, ins, octx):
    """Transposed convolution; the weight (C_in, C_out/g, k...) is
    PyTorch's layout and ``adj`` its ``output_padding``. The weight and
    bias take the activation's dtype. ``target_shape`` is declared and
    ignored, as in the JAX package."""
    x = ins[0]
    nd = x.dim() - 2
    b = None if attrs.get("no_bias", True) or len(ins) < 3 \
        else ins[2].to(x.dtype)
    return [_DECONV[nd](x, ins[1].to(x.dtype), b,
                        stride=_tup(attrs.get("stride", 1), nd),
                        padding=_tup(attrs.get("pad", 0), nd),
                        output_padding=_tup(attrs.get("adj", 0), nd),
                        groups=int(attrs.get("num_group", 1)))]


@register("UpSampling", variable_args="num_args",
          attr_types={"scale": int, "sample_type": str, "num_filter": int,
                      "multi_input_mode": str, "num_args": int})
def _upsampling(attrs, ins, octx):
    """Nearest (each pixel repeated) or bilinear (half-pixel centres, as
    ``jax.image.resize`` upsamples) by an integer ``scale``; several
    inputs concatenate on channels or sum (``multi_input_mode``)."""
    scale = int(attrs.get("scale", 2))
    nearest = attrs.get("sample_type", "nearest") == "nearest"
    outs = []
    for x in ins:
        if nearest:
            y = x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                    dim=3)
        else:
            y = F.interpolate(x, scale_factor=scale, mode="bilinear",
                              align_corners=False)
        outs.append(y)
    if len(outs) == 1:
        return outs
    if attrs.get("multi_input_mode", "concat") == "sum":
        t = outs[0]
        for o in outs[1:]:
            t = t + o
        return [t]
    return [torch.cat(outs, dim=1)]


def _pad_axis(x, axis, lo, hi, mode):
    """``jnp.pad``'s edge or reflect padding of one axis, from slices (so
    the gradient is a sum of slices, with no scatter)."""
    n = x.shape[axis]
    if mode == "edge":
        parts = [x.narrow(axis, 0, 1).expand(
                     *[lo if d == axis else -1 for d in range(x.dim())])]
        parts += [x, x.narrow(axis, n - 1, 1).expand(
            *[hi if d == axis else -1 for d in range(x.dim())])]
        return torch.cat(parts, dim=axis)
    if n == 1:
        return _pad_axis(x, axis, lo, hi, "edge")
    # reflect without repeating the edge, a period of 2(n-1) at most each
    # round, as numpy extends its own padded array
    while lo or hi:
        m = x.shape[axis]
        a, b = min(lo, m - 1), min(hi, m - 1)
        left = x.narrow(axis, 1, a).flip(axis)
        right = x.narrow(axis, m - 1 - b, b).flip(axis)
        x = torch.cat([left, x, right], dim=axis)
        lo, hi = lo - a, hi - b
    return x


@register("Pad", attr_types={"mode": str, "pad_width": tuple,
                             "constant_value": float},
          alias=("pad",))
def _pad(attrs, ins, octx):
    """``constant``, ``edge`` or ``reflect`` padding of any axis, as
    ``jnp.pad`` pads; ``pad_width`` holds (before, after) per axis."""
    x = ins[0]
    pw = attrs["pad_width"]
    pairs = [(int(pw[2 * i]), int(pw[2 * i + 1])) for i in range(x.dim())]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        flat = [w for pair in reversed(pairs) for w in pair]
        return [F.pad(x, flat, value=float(attrs.get("constant_value", 0)))]
    if mode not in ("edge", "reflect"):
        raise ValueError("unknown pad mode " + mode)
    for axis, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = _pad_axis(x, axis, lo, hi, mode)
    return [x]


def _crop_args(attrs):
    return ("data", "crop_like") if int(attrs.get("num_args", 1)) == 2 \
        else ("data",)


def _crop_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    if int(attrs.get("num_args", 1)) == 2 and in_shapes[1] is not None:
        hw = in_shapes[1][2:]
    else:
        hw = _tup(attrs.get("h_w", (0, 0)), 2)
    return in_shapes, [tuple(data[:2]) + tuple(hw)], aux


@register("Crop", arg_names=_crop_args,
          attr_types={"offset": tuple, "h_w": tuple, "center_crop": bool,
                      "num_args": int},
          infer_shape=_crop_infer)
def _crop_op(attrs, ins, octx):
    """Spatial crop to ``h_w`` or to the second input's size, at
    ``offset`` or centred."""
    x = ins[0]
    if int(attrs.get("num_args", 1)) == 2:
        th, tw = ins[1].shape[2], ins[1].shape[3]
    else:
        th, tw = _tup(attrs["h_w"], 2)
    if attrs.get("center_crop", False):
        oy, ox = (x.shape[2] - th) // 2, (x.shape[3] - tw) // 2
    else:
        oy, ox = _tup(attrs.get("offset", (0, 0)), 2)
    return [x[:, :, oy:oy + th, ox:ox + tw]]


def _roi_infer(attrs, in_shapes, aux):
    data, rois = in_shapes
    if data is None or rois is None:
        return in_shapes, None, aux
    return in_shapes, [(rois[0], data[1]) + _tup(attrs["pooled_size"], 2)],\
        aux


@register("ROIPooling", arg_names=("data", "rois"),
          attr_types={"pooled_size": tuple, "spatial_scale": float},
          infer_shape=_roi_infer)
def _roi_pooling(attrs, ins, octx):
    """ROI max pooling through ``kernels/roi_pooling.py`` (the kernels on
    the card, their plain versions on the CPU); the gradient splits among
    ties as the JAX op's does, and the ROIs get none."""
    return [_roi.roi_pooling(ins[0], ins[1], _tup(attrs["pooled_size"], 2),
                             float(attrs["spatial_scale"]))]


def _affine_grid(theta, h, w):
    """theta (n, 2, 3) applied to the [-1, 1] target grid: (n, 2, h, w)."""
    ys = torch.linspace(-1.0, 1.0, h, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx.reshape(-1), gy.reshape(-1),
                          torch.ones(h * w, device=theta.device)])
    return torch.matmul(theta, coords.to(theta.dtype)).reshape(-1, 2, h, w)


@register("GridGenerator", attr_types={"transform_type": str,
                                       "target_shape": tuple})
def _grid_generator(attrs, ins, octx):
    """Sampling grid (n, 2, h, w) in [-1, 1]: ``affine`` from (n, 6)
    parameters, ``warp`` from a flow field in pixels added to the
    identity grid."""
    if attrs.get("transform_type", "affine") == "affine":
        h, w = _tup(attrs["target_shape"], 2)
        return [_affine_grid(ins[0].reshape(-1, 2, 3), h, w)]
    flow = ins[0]
    h, w = flow.shape[2], flow.shape[3]
    ys = torch.linspace(-1.0, 1.0, h, device=flow.device)
    xs = torch.linspace(-1.0, 1.0, w, device=flow.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy])[None].to(flow.dtype)
    norm = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], dtype=flow.dtype,
                        device=flow.device).reshape(1, 2, 1, 1)
    return [base + flow / norm]


def _bilinear_sample(data, grid):
    """data (n, c, h, w) sampled at grid (n, 2, gh, gw) in [-1, 1] (x
    first), corners aligned, zeros outside."""
    return F.grid_sample(data, grid.permute(0, 2, 3, 1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


@register("BilinearSampler", arg_names=("data", "grid"))
def _bilinear_sampler(attrs, ins, octx):
    """Bilinear warp of data by a [-1, 1] grid, zero padding."""
    return [_bilinear_sample(ins[0], ins[1])]


def _st_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    in_shapes[1] = (data[0], 6)
    h, w = _tup(attrs["target_shape"], 2)
    return in_shapes, [(data[0], data[1], h, w)], aux


@register("SpatialTransformer", arg_names=("data", "loc"),
          attr_types={"target_shape": tuple, "transform_type": str,
                      "sampler_type": str},
          infer_shape=_st_infer)
def _spatial_transformer(attrs, ins, octx):
    """Affine spatial transformer: the affine grid of ``loc``, then the
    bilinear sampler."""
    h, w = _tup(attrs["target_shape"], 2)
    return [_bilinear_sample(ins[0],
                             _affine_grid(ins[1].reshape(-1, 2, 3), h, w))]
