"""Convolution and pooling.

PyTorch counterpart of ``mxnet_tpu/ops/conv.py``. The JAX package leaves
these to XLA (``lax.conv_general_dilated``, ``lax.reduce_window``), so the
port leaves them to PyTorch's convolution and pooling (cuDNN on the card).
Layout is NCHW, as in the reference. A narrow-math eval forward
(``precision.quant``) takes the convolution through its int8 / fp8 seam.
"""
from __future__ import annotations

import math

import torch.nn.functional as F

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
