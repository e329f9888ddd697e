"""Shape and indexing operators (PyTorch counterpart of
``mxnet_tpu/ops/matrix.py``): Flatten, transpose, SwapAxis, expand_dims,
Reshape, Concat, SliceChannel and Embedding. Gradients come from torch
autograd: Embedding's weight gradient is the index-add of the head
gradient into the looked-up rows, as the JAX package's scatter-add."""
from __future__ import annotations

import torch

from ..registry import register


@register("Flatten", alias=("flatten",))
def _flatten(attrs, ins, octx):
    """Collapse every axis but the first."""
    x = ins[0]
    return [x.reshape(x.shape[0], -1)]


@register("transpose", attr_types={"axes": tuple})
def _transpose(attrs, ins, octx):
    """Permute the axes (reverse them when ``axes`` is empty)."""
    x = ins[0]
    axes = attrs.get("axes") or tuple(reversed(range(x.dim())))
    return [x.permute(*axes)]


@register("SwapAxis", attr_types={"dim1": int, "dim2": int},
          alias=("swapaxes",))
def _swapaxes(attrs, ins, octx):
    """Swap axes ``dim1`` and ``dim2``."""
    return [ins[0].transpose(int(attrs.get("dim1", 0)),
                             int(attrs.get("dim2", 0)))]


@register("expand_dims", attr_types={"axis": int})
def _expand_dims(attrs, ins, octx):
    """Insert an axis of length 1 at ``axis``."""
    return [ins[0].unsqueeze(int(attrs["axis"]))]


def infer_reshape_shape(target, src_shape, reverse=False):
    """MXNet Reshape's special codes: 0 copies a dim, -1 infers one, -2
    copies the rest, -3 merges two dims, -4 splits one. With ``reverse``
    the codes are matched from the right (both lists reversed, as the
    reference does)."""
    src, target = list(src_shape), list(target)
    if reverse:
        src.reverse()
        target.reverse()
    out, i, j = [], 0, 0
    while j < len(target):
        t = target[j]
        if t == 0:
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            d1, d2 = target[j + 1], target[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(t)
            if i < len(src):
                i += 1
        j += 1
    if -1 in out:
        total = 1
        for s in src_shape:
            total *= s
        known = 1
        for s in out:
            if s != -1:
                known *= s
        out[out.index(-1)] = total // known
    if reverse:
        out.reverse()
    return tuple(out)


@register("Reshape", attr_types={"shape": tuple, "reverse": bool},
          alias=("reshape",))
def _reshape(attrs, ins, octx):
    """Reshape with MXNet's special codes (0, -1, -2, -3, -4, reverse)."""
    x = ins[0]
    return [x.reshape(infer_reshape_shape(
        attrs["shape"], tuple(x.shape), bool(attrs.get("reverse", False))))]


@register("Concat", variable_args="num_args", attr_types={"dim": int},
          alias=("concat",))
def _concat(attrs, ins, octx):
    """Join the inputs along ``dim`` (default 1)."""
    return [torch.cat(list(ins), dim=int(attrs.get("dim", 1)))]


@register("SliceChannel",
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)),
          attr_types={"num_outputs": int, "axis": int, "squeeze_axis": bool},
          alias=("split",))
def _slice_channel(attrs, ins, octx):
    """Split into ``num_outputs`` equal parts along ``axis`` (default 1),
    dropping that axis when ``squeeze_axis``."""
    x = ins[0]
    n = int(attrs["num_outputs"])
    axis = int(attrs.get("axis", 1)) % x.dim()
    if x.shape[axis] % n:
        raise ValueError("SliceChannel: axis %d of length %d does not split "
                         "into %d" % (axis, x.shape[axis], n))
    parts = torch.split(x, x.shape[axis] // n, dim=axis)
    if attrs.get("squeeze_axis", False):
        parts = [p.squeeze(axis) for p in parts]
    return list(parts)


def _embedding_infer(attrs, in_shapes, aux):
    dim = int(attrs["output_dim"])
    in_shapes[1] = (int(attrs["input_dim"]), dim)
    if in_shapes[0] is None:
        return in_shapes, None, aux
    return in_shapes, [tuple(in_shapes[0]) + (dim,)], aux


@register("Embedding", arg_names=("data", "weight"),
          attr_types={"input_dim": int, "output_dim": int},
          infer_shape=_embedding_infer)
def _embedding(attrs, ins, octx):
    """Row lookup ``weight[data]`` (indices truncated to integers); the
    weight's gradient adds each head-gradient row into its index."""
    data, weight = ins
    return [weight[data.long()]]
