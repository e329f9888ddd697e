"""Matrix, shape, indexing and ordering operators (PyTorch counterpart of
``mxnet_tpu/ops/matrix.py``): dot, batch_dot, linalg_gemm2; Flatten,
transpose, SwapAxis, expand_dims, Reshape, Concat, SliceChannel; slice,
slice_axis, crop and the sliced assignments; tile, repeat, reverse;
Embedding, take, batch_take, one_hot, gather_nd, where; topk, sort,
argsort; and the sequence ops over TNC data (SequenceLast, SequenceMask,
SequenceReverse). Gradients come from torch autograd: Embedding's weight
gradient is the index-add of the head gradient into the looked-up rows,
as the JAX package's scatter-add. The matrix products are cuBLAS calls
(float32 stays float32: the callers turn TF32 off), where the JAX
package leaves them to XLA."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from ..registry import register


def _t(x):
    """All axes reversed (``jnp``'s ``.T``)."""
    return x.permute(*reversed(range(x.dim())))


@register("dot", arg_names=("lhs", "rhs"),
          attr_types={"transpose_a": bool, "transpose_b": bool})
def _dot(attrs, ins, octx):
    """``jnp.dot``: a matrix product for 1-D and 2-D operands, else the
    contraction of lhs's last axis with rhs's second-to-last."""
    a, b = ins
    if attrs.get("transpose_a", False):
        a = _t(a)
    if attrs.get("transpose_b", False):
        b = _t(b)
    if a.dim() <= 2 and b.dim() <= 2:
        return [torch.matmul(a, b)]
    return [torch.tensordot(a, b, dims=([a.dim() - 1],
                                        [max(b.dim() - 2, 0)]))]


def _swap_last(x, flag):
    return x.transpose(-1, -2) if flag else x


@register("batch_dot", arg_names=("lhs", "rhs"),
          attr_types={"transpose_a": bool, "transpose_b": bool})
def _batch_dot(attrs, ins, octx):
    """Batched matrix product over the leading axes."""
    a, b = ins
    return [torch.matmul(_swap_last(a, attrs.get("transpose_a", False)),
                         _swap_last(b, attrs.get("transpose_b", False)))]


@register("linalg_gemm2", arg_names=("A", "B"),
          attr_types={"transpose_a": bool, "transpose_b": bool,
                      "alpha": float})
def _linalg_gemm2(attrs, ins, octx):
    """alpha · op(A) · op(B)."""
    a, b = ins
    return [float(attrs.get("alpha", 1.0))
            * torch.matmul(_swap_last(a, attrs.get("transpose_a", False)),
                           _swap_last(b, attrs.get("transpose_b", False)))]


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


# ---------------------------------------------------------------------------
# slicing
# ---------------------------------------------------------------------------
def _region(x, attrs):
    """``begin``/``end`` (None: the axis's start/end) as per-axis slices;
    axes past ``begin`` are whole."""
    begin, end = attrs.get("begin", ()), attrs.get("end", ())
    begin = (begin,) if isinstance(begin, int) else tuple(begin)
    end = (end,) if isinstance(end, int) else tuple(end)
    idx = []
    for i in range(x.dim()):
        if i < len(begin):
            b = begin[i] if begin[i] is not None else 0
            e = end[i] if end[i] is not None else x.shape[i]
            idx.append(slice(b, e))
        else:
            idx.append(slice(None))
    return tuple(idx)


@register("slice", attr_types={"begin": tuple, "end": tuple},
          alias=("crop",))
def _slice(attrs, ins, octx):
    """The region [begin, end) of the leading axes."""
    return [ins[0][_region(ins[0], attrs)]]


@register("slice_axis", attr_types={"axis": int, "begin": int, "end": int})
def _slice_axis(attrs, ins, octx):
    """[begin, end) along ``axis`` (``end`` None: to the end)."""
    x = ins[0]
    ax = int(attrs["axis"]) % x.dim()
    b = attrs.get("begin", 0) or 0
    e = attrs.get("end", None)
    idx = [slice(None)] * x.dim()
    idx[ax] = slice(b, x.shape[ax] if e is None else e)
    return [x[tuple(idx)]]


def _assign_infer(attrs, in_shapes, aux):
    lhs = in_shapes[0]
    return in_shapes, None if lhs is None else [tuple(lhs)], aux


@register("_slice_assign", arg_names=("lhs", "rhs"),
          attr_types={"begin": tuple, "end": tuple},
          infer_shape=_assign_infer, alias=("_crop_assign",))
def _slice_assign(attrs, ins, octx):
    """lhs with the region [begin, end) replaced by rhs (out of place)."""
    lhs, rhs = ins
    out = lhs.clone()
    out[_region(lhs, attrs)] = rhs
    return [out]


@register("_crop_assign_scalar",
          attr_types={"begin": tuple, "end": tuple, "scalar": float},
          infer_shape=_assign_infer)
def _crop_assign_scalar(attrs, ins, octx):
    """x with the region [begin, end) set to ``scalar``."""
    out = ins[0].clone()
    out[_region(out, attrs)] = float(attrs.get("scalar", 0.0))
    return [out]


@register("reverse", attr_types={"axis": tuple}, alias=("flip",))
def _reverse(attrs, ins, octx):
    """Reverse the order along ``axis`` (default 0)."""
    axis = attrs.get("axis", 0)
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return [torch.flip(ins[0], dims=axis)]


@register("repeat", attr_types={"repeats": int, "axis": int})
def _repeat(attrs, ins, octx):
    """Repeat each element ``repeats`` times along ``axis`` (flattened
    when None)."""
    n = int(attrs["repeats"])
    axis = attrs.get("axis", None)
    if axis is None:
        return [torch.repeat_interleave(ins[0].reshape(-1), n)]
    return [torch.repeat_interleave(ins[0], n, dim=int(axis))]


@register("tile", attr_types={"reps": tuple})
def _tile(attrs, ins, octx):
    """Tile the input ``reps`` times (``np.tile``)."""
    reps = attrs["reps"]
    return [torch.tile(ins[0], (reps,) if isinstance(reps, int)
                       else tuple(reps))]


@register("where", arg_names=("condition", "x", "y"))
def _where(attrs, ins, octx):
    """x where condition is nonzero, else y; a 1-D condition selects
    whole rows."""
    cond, x, y = ins
    if cond.dim() == 1 and x.dim() > 1:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return [torch.where(cond != 0, x, y)]


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------
@register("take", arg_names=("a", "indices"),
          attr_types={"axis": int, "mode": str})
def _take(attrs, ins, octx):
    """Rows of ``a`` along ``axis`` at ``indices`` (``mode`` clip or
    wrap)."""
    a, idx = ins
    axis = int(attrs.get("axis", 0)) % a.dim()
    idx = idx.to(torch.int64)
    mode = attrs.get("mode", "clip")
    if mode == "clip":
        idx = torch.clamp(idx, 0, a.shape[axis] - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, a.shape[axis])
    out = torch.index_select(a, axis, idx.reshape(-1))
    return [out.reshape(a.shape[:axis] + tuple(idx.shape)
                        + a.shape[axis + 1:])]


@register("batch_take", arg_names=("a", "indices"))
def _batch_take(attrs, ins, octx):
    """out[i] = a[i, indices[i]]."""
    a, idx = ins
    rows = torch.arange(a.shape[0], device=a.device)
    return [a[rows, idx.to(torch.int64)]]


@register("one_hot", attr_types={"depth": int, "on_value": float,
                                 "off_value": float, "dtype": str})
def _one_hot(attrs, ins, octx):
    """A trailing one-hot axis of ``depth``: ``on_value`` at the index,
    ``off_value`` elsewhere."""
    idx = ins[0].to(torch.int64)
    depth = int(attrs["depth"])
    dt = torch_dtype(attrs.get("dtype", "float32"))
    on = float(attrs.get("on_value", 1.0))
    off = float(attrs.get("off_value", 0.0))
    hot = (idx[..., None] == torch.arange(depth, device=idx.device)).to(dt)
    return [hot * float(torch.tensor(on - off, dtype=dt))
            + float(torch.tensor(off, dtype=dt))]


@register("gather_nd", arg_names=("data", "indices"))
def _gather_nd(attrs, ins, octx):
    """data[indices[0], indices[1], ...]: the leading axis of
    ``indices`` indexes the leading axes of ``data``."""
    data, indices = ins
    return [data[tuple(indices.to(torch.int64))]]


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------
def _order_axis(attrs, x):
    axis = attrs.get("axis", -1)
    return x.dim() - 1 if axis is None else int(axis) % x.dim()


@register("topk", attr_types={"axis": int, "k": int, "ret_typ": str,
                              "is_ascend": bool},
          num_outputs=lambda attrs: 2 if attrs.get("ret_typ") == "both"
          else 1)
def _topk(attrs, ins, octx):
    """The k largest (``is_ascend``: smallest) along ``axis``: indices
    (in the input's dtype), values, both, or a 0/1 mask."""
    x = ins[0]
    axis = _order_axis(attrs, x)
    k = int(attrs.get("k", 1))
    ret = attrs.get("ret_typ", "indices")
    vals, idxs = torch.topk(x, k, dim=axis,
                            largest=not attrs.get("is_ascend", False))
    if ret == "value":
        return [vals]
    if ret == "both":
        return [vals, idxs.to(x.dtype)]
    if ret == "mask":
        return [torch.zeros_like(x).scatter(axis, idxs, 1.0)]
    return [idxs.to(x.dtype)]


def _argsort_idx(attrs, x, axis):
    """A stable ascending argsort, reversed for descending order (the
    JAX package's flip of ``jnp.argsort``)."""
    idx = torch.argsort(x, dim=axis, stable=True)
    return idx if attrs.get("is_ascend", True) else torch.flip(idx, (axis,))


@register("sort", attr_types={"axis": int, "is_ascend": bool})
def _sort(attrs, ins, octx):
    """Values sorted along ``axis``."""
    x = ins[0]
    axis = _order_axis(attrs, x)
    return [torch.gather(x, axis, _argsort_idx(attrs, x, axis))]


@register("argsort", attr_types={"axis": int, "is_ascend": bool})
def _argsort(attrs, ins, octx):
    """The sorting indices along ``axis``, in the input's dtype."""
    x = ins[0]
    axis = _order_axis(attrs, x)
    return [_argsort_idx(attrs, x, axis).to(x.dtype)]


# ---------------------------------------------------------------------------
# sequence ops over TNC data
# ---------------------------------------------------------------------------
def _seq_args(attrs):
    # sequence_length is an argument only with use_sequence_length
    if attrs.get("use_sequence_length", False):
        return ("data", "sequence_length")
    return ("data",)


def _seq_len(attrs, ins):
    """The (N,) int64 lengths, or None when every sequence is whole."""
    if not attrs.get("use_sequence_length", False) or len(ins) < 2:
        return None
    return ins[1].to(torch.int64)


@register("SequenceLast", arg_names=_seq_args,
          attr_types={"use_sequence_length": bool})
def _sequence_last(attrs, ins, octx):
    """Each sequence's last valid step: (T, N, ...) -> (N, ...)."""
    x, n = ins[0], _seq_len(attrs, ins)
    if n is None:
        return [x[-1]]
    last = torch.clamp(n - 1, min=0)
    return [x[last, torch.arange(x.shape[1], device=x.device)]]


@register("SequenceMask", arg_names=_seq_args,
          attr_types={"use_sequence_length": bool, "value": float})
def _sequence_mask(attrs, ins, octx):
    """Steps at or past each sequence's length set to ``value``."""
    x, n = ins[0], _seq_len(attrs, ins)
    if n is None:
        return [x]
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    mask = (t < n[None, :]).reshape(x.shape[:2] + (1,) * (x.dim() - 2))
    return [torch.where(mask, x, float(attrs.get("value", 0.0)))]


@register("SequenceReverse", arg_names=_seq_args,
          attr_types={"use_sequence_length": bool})
def _sequence_reverse(attrs, ins, octx):
    """Each sequence's valid steps reversed in place; padding stays."""
    x, n = ins[0], _seq_len(attrs, ins)
    if n is None:
        return [torch.flip(x, (0,))]
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    src = torch.where(t < n[None, :], n[None, :] - 1 - t, t)
    return [x[src, torch.arange(x.shape[1], device=x.device)[None, :]]]
