"""Neural-network layer operators.

PyTorch counterpart of ``mxnet_tpu/ops/nn.py`` for the ops the ResNet
training path runs: FullyConnected, Activation, SoftmaxOutput and
BatchNorm. Each ``jax.custom_vjp`` of the JAX package is a
``torch.autograd.Function`` here: SoftmaxOutput's backward ignores the
head gradient, and the BatchNorm train core's forward and backward are
the hand-written kernels of ``kernels/batchnorm.py``.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..registry import register
from ..kernels.batchnorm import bn_fwd, bn_bwd


def _prod(xs):
    p = 1
    for x in xs:
        p *= x
    return p


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------
def _fc_args(attrs):
    return ("data", "weight") if attrs.get("no_bias", False) else \
        ("data", "weight", "bias")


def _fc_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    nh = int(attrs["num_hidden"])
    if data is not None:
        in_shapes[1] = (nh, _prod(data[1:]))
        if not attrs.get("no_bias", False) and len(in_shapes) > 2:
            in_shapes[2] = (nh,)
        return in_shapes, [(data[0], nh)], aux
    return in_shapes, None, aux


@register("FullyConnected", arg_names=_fc_args,
          attr_types={"num_hidden": int, "no_bias": bool},
          infer_shape=_fc_infer)
def _fully_connected(attrs, ins, octx):
    """Y = X·Wᵀ + b, with X flattened to 2-D."""
    x, w = ins[0], ins[1]
    w = w.to(x.dtype)
    b = None if attrs.get("no_bias", False) else ins[2].to(x.dtype)
    return [F.linear(x.reshape(x.shape[0], -1), w, b)]


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------
@register("Activation", attr_types={"act_type": str})
def _activation(attrs, ins, octx):
    """relu/sigmoid/tanh/softrelu."""
    x = ins[0]
    t = attrs.get("act_type", "relu")
    if t == "relu":
        return [torch.relu(x)]
    if t == "sigmoid":
        return [torch.sigmoid(x)]
    if t == "tanh":
        return [torch.tanh(x)]
    if t == "softrelu":
        return [F.softplus(x)]
    raise ValueError("unknown act_type %s" % t)


# ---------------------------------------------------------------------------
# SoftmaxOutput — backward ignores head grads
# ---------------------------------------------------------------------------
def _softmax_out_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    if in_shapes[1] is None:
        if attrs.get("multi_output", False):
            in_shapes[1] = (data[0],) + tuple(data[2:])
        elif attrs.get("preserve_shape", False):
            in_shapes[1] = tuple(data[:-1])
        else:
            in_shapes[1] = (data[0],)
    return in_shapes, [tuple(data)], aux


def _softmax_fwd(data, multi):
    if multi:
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), -1) \
        .reshape(data.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; backward = (p − onehot(label))·grad_scale/norm,
    whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        out = _softmax_fwd(data, attrs.get("multi_output", False))
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        attrs = ctx.attrs
        multi = attrs.get("multi_output", False)
        use_ignore = attrs.get("use_ignore", False)
        ignore_label = float(attrs.get("ignore_label", -1.0))
        if label.shape == out.shape:  # dense label distribution
            grad = out - label
            valid = torch.ones(label.shape[:1], dtype=out.dtype,
                               device=out.device)
        elif multi:
            # out: (n, c, d...), label: (n, d...)
            lab = label.long()
            classes = torch.arange(out.shape[1], device=out.device)
            onehot = (lab[:, None] == classes.reshape(
                (1, -1) + (1,) * (out.dim() - 2))).to(out.dtype)
            grad = out - onehot
            valid = torch.ones(lab.shape, dtype=out.dtype, device=out.device)
            if use_ignore:
                keep = (label != ignore_label).to(out.dtype)
                grad = grad * keep[:, None]
                valid = keep
        else:
            lab = label.reshape(-1)
            flat = out.reshape(-1, out.shape[-1])
            classes = torch.arange(flat.shape[-1], device=out.device)
            onehot = (lab.long()[:, None] == classes).to(out.dtype)
            grad = flat - onehot
            valid = torch.ones(lab.shape, dtype=out.dtype, device=out.device)
            if use_ignore:
                keep = (lab.to(out.dtype) != ignore_label).to(out.dtype)
                grad = grad * keep[:, None]
                valid = keep
            grad = grad.reshape(out.shape)
        norm_mode = attrs.get("normalization", "null")
        if norm_mode == "batch":
            norm = float(_prod(label.shape))
        elif norm_mode == "valid":
            norm = torch.clamp_min(valid.sum(), 1.0)
        else:
            norm = 1.0
        grad = grad * (float(attrs.get("grad_scale", 1.0)) / norm)
        return grad.to(out.dtype), None, None


@register("SoftmaxOutput", arg_names=("data", "label"),
          attr_types={"grad_scale": float, "ignore_label": float,
                      "multi_output": bool, "use_ignore": bool,
                      "preserve_shape": bool, "normalization": str,
                      "out_grad": bool, "smooth_alpha": float},
          infer_shape=_softmax_out_infer,
          alias=("Softmax",))
def _softmax_output(attrs, ins, octx):
    """Softmax forward; gradient (p − onehot(label))·grad_scale w.r.t. data
    only, ignoring the incoming head gradient."""
    data = ins[0]
    label = ins[1] if len(ins) > 1 else \
        torch.zeros(data.shape[:1], dtype=data.dtype, device=data.device)
    if data.device.type == "meta":
        return [_softmax_fwd(data, attrs.get("multi_output", False))]
    return [_SoftmaxOutput.apply(data, label, attrs)]


# ---------------------------------------------------------------------------
# BatchNorm — aux moving stats in/out, hand-written train core
# ---------------------------------------------------------------------------
def _bn_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    c = data[1] if len(data) > 1 else data[0]
    for i in (1, 2):
        if i < len(in_shapes):
            in_shapes[i] = (c,)
    return in_shapes, [tuple(data)], [(c,), (c,)]


def _exact_stats():
    return os.environ.get("MXNET_BN_EXACT_STATS", "0") == "1"


class _BNTrainCore(torch.autograd.Function):
    """The train-mode BatchNorm(+ReLU) core with its hand-derived backward
    (the JAX package's ``_bn_train_core_make``): forward ``bn_fwd``,
    backward ``bn_bwd``. mean and var carry no gradient (their only
    consumer is the moving-stat EMA); the centre c has zero gradient by
    construction (mean = c + E[x − c]); fix_gamma gives zero dγ. dx is
    computed only where x needs a gradient (not for the data's
    BatchNorm, as the JAX step differentiates the parameters only)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, c, eps, fix_gamma, relu, exact):
        x = x.contiguous()
        y, mean, var, rstd, scale, shift = bn_fwd(
            x, gamma, beta, c, eps, fix_gamma, relu, exact)
        ctx.save_for_backward(x, rstd, mean, scale, shift)
        ctx.flags = (fix_gamma, relu, gamma.dtype, beta.dtype)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, rstd, mean, scale, shift = ctx.saved_tensors
        fix_gamma, relu, gdt, bdt = ctx.flags
        dx, dbeta, dgamma = bn_bwd(dy.contiguous(), x, rstd, mean, scale,
                                   shift, relu, ctx.needs_input_grad[0])
        dg = torch.zeros_like(dgamma) if fix_gamma else dgamma
        return dx, dg.to(gdt), dbeta.to(bdt), None, None, None, None, None


def bn_train_core(x, gamma, beta, c, eps, fix_gamma, relu):
    """(y, mean, var) of the train core; ``MXNET_BN_EXACT_STATS=1`` selects
    the two-pass statistics, as in the JAX package."""
    return _BNTrainCore.apply(x, gamma, beta, c, eps, bool(fix_gamma),
                              bool(relu), _exact_stats())


@register("BatchNorm", arg_names=("data", "gamma", "beta"),
          aux_names=("moving_mean", "moving_var"),
          attr_types={"eps": float, "momentum": float, "fix_gamma": bool,
                      "use_global_stats": bool, "output_mean_var": bool},
          infer_shape=_bn_infer, alias=("CuDNNBatchNorm",))
def _batch_norm(attrs, ins, octx):
    """Normalize over all axes but channel (axis 1). In training, use batch
    stats and return the moving-stat EMA as aux updates (the executor
    writes them back). Statistics and normalization run in float32; the
    output comes back in the activation dtype."""
    x, gamma, beta, mmean, mvar = ins
    eps = float(attrs.get("eps", 1e-3))
    mom = float(attrs.get("momentum", 0.9))
    fix_gamma = attrs.get("fix_gamma", True)
    use_global = attrs.get("use_global_stats", False)
    fused_relu = bool(attrs.get("_fused_relu", False))
    f32 = torch.float32
    if octx.is_train and not use_global:
        c = mmean.detach().to(f32)
        out, mean, var = bn_train_core(x, gamma, beta, c, eps, fix_gamma,
                                       fused_relu)
        new_mmean = mmean * mom + mean.detach().to(mmean.dtype) * (1 - mom)
        new_mvar = mvar * mom + var.detach().to(mvar.dtype) * (1 - mom)
        return [out, new_mmean, new_mvar]
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    mean, var = mmean.to(f32), mvar.to(f32)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    out = (x.to(f32) - mean.reshape(bshape)) / \
        torch.sqrt(var.reshape(bshape) + eps)
    out = out * g.to(f32).reshape(bshape) + beta.to(f32).reshape(bshape)
    if fused_relu:
        out = torch.clamp_min(out, 0.0)
    return [out.to(x.dtype), mmean, mvar]
