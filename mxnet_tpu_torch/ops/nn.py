"""Neural-network layer operators.

PyTorch counterpart of ``mxnet_tpu/ops/nn.py``, every operator of it
under the same names and aliases. Each ``jax.custom_vjp`` of the JAX
package is a ``torch.autograd.Function`` here with the same backward:
the loss layers' (SoftmaxOutput, the regression outputs, SVMOutput,
MakeLoss) ignore the head gradient, and the BatchNorm train core's
forward and backward are the hand-written kernels of
``kernels/batchnorm.py``. Dropout and LeakyReLU's ``rrelu`` draw their
masks and slopes from the node's key (``random.key_uniform``).
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..registry import register
from ..kernels import batchnorm as _bnk
from ..kernels.batchnorm import bn_fwd, bn_bwd
from ..precision import quant as _quant
from .. import random as _random


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
    """Y = X·Wᵀ + b, with X flattened to 2-D. Under an active GEMM scope
    (``precision.quant``: an eval forward of a narrow-math mode, or a
    calibration pass) the product goes through ``narrow_dot`` and the
    bias is added after it, in the output's dtype."""
    x, w = ins[0], ins[1]
    w = w.to(x.dtype)
    x2 = x.reshape(x.shape[0], -1)
    y = _quant.narrow_dot(x2, w)
    if y is None:
        b = None if attrs.get("no_bias", False) else ins[2].to(x.dtype)
        return [F.linear(x2, w, b)]
    if not attrs.get("no_bias", False):
        y = y + ins[2].to(y.dtype)[None, :]
    return [y]


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


def _leaky_args(attrs):
    return ("data", "gamma") if attrs.get("act_type") == "prelu" else ("data",)


def _node_uniform(octx, x, what):
    """The node's uniforms in [0, 1) at ``x``'s shape, on its device."""
    if octx.key is None:
        raise MXNetError("%s in training needs a key: run it through an "
                         "executor, which draws one per forward" % what)
    return _random.key_uniform(octx.key, x.shape, x.device)


@register("LeakyReLU", arg_names=_leaky_args,
          attr_types={"act_type": str, "slope": float, "lower_bound": float,
                      "upper_bound": float},
          needs_rng=True)
def _leaky_relu(attrs, ins, octx):
    """leaky/prelu/elu/rrelu; rrelu draws its slopes in training."""
    x = ins[0]
    t = attrs.get("act_type", "leaky")
    slope = float(attrs.get("slope", 0.25))
    if t == "leaky":
        return [torch.where(x > 0, x, slope * x)]
    if t == "elu":
        return [torch.where(x > 0, x, slope * (torch.exp(x) - 1.0))]
    if t == "prelu":
        gamma = ins[1].reshape((1, -1) + (1,) * (x.dim() - 2))
        return [torch.where(x > 0, x, gamma * x)]
    if t == "rrelu":
        lo = float(attrs.get("lower_bound", 0.125))
        hi = float(attrs.get("upper_bound", 0.334))
        if octx.is_train:
            a = (lo + (hi - lo) * _node_uniform(octx, x, "rrelu")) \
                .to(x.dtype)
        else:
            a = (lo + hi) / 2.0
        return [torch.where(x > 0, x, a * x)]
    raise ValueError("unknown act_type %s" % t)


def _softmax(x, axis):
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=axis, keepdim=True)


@register("softmax", attr_types={"axis": int, "temperature": float})
def _softmax_op(attrs, ins, octx):
    tmp = attrs.get("temperature") or 1.0
    return [_softmax(ins[0] / tmp, int(attrs.get("axis", -1)))]


@register("log_softmax", attr_types={"axis": int})
def _log_softmax(attrs, ins, octx):
    x = ins[0]
    axis = int(attrs.get("axis", -1))
    s = x - torch.amax(x, dim=axis, keepdim=True)
    return [s - torch.log(torch.sum(torch.exp(s), dim=axis, keepdim=True))]


@register("SoftmaxActivation", attr_types={"mode": str})
def _softmax_activation(attrs, ins, octx):
    x = ins[0]
    if attrs.get("mode", "instance") == "channel":
        return [_softmax(x, 1)]
    return [_softmax(x.reshape(x.shape[0], -1), -1).reshape(x.shape)]


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
# regression outputs, SVMOutput, MakeLoss — backward ignores head grads
# ---------------------------------------------------------------------------
def _label_like_data_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    if in_shapes[1] is None:
        in_shapes[1] = tuple(data)
    return in_shapes, [tuple(data)], aux


class _RegressionOutput(torch.autograd.Function):
    """Forward ``fwd(data)``; backward
    ``grad(out, label)·grad_scale/num`` with num the label's elements per
    row, whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad, scale):
        ctx.save_for_backward(data, label)
        ctx.fns = (fwd, grad, scale)
        return fwd(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        fwd, grad, scale = ctx.fns
        out = fwd(data)
        num = _prod(label.shape[1:]) or 1
        k = float(torch.tensor(scale / num, dtype=out.dtype))
        return (grad(out, label.reshape(out.shape)) * k, None, None, None,
                None)


def _make_reg_output(name, fwd_fn, grad_fn):
    @register(name, arg_names=("data", "label"),
              attr_types={"grad_scale": float},
              infer_shape=_label_like_data_infer)
    def _f(attrs, ins, octx):
        scale = float(attrs.get("grad_scale", 1.0))
        return [_RegressionOutput.apply(ins[0], ins[1], fwd_fn, grad_fn,
                                        scale)]
    return _f


_make_reg_output("LinearRegressionOutput",
                 lambda d: d,
                 lambda o, l: o - l)
_make_reg_output("LogisticRegressionOutput",
                 lambda d: 1.0 / (1.0 + torch.exp(-d)),
                 lambda o, l: o - l)
_make_reg_output("MAERegressionOutput",
                 lambda d: d,
                 lambda o, l: torch.sign(o - l))


def _svm_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    if in_shapes[1] is None:
        in_shapes[1] = (data[0],)
    return in_shapes, [tuple(data)], aux


class _SVMOutput(torch.autograd.Function):
    """Forward identity; backward the hinge loss's gradient (squared, or
    linear with ``use_linear``), whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, linear):
        ctx.save_for_backward(data, label)
        ctx.flags = (margin, reg, linear)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg, linear = ctx.flags
        classes = torch.arange(data.shape[1], device=data.device)
        onehot = (label.long()[:, None] == classes).to(data.dtype)
        sign = 2.0 * onehot - 1.0    # +1 at the true class, -1 elsewhere
        viol = (margin - sign * data) > 0
        if linear:
            grad = torch.where(viol, -sign * reg, 0.0)
        else:
            grad = torch.where(
                viol, -2.0 * reg * sign * (margin - sign * data), 0.0)
        return grad.to(data.dtype), None, None, None, None


@register("SVMOutput", arg_names=("data", "label"),
          attr_types={"margin": float, "regularization_coefficient": float,
                      "use_linear": bool},
          infer_shape=_svm_infer)
def _svm_output(attrs, ins, octx):
    """Hinge-loss output layer."""
    return [_SVMOutput.apply(
        ins[0], ins[1], float(attrs.get("margin", 1.0)),
        float(attrs.get("regularization_coefficient", 1.0)),
        bool(attrs.get("use_linear", False)))]


class _MakeLoss(torch.autograd.Function):
    """Forward identity; backward ``grad_scale`` (over the element count
    with ``normalization='batch'``) everywhere, whatever the head
    gradient."""

    @staticmethod
    def forward(ctx, data, scale, batch_norm):
        ctx.shape_dtype = (data.shape, data.dtype, data.device)
        ctx.flags = (scale, batch_norm)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.shape_dtype
        scale, batch_norm = ctx.flags
        denom = float(_prod(shape)) if batch_norm else 1.0
        return torch.full(shape, scale / denom, dtype=dtype,
                          device=device), None, None


@register("MakeLoss", attr_types={"grad_scale": float, "normalization": str,
                                  "valid_thresh": float},
          alias=("make_loss",))
def _make_loss(attrs, ins, octx):
    """Forward identity; backward seeds grad_scale."""
    return [_MakeLoss.apply(ins[0], float(attrs.get("grad_scale", 1.0)),
                            attrs.get("normalization", "null") == "batch")]


# ---------------------------------------------------------------------------
# Dropout — the mask from the node's key
# ---------------------------------------------------------------------------
@register("Dropout", attr_types={"p": float}, needs_rng=True)
def _dropout(attrs, ins, octx):
    """In training, keep each element with probability 1 − p and scale
    it by 1/(1 − p): the mask is ``uniform(key) < 1 − p``; identity in
    eval and at p = 0."""
    x = ins[0]
    p = float(attrs.get("p", 0.5))
    if not octx.is_train or p <= 0.0:
        return [x]
    keep = 1.0 - p
    mask = _node_uniform(octx, x, "Dropout") < keep
    # 1 − p rounded to the activation dtype first, as the JAX package
    # divides by it
    kv = float(torch.tensor(keep, dtype=x.dtype))
    return [torch.where(mask, x / kv, 0.0)]


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


# the runtime of the open cross_rank_bn scope: process-wide, not per
# thread, since autograd may run a backward (and a remat recompute inside
# it) on its own device thread
_CROSS_RANK = [None]


@contextlib.contextmanager
def cross_rank_bn(runtime):
    """Within this scope a training BatchNorm reduces its statistics and
    backward sums over the ranks of ``runtime`` (a ``dist.DistRuntime``
    of two or more ranks; None leaves the core on this process's rows).
    The executor groups of a data-parallel module open it around every
    training forward and backward."""
    prev = _CROSS_RANK[0]
    _CROSS_RANK[0] = runtime
    try:
        yield
    finally:
        _CROSS_RANK[0] = prev


def _cross_rank_runtime():
    rt = _CROSS_RANK[0]
    return rt if rt is not None and rt.size > 1 else None


class _BNTrainCore(torch.autograd.Function):
    """The train-mode BatchNorm(+ReLU) core with its hand-derived backward
    (the JAX package's ``_bn_train_core_make``). Two explicit routes:

    * one process (no ``cross_rank_bn`` scope, or a world of one): the
      one-call pair, forward ``bn_fwd`` and backward ``bn_bwd``;
    * a world of two or more ranks: the cross-rank split
      (``kernels.batchnorm.bn_fwd_split``/``bn_bwd_split``), whose
      statistics and dx are those of the global batch, as the JAX
      package's core under a dp mesh computes them. Its dγ and dβ are the
      rank's own partial sums, summed over the ranks with every other
      gradient by the step.

    mean and var carry no gradient (their only consumer is the
    moving-stat EMA); the centre c has zero gradient by construction
    (mean = c + E[x − c]); fix_gamma gives zero dγ. dx is computed only
    where x needs a gradient (not for the data's BatchNorm, as the JAX
    step differentiates the parameters only)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, c, eps, fix_gamma, relu, exact):
        x = x.contiguous()
        rt = _cross_rank_runtime()
        if rt is None:
            y, mean, var, rstd, scale, shift = bn_fwd(
                x, gamma, beta, c, eps, fix_gamma, relu, exact)
        else:
            y, mean, var, rstd, scale, shift = _bnk.bn_fwd_split(
                x, gamma, beta, c, eps, fix_gamma, relu, exact,
                rt.allreduce_, rt.size)
        ctx.save_for_backward(x, rstd, mean, scale, shift)
        ctx.flags = (fix_gamma, relu, gamma.dtype, beta.dtype)
        ctx.runtime = rt
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, rstd, mean, scale, shift = ctx.saved_tensors
        fix_gamma, relu, gdt, bdt = ctx.flags
        rt = ctx.runtime
        if rt is None:
            dx, dbeta, dgamma = bn_bwd(dy.contiguous(), x, rstd, mean,
                                       scale, shift, relu,
                                       ctx.needs_input_grad[0])
        else:
            dx, dbeta, dgamma = _bnk.bn_bwd_split(
                dy.contiguous(), x, rstd, mean, scale, shift, relu,
                ctx.needs_input_grad[0], rt.allreduce_, rt.size)
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


# ---------------------------------------------------------------------------
# InstanceNorm, L2Normalization, LRN, the KL-sparse identity, and
# softmax_cross_entropy
# ---------------------------------------------------------------------------
def _in_infer(attrs, in_shapes, aux):
    d = in_shapes[0]
    if d is not None:
        in_shapes[1] = (d[1],)
        in_shapes[2] = (d[1],)
        return in_shapes, [tuple(d)], aux
    return in_shapes, None, aux


@register("InstanceNorm", arg_names=("data", "gamma", "beta"),
          attr_types={"eps": float}, infer_shape=_in_infer)
def _instance_norm(attrs, ins, octx):
    x, gamma, beta = ins
    eps = float(attrs.get("eps", 1e-3))
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    out = (x - mean) / torch.sqrt(var + eps)
    return [out * gamma.reshape(bshape) + beta.reshape(bshape)]


@register("L2Normalization", attr_types={"eps": float, "mode": str})
def _l2_normalization(attrs, ins, octx):
    x = ins[0]
    eps = float(attrs.get("eps", 1e-10))
    mode = attrs.get("mode", "instance")
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, x.dim()))
    else:
        raise ValueError("unknown mode " + mode)
    denom = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                       + eps)
    return [x / denom]


@register("LRN", attr_types={"alpha": float, "beta": float, "knorm": float,
                             "nsize": int})
def _lrn(attrs, ins, octx):
    """Local response norm across channels: x / (knorm + alpha/nsize ·
    Σ x² over nsize channels, zero-padded)^beta."""
    x = ins[0]
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    knorm = float(attrs.get("knorm", 2.0))
    nsize = int(attrs.get("nsize", 5))
    half = nsize // 2
    sq = torch.square(x)
    pad = [0, 0] * (x.dim() - 2) + [half, half]
    sqp = F.pad(sq, pad)
    C = x.shape[1]
    window_sum = sqp[:, 0:C]
    for j in range(1, nsize):
        window_sum = window_sum + sqp[:, j:j + C]
    return [x / torch.pow(knorm + (alpha / nsize) * window_sum, beta)]


@register("IdentityAttachKLSparseReg",
          attr_types={"sparseness_target": float, "penalty": float,
                      "momentum": float})
def _identity_kl_sparse(attrs, ins, octx):
    """Identity, as in the JAX package (the reference's sparseness
    penalty on the gradient is not applied there either)."""
    return [ins[0]]


def _sce_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is not None and in_shapes[1] is None:
        in_shapes[1] = (data[0],)
    return in_shapes, [(1,)], aux


@register("softmax_cross_entropy", arg_names=("data", "label"),
          infer_shape=_sce_infer)
def _softmax_cross_entropy(attrs, ins, octx):
    """Scalar −Σ log softmax(data)[i, label_i]; the gradient by autograd."""
    data, label = ins
    logp = torch.log_softmax(data, dim=-1)
    lab = torch.clamp(label.long(), 0, data.shape[-1] - 1)
    picked = torch.gather(logp, -1, lab[:, None])
    return [-torch.sum(picked).reshape(1)]
