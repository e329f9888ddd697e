"""Optimizer update ops (PyTorch counterpart of
``mxnet_tpu/ops/optimizer_ops.py``): SGD with and without momentum,
Adam, and RMSProp in Tieleman's and Graves' (centered) forms. The
Optimizer calls them with ``out=`` set to the weight (and state), so the
update lands in place."""
from __future__ import annotations

import torch

from ..registry import register

_SGD_ATTRS = {"lr": float, "wd": float, "rescale_grad": float,
              "clip_gradient": float, "momentum": float}


def _prep(attrs, grad):
    g = grad * float(attrs.get("rescale_grad", 1.0))
    clip = attrs.get("clip_gradient", None)
    if clip is not None and float(clip) > 0:
        g = torch.clamp(g, -float(clip), float(clip))
    return g


@register("sgd_update", arg_names=("weight", "grad"), attr_types=_SGD_ATTRS)
def _sgd_update(attrs, ins, octx):
    """w − lr·(rescale·g + wd·w)."""
    w, grad = ins
    lr = float(attrs.get("lr", 0.01))
    wd = float(attrs.get("wd", 0.0))
    return [w - lr * (_prep(attrs, grad) + wd * w)]


@register("sgd_mom_update", arg_names=("weight", "grad", "mom"),
          out_names=("weight", "mom"), attr_types=_SGD_ATTRS)
def _sgd_mom_update(attrs, ins, octx):
    """mom' = momentum·mom − lr·(rescale·g + wd·w); w' = w + mom'."""
    w, grad, mom = ins
    lr = float(attrs.get("lr", 0.01))
    wd = float(attrs.get("wd", 0.0))
    momentum = float(attrs.get("momentum", 0.0))
    new_mom = momentum * mom - lr * (_prep(attrs, grad) + wd * w)
    return [w + new_mom, new_mom]


@register("adam_update", arg_names=("weight", "grad", "mean", "var"),
          out_names=("weight", "mean", "var"),
          attr_types={"lr": float, "beta1": float, "beta2": float,
                      "epsilon": float, "wd": float, "rescale_grad": float,
                      "clip_gradient": float})
def _adam_update(attrs, ins, octx):
    """g = rescale·grad (+clip) + wd·w; m' = β1·m + (1−β1)·g;
    v' = β2·v + (1−β2)·g²; w' = w − lr·m'/(√v' + ε)."""
    w, grad, mean, var = ins
    lr = float(attrs.get("lr", 0.01))
    beta1 = float(attrs.get("beta1", 0.9))
    beta2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    wd = float(attrs.get("wd", 0.0))
    g = _prep(attrs, grad) + wd * w
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = w - lr * new_mean / (torch.sqrt(new_var) + eps)
    return [new_w, new_mean, new_var]


_RMSPROP_ATTRS = {"lr": float, "gamma1": float, "gamma2": float,
                  "epsilon": float, "wd": float, "rescale_grad": float,
                  "clip_gradient": float, "clip_weights": float}


def _clip_weights(attrs, w):
    cw = attrs.get("clip_weights", None)
    if cw is not None and float(cw) > 0:
        return torch.clamp(w, -float(cw), float(cw))
    return w


@register("rmsprop_update", arg_names=("weight", "grad", "n"),
          out_names=("weight", "n"), attr_types=_RMSPROP_ATTRS)
def _rmsprop_update(attrs, ins, octx):
    """Tieleman's RMSProp: g = rescale·grad (+clip) + wd·w;
    n' = (1−γ1)·g² + γ1·n; w' = w − lr·g/√(n' + ε) (+clip_weights)."""
    w, grad, n = ins
    lr = float(attrs.get("lr", 0.01))
    gamma1 = float(attrs.get("gamma1", 0.95))
    eps = float(attrs.get("epsilon", 1e-8))
    g = _prep(attrs, grad) + float(attrs.get("wd", 0.0)) * w
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_w = w - lr * g / torch.sqrt(new_n + eps)
    return [_clip_weights(attrs, new_w), new_n]


@register("rmspropalex_update",
          arg_names=("weight", "grad", "n", "g", "delta"),
          out_names=("weight", "n", "g", "delta"), attr_types=_RMSPROP_ATTRS)
def _rmspropalex_update(attrs, ins, octx):
    """Graves' centered RMSProp: n' = (1−γ1)·g² + γ1·n;
    ḡ' = (1−γ1)·g + γ1·ḡ; δ' = γ2·δ − lr·g/√(n' − ḡ'² + ε); w' = w + δ'."""
    w, grad, n, gbar, delta = ins
    lr = float(attrs.get("lr", 0.01))
    gamma1 = float(attrs.get("gamma1", 0.95))
    gamma2 = float(attrs.get("gamma2", 0.9))
    eps = float(attrs.get("epsilon", 1e-8))
    g = _prep(attrs, grad) + float(attrs.get("wd", 0.0)) * w
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_gbar = (1 - gamma1) * g + gamma1 * gbar
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_gbar) + eps)
    return [_clip_weights(attrs, w + new_delta), new_n, new_gbar, new_delta]
