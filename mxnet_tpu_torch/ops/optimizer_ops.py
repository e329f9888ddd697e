"""Optimizer update ops (PyTorch counterpart of
``mxnet_tpu/ops/optimizer_ops.py``). The Optimizer calls them with
``out=`` set to the weight (and state), so the update lands in place."""
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
