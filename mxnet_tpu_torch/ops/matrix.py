"""Shape operators (PyTorch counterpart of ``mxnet_tpu/ops/matrix.py``):
Flatten and transpose."""
from __future__ import annotations

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
