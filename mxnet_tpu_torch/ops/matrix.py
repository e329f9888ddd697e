"""Shape operators (PyTorch counterpart of ``mxnet_tpu/ops/matrix.py``)."""
from __future__ import annotations

from ..registry import register


@register("Flatten", alias=("flatten",))
def _flatten(attrs, ins, octx):
    """Collapse every axis but the first."""
    x = ins[0]
    return [x.reshape(x.shape[0], -1)]
