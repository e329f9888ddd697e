"""Creation operators (PyTorch counterpart of
``mxnet_tpu/ops/init_ops.py``): ``_zeros``, the op behind
``mx.sym.zeros``, which RNN cells use for their initial states."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from ..registry import register


def _shape(attrs):
    shape = attrs.get("shape", ())
    return (shape,) if isinstance(shape, int) else tuple(shape)


@register("_zeros", arg_names=(), attr_types={"shape": tuple, "dtype": str},
          infer_shape=lambda attrs, ins, aux: (ins, [_shape(attrs)], aux),
          alias=("zeros",))
def _zeros(attrs, ins, octx):
    """Zeros of ``shape`` and ``dtype`` (float32) on the graph's device."""
    return [torch.zeros(_shape(attrs),
                        dtype=torch_dtype(attrs.get("dtype", "float32")),
                        device=octx.device)]
