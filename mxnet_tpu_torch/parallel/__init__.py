"""Parallelism toolkit (PyTorch counterpart of ``mxnet_tpu/parallel``):
its data-parallel half.

* ``mesh``: the 'dp' mesh over the ranks of the process group
* ``data_parallel``: the data-parallel train step (gradients summed over
  the ranks, BatchNorm over the global batch)
* ``dist``: the multi-process runtime behind the KVStore API (a shim over
  ``mxnet_tpu_torch.dist``)

Tensor, pipeline and expert parallelism and ring attention come with the
model-parallel half of the port (ROADMAP A8b): their names raise.
"""
from __future__ import annotations

from ..base import MXNetError
from . import dist  # noqa: F401
from . import mesh  # noqa: F401
from . import data_parallel  # noqa: F401

_A8B = {
    "tensor_parallel": ("column_parallel_dense", "row_parallel_dense",
                        "tp_mlp_block", "tp_attention_block", "TPDensePair",
                        "shard_params_for_tp"),
    "pipeline_parallel": ("pipeline_apply", "PipelineRunner"),
    "expert_parallel": ("top1_routing", "moe_dispatch_combine",
                        "moe_ffn_block", "MoELayer"),
    "ring_attention": ("ring_attention", "ring_self_attention",
                       "local_attention", "RingAttention"),
}


def __getattr__(name):
    for module, names in _A8B.items():
        if name == module or name in names:
            raise MXNetError(
                "parallel.%s (the JAX package's parallel/%s.py) comes with "
                "the model-parallel half of the port (ROADMAP A8b); this "
                "slice has data parallelism" % (name, module))
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
