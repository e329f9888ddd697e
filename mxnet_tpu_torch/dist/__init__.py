"""mxnet_tpu_torch.dist — the multi-process data-parallel runtime
(PyTorch counterpart of ``mxnet_tpu/dist``).

The reference scaled past one box through the kvstore's
``dist_device_sync`` over ps-lite servers; the JAX package runs one
global SPMD program whose ``dp`` axis spans processes. The port runs one
process per device over a ``torch.distributed`` process group: every
rank trains its row block of the global batch, gradients are summed over
the ranks before the optimizer and BatchNorm reduces its statistics over
the global batch. The pieces:

* **bootstrap** (:func:`initialize`) — the process group from the
  reference's ``DMLC_*`` variables (or the coordination names), with
  bounded connect retry, a rendezvous barrier with a timeout and an
  explicit backend;
* **runtime** (:class:`DistRuntime`) — rank and size, sum and broadcast
  collectives, a store barrier and heartbeat liveness;
* **staging** (:class:`ShardedDataIter`, :mod:`.staging`) — each rank's
  deterministic slice of the stream, seeded by ``(seed, epoch,
  batch_index, rank)``;
* **elastic** (:class:`ElasticTrainer`, :class:`HeartbeatMonitor`) — on
  a lost worker, resume ``fit(resume_from=)`` from the last committed
  step at the surviving width;
* **virtual hosts** (:class:`VirtualCluster`) — the slice and assembly
  rules driven in one process over simulated hosts.

``mxnet_tpu_torch.parallel.dist`` is a thin compatibility shim over this
package, and ``kvstore.create("dist_*")`` stores ride the same runtime.
"""
from __future__ import annotations

from .bootstrap import initialize, init_from_env, coordination_env
from .runtime import DistRuntime, get_runtime, reset_runtime

__all__ = [
    "initialize", "init_from_env", "coordination_env",
    "DistRuntime", "get_runtime", "reset_runtime",
    "ShardedDataIter", "shard_rows", "batch_seed",
    "VirtualCluster", "VirtualFeed",
    "ElasticTrainer", "HeartbeatMonitor", "WorkerLost",
    "RestartRequired", "ProcessWorld", "RELAUNCH_EXIT_CODE",
    "request_relaunch", "run_with_relaunch", "virtual_world_from_env",
    "stage_sharded", "assemble_host_slices",
]

_LAZY = {
    "ShardedDataIter": "sharded_iter", "shard_rows": "sharded_iter",
    "batch_seed": "sharded_iter",
    "VirtualCluster": "virtual", "VirtualFeed": "virtual",
    "ElasticTrainer": "elastic", "HeartbeatMonitor": "elastic",
    "WorkerLost": "elastic", "RestartRequired": "elastic",
    "ProcessWorld": "elastic", "RELAUNCH_EXIT_CODE": "elastic",
    "request_relaunch": "elastic", "run_with_relaunch": "elastic",
    "virtual_world_from_env": "elastic",
    "stage_sharded": "staging", "assemble_host_slices": "staging",
    "staging": "staging", "virtual": "virtual", "elastic": "elastic",
    "sharded_iter": "sharded_iter",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    import importlib
    module = importlib.import_module("." + mod, __name__)
    value = module if name == mod else getattr(module, name)
    globals()[name] = value
    return value
