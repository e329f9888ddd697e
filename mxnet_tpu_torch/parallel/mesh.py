"""Device meshes for data parallelism (PyTorch counterpart of
``mxnet_tpu/parallel/mesh.py``).

The JAX package runs a job over a ``jax.sharding.Mesh`` with named axes.
The port's data-parallel mesh is one ``dp`` axis over the ranks of the
process group (one device per rank, :class:`~mxnet_tpu_torch.dist.
DistRuntime`), or over a virtual cluster's devices. Tensor, pipeline,
sequence and expert axes, and several devices in one process, come with
the model-parallel half of the port (ROADMAP A8b): naming one raises.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["Mesh", "make_mesh", "data_parallel_mesh", "mesh_from_contexts",
           "shard_bounds"]

_A8B = ("comes with the model-parallel half of the port (ROADMAP A8b); "
        "this slice has the 'dp' axis over ranks")


class Mesh:
    """A 1-D named mesh: ``axis_names`` ("dp",), ``shape`` {"dp": n} and
    its ``devices`` in axis order."""

    def __init__(self, devices, axis_names=("dp",)):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: len(self.devices)}

    @property
    def size(self):
        return len(self.devices)

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%s=%d" % kv
                                      for kv in self.shape.items())


def shard_bounds(index, shape):
    """A shard index (a tuple of slices over the global shape) as per-dim
    ``(start, stop)`` bounds; strided shards are rejected."""
    out = []
    for sl, n in zip(index, shape):
        start, stop, step = sl.indices(n)
        if step != 1:
            raise ValueError("non-contiguous shard index %r" % (sl,))
        out.append((start, stop))
    return tuple(out)


def make_mesh(axis_sizes, devices=None):
    """A mesh from ``{"dp": n}`` (-1 takes every device) over ``devices``
    (default: the ranks of the live runtime)."""
    axis_sizes = dict(axis_sizes)
    other = [a for a in axis_sizes if a != "dp"]
    if other:
        raise MXNetError("mesh axis %r %s" % (other[0], _A8B))
    if devices is None:
        from ..dist.runtime import get_runtime
        devices = get_runtime().global_devices
    devices = list(devices)
    n = axis_sizes.get("dp", -1)
    n = len(devices) if n == -1 else int(n)
    if n > len(devices) or n < 1:
        raise MXNetError("mesh {'dp': %d} needs %d devices, have %d"
                         % (n, n, len(devices)))
    return Mesh(devices[:n])


def data_parallel_mesh(num_devices=None, devices=None):
    """The 1-D 'dp' mesh over the ranks (or ``devices``)."""
    if devices is None:
        from ..dist.runtime import get_runtime
        devices = get_runtime().global_devices
    devices = list(devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    return make_mesh({"dp": len(devices)}, devices)


def mesh_from_contexts(contexts):
    """Map a Module ``context=`` list onto the dp mesh: one context per
    process, the mesh spanning the ranks. Several contexts in one
    process raise (ROADMAP A8b)."""
    from ..context import Context
    if isinstance(contexts, Context):
        contexts = [contexts]
    if len(contexts) != 1:
        raise MXNetError("%d contexts in one process %s"
                         % (len(contexts), _A8B))
    return data_parallel_mesh()
