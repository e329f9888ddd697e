"""Multi-process staging — a rank's rows onto its device (PyTorch
counterpart of ``mxnet_tpu/dist/staging.py``).

The JAX package stages every input onto a global mesh-sharded array:
each process contributes the rows its devices own and no host holds the
whole batch. In the port each rank trains its own row block on its own
device, so staging is:

* a world of one: the value goes to the device as it is, which is what
  ``MeshExecutorGroup._stage`` does (a copy into the bound input);
* a world of R: a value with the rank's row count is its block already
  (a ``ShardedDataIter`` slice); a value with R times as many rows is a
  replicated global batch, cut to the rank's block (:func:`local_block`)
  before it moves; anything else raises.

:func:`assemble_host_slices` is the one-process twin used by the
virtual-host harness (:class:`~mxnet_tpu_torch.dist.VirtualCluster`):
the global batch is made on the one device by copying each simulated
host's slice into its row block of a device tensor, with no host-side
concatenation.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["stage_sharded", "assemble_host_slices", "local_block"]


def local_block(global_shape, rank, num_shards, axis=0):
    """Rank ``rank``'s contiguous block (a tuple of per-dim slices) of a
    ``global_shape`` array split over ``num_shards`` on ``axis``."""
    global_shape = tuple(global_shape)
    n = global_shape[axis]
    if n % num_shards:
        raise MXNetError("%d rows on axis %d do not divide over %d shards"
                         % (n, axis, num_shards))
    m = n // num_shards
    return tuple(slice(rank * m, (rank + 1) * m) if d == axis
                 else slice(0, extent)
                 for d, extent in enumerate(global_shape))


def _tensor(value):
    from ..ndarray import NDArray
    if isinstance(value, NDArray):
        return value._read()
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(value)


def stage_sharded(value, device, global_shape=None, rank=0, num_shards=1,
                  axis=0):
    """This rank's rows of ``value`` (NDArray, tensor or numpy) on
    ``device``. ``global_shape`` is the GLOBAL shape (None: the value's
    own); see the module docstring for the rule."""
    val = _tensor(value)
    if num_shards > 1:
        gshape = tuple(global_shape) if global_shape is not None \
            else tuple(val.shape)
        if tuple(val.shape) == gshape:
            val = val[local_block(gshape, rank, num_shards, axis)]
        elif val.shape[axis] * num_shards != gshape[axis]:
            raise MXNetError(
                "rank %d got %d rows on axis %d: neither its block of %d "
                "nor the global %d" % (rank, val.shape[axis], axis,
                                       gshape[axis] // num_shards,
                                       gshape[axis]))
    return val.to(device)


def assemble_host_slices(host_slices, device, global_shape=None):
    """The global array on ``device`` from the simulated hosts' row
    blocks (host order = row order, the ``shard_rows`` rule): one
    ``torch.empty`` of the global shape and one copy of each host's block
    into its rows."""
    parts = [_tensor(s) for s in host_slices]
    m = parts[0].shape[0]
    gshape = tuple(global_shape) if global_shape is not None \
        else (m * len(parts),) + tuple(parts[0].shape[1:])
    if gshape[0] != m * len(parts):
        raise MXNetError("%d hosts of %d rows do not make %d rows"
                         % (len(parts), m, gshape[0]))
    out = torch.empty(gshape, dtype=parts[0].dtype, device=device)
    for h, part in enumerate(parts):
        if tuple(part.shape) != (m,) + gshape[1:]:
            raise MXNetError("host %d's block has shape %s, not %s"
                             % (h, tuple(part.shape), (m,) + gshape[1:]))
        out[h * m:(h + 1) * m].copy_(part)
    return out
