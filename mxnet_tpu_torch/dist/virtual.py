"""Virtual hosts — multi-host semantics in one process (PyTorch
counterpart of ``mxnet_tpu/dist/virtual.py``).

A :class:`VirtualCluster` splits a dp width into simulated hosts and
drives the code a real job runs, in one process on one device:

* each host's row slice is :func:`~mxnet_tpu_torch.dist.shard_rows`, the
  rule ``ShardedDataIter`` applies per rank;
* the global batch is assembled on the device from the hosts' slices
  (:func:`~mxnet_tpu_torch.dist.staging.assemble_host_slices`: each
  slice copied into its rows, no host-side concatenation), so it holds
  exactly the bytes of the plain batch and a fit through the feed trains
  to a plain fit's parameters bit for bit.

``VirtualCluster.shrink(dead_hosts)`` is the elastic story: the
survivors make the new, narrower world, as a real relaunch at a smaller
world size does.
"""
from __future__ import annotations

import time

import numpy as onp

from ..base import MXNetError
from ..io import DataBatch, DataIter
from .sharded_iter import _host, batch_seed, shard_rows

__all__ = ["VirtualCluster", "VirtualFeed"]


class VirtualCluster:
    """``n_hosts`` simulated hosts of ``devices_per_host`` virtual
    devices each, all computing on one real device (``context``, default
    the current context). Host h owns virtual devices
    ``[h*per:(h+1)*per]``; the dp width is their count."""

    def __init__(self, n_hosts, devices_per_host=1, context=None):
        n_hosts, per = int(n_hosts), int(devices_per_host)
        if n_hosts < 1 or per < 1:
            raise MXNetError("a cluster needs at least one host of one "
                             "device (got %d x %d)" % (n_hosts, per))
        if context is None:
            from ..context import current_context
            context = current_context()
        self.context = context
        self.hosts = [["vdev%d" % (h * per + i) for i in range(per)]
                      for h in range(n_hosts)]

    @property
    def n_hosts(self):
        return len(self.hosts)

    @property
    def devices(self):
        return [d for host in self.hosts for d in host]

    @property
    def device_count(self):
        return sum(len(h) for h in self.hosts)

    def contexts(self):
        """The Module ``context=`` argument: the one real device."""
        return [self.context]

    def shrink(self, dead_hosts, dead_count=None):
        """The surviving cluster after ``dead_hosts`` (host ranks) die.
        A heartbeat-detected loss carries only a count: the trailing
        ``dead_count`` hosts retire."""
        dead_hosts = tuple(dead_hosts)
        if not dead_hosts and dead_count:
            dead_hosts = tuple(range(self.n_hosts - int(dead_count),
                                     self.n_hosts))
        dead = {int(h) for h in dead_hosts}
        unknown = dead - set(range(self.n_hosts))
        if unknown:
            raise MXNetError("no such host(s): %s" % sorted(unknown))
        survivors = [host for h, host in enumerate(self.hosts)
                     if h not in dead]
        if not survivors:
            raise MXNetError("cannot shrink to an empty cluster")
        out = VirtualCluster.__new__(VirtualCluster)
        out.context = self.context
        out.hosts = survivors
        return out

    def feed(self, data_iter, module=None, seed=0, transform=None):
        """A :class:`VirtualFeed` of ``data_iter``'s global batches."""
        return VirtualFeed(data_iter, self, module=module, seed=seed,
                           transform=transform)

    def describe(self):
        """JSON-friendly cluster spec."""
        return {
            "n_hosts": self.n_hosts,
            "devices_per_host": len(self.hosts[0]),
            "dp_width": self.device_count,
            "hosts": [list(host) for host in self.hosts],
        }


class VirtualFeed(DataIter):
    """Global batches staged as if ``cluster.n_hosts`` processes fed
    them: every host's slice cut with :func:`shard_rows` (and run through
    the optional ``transform(parts, rng)`` on numpy, seeded
    ``(seed, epoch, batch_index, host)``, the stream a real
    ``ShardedDataIter`` would give), then assembled on the device the
    bound module trains on (else the cluster's)."""

    def __init__(self, data_iter, cluster, module=None, seed=0,
                 transform=None):
        super().__init__(getattr(data_iter, "batch_size", 0))
        if self.batch_size and self.batch_size % cluster.device_count:
            raise MXNetError(
                "global batch %d does not divide the cluster's %d devices"
                % (self.batch_size, cluster.device_count))
        self._iter = data_iter
        self._cluster = cluster
        self._module = module
        self._seed = int(seed)
        self._transform = transform
        self._epoch = 0
        self._nbatch = -1
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        # per-host feed clocks -> the straggler gauge
        self._host_ms = [0.0] * cluster.n_hosts
        self._straggler_gauge = None

    # ------------------------------------------------------- epochs
    @property
    def epoch_coord(self):
        return self._epoch

    def set_epoch(self, epoch):
        self._epoch = int(epoch)

    def reset(self):
        self._iter.reset()
        self._epoch += 1
        self._nbatch = -1

    def skip_batches(self, n):
        """Advance the stream by ``n`` batches without slicing or
        placing them (fit's mid-epoch resume)."""
        done = 0
        for _ in range(int(n)):
            try:
                self._iter.next()
            except StopIteration:
                break
            self._nbatch += 1
            done += 1
        return done

    # ------------------------------------------------------ staging
    def _device(self):
        grp = getattr(self._module, "_exec_group", None)
        if grp is not None:
            return grp.contexts[0].torch_device()
        return self._cluster.context.torch_device()

    def _host_parts(self, batch):
        """Per-host {data, label} row slices (transformed under the
        per-(host, batch) rng), each host's time folded into its clock."""
        from .. import faults as _faults
        from ..ndarray import NDArray
        n = self._cluster.n_hosts

        def read(a):
            return a._read() if isinstance(a, NDArray) else a

        parts = []
        for h in range(n):
            t0 = time.perf_counter()
            if _faults.armed():
                # straggler seam (kind=delay): one host's feed stalls
                _faults.check("dist.straggler", host=h,
                              batch=self._nbatch, epoch=self._epoch)
            part = {
                "data": [shard_rows(read(d), h, n) for d in batch.data],
                "label": [None if lb is None else shard_rows(read(lb), h, n)
                          for lb in (batch.label or [])],
            }
            if self._transform is not None:
                rng = onp.random.RandomState(batch_seed(
                    self._seed, self._epoch, self._nbatch, h))
                part = self._transform(
                    {k: [None if v is None else _host(v) for v in vs]
                     for k, vs in part.items()}, rng)
            self._host_ms[h] += (time.perf_counter() - t0) * 1000.0
            parts.append(part)
        self._publish_straggler()
        return parts

    def host_clocks_ms(self):
        """Cumulative per-host feed clocks."""
        return list(self._host_ms)

    def straggler_ratio(self):
        """max/mean of the per-host feed clocks: 1.0 for balanced hosts,
        well above it for a straggler."""
        mean = sum(self._host_ms) / max(len(self._host_ms), 1)
        if mean <= 0.0:
            return 1.0
        return max(self._host_ms) / mean

    def _publish_straggler(self):
        from .. import telemetry
        if self._straggler_gauge is None:
            self._straggler_gauge = telemetry.registry().gauge(
                "dist.straggler_ratio")
        self._straggler_gauge.set(round(self.straggler_ratio(), 4))

    def next(self):
        from ..ndarray import NDArray
        from .staging import assemble_host_slices
        batch = self._iter.next()     # StopIteration at epoch end
        self._nbatch += 1
        parts = self._host_parts(batch)
        dev = self._device()
        data = [NDArray(assemble_host_slices([p["data"][i] for p in parts],
                                             dev))
                for i in range(len(batch.data))]
        label = None
        if batch.label:
            label = [None if batch.label[i] is None else NDArray(
                assemble_host_slices([p["label"][i] for p in parts], dev))
                for i in range(len(batch.label))]
        return DataBatch(data=data, label=label, pad=batch.pad,
                         index=batch.index)

