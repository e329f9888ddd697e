"""PeerCheckpointStore — peer-replicated in-memory checkpoints (the
port's counterpart of ``mxnet_tpu/autopilot/peer.py``).

Disk is the durability story (the manager's atomic commits); this
store is the GOODPUT story: every elastic commit also leaves a host-
memory copy, row-sharded over the job's hosts by the same
``shard_rows`` rule the data plane uses, with each host additionally
retaining its RIGHT neighbor's block (replication factor 2, ring
layout: block ``b`` lives on hosts ``b`` and ``(b+1) % n``). When a
dp-shrink kills hosts, the survivors can reassemble the full global
arrays from memory — no disk re-read on the resume path — as long as
no block lost BOTH its holders (i.e. no two ring-adjacent hosts died
together). Arrays whose leading dim does not split evenly (biases,
scalars, optimizer bytes, RNG state, manifest extra) are replicated on
every host.

The assembled :class:`~mxnet_tpu_torch.checkpoint.manager.Checkpoint` is
bitwise-equal to ``manager.restore()`` of the same step: both paths
copy the same card tensors to the host (``serialize.snapshot``), and
the npy round-trip the disk path adds is exact.
``ElasticTrainer(peer_store=...)`` captures behind its existing commit
callback and consults :meth:`resume_checkpoint` on recovery — peer
memory is used only when it holds exactly the step disk would restore
(:func:`~mxnet_tpu_torch.autopilot.kernel.decide_resume`).

The hosts here are dicts in one process (the hosts of a
``dist.VirtualCluster``), and ``drop_hosts`` simulates the memory loss a
real death causes; the sharding/placement math is identical either
way.
"""
from __future__ import annotations

import logging
import threading
import time

__all__ = ["PeerCheckpointStore"]


class PeerCheckpointStore(object):
    """In-memory ring-replicated checkpoint snapshots.

    Parameters
    ----------
    n_hosts : int
        The job's host count — the ring the blocks replicate over.
        Fixed at construction (captures shard over the ORIGINAL ring;
        a shrink only removes holders).
    keep : int
        Snapshots retained (default 2); older steps are evicted on
        capture.
    """

    def __init__(self, n_hosts, keep=2, logger=None):
        if int(n_hosts) < 1:
            raise ValueError("n_hosts must be >= 1")
        self.n_hosts = int(n_hosts)
        self.keep = max(1, int(keep))
        self._hosts = [dict() for _ in range(self.n_hosts)]
        self._steps = []
        self._dead = set()
        self._lock = threading.Lock()
        self._logger = logger or logging.getLogger(
            "mxnet_tpu_torch.autopilot")
        self.transcript = []   # resume decisions, replayable
        from .. import telemetry
        scope = telemetry.registry().scope("autopilot")
        self._c_captures = scope.counter("peer_captures")
        self._c_restores = scope.counter("peer_restores")
        self._c_restore_ms = scope.counter("peer_restore_ms")

    # ----------------------------------------------------------- write
    def _split(self, arr):
        """True when ``arr`` row-shards evenly over the ring."""
        n = self.n_hosts
        return (n > 1 and getattr(arr, "ndim", 0) >= 1
                and arr.shape[0] >= n and arr.shape[0] % n == 0)

    def capture(self, step, arrays, optimizer_state=None, extra=None,
                rng_state="auto"):
        """Snapshot one committed step into host memory. ``arrays``
        maps name -> NDArray / tensor / numpy (the same values the
        manager's ``save`` snapshots — call right after the disk
        commit so both paths freeze identical buffers)."""
        from .. import random as _random
        from ..checkpoint import serialize
        from ..dist.sharded_iter import shard_rows
        step = int(step)
        if rng_state == "auto":
            rng_state = _random.get_state()
        n = self.n_hosts
        assembled = {}
        for name, value in arrays.items():
            shards = serialize.snapshot(value)
            full = next((a for idx, a in shards if idx is None), None)
            if full is not None:
                arr = full
            else:
                gshape = [max(idx[d][1] for idx, _ in shards)
                          for d in range(len(shards[0][0]))]
                arr = serialize.assemble(gshape,
                                         str(shards[0][1].dtype),
                                         shards)
            assembled[str(name)] = arr
        with self._lock:
            names = {}
            for name, arr in assembled.items():
                if self._split(arr):
                    names[name] = n
                    for b in range(n):
                        block = shard_rows(arr, b, n)
                        for holder in (b, (b + 1) % n):
                            self._hosts[holder][(step, name, b)] = block
                else:
                    names[name] = None
                    for holder in range(n):
                        self._hosts[holder][(step, name, None)] = arr
            meta = {"names": names,
                    "optimizer": bytes(optimizer_state)
                    if optimizer_state is not None else None,
                    "rng": rng_state,
                    "extra": dict(extra or {})}
            for holder in range(n):
                self._hosts[holder][(step, "__meta__", None)] = meta
            if step in self._steps:
                self._steps.remove(step)
            self._steps.append(step)
            while len(self._steps) > self.keep:
                self._evict(self._steps.pop(0))
        self._c_captures.add()
        return step

    def _evict(self, step):
        for host in self._hosts:
            for key in [k for k in host if k[0] == step]:
                del host[key]

    # ---------------------------------------------------------- deaths
    def drop_hosts(self, hosts):
        """A host death loses its memory: clear the named hosts'
        retained blocks (identity-known deaths — heartbeat-only counts
        cannot name a memory to drop and fall back to disk)."""
        with self._lock:
            for h in hosts:
                h = int(h)
                if 0 <= h < self.n_hosts:
                    self._hosts[h].clear()
                    self._dead.add(h)
        return sorted(self._dead)

    def _holder(self, step, name, block):
        """A surviving host holding the block, or None."""
        if block is None:
            candidates = range(self.n_hosts)
        else:
            candidates = (block, (block + 1) % self.n_hosts)
        for h in candidates:
            if h not in self._dead and \
                    (step, name, block) in self._hosts[h]:
                return h
        return None

    def restorable(self, step):
        """Whether every block of ``step`` still has a surviving
        holder."""
        meta_host = self._holder(step, "__meta__", None)
        if meta_host is None:
            return False
        meta = self._hosts[meta_host][(step, "__meta__", None)]
        for name, nblocks in meta["names"].items():
            blocks = [None] if nblocks is None else range(nblocks)
            for b in blocks:
                if self._holder(step, name, b) is None:
                    return False
        return True

    def latest(self):
        """Newest captured step still assemblable from the survivors,
        or None."""
        with self._lock:
            for step in reversed(self._steps):
                if self.restorable(step):
                    return step
        return None

    # --------------------------------------------------------- restore
    def restore(self, step=None):
        """Assemble a :class:`~mxnet_tpu_torch.checkpoint.manager
        .Checkpoint` from the surviving hosts' memory (default: the
        newest restorable step). Raises ``KeyError`` when no step is
        restorable."""
        import numpy as onp

        from ..checkpoint.manager import Checkpoint
        t0 = time.perf_counter()
        with self._lock:
            if step is None:
                step = next((s for s in reversed(self._steps)
                             if self.restorable(s)), None)
            if step is None or not self.restorable(step):
                raise KeyError(
                    "no peer-restorable checkpoint (steps %r, dead "
                    "hosts %r)" % (self._steps, sorted(self._dead)))
            step = int(step)
            meta_host = self._holder(step, "__meta__", None)
            meta = self._hosts[meta_host][(step, "__meta__", None)]
            params = {}
            for name, nblocks in meta["names"].items():
                if nblocks is None:
                    h = self._holder(step, name, None)
                    params[name] = self._hosts[h][(step, name, None)]
                else:
                    blocks = []
                    for b in range(nblocks):
                        h = self._holder(step, name, b)
                        blocks.append(self._hosts[h][(step, name, b)])
                    params[name] = onp.concatenate(blocks, axis=0)
        self._c_restores.add()
        self._c_restore_ms.add((time.perf_counter() - t0) * 1000.0)
        return Checkpoint(step=step, params=params,
                          optimizer_state=meta["optimizer"],
                          extra=dict(meta["extra"]), rng=meta["rng"])

    def resume_checkpoint(self, disk_step):
        """The elastic-resume hook: the peer Checkpoint when memory
        holds exactly ``disk_step`` (the manager's newest committed
        step), else None (resume from disk). The decision is the pure
        :func:`~mxnet_tpu_torch.autopilot.kernel.decide_resume` and is
        recorded — with its observation — into ``self.transcript``
        and the flight recorder."""
        from .. import telemetry
        from .kernel import AutopilotConfig, decide_resume
        peer_step = self.latest()
        obs = {"disk_step": disk_step, "peer_step": peer_step,
               "peer_restorable": peer_step is not None}
        decision = decide_resume(AutopilotConfig(), obs)
        self.transcript.append({"plane": "resume", "obs": obs,
                                "decision": decision})
        telemetry.flight_recorder().note(
            "autopilot_resume_decision", **dict(obs, **decision))
        if decision["action"] != "peer_restore":
            self._logger.info(
                "autopilot: elastic resume from DISK (%s)",
                decision["reason"])
            return None
        ckpt = self.restore(peer_step)
        self._logger.warning(
            "autopilot: elastic resume from PEER MEMORY at step %d "
            "(no disk re-read)", ckpt.step)
        return ckpt

    # ------------------------------------------------------------ misc
    def stats(self):
        """Occupancy snapshot: steps retained, dead hosts, resident
        bytes per host."""
        with self._lock:
            return {
                "steps": list(self._steps),
                "dead_hosts": sorted(self._dead),
                "bytes_per_host": [
                    sum(getattr(v, "nbytes", 0) for k, v in host.items()
                        if k[1] != "__meta__")
                    for host in self._hosts],
            }
