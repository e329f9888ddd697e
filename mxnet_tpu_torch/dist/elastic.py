"""Elastic fault tolerance — a dead worker is a restart, not a lost job
(PyTorch counterpart of ``mxnet_tpu/dist/elastic.py``).

The durable checkpoints already guarantee that a committed step
survives anything, so elasticity is control flow:

* a :class:`HeartbeatMonitor` thread watches the runtime's liveness view
  (``DistRuntime.num_dead_nodes``, heartbeats through the store) and
  flips a flag the training loop reads: detection happens off the step
  path, the reaction on it;
* :class:`ElasticTrainer` wraps ``Module.fit(resume_from=)``: it commits
  a checkpoint every K optimizer steps, and when a worker is lost
  (detected or injected) it shrinks the world, rebuilds the module at
  the new dp width through the caller's factory and re-enters ``fit``
  from the last committed step. ``num_update`` (and with it the lr
  schedule), optimizer state, BatchNorm statistics and the RNG come back
  from the checkpoint, and ``set_epoch`` + ``fit``'s mid-epoch batch skip
  replay the stream position, so the resumed trajectory is that of a
  fresh run started from that step at that width.

A live process group cannot shrink in place: :class:`ProcessWorld`'s
``shrink`` raises :class:`RestartRequired`, and :func:`run_with_relaunch`
turns it into the launcher's relaunch contract (``tools/launch.py
--elastic``: exit :data:`RELAUNCH_EXIT_CODE` with the surviving size in
``$MXNET_RELAUNCH_FILE``). The one-process
:class:`~mxnet_tpu_torch.dist.VirtualCluster` shrinks in place.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time

from ..base import MXNetError

__all__ = ["WorkerLost", "RestartRequired", "HeartbeatMonitor",
           "ElasticTrainer", "ProcessWorld", "RELAUNCH_EXIT_CODE",
           "request_relaunch", "run_with_relaunch",
           "virtual_world_from_env"]

# the launcher-relaunch contract (tools/launch.py --elastic)
RELAUNCH_EXIT_CODE = 77


class WorkerLost(MXNetError):
    """A peer died mid-training. ``dead_hosts`` carries the lost host
    ranks when known (injected faults); heartbeat detection only knows
    how many died (``dead_count``). ``faults.WorkerLost`` is this class."""

    def __init__(self, msg, dead_hosts=(), dead_count=None):
        super().__init__(msg)
        self.dead_hosts = tuple(dead_hosts)
        self.dead_count = len(self.dead_hosts) if dead_count is None \
            else int(dead_count)


class RestartRequired(MXNetError):
    """A multi-process job must be relaunched at ``num_processes``."""

    def __init__(self, msg, num_processes):
        super().__init__(msg)
        self.num_processes = int(num_processes)


def request_relaunch(num_processes, path=None):
    """Commit ``{"num_processes": N}`` atomically at ``path`` (default
    ``$MXNET_RELAUNCH_FILE``) for the launcher's relaunch loop. Returns
    the path, or None without one."""
    path = path or os.environ.get("MXNET_RELAUNCH_FILE")
    if not path:
        return None
    from ..checkpoint.serialize import atomic_write_bytes
    atomic_write_bytes(path, json.dumps(
        {"num_processes": int(num_processes),
         "pid": os.getpid()}).encode("utf-8"))
    return path


def run_with_relaunch(fn, exit_fn=None, logger=None):
    """Run ``fn()``; a :class:`RestartRequired` escaping it commits the
    relaunch request and exits with :data:`RELAUNCH_EXIT_CODE`. Returns
    ``fn()``'s value otherwise."""
    log = logger or logging.getLogger(__name__)
    try:
        return fn()
    except RestartRequired as exc:
        path = request_relaunch(exc.num_processes)
        log.warning(
            "relaunch required at %d process(es): %s (exit %d)",
            exc.num_processes,
            "request committed to %s" % path if path
            else "no MXNET_RELAUNCH_FILE — the launcher cannot see "
                 "the surviving size", RELAUNCH_EXIT_CODE)
        (exit_fn or sys.exit)(RELAUNCH_EXIT_CODE)


def virtual_world_from_env(default_hosts=None, context=None):
    """The virtual world an elastic launcher child runs at:
    ``MXNET_VIRTUAL_HOSTS`` (set per attempt by ``tools/launch.py
    --elastic --virtual-hosts N``) is the surviving host count. Returns a
    :class:`~mxnet_tpu_torch.dist.VirtualCluster`, or None."""
    n = os.environ.get("MXNET_VIRTUAL_HOSTS", default_hosts)
    if n is None:
        return None
    from .virtual import VirtualCluster
    return VirtualCluster(int(n), context=context)


class HeartbeatMonitor:
    """Poll peer liveness off the step path.

    A daemon thread probes ``runtime.num_dead_nodes()`` every
    ``interval_s`` (default ``MXNET_DIST_HEARTBEAT_INTERVAL``, 5 s),
    publishes ``dist.dead_nodes`` and ``dist.heartbeat_probe_ms``, and
    calls ``on_dead(count)`` once per increase. ``unacknowledged`` is
    what the training loop's per-batch check reads."""

    def __init__(self, runtime=None, interval_s=None, on_dead=None):
        if runtime is None:
            from .runtime import get_runtime
            runtime = get_runtime()
        self._runtime = runtime
        self._interval = float(
            os.environ.get("MXNET_DIST_HEARTBEAT_INTERVAL", "5")
            if interval_s is None else interval_s)
        self._on_dead = on_dead
        self._stop = threading.Event()
        self._thread = None
        self._dead = 0
        self._acked = 0
        self._lock = threading.Lock()

    @property
    def dead_count(self):
        with self._lock:
            return self._dead

    @property
    def unacknowledged(self):
        """Deaths not yet handled by a recovery."""
        with self._lock:
            return self._dead - self._acked

    def acknowledge(self):
        """Mark the current death count handled (after a shrink)."""
        with self._lock:
            self._acked = self._dead

    def _probe_once(self):
        from .. import faults as _faults
        from .. import telemetry
        scope = telemetry.registry().scope("dist")
        t0 = time.perf_counter()
        n = self._runtime.num_dead_nodes()
        if _faults.armed():
            # heartbeat-death seam (kind=value): injected dead peers
            n = int(_faults.value("dist.heartbeat", n))
        scope.counter("heartbeat_probe_ms").add(
            (time.perf_counter() - t0) * 1000.0)
        scope.gauge("dead_nodes").set(n)
        fire = False
        with self._lock:
            if n > self._dead:
                self._dead = n
                fire = True
        if fire and self._on_dead is not None:
            self._on_dead(n)
        return n

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                self._probe_once()
            except Exception:  # noqa: BLE001 — the monitor must survive
                logging.getLogger(__name__).exception(
                    "heartbeat probe failed")

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="dist-heartbeat-monitor",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2 * self._interval + 1)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ProcessWorld:
    """The multi-process world as an elastic-trainer target: this rank's
    one device; ``shrink`` raises :class:`RestartRequired` with the
    surviving world size for the launcher."""

    def __init__(self, runtime=None):
        if runtime is None:
            from .runtime import get_runtime
            runtime = get_runtime()
        self.runtime = runtime

    @property
    def device_count(self):
        return self.runtime.size

    def contexts(self):
        from ..context import Context
        dev = self.runtime.device
        return [Context("cpu") if dev.type == "cpu"
                else Context("gpu", dev.index or 0)]

    def shrink(self, dead_hosts, dead_count=None):
        dead = max(len(tuple(dead_hosts)), int(dead_count or 0))
        survivors = self.runtime.size - dead
        raise RestartRequired(
            "a live process group cannot shrink in place; relaunch with "
            "%d processes and fit(resume_from=) the same checkpoint "
            "directory" % survivors, survivors)

    def describe(self):
        return {"n_hosts": self.runtime.size,
                "dp_width": self.device_count,
                "rank": self.runtime.rank}


class ElasticTrainer:
    """``fit`` that survives worker loss by shrinking the world.

    Parameters
    ----------
    world : VirtualCluster or ProcessWorld
        Provides ``contexts()``, ``device_count``, ``shrink(dead_hosts)``
        and ``describe()``.
    module_factory : callable
        ``module_factory(world) -> Module`` (unbound), called for every
        attempt.
    data_factory : callable
        ``data_factory(world) -> DataIter`` for every attempt.
    manager : CheckpointManager or str
        The durable checkpoint directory every attempt writes to and
        resumes from.
    checkpoint_every_steps : int
        Commit cadence in optimizer steps (``num_update`` crossing a
        multiple of it).
    min_dp_width : int
        Refuse to train below this width.
    max_restarts : int
        Give up after this many restarts.
    peer_store : PeerCheckpointStore, optional
        A ring-replicated host-memory copy of every commit
        (:class:`~mxnet_tpu_torch.autopilot.PeerCheckpointStore`); a
        resume after a worker loss restores from the survivors' memory
        when it holds exactly the step disk would restore.
        ``MXNET_AUTOPILOT_PEER_CKPT=1`` builds one over the world's
        hosts when none is passed.
    """

    def __init__(self, world, module_factory, data_factory, manager,
                 checkpoint_every_steps=1, save_optimizer_states=True,
                 min_dp_width=1, max_restarts=4, logger=None,
                 flight_recorder=None, peer_store=None):
        from ..checkpoint import CheckpointManager
        if isinstance(manager, str):
            manager = CheckpointManager(manager)
        if peer_store is None and os.environ.get(
                "MXNET_AUTOPILOT_PEER_CKPT", "0") == "1":
            from ..autopilot import PeerCheckpointStore
            peer_store = PeerCheckpointStore(
                world.describe().get("n_hosts", world.device_count))
        self.peer_store = peer_store
        self.world = world
        self.module_factory = module_factory
        self.data_factory = data_factory
        self.manager = manager
        self.every = max(1, int(checkpoint_every_steps))
        self.save_optimizer_states = bool(save_optimizer_states)
        self.min_dp_width = int(min_dp_width)
        self.max_restarts = int(max_restarts)
        self.logger = logger or logging.getLogger(__name__)
        self.transcript = []
        if flight_recorder is None:
            from .. import telemetry
            flight_recorder = telemetry.flight_recorder()
        self.recorder = flight_recorder
        if not self.recorder.armed:
            self.recorder.arm(os.path.join(self.manager.directory,
                                           "blackbox"))

    # ------------------------------------------------------ callbacks
    def _checkpoint_callback(self, mod, world):
        """Batch-end callback committing a step entry whenever
        ``num_update`` crosses a multiple of ``self.every``, keyed by
        ``num_update`` and carrying the resume coordinates."""
        state = {"prev": self.manager.latest() or 0}

        def _cb(param):
            n = mod._optimizer.num_update
            crossed = n // self.every > state["prev"] // self.every
            state["prev"] = n
            if not crossed:
                return
            coords = {"epoch": param.epoch, "nbatch": param.nbatch,
                      "num_update": n, "dp_width": world.device_count}
            mod.save_checkpoint(
                None, n, save_optimizer_states=self.save_optimizer_states,
                manager=self.manager, extra=coords)
            if self.peer_store is not None:
                # the peer-memory copy of the SAME commit, with no step
                # (or RNG draw) in between: both hold identical state
                self.peer_store.capture(
                    n, mod._checkpoint_arrays(),
                    optimizer_state=mod._optimizer_state_bytes()
                    if self.save_optimizer_states else None,
                    extra=coords)
        return _cb

    def _fault_callback(self, fail_at_update, dead_hosts, monitor, mod):
        """Per-batch fault check: an injected fault or a heartbeat-
        detected death raises :class:`WorkerLost` on the training
        thread."""
        def _cb(param):
            from .. import faults as _faults
            if _faults.armed():
                # plan-driven worker loss (kind=worker_lost)
                _faults.check("dist.worker",
                              num_update=mod._optimizer.num_update,
                              epoch=param.epoch, nbatch=param.nbatch)
            if monitor is not None and monitor.unacknowledged:
                raise WorkerLost(
                    "%d peer(s) lost (heartbeat)" % monitor.dead_count,
                    dead_hosts=dead_hosts or (),
                    dead_count=monitor.unacknowledged)
            if fail_at_update is not None and \
                    mod._optimizer.num_update >= fail_at_update:
                raise WorkerLost(
                    "injected fault at num_update=%d"
                    % mod._optimizer.num_update, dead_hosts=dead_hosts)
        return _cb

    # ------------------------------------------------------------ fit
    def fit(self, train_factory_kwargs=None, num_epoch=None,
            inject_fault=None, monitor=None, batch_end_callback=None,
            **fit_kwargs):
        """Train to ``num_epoch``, surviving worker loss.

        ``inject_fault=(num_update, dead_hosts)`` makes the first attempt
        raise :class:`WorkerLost` once ``num_update`` reaches the step;
        ``monitor`` may be a started :class:`HeartbeatMonitor`. Returns
        the trained module; ``self.transcript`` records every attempt."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        del train_factory_kwargs
        installed_here = not self.recorder.installed
        if installed_here:
            self.recorder.install()
        try:
            return self._fit_attempts(self.world, inject_fault, num_epoch,
                                      monitor, batch_end_callback,
                                      fit_kwargs)
        finally:
            if installed_here:
                self.recorder.uninstall()

    def _fit_attempts(self, world, fault, num_epoch, monitor,
                      batch_end_callback, fit_kwargs):
        attempt = 0
        resume_src = self.manager
        while True:
            if world.device_count < self.min_dp_width:
                raise MXNetError(
                    "surviving world (%d devices) below min_dp_width=%d"
                    % (world.device_count, self.min_dp_width))
            self.recorder.set_state(attempt=attempt,
                                    dp_width=world.device_count,
                                    world=world.describe(),
                                    resume_step=self.manager.latest())
            self.recorder.note("elastic_attempt", attempt=attempt,
                               dp_width=world.device_count)
            mod = self.module_factory(world)
            data = self.data_factory(world)
            cbs = [self._checkpoint_callback(mod, world)]
            from .. import faults as _faults
            if fault is not None or monitor is not None \
                    or _faults.armed():
                cbs.append(self._fault_callback(
                    fault[0] if fault else None,
                    fault[1] if fault else (), monitor, mod))
            if batch_end_callback is not None:
                cbs.extend(batch_end_callback if isinstance(
                    batch_end_callback, list) else [batch_end_callback])
            entry = {"attempt": attempt, "dp_width": world.device_count,
                     "resume_step": self.manager.latest(),
                     "resume_source": "disk" if resume_src
                     is self.manager else "peer",
                     "world": world.describe()}
            self.recorder.pop_last_dump()
            t0 = time.perf_counter()
            try:
                mod.fit(data, num_epoch=num_epoch,
                        resume_from=resume_src,
                        batch_end_callback=cbs, **fit_kwargs)
            except WorkerLost as exc:
                entry.update({
                    "event": "worker_lost", "error": str(exc),
                    "dead_hosts": list(exc.dead_hosts),
                    "train_s": round(time.perf_counter() - t0, 3),
                    "at_num_update": mod._optimizer.num_update,
                })
                self.recorder.note("worker_lost", error=str(exc),
                                   at_num_update=entry["at_num_update"])
                from .. import telemetry as _tel
                wd = _tel.health_watchdog()
                entry["health_incidents"] = [
                    {k: i.get(k) for k in ("gauge", "value", "baseline",
                                           "threshold", "ts")}
                    for i in wd.incidents()] if wd.armed else []
                try:
                    entry["postmortem"] = self.recorder.pop_last_dump() \
                        or self.recorder.dump("worker_lost: %s" % exc)
                except Exception:  # noqa: BLE001 - recovery must proceed
                    self.logger.exception("flight-recorder dump failed")
                    entry["postmortem"] = None
                self.transcript.append(entry)
                # what finished writing commits; a failed in-flight save
                # is simply not the latest committed step
                try:
                    self.manager.wait_until_finished()
                except MXNetError:
                    self.logger.exception(
                        "in-flight checkpoint failed during recovery")
                attempt += 1
                if attempt > self.max_restarts:
                    raise MXNetError(
                        "gave up after %d elastic restarts" % attempt
                    ) from exc
                world = world.shrink(exc.dead_hosts,
                                     dead_count=exc.dead_count)
                resume_src = self.manager
                if self.peer_store is not None:
                    # the dead hosts' memory is gone; the survivors' ring
                    # replicas may still cover every block, and then the
                    # resume skips the disk read. Any failure here falls
                    # back to the durable path.
                    self.peer_store.drop_hosts(exc.dead_hosts)
                    try:
                        peer_ckpt = self.peer_store.resume_checkpoint(
                            self.manager.latest())
                    except Exception:  # noqa: BLE001 - recovery proceeds
                        self.logger.exception(
                            "peer-checkpoint resume failed; falling "
                            "back to disk")
                        peer_ckpt = None
                    if peer_ckpt is not None:
                        resume_src = peer_ckpt
                        self.recorder.note("peer_restore",
                                           step=peer_ckpt.step)
                fault = None  # an injected fault fires once
                if monitor is not None:
                    monitor.acknowledge()
                self.logger.warning(
                    "worker lost (%s); resuming from step %s at dp=%d",
                    exc, self.manager.latest(), world.device_count)
                continue
            entry.update({
                "event": "finished",
                "train_s": round(time.perf_counter() - t0, 3),
                "final_num_update": mod._optimizer.num_update,
            })
            self.transcript.append(entry)
            self.world = world
            return mod
