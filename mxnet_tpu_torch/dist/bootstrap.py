"""Cluster bootstrap — ``torch.distributed`` from the environment
(PyTorch counterpart of ``mxnet_tpu/dist/bootstrap.py``).

A job is launched as the reference launched it (``tools/launch.py -n 4
python train.py``: every process gets the coordinator's address, the
world size and its id), and the variables may come from either
vocabulary:

=======================  ==========================  ==========================
meaning                  reference (``DMLC_*``)      coordination
=======================  ==========================  ==========================
coordinator host         ``DMLC_PS_ROOT_URI``        ``JAX_COORDINATOR_ADDRESS``
coordinator port         ``DMLC_PS_ROOT_PORT``       (part of the address)
world size               ``DMLC_NUM_WORKER``         ``JAX_NUM_PROCESSES``
process id               ``DMLC_WORKER_ID``          ``JAX_PROCESS_ID``
=======================  ==========================  ==========================

(the coordination names are the JAX package's, kept so that one launch
environment starts either package).

:func:`initialize` joins the job: rank 0 hosts a ``TCPStore`` at the
coordinator address and every rank connects to it with bounded retry and
exponential backoff (workers race the coordinator to its port); the
process group starts on that store; then a rendezvous barrier with a
timeout holds every rank until the world is whole. ``dist.rank``,
``dist.world_size`` and ``dist.bootstrap_ms`` go into the telemetry
registry.

The backend is explicit (``backend=`` or ``MXNET_DIST_BACKEND``):
``nccl`` when every rank on the host has a card of its own, ``gloo``
without CUDA. Ranks that would share a card (NCCL refuses two ranks on
one card) must name ``gloo``; a backend that cannot start raises, and
nothing switches backend quietly.
"""
from __future__ import annotations

import datetime
import logging
import os
import time

import torch

from ..base import MXNetError

__all__ = ["initialize", "init_from_env", "coordination_env"]

BACKENDS = ("nccl", "gloo")
CONNECT_TIMEOUT_S = 30.0     # one connect attempt's wait for the store
COLLECTIVE_TIMEOUT_S = 300.0  # the process group's bound on a collective


def coordination_env(env=None):
    """Resolve the coordination settings from the environment.

    Returns ``{"coordinator_address", "num_processes", "process_id",
    "heartbeat_timeout", "source"}``, ``source`` naming the vocabulary
    that supplied them (``"jax"``, ``"dmlc"`` or ``"none"``); the
    coordination names win when both are set."""
    env = os.environ if env is None else env
    if env.get("JAX_COORDINATOR_ADDRESS") or env.get("JAX_NUM_PROCESSES"):
        return {
            "coordinator_address": env.get("JAX_COORDINATOR_ADDRESS"),
            "num_processes": int(env.get("JAX_NUM_PROCESSES", "1")),
            "process_id": int(env.get("JAX_PROCESS_ID", "0")),
            "heartbeat_timeout": int(
                env.get("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", "100")),
            "source": "jax",
        }
    n_worker = int(env.get("DMLC_NUM_WORKER", "1"))
    if n_worker > 1:
        coord = env.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        port = env.get("DMLC_PS_ROOT_PORT", "9091")
        return {
            "coordinator_address": "%s:%s" % (coord, port),
            "num_processes": n_worker,
            "process_id": int(env.get("DMLC_WORKER_ID", "0")),
            "heartbeat_timeout": int(
                env.get("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", "100")),
            "source": "dmlc",
        }
    return {"coordinator_address": None, "num_processes": 1,
            "process_id": 0, "heartbeat_timeout": 100, "source": "none"}


def resolve_backend(backend, num_processes):
    """The backend a job of ``num_processes`` ranks on this host runs:
    the named one (argument, else ``MXNET_DIST_BACKEND``), checked to be
    available; else ``nccl`` when there are at least as many cards as
    ranks, ``gloo`` without CUDA. Raises for ranks that would share a
    card without a named backend, and for a named backend that is not
    available."""
    backend = backend or os.environ.get("MXNET_DIST_BACKEND") or None
    if backend is not None:
        if backend not in BACKENDS:
            raise MXNetError("unknown dist backend %r (one of %s)"
                             % (backend, ", ".join(BACKENDS)))
        if backend == "nccl" and not (
                torch.cuda.is_available()
                and torch.distributed.is_nccl_available()):
            raise MXNetError("dist backend 'nccl' needs CUDA and a "
                             "PyTorch built with NCCL; this process has "
                             "neither")
        if backend == "gloo" and not torch.distributed.is_gloo_available():
            raise MXNetError("dist backend 'gloo' is not built into this "
                             "PyTorch")
        return backend
    if not torch.cuda.is_available():
        return "gloo"
    cards = torch.cuda.device_count()
    if cards >= int(num_processes):
        return "nccl"
    raise MXNetError(
        "%d ranks on this host share %d card(s) and NCCL puts one rank on "
        "a card: name the backend (MXNET_DIST_BACKEND=gloo, or "
        "initialize(backend='gloo'))" % (num_processes, cards))


def _split_address(address):
    host, _, port = str(address).rpartition(":")
    if not host or not port.isdigit():
        raise MXNetError("coordinator address %r is not host:port"
                         % (address,))
    return host, int(port)


def _connect(address, num_processes, process_id, timeout_s):
    """One attempt at the coordination store: rank 0 serves it at the
    address, the other ranks connect (waiting at most ``timeout_s``)."""
    host, port = _split_address(address)
    return torch.distributed.TCPStore(
        host, port, int(num_processes), int(process_id) == 0,
        timeout=datetime.timedelta(seconds=float(timeout_s)),
        wait_for_workers=False)


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, heartbeat_timeout=None,
               connect_retries=None, connect_backoff_s=None,
               barrier_timeout=None, backend=None):
    """Join (or stand up) the multi-process job and return the runtime.

    Arguments default from the environment (:func:`coordination_env`;
    ``MXNET_DIST_CONNECT_RETRIES``, ``MXNET_DIST_CONNECT_BACKOFF``,
    ``MXNET_DIST_BARRIER_TIMEOUT``, ``MXNET_DIST_BACKEND``). With one
    process and no backend named this starts no group and returns the
    world of one. Otherwise (a world of one included, when a backend or
    an address is named) it connects to the store with bounded
    exponential backoff (an attempt count and a schedule, then
    ``RuntimeError``), starts the process group on it with every
    collective bounded by the collective timeout, installs the runtime
    and holds the rendezvous barrier."""
    from .runtime import DistRuntime, _install_runtime, active_runtime
    resolved = coordination_env()
    if coordinator_address is None:
        coordinator_address = resolved["coordinator_address"]
    if num_processes is None:
        num_processes = resolved["num_processes"]
    if process_id is None:
        process_id = resolved["process_id"]
    if heartbeat_timeout is None:
        heartbeat_timeout = resolved["heartbeat_timeout"]
    if connect_retries is None:
        connect_retries = int(os.environ.get(
            "MXNET_DIST_CONNECT_RETRIES", "5"))
    if connect_backoff_s is None:
        connect_backoff_s = float(os.environ.get(
            "MXNET_DIST_CONNECT_BACKOFF", "0.5"))
    if barrier_timeout is None:
        barrier_timeout = float(os.environ.get(
            "MXNET_DIST_BARRIER_TIMEOUT", "300"))
    num_processes, process_id = int(num_processes), int(process_id)
    named = backend or os.environ.get("MXNET_DIST_BACKEND")
    current = active_runtime()
    if current is not None and current.grouped:
        return current
    if num_processes <= 1 and not named and coordinator_address is None:
        from .runtime import get_runtime
        return get_runtime()
    if coordinator_address is None:
        raise MXNetError("a %d-process job needs a coordinator address"
                         % num_processes)
    backend = resolve_backend(backend, num_processes)

    t0 = time.perf_counter()
    from .. import faults as _faults

    def attempt():
        if _faults.armed():
            # coordinator connect-flap seam: a transient fault here is a
            # worker racing a restarting coordinator
            _faults.check("dist.connect", address=str(coordinator_address))
        return _connect(coordinator_address, num_processes, process_id,
                        CONNECT_TIMEOUT_S)
    retry_on = (RuntimeError, ConnectionError, _faults.TransientFault)
    try:
        store = _faults.retry(
            attempt, retries=int(connect_retries),
            backoff_s=float(connect_backoff_s),
            max_backoff_s=float("inf"), jitter=0.0, retry_on=retry_on,
            site="dist.connect", sleep=lambda s: time.sleep(s),
            logger=logging.getLogger(__name__))
    except retry_on as exc:
        raise RuntimeError(
            "could not join coordinator %s after %d attempts"
            % (coordinator_address, int(connect_retries) + 1)) from exc

    if backend == "nccl":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    torch.distributed.init_process_group(
        backend, store=torch.distributed.PrefixStore("pg", store),
        rank=process_id, world_size=num_processes,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    runtime = _install_runtime(DistRuntime(
        rank=process_id, size=num_processes, backend=backend, store=store,
        device=device, heartbeat_timeout=heartbeat_timeout))
    # the rendezvous: no rank starts training on a half-formed world;
    # bounded, so a peer that died during its own bootstrap fails the job
    runtime.barrier(timeout=barrier_timeout)
    from .. import telemetry
    telemetry.registry().scope("dist").counter("bootstrap_ms").add(
        (time.perf_counter() - t0) * 1000.0)
    return runtime


def init_from_env():
    """Start the group iff the environment declares a multi-process job
    (``tools/launch.py``'s ``DMLC_*`` or the coordination names); a
    no-op otherwise."""
    resolved = coordination_env()
    if resolved["num_processes"] <= 1:
        return
    initialize(coordinator_address=resolved["coordinator_address"],
               num_processes=resolved["num_processes"],
               process_id=resolved["process_id"],
               heartbeat_timeout=resolved["heartbeat_timeout"])
