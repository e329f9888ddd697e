"""mxnet_tpu_torch.serving — online inference on the card: dynamic
batching over batch-size buckets, with backpressure and tenancy, and
continuous-batching decode of sequence models, and the persistent
executable cache that warm-starts a replica (the port of
``mxnet_tpu/serving``).

* :class:`Predictor` — binds a trained/loaded Module for inference, one
  module per padded batch-size bucket, all on one set of parameter
  tensors; ``warmup()`` runs every bucket once before traffic, and
  served rows equal, bit for bit, ``Module.predict`` at the bucket's
  batch.
* :class:`DynamicBatcher` — bounded request queue + background worker
  that coalesces concurrent requests into one bucket-padded launch
  within a ``max_wait_ms`` window; queue-full rejection, per-request
  timeouts, graceful shutdown. Hosts several named :class:`Tenant`
  models behind one queue, with SLO-driven admission: a tenant whose own
  burn windows breach is shed (:class:`TenantShed`) while co-hosted
  tenants keep serving.
* :class:`DecodeEngine` — continuous-batching decode of an
  autoregressive model (:class:`LSTMCharLM`, :class:`TransformerLM`):
  power-of-two prefill buckets, a slot-indexed state on the device, a
  scheduler that admits and retires sequences between fixed-shape steps,
  TTFT / per-token SLO trackers, and token streams bit for bit equal to
  the same request decoded alone.
* :class:`ServingStats` — one snapshot (``stats()``) of latency
  p50/p95/p99, batch-fill ratio, queue depth, the compile counter and
  the cache's hits and misses; with telemetry enabled, per-request phase
  traces too.
* :class:`ExecutableCache` (:mod:`.cache`) — the persistent executable
  cache: ``Predictor.warmup(cache_dir=)`` and ``DecodeEngine.warmup(
  cache_dir=)`` trace each program once with ``torch.export`` and a
  second replica loads it (``MXNET_COMPILE_CACHE_DIR`` sets both the
  executable store and, through :func:`enable_persistent_compile_cache`'s
  rule, where every ``nvcc`` build goes).

Fault seams (``faults``): ``serving.device`` (Predictor launch),
``serving.worker`` and ``serving.queue_flood`` (DynamicBatcher),
``serving.cache`` (a committed cache entry), ``serving.decode_worker``,
``serving.decode_step`` and ``serving.decode_abandon`` (DecodeEngine).

Quick start::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import Predictor, DynamicBatcher

    pred = Predictor(trained_module, max_batch_size=32)
    pred.warmup(cache_dir="/var/cache/mx")   # trace or load each bucket
    with DynamicBatcher(pred, max_queue=256, max_wait_ms=2) as srv:
        probs = srv.submit(x).result()   # from any number of threads
    print(pred.stats())
"""
from __future__ import annotations

from . import cache
from .batcher import DynamicBatcher
from .cache import (CacheMiss, ExecutableCache,
                    enable_persistent_compile_cache)
from .decode import (DecodeEngine, DecodeModel, DecodeRequest, LSTMCharLM,
                     TransformerLM)
from .errors import (QueueFull, RequestAbandoned, RequestTimeout,
                     ServerClosed, TenantShed, WorkerCrashed)
from .predictor import Predictor
from .stats import ServingStats
from .tenancy import Tenant

__all__ = ["Predictor", "DynamicBatcher", "ServingStats", "Tenant",
           "DecodeEngine", "DecodeModel", "DecodeRequest", "LSTMCharLM",
           "TransformerLM",
           "QueueFull", "RequestAbandoned", "RequestTimeout",
           "ServerClosed", "TenantShed", "WorkerCrashed", "cache",
           "CacheMiss", "ExecutableCache", "enable_persistent_compile_cache"]
