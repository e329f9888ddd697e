"""Serving-path error types (the port's copy of
``mxnet_tpu/serving/errors.py``).

Overload must degrade, not OOM: each failure mode a caller can react
to gets its own exception class so client code can distinguish "back
off and retry" (:class:`QueueFull`) from "this request died"
(:class:`RequestTimeout`) from "stop sending" (:class:`ServerClosed`).
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["QueueFull", "RequestAbandoned", "RequestTimeout",
           "ServerClosed", "TenantShed", "WorkerCrashed"]


class QueueFull(MXNetError):
    """Backpressure: the batcher's bounded request queue is at capacity.

    Raised synchronously by :meth:`DynamicBatcher.submit` — the request
    was never enqueued. Callers should shed load or retry with backoff;
    an unbounded queue here would turn overload into latency collapse
    and eventually host OOM."""


class TenantShed(QueueFull):
    """SLO-driven admission shed this tenant's request: the tenant's
    own declared objectives are in multi-window burn-rate breach
    (``SLOTracker.breached()``) and the tenant is not protected.

    A subclass of :class:`QueueFull` so generic backoff handlers treat
    it as shed load; raised synchronously at ``submit`` (the request is
    never enqueued) and set on already-queued futures the worker drops
    while the breach is active. Only the breached tenant is shed —
    co-hosted tenants keep serving."""


class RequestTimeout(MXNetError, TimeoutError):
    """The request's deadline passed before it reached the device.

    Set as the future's exception by the batcher worker when a queued
    request expires (``timeout_ms``). Also a ``TimeoutError`` so generic
    timeout handling catches it."""


class ServerClosed(MXNetError):
    """The batcher has been shut down and accepts no new requests."""


class RequestAbandoned(MXNetError):
    """A streaming decode request ended before its token budget (the
    client cancelled, or the engine shut down without drain while the
    sequence was active). The future resolves with this error; it never
    hangs. Raised by the decode engine, which comes with the next slice
    of the port; defined here so the error family is complete."""


class WorkerCrashed(MXNetError):
    """An unexpected exception escaped the batcher worker while this
    request was in flight.

    The implicated requests fail with THIS error (carrying the original
    exception as ``__cause__``), the tenant's
    ``serving.<i>.worker_restarts`` counter increments, and the worker
    restarts to serve the rest of the queue, so no future hangs.
    Retrying the request is safe — it never (completely) launched."""
