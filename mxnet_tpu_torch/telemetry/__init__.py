"""mxnet_tpu_torch.telemetry — the metrics registry, host spans, SLO
burn-rate tracking and the exporters the serving stack records into
(the part of ``mxnet_tpu/telemetry`` the port carries so far).

Every serving counter records into ONE process-wide
:class:`MetricsRegistry`, exportable as an append-only JSONL event log
and a Prometheus ``/metrics`` endpoint; host spans land in a bounded
Chrome-trace ring; an :class:`SLOTracker` evaluates declared serving
objectives over multi-window rolling burn rates (``slo.*`` gauges, fed
by ``DynamicBatcher(slo=...)``).

Quick start::

    from mxnet_tpu_torch import telemetry

    telemetry.enable(jsonl="run.jsonl", port=9100)  # both optional
    ...                                             # serve traffic
    print(telemetry.registry().snapshot())          # every counter
    telemetry.disable()

Disabled mode costs one branch per call site (``telemetry.enabled()``
/ a shared no-op span). Spans and traces read host clocks only: they
never synchronise with the device.

Env: ``MXNET_TELEMETRY=1`` enables at import (the programmatic
``enable()`` twin); ``MXNET_TELEMETRY_JSONL`` / ``MXNET_TELEMETRY_PORT``
set the sink path / metrics port for that autostart.
"""
from __future__ import annotations

import os
import threading

from .export import JsonlSink, MetricsServer, render_prometheus
from .registry import (Counter, Gauge, Histogram, MetricsRegistry, Scope,
                       instrument_value, DEFAULT_MS_BUCKETS)
from .slo import SLOTracker
from .tracing import (NOOP_SPAN, Span, clear_trace, record_events, span,
                      trace_events)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Scope",
    "instrument_value", "Span", "span", "JsonlSink", "MetricsServer",
    "render_prometheus", "SLOTracker", "registry", "enable", "disable",
    "enabled", "flush_metrics", "trace_events",
    "clear_trace", "record_events", "NOOP_SPAN", "DEFAULT_MS_BUCKETS",
    "set_active_pipeline", "active_pipeline",
]

_REGISTRY = MetricsRegistry()
_lock = threading.Lock()
_state = {"enabled": False, "sink": None, "server": None,
          "active_pipeline": None}


def registry():
    """The process-wide :class:`MetricsRegistry` every subsystem
    records into."""
    return _REGISTRY


def enabled():
    """Whether telemetry recording (spans, request traces, JSONL) is on
    — THE one branch disabled mode costs."""
    return _state["enabled"]


def enable(jsonl=None, port=None):
    """Turn telemetry recording on. ``jsonl=`` opens an append-only
    event-log sink; ``port=`` serves the Prometheus endpoint (0 picks a
    free port). Idempotent; reconfigures sink/server when given.
    Returns the metrics server, or None."""
    with _lock:
        _state["enabled"] = True
        if jsonl is not None:
            old = _state["sink"]
            if old is not None and old.path != str(jsonl):
                old.close()
                old = None
            if old is None:
                _state["sink"] = JsonlSink(jsonl)
        if port is not None and _state["server"] is None:
            _state["server"] = MetricsServer(_REGISTRY, port=port)
    return _state["server"]


def disable():
    """Turn recording off and release the sink/endpoint. Instruments
    stay readable."""
    with _lock:
        _state["enabled"] = False
        sink, _state["sink"] = _state["sink"], None
        server, _state["server"] = _state["server"], None
    if sink is not None:
        sink.close()
    if server is not None:
        server.close()


def flush_metrics(reason=""):
    """Append a full registry snapshot to the JSONL sink as one
    ``{"kind": "metrics"}`` line (no-op without a sink)."""
    sink = _state["sink"]
    if sink is not None:
        payload = {"metrics": _REGISTRY.snapshot()}
        if reason:
            payload["reason"] = str(reason)
        sink.write("metrics", payload)


def set_active_pipeline(stats):
    """Publish the ``PipelineStats`` of the device-feed loader the current
    ``fit`` trains through (None clears it): ``Speedometer`` and the fit
    epoch log read host-wait from here."""
    _state["active_pipeline"] = stats


def active_pipeline():
    """The published ``PipelineStats``, or None when fit is host-fed."""
    return _state["active_pipeline"]


def _autostart():
    if os.environ.get("MXNET_TELEMETRY", "0") != "1":
        return
    jsonl = os.environ.get("MXNET_TELEMETRY_JSONL") or None
    port = os.environ.get("MXNET_TELEMETRY_PORT")
    enable(jsonl=jsonl, port=int(port) if port else None)


_autostart()
