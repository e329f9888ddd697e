"""mxnet_tpu_torch.telemetry — unified metrics, tracing and step-timeline
observability (the port's counterpart of ``mxnet_tpu/telemetry``).

Every subsystem records into ONE process-wide :class:`MetricsRegistry`,
exportable as an append-only JSONL event log and a Prometheus
``/metrics`` endpoint; host spans land in a bounded Chrome-trace ring;
an :class:`SLOTracker` evaluates declared serving objectives over
multi-window rolling burn rates (``slo.*`` gauges, fed by
``DynamicBatcher(slo=...)``). For training, the :class:`StepTimeline`
answers "why was step 412 slow" after the fact, the
:class:`CompileWatch` attributes every program's first run to a call
site and warns when one lands after the warmup boundary, the
:class:`ProgramInventory` holds each program's counted FLOPs and bytes
(the live roofline's basis), the :class:`RegressionWatchdog` compares
live step windows against a baseline and emits warn-once ``health.*``
incidents, and the :class:`FlightRecorder` commits a postmortem when
``fit`` dies.

Quick start::

    from mxnet_tpu_torch import telemetry

    telemetry.enable(jsonl="run.jsonl", port=9100)  # both optional
    mod.fit(...)                                    # emits step records
    print(telemetry.timeline().slowest(3))          # worst steps
    print(telemetry.registry().snapshot())          # every counter
    telemetry.disable()

The contracts: a telemetry-on ``fit`` trains to the same parameters bit
for bit (host clocks only: no readback, no RNG); disabled mode costs one
branch per call site (``telemetry.enabled()`` / a shared no-op span);
the steady-state train loop runs no new program after the warmup
boundary (``compile.post_warmup_retraces`` stays 0).

Env: ``MXNET_TELEMETRY=1`` enables at import (the programmatic
``enable()`` twin); ``MXNET_TELEMETRY_JSONL`` / ``MXNET_TELEMETRY_PORT``
set the sink path / metrics port for that autostart;
``MXNET_TELEMETRY_BLACKBOX=<dir>`` arms the flight recorder there.
"""
from __future__ import annotations

import os
import threading

from .compile_watch import CompileWatch
from .export import (JsonlSink, MetricsServer, atomic_json_dump,
                     render_prometheus)
from .flight import FlightRecorder, load_postmortem
from .health import RegressionWatchdog
from .introspect import (ProgramCounter, ProgramInventory, analyze_compiled,
                         device_peaks, roofline, BOUND_BY_CODES)
from .registry import (Counter, Gauge, Histogram, MetricsRegistry, Scope,
                       instrument_value, DEFAULT_MS_BUCKETS)
from .slo import SLOTracker
from .timeline import StepTimeline
from .tracing import (NOOP_SPAN, Span, clear_trace, record_events, span,
                      trace_events)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Scope",
    "instrument_value", "Span", "span", "JsonlSink", "MetricsServer",
    "render_prometheus", "atomic_json_dump", "SLOTracker", "StepTimeline",
    "CompileWatch", "ProgramCounter", "ProgramInventory", "FlightRecorder",
    "load_postmortem", "RegressionWatchdog", "analyze_compiled",
    "device_peaks", "roofline", "BOUND_BY_CODES", "registry", "timeline",
    "compile_watch", "inventory", "dump_programs", "flight_recorder",
    "health_watchdog", "health_report", "enable", "disable", "enabled",
    "log_event", "flush_metrics", "jsonl_sink", "metrics_server",
    "serve_metrics",
    "trace_events", "clear_trace", "record_events", "NOOP_SPAN",
    "DEFAULT_MS_BUCKETS", "set_active_pipeline", "active_pipeline",
]

_REGISTRY = MetricsRegistry()
_TIMELINE = StepTimeline()
_WATCH = None
_INVENTORY = None
_FLIGHT = None
_WATCHDOG = None
_lock = threading.Lock()
_state = {"enabled": False, "sink": None, "server": None,
          "active_pipeline": None}


def registry():
    """The process-wide :class:`MetricsRegistry` every subsystem
    records into."""
    return _REGISTRY


def timeline():
    """The process-wide :class:`StepTimeline` the ``fit`` loop writes."""
    return _TIMELINE


def compile_watch():
    """The process-wide :class:`CompileWatch` (created on first use)."""
    global _WATCH
    with _lock:
        if _WATCH is None:
            _WATCH = CompileWatch()
        return _WATCH


def inventory():
    """The process-wide :class:`ProgramInventory` every analysed program
    registers into (created on first use)."""
    global _INVENTORY
    with _lock:
        if _INVENTORY is None:
            _INVENTORY = ProgramInventory(registry=_REGISTRY)
        return _INVENTORY


def dump_programs(path=None):
    """The program inventory as JSON (see
    :meth:`ProgramInventory.dump_programs`)."""
    return inventory().dump_programs(path)


def flight_recorder():
    """The process-wide :class:`FlightRecorder` (created on first use;
    unarmed — and therefore silent — until :meth:`FlightRecorder.arm` or
    ``MXNET_TELEMETRY_BLACKBOX`` points it at a directory)."""
    global _FLIGHT
    with _lock:
        if _FLIGHT is None:
            _FLIGHT = FlightRecorder()
        return _FLIGHT


def health_watchdog():
    """The process-wide :class:`RegressionWatchdog` (created on first
    use; unarmed — and therefore silent — until ``Module.fit`` arms it
    at the warmup boundary or :meth:`RegressionWatchdog.arm` is called)."""
    global _WATCHDOG
    with _lock:
        if _WATCHDOG is None:
            _WATCHDOG = RegressionWatchdog(registry=_REGISTRY,
                                           timeline=_TIMELINE)
        return _WATCHDOG


def health_report():
    """The watchdog's state as JSON (armed/baseline/incidents/healthy) —
    also served as ``GET /health`` by the MetricsServer."""
    return health_watchdog().report()


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


def jsonl_sink():
    """The live :class:`JsonlSink`, or None."""
    return _state["sink"]


def metrics_server():
    """The live :class:`MetricsServer`, or None."""
    return _state["server"]


def serve_metrics(port=0):
    """Start (or return the already-running) Prometheus endpoint
    (``port=0`` picks a free port). Recording stays as it was."""
    with _lock:
        if _state["server"] is None:
            _state["server"] = MetricsServer(_REGISTRY, port=port)
        return _state["server"]


def log_event(kind, payload):
    """Append one event line to the JSONL sink (no-op without one)."""
    sink = _state["sink"]
    if sink is not None:
        sink.write(kind, payload)


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
    blackbox = os.environ.get("MXNET_TELEMETRY_BLACKBOX")
    if blackbox:
        # the crash black box: fit faults, SIGTERM and unhandled
        # exceptions leave an atomic postmortem in this directory
        flight_recorder().arm(blackbox).install()
    if os.environ.get("MXNET_TELEMETRY", "0") != "1":
        return
    jsonl = os.environ.get("MXNET_TELEMETRY_JSONL") or None
    port = os.environ.get("MXNET_TELEMETRY_PORT")
    enable(jsonl=jsonl, port=int(port) if port else None)


_autostart()
