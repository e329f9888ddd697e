"""Span tracing — nestable host-side spans in Chrome-trace form (the
port's copy of ``mxnet_tpu/telemetry/tracing.py``).

``with telemetry.span("stage"):`` records ONE complete event
(``"ph": "X"`` with a ``dur``) into a bounded ring buffer, keyed by the
real thread id — Perfetto/chrome://tracing then renders nesting from
the containment of (ts, dur) intervals per thread, which is why
complete events (not B/E pairs) are the only correct encoding when
spans from different threads interleave. ``trace_events()`` returns the
ring as a list of event dicts, ready for a ``{"traceEvents": [...]}``
file. Spans read host clocks only: they neither synchronise with nor
time the device.

Disabled telemetry costs one branch: ``span()`` returns a shared no-op
context manager.
"""
from __future__ import annotations

import collections
import threading
import time

__all__ = ["Span", "span", "trace_events", "clear_trace",
           "record_events"]

_RING_CAPACITY = 16384
_ring = collections.deque(maxlen=_RING_CAPACITY)
_lock = threading.Lock()


class Span(object):
    """Context manager timing one named region into the trace ring.

    ``attrs`` (small JSON-able values) ride in the event's ``args`` —
    visible in the Perfetto detail pane."""

    __slots__ = ("name", "attrs", "_ts_us", "_t0")

    def __init__(self, name, **attrs):
        self.name = str(name)
        self.attrs = attrs or None

    def __enter__(self):
        self._ts_us = time.time() * 1e6
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur_us = (time.perf_counter() - self._t0) * 1e6
        ev = {"name": self.name, "cat": "telemetry", "ph": "X",
              "ts": self._ts_us, "dur": dur_us, "pid": 0,
              "tid": threading.get_ident()}
        if self.attrs:
            ev["args"] = self.attrs
        with _lock:
            _ring.append(ev)
        return False


class _NoopSpan(object):
    """Shared disabled-mode span: enter/exit carry no state, so ONE
    instance serves every call site concurrently."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


def span(name, **attrs):
    """A :class:`Span` when telemetry is enabled, else the shared
    no-op (one branch — the disabled-mode cost contract)."""
    from . import enabled
    if not enabled():
        return NOOP_SPAN
    return Span(name, **attrs)


def record_events(events):
    """Append pre-built Chrome-trace complete events to the span ring —
    how the serving request traces merge their phase events
    (queue-wait / coalesce / pad / device / resolve) into the ONE
    timeline beside the host spans. Each event must be a ``ph:"X"``
    dict with ``ts``/``dur`` in microseconds."""
    with _lock:
        _ring.extend(events)


def trace_events():
    """Snapshot of the span ring as Chrome-trace event dicts."""
    with _lock:
        return list(_ring)


def clear_trace():
    with _lock:
        _ring.clear()
