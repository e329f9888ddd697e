"""MetricsRegistry — process-wide named counters, gauges, and
fixed-bucket histograms (the port's copy of
``mxnet_tpu/telemetry/registry.py``; host code only).

Every stats surface of the port (``ServingStats`` today) records into
ONE registry, so "what is this process doing" is a single snapshot (and
a single Prometheus page / JSONL stream), not a hunt through per-object
stats. Instruments are get-or-create by dotted name::

    reg = telemetry.registry()
    reg.counter("serving.0.requests").add()
    reg.gauge("serving.0.queue_depth").set_fn(lambda: len(queue))
    reg.histogram("serving.0.latency_ms").observe(4.2)

Hot-path cost is one dict lookup (get-or-create — callers that care
cache the instrument object) plus one small-lock add; snapshots are
nested dicts, renderable as Prometheus text (``export.render_prometheus``)
or appended to a JSONL event log (``export.JsonlSink``).

Thread-safety: the registry dict is guarded by one lock; each
instrument carries its own lock, so concurrent writers on different
instruments never contend and a snapshot reads each value coherently.
"""
from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Scope",
           "instrument_value", "DEFAULT_MS_BUCKETS"]

# latency-ish default bucket ladder (upper bounds, ms); +Inf is implicit
DEFAULT_MS_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                      500.0, 1000.0, 2000.0, 5000.0)


class Counter(object):
    """Monotonic (within a process) numeric counter. ``add`` accepts
    ints or floats (cumulative clocks like ``host_wait_ms`` are float
    counters)."""

    kind = "counter"
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def add(self, n=1):
        with self._lock:
            self._value += n

    inc = add

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        """Zero the counter (stats-view ``reset()`` semantics; a
        Prometheus scraper sees this as a counter restart)."""
        with self._lock:
            self._value = 0


class Gauge(object):
    """Point-in-time value: ``set`` a number, or ``set_fn`` a live
    ``() -> number`` probe (queue depths, ring occupancy)."""

    kind = "gauge"
    __slots__ = ("name", "_lock", "_value", "_fn")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0
        self._fn = None

    def set(self, v):
        with self._lock:
            self._value = v
            self._fn = None

    def set_fn(self, fn):
        with self._lock:
            self._fn = fn

    @property
    def value(self):
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return fn()
        except Exception:  # a dead probe must not poison snapshots
            return 0

    def reset(self):
        self.set(0)


class Histogram(object):
    """Fixed-bucket histogram: ``observe(v)`` lands ``v`` in the first
    bucket whose upper bound is ``>= v`` (one implicit +Inf bucket at
    the end), tracking ``sum`` and ``count`` alongside — exactly the
    Prometheus histogram model, so export is a straight rendering."""

    kind = "histogram"
    __slots__ = ("name", "buckets", "_lock", "_counts", "_sum", "_count")

    def __init__(self, name, buckets=DEFAULT_MS_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram %r needs at least one bucket"
                             % name)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        v = float(v)
        import bisect
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def value(self):
        with self._lock:
            return {"buckets": list(self.buckets),
                    "counts": list(self._counts),
                    "sum": self._sum, "count": self._count}

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0


class instrument_value(object):
    """Class-attribute descriptor: ``requests =
    instrument_value("_c_requests")`` reads ``self._c_requests.value``
    — the ONE definition of the counter/gauge-view read that a
    registry-backed stats class (``ServingStats``) would otherwise
    hand-write per field."""

    __slots__ = ("attr",)

    def __init__(self, attr):
        self.attr = attr

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return getattr(obj, self.attr).value


class Scope(object):
    """A name-prefix view of a registry: ``scope.counter("requests")``
    is ``registry.counter(prefix + ".requests")``. Stats objects hold a
    scope so every instance gets its own namespace in the ONE registry."""

    __slots__ = ("_registry", "prefix")

    def __init__(self, registry, prefix):
        self._registry = registry
        self.prefix = prefix

    def _name(self, name):
        return "%s.%s" % (self.prefix, name) if self.prefix else name

    def counter(self, name):
        return self._registry.counter(self._name(name))

    def gauge(self, name):
        return self._registry.gauge(self._name(name))

    def histogram(self, name, buckets=DEFAULT_MS_BUCKETS):
        return self._registry.histogram(self._name(name), buckets=buckets)

    def snapshot(self):
        """Snapshot of this scope's instruments only, prefix stripped."""
        return self._registry.snapshot(prefix=self.prefix)

    def release(self):
        """Drop this scope's instruments from the registry (see
        :meth:`MetricsRegistry.drop_scope`)."""
        self._registry.drop_scope(self.prefix)


class MetricsRegistry(object):
    """Process-wide instrument table (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}       # name -> instrument
        self._scope_ids = {}     # family -> next instance index

    # -- get-or-create --------------------------------------------------
    def _get(self, name, factory, kind):
        name = str(name)
        with self._lock:
            inst = self._metrics.get(name)
            if inst is None:
                inst = self._metrics[name] = factory(name)
            elif inst.kind != kind:
                raise TypeError(
                    "metric %r is a %s, requested as %s"
                    % (name, inst.kind, kind))
            return inst

    def counter(self, name):
        return self._get(name, Counter, "counter")

    def gauge(self, name):
        return self._get(name, Gauge, "gauge")

    def histogram(self, name, buckets=DEFAULT_MS_BUCKETS):
        return self._get(name, lambda n: Histogram(n, buckets=buckets),
                         "histogram")

    def scope(self, prefix):
        """A :class:`Scope` view under ``prefix``."""
        return Scope(self, str(prefix))

    def unique_scope(self, family):
        """A fresh per-instance namespace ``<family>.<i>`` — every
        ``ServingStats`` instance claims one, so two Predictors in one
        process never share counters."""
        with self._lock:
            i = self._scope_ids.get(family, 0)
            self._scope_ids[family] = i + 1
        return Scope(self, "%s.%d" % (family, i))

    def drop_scope(self, prefix):
        """Remove every instrument under ``prefix.`` from the registry.
        The instrument OBJECTS keep working for whoever holds them —
        they just stop appearing in snapshots/exports. The lifecycle
        hook for per-instance scopes: a process that builds a
        Predictor per model generation (each claiming a ``serving.<i>``
        scope) would otherwise grow the registry — and every
        ``/metrics`` scrape — without bound."""
        strip = str(prefix) + "."
        with self._lock:
            for name in [n for n in self._metrics
                         if n.startswith(strip)]:
                del self._metrics[name]

    # -- reading --------------------------------------------------------
    def instruments(self):
        with self._lock:
            return dict(self._metrics)

    def snapshot(self, prefix=None):
        """Nested dict of every instrument's current value::

            {"counters": {name: number},
             "gauges": {name: number},
             "histograms": {name: {"buckets": [...], "counts": [...],
                                   "sum": s, "count": n}}}

        ``prefix=`` restricts to one scope and strips the prefix from
        the reported names.
        """
        strip = prefix + "." if prefix else None
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in sorted(self.instruments().items()):
            if strip is not None:
                if not name.startswith(strip):
                    continue
                name = name[len(strip):]
            out[inst.kind + "s"][name] = inst.value
        return out

    def tree(self, prefix=None):
        """The snapshot with dotted names exploded into nested dicts
        (``serving.0.requests`` -> ``{"serving": {"0": {"requests":
        ...}}}``) — the "nested dict" view for humans and tests."""
        snap = self.snapshot(prefix=prefix)
        root = {}
        for kind in ("counters", "gauges", "histograms"):
            for name, value in snap[kind].items():
                node = root
                parts = name.split(".")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = value
        return root

    def reset(self):
        """Zero every instrument (keeps registrations — live gauge
        probes stay installed). Test/bench plumbing."""
        for inst in self.instruments().values():
            if inst.kind != "gauge" or inst._fn is None:
                inst.reset()
