"""Telemetry exporters: JSONL event log, Prometheus text, HTTP endpoint
(the port's copy of ``mxnet_tpu/telemetry/export.py``).

Two export paths, both fed from the ONE :class:`MetricsRegistry`:

* :class:`JsonlSink` — an append-only event log: every ``write`` is one
  wall-clock-stamped JSON line (``{"ts": unix_seconds, "kind": ...,
  ...}``); ``telemetry.flush_metrics`` appends full registry snapshots,
  so a run's telemetry survives the process.
* :func:`render_prometheus` — the registry as Prometheus text
  exposition (counters/gauges/histograms with cumulative ``le``
  buckets), served live by :class:`MetricsServer` — a stdlib
  ``http.server`` daemon thread with ``GET /metrics`` — so a scraper
  can sit next to a :class:`~mxnet_tpu_torch.serving.DynamicBatcher`
  without any new dependency.

The port runs one process, so no line or sample carries the
``rank``/``process_count`` labels a multi-process JAX job adds.
"""
from __future__ import annotations

import json
import re
import threading
import time

__all__ = ["JsonlSink", "render_prometheus", "MetricsServer"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


class JsonlSink(object):
    """Append-only JSONL event log (one line per event, flushed
    immediately so a crash loses at most the in-progress line)."""

    def __init__(self, path):
        self.path = str(path)
        self._lock = threading.Lock()
        self._f = open(self.path, "a")

    def write(self, kind, payload):
        """Append ``{"ts": now, "kind": kind, **payload}`` as one line."""
        rec = {"ts": round(time.time(), 6), "kind": str(kind)}
        rec.update(payload)
        line = json.dumps(rec, sort_keys=True, default=str)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            f.close()


def _prom_name(name, prefix="mxtpu"):
    return _NAME_RE.sub("_", "%s_%s" % (prefix, name))


def render_prometheus(registry, prefix="mxtpu"):
    """The registry as Prometheus text exposition format (0.0.4).
    Dotted metric names sanitize to underscores (``serving.0.requests``
    -> ``mxtpu_serving_0_requests``); histograms render the standard
    cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` triple. The
    text is the JAX package's for the same recorded values."""
    lines = []
    snap = registry.snapshot()
    for name, value in snap["counters"].items():
        n = _prom_name(name, prefix)
        lines.append("# TYPE %s counter" % n)
        lines.append("%s %s" % (n, repr(float(value))))
    for name, value in snap["gauges"].items():
        n = _prom_name(name, prefix)
        lines.append("# TYPE %s gauge" % n)
        lines.append("%s %s" % (n, repr(float(value))))
    for name, h in snap["histograms"].items():
        n = _prom_name(name, prefix)
        lines.append("# TYPE %s histogram" % n)
        cum = 0
        for bound, cnt in zip(h["buckets"], h["counts"]):
            cum += cnt
            lines.append('%s_bucket{le="%s"} %d' % (n, repr(bound), cum))
        cum += h["counts"][-1]
        lines.append('%s_bucket{le="+Inf"} %d' % (n, cum))
        lines.append("%s_sum %s" % (n, repr(float(h["sum"]))))
        lines.append("%s_count %d" % (n, h["count"]))
    return "\n".join(lines) + "\n"


class MetricsServer(object):
    """``GET /metrics`` over stdlib ``http.server`` on a daemon thread.

    Zero dependencies, bounded surface: ``/metrics`` renders the
    registry as Prometheus text and ``/healthz`` answers ``ok`` (a
    load-balancer liveness probe for a serving deployment). ``port=0``
    picks a free port (``.port`` reports the bound one). It binds
    ``127.0.0.1`` unless told otherwise.
    """

    def __init__(self, registry, port=0, host="127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                route = self.path.split("?")[0]
                if route == "/metrics":
                    body = render_prometheus(reg).encode()
                    ctype = "text/plain; version=0.0.4"
                elif route == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mxtpu-telemetry-metrics", daemon=True)
        self._thread.start()

    @property
    def url(self):
        return "http://%s:%d/metrics" % (self.host, self.port)

    def close(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            self._thread.join(5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
