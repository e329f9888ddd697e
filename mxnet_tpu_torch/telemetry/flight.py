"""FlightRecorder — a bounded black box that survives the crash.

(The port's copy of ``mxnet_tpu/telemetry/flight.py``: a postmortem
written by either package loads in the other.) Without it a dying
training step leaves NO artifact of what it was doing — the postmortem
is whatever scrolled past on stderr. The
recorder keeps a bounded ring of context events and, on a fault,
composes a postmortem from everything the telemetry substrate already
retains — the last N :class:`StepTimeline` records, the span-trace
tail, the ``dist.*`` / ``compile.*`` metric scopes, and its own noted
events — and commits it ATOMICALLY (tmp + fsync + rename, the same
commit discipline as checkpoint entries): a crash mid-dump leaves only
a ``.tmp-*`` file, never a torn committed postmortem.

Dump triggers (all wired, none default-on):

* an unhandled exception escaping ``Module.fit`` (the fit loop dumps
  when the recorder is armed);
* ``SIGTERM`` and a process-level unhandled exception, via
  :meth:`install`;
* explicit :meth:`dump` calls.

Arm it with :meth:`arm` (a directory) or ``MXNET_TELEMETRY_BLACKBOX=<dir>``
at import. Unarmed, every trigger is a no-op — tests and raw loops see no
new files.
"""
from __future__ import annotations

import collections
import itertools
import os
import signal
import sys
import threading
import time

__all__ = ["FlightRecorder", "load_postmortem"]


def load_postmortem(path):
    """Load + verify one committed postmortem.

    The reading half of the atomic-commit contract: a truncated,
    bit-flipped, or non-postmortem file refuses LOUDLY here (with the
    failing path in the message) instead of feeding a torn JSON into
    an incident review. ``.tmp-*`` partials — what a crash mid-dump
    leaves — are refused by name, the same discipline as checkpoint
    entries."""
    import json

    from ..base import MXNetError
    name = os.path.basename(str(path))
    if name.startswith(".tmp-") or ".tmp-" in name:
        raise MXNetError(
            "refusing postmortem %s: a .tmp-* file is an uncommitted "
            "crash partial, never a postmortem" % path)
    try:
        with open(path, "rb") as f:
            payload = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError) as exc:
        raise MXNetError(
            "postmortem %s is unreadable (corrupt or truncated): %s"
            % (path, exc)) from exc
    if not isinstance(payload, dict) or \
            payload.get("format") != "flight-recorder-r1":
        raise MXNetError(
            "%s is not a flight-recorder postmortem (format %r)"
            % (path, payload.get("format")
               if isinstance(payload, dict) else type(payload).__name__))
    return payload


class FlightRecorder(object):
    """Bounded crash black box (module docstring)."""

    def __init__(self, capacity=512, directory=None):
        self._capacity = int(capacity)
        self._events = collections.deque(maxlen=self._capacity)
        self._state = {}
        self._lock = threading.Lock()
        self._dir = str(directory) if directory else None
        self._seq = itertools.count()
        self.last_dump_path = None
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._installed = False

    # -- arming ---------------------------------------------------------
    @property
    def armed(self):
        return self._dir is not None

    @property
    def directory(self):
        return self._dir

    def arm(self, directory):
        """Point the recorder at a postmortem directory (created on
        demand); dumps are committed there as
        ``postmortem-<pid>-<seq>.json``. Returns self."""
        self._dir = str(directory)
        return self

    def disarm(self):
        self._dir = None

    # -- recording ------------------------------------------------------
    def note(self, kind, **payload):
        """Append one context event to the ring (heartbeat deaths,
        elastic attempts, rank transitions...). Cheap: one deque
        append under a lock."""
        rec = {"ts": round(time.time(), 6), "kind": str(kind)}
        rec.update(payload)
        with self._lock:
            self._events.append(rec)
        return rec

    def set_state(self, **kv):
        """Merge identity/state keys (rank, world, attempt, dp_width)
        carried in every dump's header."""
        with self._lock:
            self._state.update(kv)

    def clear(self):
        """Drop the retained event ring and state (test/bench plumbing
        — a production black box keeps its history)."""
        with self._lock:
            self._events.clear()
            self._state.clear()

    # -- dumping --------------------------------------------------------
    def snapshot(self, reason):
        """The postmortem payload: header + state + noted events + the
        telemetry substrate's retained rings (step records, span tail,
        dist/compile/health/slo metric scopes — the watchdog's
        incident notes are in the event ring, so a postmortem carries
        the drift history that preceded the crash). Pure reads — safe
        from signal handlers and except blocks."""
        import mxnet_tpu_torch.telemetry as _tel
        with self._lock:
            events = list(self._events)
            state = dict(self._state)
        steps = _tel.timeline().records()[-self._capacity:]
        spans = _tel.trace_events()[-self._capacity:]
        reg = _tel.registry()
        return {
            "format": "flight-recorder-r1",
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "reason": str(reason),
            "state": state,
            "events": events,
            "steps": steps,
            "spans": spans,
            "metrics": {"dist": reg.snapshot(prefix="dist"),
                        "compile": reg.snapshot(prefix="compile"),
                        "health": reg.snapshot(prefix="health"),
                        "slo": reg.snapshot(prefix="slo")},
        }

    def dump(self, reason, path=None):
        """Commit one postmortem atomically and return its path (None
        when unarmed and no explicit ``path``). The commit is the
        checkpoint discipline: serialize to ``<path>.tmp-<pid>``,
        flush+fsync, then ``os.replace`` onto the final name — a crash
        at ANY point leaves either the old state or a committed file,
        plus possibly a ``.tmp-*`` to sweep, NEVER a torn postmortem."""
        if path is None:
            if self._dir is None:
                return None
            os.makedirs(self._dir, exist_ok=True)
            path = os.path.join(
                self._dir, "postmortem-%d-%03d.json"
                % (os.getpid(), next(self._seq)))
        from .export import atomic_json_dump
        path = atomic_json_dump(path, self.snapshot(reason),
                                indent=None, fsync=True)
        self.last_dump_path = path
        return path

    # -- process hooks --------------------------------------------------
    @property
    def installed(self):
        """Whether the process hooks are currently installed — callers
        that bracket work with install()/uninstall() (ElasticTrainer)
        check this first so they never tear down hooks someone else
        (e.g. the ``MXNET_TELEMETRY_BLACKBOX`` autostart) installed."""
        return self._installed

    def install(self, sigterm=True, excepthook=True):
        """Hook SIGTERM and/or ``sys.excepthook`` to dump before the
        process dies (previous handlers are chained, and restored by
        :meth:`uninstall`). SIGTERM installation is skipped quietly off
        the main thread (signal module restriction)."""
        if self._installed:
            return self
        if excepthook:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._on_excepthook
        if sigterm:
            try:
                self._prev_sigterm = signal.signal(
                    signal.SIGTERM, self._on_sigterm)
            except ValueError:  # not the main thread
                self._prev_sigterm = None
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None
        self._installed = False

    def _safe_dump(self, reason):
        try:
            return self.dump(reason)
        except Exception:  # noqa: BLE001 - dying anyway; don't mask it
            return None

    def _on_excepthook(self, etype, value, tb):
        self._safe_dump("unhandled: %s: %s" % (etype.__name__, value))
        prev = self._prev_excepthook or sys.__excepthook__
        prev(etype, value, tb)

    def _on_sigterm(self, signum, frame):
        self._safe_dump("SIGTERM")
        prev = self._prev_sigterm
        if prev is signal.SIG_IGN:
            # the process deliberately ignored SIGTERM before install —
            # keep ignoring it (we only add the dump, never a death)
            return
        if callable(prev):
            prev(signum, frame)
            return
        # default disposition: restore and re-deliver so the process
        # still dies by SIGTERM (exit status visible to the launcher)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signum)
