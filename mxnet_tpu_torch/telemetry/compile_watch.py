"""CompileWatch — every program's first run counted, attributed, and
(after a declared warmup boundary) warned about (the port's counterpart
of ``mxnet_tpu/telemetry/compile_watch.py``).

The JAX package counts XLA traces. The port runs eager PyTorch, so its
"compile" is a program's first run for a (kind, shape signature), as
``serving.Predictor`` counts it: the run where cuDNN picks its algorithms
for the shapes and the caching allocator grows, a step far slower than
the steady state. The fused executor group (``MeshExecutorGroup``) keeps
the set of (kind, signature) pairs it has run and reports each new one
to the watch it is attached to.

Usage::

    watch = telemetry.compile_watch()      # process-wide instance
    watch.attach(mod)                      # after bind; idempotent
    ... warmup traffic / first epoch ...
    watch.mark_warmup_done()
    ... steady state: every new program now increments
        ``compile.post_warmup_retraces`` and logs a warning naming the
        call site and input shapes ...

``serving.Predictor.warmup`` and ``DecodeEngine.warmup`` run inside
:meth:`CompileWatch.warmup_scope`: a bucket's first run, or its
``torch.export`` trace under the persistent executable cache, counts into
``compile.warmup_compiles`` (never ``compile.retraces``), and the cache's
loads and fresh traces into ``compile.cache_hits``/``cache_misses``.

``Module.fit`` does all of this automatically when telemetry is
enabled: attach at fit start, warmup boundary after the first epoch
(every steady shape — the eval pass included — has run by then),
boundary reset when fit returns.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
import traceback

__all__ = ["CompileWatch"]


_STDLIB = os.path.dirname(contextlib.__file__).replace("\\", "/") + "/"


def _call_site():
    """First stack frame outside this package, torch and the standard
    library — the user-code line whose call ran the new program."""
    for frame in reversed(traceback.extract_stack(limit=40)):
        fn = frame.filename.replace("\\", "/")
        if "/mxnet_tpu_torch/" in fn or "/torch/" in fn or \
                (fn.startswith(_STDLIB) and "-packages/" not in fn):
            continue
        return "%s:%d" % (fn, frame.lineno)
    return "<unknown>"


class CompileWatch(object):
    """Retrace monitor over fused executor groups (module docstring)."""

    def __init__(self, scope=None, logger=None, max_events=256):
        if scope is None:
            import mxnet_tpu_torch.telemetry as _tel
            scope = _tel.registry().scope("compile")
        self._c_retraces = scope.counter("retraces")
        self._c_post_warmup = scope.counter("post_warmup_retraces")
        # declared warmups count into their own stream (not the
        # training stream a dashboard alerts on)
        self._c_warmup = scope.counter("warmup_compiles")
        # serving warm starts (serving.cache): programs loaded from the
        # persistent executable cache (hits) or traced afresh (misses)
        self._c_cache_hits = scope.counter("cache_hits")
        self._c_cache_misses = scope.counter("cache_misses")
        self.logger = logger or logging.getLogger(
            "mxnet_tpu_torch.telemetry")
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=int(max_events))
        self._steady = False
        self._warned_sites = set()
        self._tls = threading.local()   # .suppress, .warmup

    # -- attachment -----------------------------------------------------
    def attach(self, module_or_group):
        """Report the fused executor group's new programs here
        (idempotent; re-attaching after a rebind attaches the new group).
        Returns True when attached; False for classic per-executor
        groups, whose programs are not observable here."""
        grp = getattr(module_or_group, "_exec_group", module_or_group)
        if grp is None or not getattr(grp, "fused", False):
            return False
        grp._compile_watch = self
        return True

    def note_program(self, kind, shapes):
        """One new (kind, shapes) program of an attached group: counted
        with the user-code call site that ran it."""
        if getattr(self._tls, "suppress", False):
            return
        self._record("%s @ %s" % (kind, _call_site()), dict(shapes))

    def _record(self, site, shapes):
        if getattr(self._tls, "warmup", False):
            # a declared warmup compile: its OWN stream — folding it
            # into compile.retraces would make the training counter
            # unreadable the moment a serving replica warms in-process,
            # and it must never fire the post-warmup warning
            self._c_warmup.add()
            with self._lock:
                self._events.append({
                    "time": time.time(), "site": site, "shapes": shapes,
                    "post_warmup": False, "warmup": True})
            return
        self._c_retraces.add()
        with self._lock:
            steady = self._steady
            if steady:
                self._c_post_warmup.add()
            self._events.append({
                "time": time.time(), "site": site, "shapes": shapes,
                "post_warmup": steady})
            warn = steady and (site, tuple(sorted(shapes.items()))) \
                not in self._warned_sites
            if warn:
                self._warned_sites.add(
                    (site, tuple(sorted(shapes.items()))))
        if warn:
            self.logger.warning(
                "new program AFTER the warmup boundary at %s with input "
                "shapes %s — a steady-state loop should run no new "
                "program; check for shape drift or a missing warmup "
                "bucket", site, shapes)

    @contextlib.contextmanager
    def suppressed(self):
        """Suppress counting on this thread for the duration: a
        diagnostic run (a probe outside the step path) must never count
        as, or warn about, a steady-state program."""
        prev = getattr(self._tls, "suppress", False)
        self._tls.suppress = True
        try:
            yield self
        finally:
            self._tls.suppress = prev

    @contextlib.contextmanager
    def warmup_scope(self):
        """Attribute traces on this thread to a declared warmup for the
        duration: they count into ``compile.warmup_compiles`` instead
        of ``compile.retraces`` and never warn (a serving bucket
        ladder's warmup, run in the training process)."""
        prev = getattr(self._tls, "warmup", False)
        self._tls.warmup = True
        try:
            yield self
        finally:
            self._tls.warmup = prev

    def note_cache_hit(self):
        """A serving program loaded from the persistent executable cache
        (``compile.cache_hits``): no trace, no compile."""
        self._c_cache_hits.add()

    def note_cache_miss(self):
        """A serving program traced afresh at warmup because its cache
        entry was absent, drifted or corrupt (``compile.cache_misses``)."""
        self._c_cache_misses.add()

    # -- warmup boundary ------------------------------------------------
    def mark_warmup_done(self):
        """Declare the warmup boundary: retraces from here on count as
        ``post_warmup_retraces`` and warn with their call site."""
        with self._lock:
            self._steady = True

    def reset_warmup(self):
        """Leave steady state (a new fit's first epoch legitimately
        compiles new programs)."""
        with self._lock:
            self._steady = False

    # -- reading --------------------------------------------------------
    @property
    def count(self):
        return self._c_retraces.value

    @property
    def post_warmup_count(self):
        return self._c_post_warmup.value

    @property
    def warmup_compiles(self):
        return self._c_warmup.value

    @property
    def cache_hits(self):
        return self._c_cache_hits.value

    @property
    def cache_misses(self):
        return self._c_cache_misses.value

    def events(self):
        """The newest new-program events: ``{"time", "site", "shapes",
        "post_warmup"}`` dicts, oldest first."""
        with self._lock:
            return list(self._events)
