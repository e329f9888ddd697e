"""Engine — the host-side dependency engine (the port's counterpart of
``mxnet_tpu/engine.py``).

The reference's engine (src/engine/, ThreadedEnginePerDevice) orders ops
by the variables they read and write and runs them on worker pools. In
the port, as in the JAX package, the *device* order is the runtime's: a
CUDA stream runs what PyTorch enqueues in order. What is left for the
engine is HOST work — input stages, staging fills, checkpoint writes,
callbacks — overlapped with the device, hazard-ordered among themselves.

The engine is the native C++ one (``runtime/engine_core.cpp``, bound in
``runtime/core.py``), as in the JAX package, wherever ``g++`` can build
it; ``MXNET_CPU_WORKER_NTHREADS`` sizes its pool (default
min(8, cores)). Where no library builds (``runtime.core.get_lib()`` is
None), the same contract runs in Python on ``MXNET_CPU_WORKER_NTHREADS``
threads (default 1). Either way: per-variable hazard order, as
``threaded_engine.h``'s ThreadedVar —

* ops that only READ a variable run concurrently with each other;
* an op that WRITES a variable waits for every earlier op on it (reads
  and writes) and every later op waits for it;
* ops on disjoint variables overlap;

a priority worker pool, ``wait_for_var``/``wait_for_all`` sync points
(an op's exception surfaces there), and per-op profiler stamps dumped as
Chrome trace JSON. ``MXNET_ENGINE_TYPE=NaiveEngine`` (read at import)
runs every op synchronously at push, the reference's race-bisection
tool. The Python path's workers are daemon threads named
``mxnet-engine-<i>``. The native engine's pool is drained and joined at
interpreter exit (``shutdown``, registered with ``atexit``): a C++
worker still inside a Python callback while the interpreter finalises
aborts the process.
"""
from __future__ import annotations

import atexit
import heapq
import itertools
import json
import os
import threading
import time

__all__ = ["Engine", "Var", "get", "waitall", "is_naive"]

_NAIVE = os.environ.get("MXNET_ENGINE_TYPE", "") == "NaiveEngine"


def is_naive():
    """Whether ``MXNET_ENGINE_TYPE=NaiveEngine`` made the engine
    synchronous."""
    return _NAIVE


class Var(object):
    """A dependency token (Engine::NewVariable): the last op that writes
    it and the reads pushed since."""

    __slots__ = ("last_write", "reads", "deleted")

    def __init__(self):
        self.last_write = None
        self.reads = []
        self.deleted = False


class _Op(object):
    __slots__ = ("fn", "name", "priority", "seq", "pending", "dependents",
                 "done", "error")

    def __init__(self, fn, name, priority, seq):
        self.fn = fn
        self.name = name
        self.priority = priority
        self.seq = seq
        self.pending = 0
        self.dependents = []
        self.done = threading.Event()
        self.error = None


class Engine(object):
    """Host-side dependency engine (module docstring)."""

    _inst = None

    def __init__(self, num_workers=None):
        self._naive = _NAIVE
        self._native = None
        self._deleted = set()        # the native path's deleted var ids
        if not self._naive:
            from .runtime.core import NativeEngine
            native = NativeEngine(num_workers)
            if native.available:
                self._native = native
        if num_workers is None:
            num_workers = int(os.environ.get(
                "MXNET_CPU_WORKER_NTHREADS",
                1 if self._native is None else min(8, os.cpu_count() or 4)))
        self.num_workers = max(1, int(num_workers))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._ready = []                 # heap of (-priority, seq, op)
        self._seq = itertools.count()
        self._inflight = 0               # pushed, not yet finished
        self._errors = []
        self._closed = False
        self._profiling = False
        self._stamps = []
        self._workers = []
        if self._native is not None:
            # registered at creation: atexit is LIFO, so hooks that push
            # work at exit (a checkpoint drain, registered later) run
            # first and this drain still sees what they pushed
            atexit.register(self.shutdown)
        elif not self._naive:
            for i in range(self.num_workers):
                t = threading.Thread(target=self._worker,
                                     name="mxnet-engine-%d" % i,
                                     daemon=True)
                t.start()
                self._workers.append(t)
            atexit.register(self.shutdown)

    # -------------------------------------------------------------- vars
    @property
    def is_native(self):
        """Whether the native C++ engine runs the ops."""
        return self._native is not None

    def new_var(self):
        """Engine::NewVariable — a dependency token for host buffers."""
        if self._native is not None:
            return self._native.new_var()
        return Var()

    def del_var(self, var):
        """Engine::DeleteVariable: the var takes no new ops; pushed ones
        still run."""
        if var is None:
            return
        if self._native is not None:
            self._deleted.add(var)
            self._native.del_var(var)
        else:
            var.deleted = True

    # -------------------------------------------------------------- push
    def push(self, fn, const_vars=(), mutate_vars=(), priority=0,
             name="op"):
        """Engine::PushAsync — run ``fn()`` once its hazards clear: after
        the last write of every var it reads, and after every earlier
        op of every var it writes. A var given as both is a write.
        Returns a ``threading.Event`` set when ``fn`` has run."""
        mutate = list(dict.fromkeys(v for v in mutate_vars if v is not None))
        const = [v for v in dict.fromkeys(c for c in const_vars
                                          if c is not None)
                 if v not in mutate]
        for v in const + mutate:
            if v in self._deleted if isinstance(v, int) else v.deleted:
                raise ValueError("push on a deleted engine var")
        if self._native is not None:
            return self._push_native(fn, const, mutate, priority, name)
        op = _Op(fn, str(name), int(priority), next(self._seq))
        with self._lock:
            # naive: every op in line; closed: late host work (a finaliser
            # at exit) in line
            inline = self._naive or self._closed
            if not inline:
                deps = set()
                for v in const:
                    if v.last_write is not None:
                        deps.add(v.last_write)
                    v.reads.append(op)
                for v in mutate:
                    if v.last_write is not None:
                        deps.add(v.last_write)
                    deps.update(v.reads)
                    v.last_write, v.reads = op, []
                deps = [d for d in deps if not d.done.is_set()]
                op.pending = len(deps)
                for d in deps:
                    d.dependents.append(op)
                self._inflight += 1
                if op.pending == 0:
                    heapq.heappush(self._ready, (-op.priority, op.seq, op))
                    self._cv.notify()
        if inline:
            self._run(op)
            op.done.set()
            if op.error is not None:
                raise op.error
        return op.done

    def _push_native(self, fn, const, mutate, priority, name):
        done = threading.Event()

        def run():
            try:
                fn()
            finally:
                done.set()

        native = self._native
        if native is None:       # shut down since: late host work in line
            run()
        else:
            native.push(run, const, mutate, int(priority), str(name))
        return done

    def push_async(self, fn):
        """Dependency-free host op; returns a waitable Event."""
        return self.push(fn)

    # ----------------------------------------------------------- workers
    def _run(self, op):
        t0 = time.time()
        try:
            op.fn()
        except BaseException as e:  # noqa: BLE001 - surfaced at the waits
            op.error = e
        t1 = time.time()
        if self._profiling:
            self._stamps.append({
                "name": op.name, "cat": "engine", "ph": "X",
                "ts": t0 * 1e6, "dur": max(0.0, (t1 - t0) * 1e6),
                "pid": 0, "tid": threading.get_ident()})

    def _worker(self):
        while True:
            with self._lock:
                while not self._ready and not self._closed:
                    self._cv.wait()
                if not self._ready:
                    return
                _, _, op = heapq.heappop(self._ready)
            self._run(op)
            with self._lock:
                # the dependents' counts fall under the lock the pushes
                # take, so a push never sees a finished op as pending
                op.done.set()
                if op.error is not None:
                    self._errors.append(op.error)
                for d in op.dependents:
                    d.pending -= 1
                    if d.pending == 0:
                        heapq.heappush(self._ready, (-d.priority, d.seq, d))
                op.dependents = []
                self._inflight -= 1
                self._cv.notify_all()

    def _raise_errors(self):
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    # ------------------------------------------------------------- waits
    def wait_for_var(self, var):
        """Engine::WaitForVar — block until every op pushed on ``var``
        so far has run."""
        if self._native is not None:
            if var is not None:
                self._native.wait_for_var(var)
            return
        if var is not None and not self._naive:
            with self._lock:
                ops = ([var.last_write] if var.last_write else []) + \
                    list(var.reads)
            for op in ops:
                op.done.wait()
        self._raise_errors()

    def wait_for_all(self):
        """Engine::WaitForAll — block until every pushed op has run,
        then until the card (when one is in use) has finished its
        queued work. Raises the first error an op raised."""
        if self._native is not None:
            self._native.wait_all()
        elif not self._naive:
            with self._lock:
                while self._inflight:
                    self._cv.wait()
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._raise_errors()

    def shutdown(self):
        """Drain pending ops and stop the workers (idempotent; the
        interpreter-exit hook). Work pushed afterwards runs in line."""
        native, self._native = self._native, None
        if native is not None:
            self._closed = True
            try:
                native.wait_all()
            except BaseException:  # noqa: BLE001 - surfaced at the waits
                import logging
                logging.getLogger(__name__).exception(
                    "pending engine op failed during shutdown drain")
            native.close()
            return
        if self._naive:
            return
        with self._lock:
            if self._closed:
                return
            while self._inflight:
                self._cv.wait()
            self._closed = True
            self._cv.notify_all()
        for t in self._workers:
            t.join(timeout=5)

    # ----------------------------------------------------------- profiler
    def profile_start(self):
        self._profiling = True
        if self._native is not None:
            self._native.profile_start()

    def profile_stop(self):
        self._profiling = False
        if self._native is not None:
            self._native.profile_stop()

    def profile_dump(self, path, clear=True):
        """Write the ops' stamps as Chrome trace JSON (complete events);
        returns their count."""
        if self._native is not None:
            return self._native.profile_dump(path, clear)
        stamps = list(self._stamps)
        if clear:
            del self._stamps[:len(stamps)]
        with open(path, "w") as f:
            json.dump({"traceEvents": stamps, "displayTimeUnit": "ms"}, f)
        return len(stamps)

    def profile_events(self, clear=True):
        """The ops' stamps as Chrome trace events (``profile_dump``
        without the file)."""
        if self._native is not None:
            # the native engine writes only to a path: an in-memory file
            # takes its dump, and nothing touches the disk
            fd = os.memfd_create("mxnet-engine-trace")
            with open(fd, "rb") as f:
                self._native.profile_dump("/proc/self/fd/%d" % fd, clear)
                events = json.load(f)["traceEvents"]
            for ev in events:
                ev["cat"] = "engine"
            return events
        stamps = list(self._stamps)
        if clear:
            del self._stamps[:len(stamps)]
        return stamps


def get():
    """The process-wide engine (created on first use)."""
    if Engine._inst is None:
        Engine._inst = Engine()
    return Engine._inst


def waitall():
    """``mx.waitall`` — block until all pending host and card work is
    done."""
    get().wait_for_all()
