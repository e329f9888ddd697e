"""Profiler — the reference's profiling API on PyTorch (the port's
counterpart of ``mxnet_tpu/profiler.py``; python/mxnet/profiler.py +
src/engine/profiler.{h,cc} in the reference).

The reference stamps each op in its engine and dumps Chrome trace JSON.
The JAX package keeps that API (``profiler_set_config``/
``profiler_set_state``/``dump_profile``, :class:`Scope`) over host events
and bridges to ``jax.profiler``. The port bridges to ``torch.profiler``:
while the state is ``"run"`` a ``torch.profiler.profile`` records the
card's kernels (when a card is in use) and, in mode ``"all"``,
PyTorch's host operators. One
``dump_profile`` file carries the whole timeline on the host's wall
clock: :class:`Scope` regions, the telemetry span ring
(``telemetry.span``), in mode ``"all"`` the engine's per-op stamps
(``engine.Engine.push``), and the recorded kernels (``"cat": "kernel"``,
``"pid": "card"``) or host operators (``"cat": "operator"``).

Env contract (the reference's docs/how_to/env_var.md):
``MXNET_PROFILER_AUTOSTART=1`` starts profiling at import and dumps at
exit; ``MXNET_PROFILER_MODE=1`` selects mode ``"all"``;
``MXNET_PROFILER_FILENAME`` names the file (default ``profile.json``).
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "Scope", "record_event"]

_config = {"mode": "symbolic", "filename": "profile.json"}
_state = "stop"
_events = []
_torch_events = []     # the torch.profiler bridge's events, kept across dumps
_lock = threading.Lock()
_ran_undumped = False  # profiling ran but no dump written since
_bridge = None         # the live torch.profiler.profile


def _autostart():
    """Honour MXNET_PROFILER_AUTOSTART / MXNET_PROFILER_MODE: profiling
    starts at import and the dump fires at exit."""
    if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") != "1":
        return
    mode = "all" if os.environ.get("MXNET_PROFILER_MODE", "0") == "1" \
        else "symbolic"
    profiler_set_config(mode=mode, filename=os.environ.get(
        "MXNET_PROFILER_FILENAME", "profile.json"))
    profiler_set_state("run")
    import atexit

    def _stop_and_dump():
        # sticky: dump whenever profiling ran and data may be undumped,
        # so neither a manual stop nor a mid-run dump loses the tail
        was_running = _state == "run"
        if was_running:
            profiler_set_state("stop")
        if was_running or _ran_undumped:
            dump_profile()

    atexit.register(_stop_and_dump)


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """mode: ``'symbolic'`` or ``'all'`` (MXSetProfilerConfig)."""
    _config["mode"] = mode
    _config["filename"] = filename


def _on_card():
    import torch
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _activities():
    """What the torch.profiler bridge records: with a card in use, its
    kernels and the host operators around them (the activities every
    profile of ``chip_smoke.py`` takes); without one, the host operators
    in mode ``'all'``; nothing otherwise."""
    from torch.profiler import ProfilerActivity
    if _on_card():
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if _config.get("mode") == "all":
        return [ProfilerActivity.CPU]
    return []


def _bridge_start():
    global _bridge
    acts = _activities()
    if not acts:
        return
    import torch
    _bridge = torch.profiler.profile(activities=acts)
    _bridge.start()


def _bridge_stop():
    """Stop the torch.profiler bridge and keep its events as Chrome
    complete events on the wall clock."""
    global _bridge
    prof, _bridge = _bridge, None
    if prof is None:
        return
    prof.stop()
    try:
        start_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
    except Exception:  # noqa: BLE001 - an older layout: now - duration
        start_us = None
    fresh = []
    host_ops = _config.get("mode") == "all"
    for e in prof.events():
        card = str(e.device_type).endswith("CUDA")
        if not (card or host_ops):
            continue
        fresh.append({
            "name": e.name, "cat": "kernel" if card else "operator",
            "ph": "X", "ts": e.time_range.start,
            "dur": max(0.0, e.time_range.end - e.time_range.start),
            "pid": "card" if card else 0,
            "tid": e.device_index if card else e.thread})
    if start_us is None:
        end = max((ev["ts"] + ev["dur"] for ev in fresh), default=0.0)
        start_us = time.time() * 1e6 - end
    for ev in fresh:
        ev["ts"] += start_us
    with _lock:
        _torch_events.extend(fresh)


def profiler_set_state(state="stop"):
    """state: ``'run'`` or ``'stop'`` (MXSetProfilerState); also starts
    and stops the engine's per-op stamps and the torch.profiler bridge."""
    global _state, _ran_undumped
    if state == _state:
        return
    _state = state
    from . import engine as _engine
    if state == "run":
        _ran_undumped = True
        _engine.get().profile_start()
        _bridge_start()
    else:
        _engine.get().profile_stop()
        _bridge_stop()


def record_event(name, begin_us, end_us, pid=0, tid=None):
    """Append one duration event (the engine's AddOprStat): ONE complete
    event (``"ph": "X"`` with a ``dur``) on the recording thread's id."""
    global _ran_undumped
    if _state != "run":
        return
    _ran_undumped = True
    if tid is None:
        tid = threading.get_ident()
    with _lock:
        _events.append({"name": name, "cat": "operator", "ph": "X",
                        "ts": begin_us, "dur": max(0.0, end_us - begin_us),
                        "pid": pid, "tid": tid})


class Scope(object):
    """Context manager timing a named region into the trace."""

    def __init__(self, name, pid=0):
        self.name = name
        self.pid = pid

    def __enter__(self):
        self.begin = time.time() * 1e6
        return self

    def __exit__(self, *args):
        record_event(self.name, self.begin, time.time() * 1e6, self.pid)


_engine_events = []   # drained from the engine, kept so dumps accumulate


def dump_profile():
    """Write the accumulated events as Chrome tracing JSON
    (MXDumpProfile): the Scope regions, the telemetry span ring and the
    bridge's kernels or host operators, plus in mode ``'all'`` the
    engine's per-op stamps. Callable repeatedly: every source
    accumulates across dumps."""
    global _ran_undumped
    from . import engine as _engine
    from . import telemetry as _telemetry
    if _config.get("mode") == "all":
        fresh = _engine.get().profile_events(clear=True)
        with _lock:
            _engine_events.extend(fresh)
    with _lock:
        events = list(_events)
        if _config.get("mode") == "all":
            events += list(_engine_events)
        events += list(_torch_events)
        events += _telemetry.trace_events()
        data = {"traceEvents": events, "displayTimeUnit": "ms"}
        with open(_config["filename"], "w") as f:
            json.dump(data, f)
    _ran_undumped = False


_autostart()
