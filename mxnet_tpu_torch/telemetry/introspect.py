"""Program introspection — every program the port runs, its FLOPs and
bytes, and the live roofline they imply (the port's counterpart of
``mxnet_tpu/telemetry/introspect.py``).

The JAX package asks XLA for a compiled program's cost. The port runs
eager PyTorch, so a "program" is one of the fused group's step or eval
functions at one (kind, shape signature), and its "compile" is its first
run (where cuDNN picks its algorithms and the caching allocator grows —
what ``serving.Predictor`` counts as a compile). That first run is where
the analysis happens, and only while telemetry is enabled:

* :class:`ProgramCounter` — a ``TorchDispatchMode`` that sees every aten
  op of the run: FLOPs through ``torch.utils.flop_counter``'s formulas
  (matrix products and convolutions, forward and backward; elementwise
  ops count none, as there), bytes as the inputs plus the outputs of
  every op that is not a view. The hand-written kernels (``bn_fwd``,
  ``bn_bwd``) are ctypes calls, not aten ops: their wrappers add their
  own FLOPs and bytes (:func:`kernel_work`) and hide their plain
  versions' ops, so a count on the CPU equals the count on the card.
  These bytes are unfused — every op's operands counted once each — so
  they lie above XLA's ``bytes_accessed`` for the same step, which
  counts a fused program's traffic.
* :func:`analyze_compiled` runs a function once under a counter and
  returns its result and the count; the step is never re-run to analyse
  it (it updates parameters in place).
* :class:`ProgramInventory` — every analysed program of the process,
  with analytic entries for work the counter cannot see (the optimizer
  update folded into the fused step). Reports publish as a
  ``programs.*`` gauge scope and as JSON (:meth:`dump_programs`).
* :func:`roofline` + :func:`device_peaks` — the per-step ``mfu`` /
  ``achieved_tflops`` / ``achieved_hbm_gbps`` / ``bound_by`` arithmetic
  the fit loop publishes live; the arithmetic is the JAX package's.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["analyze_compiled", "device_peaks", "roofline", "kernel_work",
           "active_counter", "ProgramCounter", "ProgramInventory",
           "BOUND_BY_CODES"]

# per-card peaks by device-name substring: (dense TFLOP/s by compute
# type, HBM GB/s). H100 SXM from NVIDIA's data sheet (dense, without
# sparsity); the PCIe and NVL parts have other peaks and are not listed.
_PEAKS = [("h100", {"bfloat16": 989.0, "float16": 989.0, "tf32": 494.5,
                    "float32": 67.0}, 3350.0)]
_NOT_LISTED = ("pcie", "nvl")

# bound_by classification as a Prometheus-representable gauge code
BOUND_BY_CODES = {"compute": 0, "hbm": 1, "host-wait": 2}


def _peak_key(dtype):
    """The peak table's key for a step's compute dtype: bfloat16/float16
    by name; float32 is ``tf32`` when cuDNN may run its convolutions in
    TF32 (PyTorch's default), else ``float32``."""
    name = str(dtype or "float32").replace("torch.", "")
    if name in ("bfloat16", "float16"):
        return name
    return "tf32" if torch.backends.cudnn.allow_tf32 else "float32"


def device_peaks(device_kind, dtype="float32"):
    """The card's (peak TFLOP/s for ``dtype``, peak HBM GB/s) from its
    ``torch.cuda.get_device_name`` string, or ``(None, None)`` when the
    table does not know it (the CPU, other cards). ``MXNET_PEAK_TFLOPS``
    / ``MXNET_PEAK_HBM_GBPS`` override each component on its own."""
    kind = str(device_kind or "").lower()
    tf = bw = None
    if not any(s in kind for s in _NOT_LISTED):
        for sub, tflops, gbps in _PEAKS:
            if sub in kind:
                tf, bw = tflops[_peak_key(dtype)], gbps
                break
    tf_env = os.environ.get("MXNET_PEAK_TFLOPS")
    bw_env = os.environ.get("MXNET_PEAK_HBM_GBPS")
    if tf_env:
        tf = float(tf_env)
    if bw_env:
        bw = float(bw_env)
    return tf, bw


def roofline(flops, bytes_accessed, seconds, peak_tflops=None,
             peak_hbm_gbps=None, host_wait_fraction=0.0):
    """The roofline numbers one (flops, bytes, wall seconds) triple
    implies — the JAX package's arithmetic.

    ``bound_by``: ``host-wait`` when the input path ate most of the
    step, else ``hbm`` when the implied HBM utilization crosses 0.5,
    else ``compute``."""
    seconds = max(float(seconds), 1e-9)
    out = {
        "achieved_tflops": flops / seconds / 1e12,
        "achieved_hbm_gbps": bytes_accessed / seconds / 1e9,
    }
    out["mfu"] = out["achieved_tflops"] / peak_tflops if peak_tflops \
        else 0.0
    out["hbm_util"] = out["achieved_hbm_gbps"] / peak_hbm_gbps \
        if peak_hbm_gbps else 0.0
    if host_wait_fraction > 0.5:
        out["bound_by"] = "host-wait"
    elif out["hbm_util"] > 0.5:
        out["bound_by"] = "hbm"
    else:
        out["bound_by"] = "compute"
    out["bound_by_code"] = BOUND_BY_CODES[out["bound_by"]]
    return out


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------
_ACTIVE = []    # the counters of the runs being analysed, innermost last


def active_counter():
    """The innermost :class:`ProgramCounter` counting on this process, or
    None (the one branch an uncounted kernel call pays)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def kernel_work(flops, nbytes):
    """Inside a hand-written kernel's wrapper: add the kernel's own FLOPs
    and bytes to the active count and hide the aten ops the wrapper runs
    around (or instead of) it. Callers check :func:`active_counter`
    first, so an uncounted call never enters here."""
    counter = active_counter()
    counter.flops += float(flops)
    counter.bytes += float(nbytes)
    counter.kernels += 1
    counter._hidden += 1
    try:
        yield
    finally:
        counter._hidden -= 1


def _nbytes(t):
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


class ProgramCounter(TorchDispatchMode):
    """FLOPs and bytes of every aten op run under it (module docstring);
    ``kernels`` counts the hand-written kernel calls that added their own
    work."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.kernels = 0
        self._hidden = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._hidden or getattr(func, "is_view", False):
            return out
        self.ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in tree_leaves(out))
        return out


def analyze_compiled(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` ONCE under a :class:`ProgramCounter`:
    returns ``(fn's result, {"flops", "bytes_accessed", "ops",
    "kernels"})``. The port's counterpart of the JAX package's analysis
    of a compiled program — here the program's first run is analysed as
    it runs, never run a second time."""
    counter = ProgramCounter()
    with counter:
        result = fn(*args, **kwargs)
    return result, {"flops": counter.flops,
                    "bytes_accessed": counter.bytes,
                    "ops": counter.ops, "kernels": counter.kernels}


# ---------------------------------------------------------------------------
# the inventory
# ---------------------------------------------------------------------------
class ProgramInventory(object):
    """Registry of every analysed program of the process (module
    docstring). Entries carry their counted or analytic
    ``flops`` / ``bytes_accessed``."""

    def __init__(self, registry=None, capacity=256):
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()
        self._capacity = int(capacity)
        self._registry = registry

    def _scope(self):
        if self._registry is None:
            import mxnet_tpu_torch.telemetry as _tel
            self._registry = _tel.registry()
        return self._registry

    def register(self, name, kind="", n_dev=1, device_kind="", meta=None,
                 flops=None, bytes_accessed=None, analytic=False):
        """Register (or replace) one program entry: a counted first run
        (``analyze_compiled``'s numbers) or, with ``analytic=True``, an
        account of work no counter saw. Returns the entry name."""
        entry = {
            "name": str(name), "kind": str(kind), "n_dev": int(n_dev),
            "device_kind": str(device_kind), "meta": dict(meta or {}),
            "registered_ts": time.time(), "analytic": bool(analytic),
            "analysis": {"flops": float(flops or 0.0),
                         "bytes_accessed": float(bytes_accessed or 0.0)},
        }
        with self._lock:
            self._entries.pop(entry["name"], None)
            self._entries[entry["name"]] = entry
            while len(self._entries) > self._capacity:
                self._entries.popitem(last=False)
        return entry["name"]

    def names(self):
        with self._lock:
            return list(self._entries)

    def clear(self):
        """Drop every entry (test isolation)."""
        with self._lock:
            self._entries.clear()

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def analyze(self, name):
        """The report dict of one entry (None for unknown names)."""
        with self._lock:
            entry = self._entries.get(str(name))
        if entry is None:
            return None
        a = entry["analysis"]
        n_dev = max(entry["n_dev"], 1)
        out = {"name": entry["name"], "kind": entry["kind"],
               "n_dev": entry["n_dev"], "device_kind": entry["device_kind"],
               "analytic": entry["analytic"], "meta": dict(entry["meta"]),
               "flops_per_device": a["flops"],
               "bytes_per_device": a["bytes_accessed"],
               "flops": a["flops"] * n_dev,
               "bytes_accessed": a["bytes_accessed"] * n_dev}
        self._publish(out)
        return out

    def _publish(self, report):
        """Mirror one entry into the ``programs.*`` gauge scope."""
        try:
            scope = self._scope().scope("programs.%s" % report["name"])
            scope.gauge("flops").set(report.get("flops", 0.0))
            scope.gauge("bytes_accessed").set(
                report.get("bytes_accessed", 0.0))
        except Exception:  # noqa: BLE001 - publishing is best-effort
            pass

    def report(self):
        """Every entry, sorted by name."""
        return [self.analyze(n) for n in sorted(self.names())]

    def dump_programs(self, path=None):
        """The full inventory as a JSON report; ``path=`` also writes it
        (tmp + rename, so a reader never sees a torn file). Returns the
        report dict."""
        report = {
            "format": "program-inventory-r1",
            "generated_ts": round(time.time(), 3),
            "n_programs": len(self),
            "programs": self.report(),
        }
        if path is not None:
            from .export import atomic_json_dump
            atomic_json_dump(path, report)
        return report
