"""ctypes bindings of the native host runtime (``engine_core.cpp``; the
port's counterpart of ``mxnet_tpu/runtime/core.py``).

``NativeEngine`` — the C++ dependency engine: ops declare const/mutate var
ids (the reference's Engine::PushAsync contract, include/mxnet/engine.h);
consecutive reads run concurrently, writes serialize, ops run on a C++
worker pool. Python callables are dispatched through ONE static ctypes
trampoline (it outlives every op in flight; each op's closure is kept in
a table keyed by an integer ctx and dropped after it ran).

``HostPool`` — the size-bucketed pooled host allocator (the reference's
src/storage pooled managers, for staging buffers): ``alloc_array`` hands
out 64-byte-aligned numpy views whose memory recycles through the pool.

Of the reference's two op resources, ``kRandom`` is the port's key chain
(``random.py``: a ``needs_rng`` op receives its node's key); ``kTempSpace``
has no user-visible counterpart: PyTorch's caching allocator gives each
kernel its scratch.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as onp

from ._native_build import load_native

_LIB = None
_LOCK = threading.Lock()

_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_int64)


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB if _LIB is not False else None
        lib = load_native("engine_core.cpp")
        if lib is None:
            _LIB = False
            return None
        lib.eng_create.restype = ctypes.c_void_p
        lib.eng_create.argtypes = [ctypes.c_int]
        lib.eng_destroy.argtypes = [ctypes.c_void_p]
        lib.eng_new_var.restype = ctypes.c_int64
        lib.eng_new_var.argtypes = [ctypes.c_void_p]
        lib.eng_del_var.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.eng_push.argtypes = [
            ctypes.c_void_p, _CALLBACK, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p]
        lib.eng_wait_for_var.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.eng_wait_all.argtypes = [ctypes.c_void_p]
        lib.eng_pending.restype = ctypes.c_int64
        lib.eng_pending.argtypes = [ctypes.c_void_p]
        lib.eng_profile_start.argtypes = [ctypes.c_void_p]
        lib.eng_profile_stop.argtypes = [ctypes.c_void_p]
        lib.eng_profile_dump.restype = ctypes.c_int64
        lib.eng_profile_dump.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int]
        lib.sto_create.restype = ctypes.c_void_p
        lib.sto_destroy.argtypes = [ctypes.c_void_p]
        lib.sto_alloc.restype = ctypes.c_void_p
        lib.sto_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sto_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sto_direct_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sto_release_all.argtypes = [ctypes.c_void_p]
        lib.sto_used_bytes.restype = ctypes.c_int64
        lib.sto_used_bytes.argtypes = [ctypes.c_void_p]
        lib.sto_pooled_bytes.restype = ctypes.c_int64
        lib.sto_pooled_bytes.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class NativeEngine(object):
    """The C++ dependency engine (None-safe: check ``available``)."""

    def __init__(self, num_workers=None):
        self._lib = get_lib()
        self._h = None
        if self._lib is None:
            return
        if num_workers is None:
            if os.environ.get("MXNET_ENGINE_TYPE", "") == "NaiveEngine":
                num_workers = 0  # synchronous, the race-bisection mode
            else:
                num_workers = int(os.environ.get(
                    "MXNET_CPU_WORKER_NTHREADS",
                    min(8, os.cpu_count() or 4)))
        self._fns = {}
        self._fns_lock = threading.Lock()
        self._next_ctx = [1]
        self._errors = []

        def _dispatch(ctx):
            with self._fns_lock:
                fn = self._fns.pop(ctx)
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — surface on waitall
                self._errors.append(e)

        # the single immortal trampoline: per-op python closures live in
        # self._fns until executed, so nothing is freed mid-call
        self._trampoline = _CALLBACK(_dispatch)
        self._h = self._lib.eng_create(num_workers)

    @property
    def available(self):
        return self._h is not None

    def close(self):
        """Join workers and free the C++ engine (safe to call twice)."""
        h, self._h = self._h, None
        if h is not None and self._lib is not None:
            try:
                self._lib.eng_destroy(h)
            except Exception:  # pragma: no cover - interpreter teardown
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # pragma: no cover
            pass

    def new_var(self):
        return self._lib.eng_new_var(self._h)

    def del_var(self, var):
        self._lib.eng_del_var(self._h, var)

    def push(self, fn, const_vars=(), mutate_vars=(), priority=0, name=""):
        """Schedule fn() honoring read/write hazards on the given vars."""
        # dedup (engine.h DeduplicateVarHandle): mutate wins over const
        mut = list(dict.fromkeys(mutate_vars))
        con = [v for v in dict.fromkeys(const_vars) if v not in set(mut)]
        with self._fns_lock:
            ctx = self._next_ctx[0]
            self._next_ctx[0] += 1
            self._fns[ctx] = fn
        c_arr = (ctypes.c_int64 * max(1, len(con)))(*(con or [0]))
        m_arr = (ctypes.c_int64 * max(1, len(mut)))(*(mut or [0]))
        self._lib.eng_push(self._h, self._trampoline, ctx, c_arr, len(con),
                           m_arr, len(mut), priority,
                           name.encode() if name else b"op")

    def wait_for_var(self, var):
        self._lib.eng_wait_for_var(self._h, var)
        self._raise_pending()

    def wait_all(self):
        self._lib.eng_wait_all(self._h)
        self._raise_pending()

    def _raise_pending(self):
        if self._errors:
            err = self._errors.pop(0)
            self._errors.clear()
            raise err

    def pending(self):
        return int(self._lib.eng_pending(self._h))

    # ---- profiler hooks (profiler.py merges this into its dump) ---------
    def profile_start(self):
        self._lib.eng_profile_start(self._h)

    def profile_stop(self):
        self._lib.eng_profile_stop(self._h)

    def profile_dump(self, path, clear=True):
        return int(self._lib.eng_profile_dump(
            self._h, str(path).encode(), 1 if clear else 0))


class HostPool(object):
    """Pooled host allocator; alloc_array returns recycling numpy views."""

    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.sto_create() if self._lib is not None else None

    @property
    def available(self):
        return self._h is not None

    def close(self):
        """Free the native pool and every buffer it caches (idempotent)."""
        h, self._h = self._h, None
        if h is not None and self._lib is not None:
            try:
                self._lib.sto_destroy(h)
            except Exception:  # pragma: no cover - interpreter teardown
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # pragma: no cover
            pass

    def alloc_array(self, shape, dtype=onp.float32):
        """numpy array over pooled 64B-aligned memory; release() recycles."""
        dtype = onp.dtype(dtype)
        nbytes = int(onp.prod(shape)) * dtype.itemsize
        ptr = self._lib.sto_alloc(self._h, max(1, nbytes))
        if not ptr:
            raise MemoryError(nbytes)
        buf = (ctypes.c_uint8 * max(1, nbytes)).from_address(ptr)
        arr = onp.frombuffer(buf, dtype=dtype,
                             count=int(onp.prod(shape))).reshape(shape)
        return arr

    def release(self, arr):
        """Recycle the ORIGINAL array returned by alloc_array (its data
        pointer is the pool key — don't pass slices/views). The caller owns
        the lifetime: ``torch.from_numpy`` shares the buffer and a
        ``non_blocking`` copy to the card reads it later, so release only
        once no tensor aliases it and every copy from it has completed."""
        self._lib.sto_free(self._h,
                           ctypes.c_void_p(arr.ctypes.data))

    def release_all(self):
        self._lib.sto_release_all(self._h)

    def used_bytes(self):
        return int(self._lib.sto_used_bytes(self._h))

    def pooled_bytes(self):
        return int(self._lib.sto_pooled_bytes(self._h))
