"""Runtime user kernels (``mx.rtc``) for Hopper: CUDA generated from each
checked body on the port's streaming engine, beside its plain PyTorch
version.

What it replaces: ``PallasKernel.__call__`` (``mxnet_tpu/rtc.py:33``,
``pl.pallas_call`` at ``:49``), built by ``Rtc`` (``:59``), which compiles
a user's body over refs once per (shapes, dtypes) key. With no grid there,
each ref is the whole array; here too. The reference's ``mx.rtc``
compiled CUDA C at run time; so does the port.

What bounds it on the H100: bytes. A body in the supported language does
a few operations per element, far below the card's ~295 operations per
byte, so the least time is one read of every input and one write of every
output at the memory rate. ``rtc_codegen.cuda_source`` instantiates the
streaming engine (``csrc/stream.cuh``) with the body: each thread takes
16-byte vectors of every ref, several a round, with streaming loads and
stores (``stream.plan``: vectors aligned to the first output, a ref off
that alignment moving as words).

Build: the generated source is written to ``build/rtc/<digest>/rtc.cu``
(``<dir>/cuda/rtc/<digest>/`` under ``MXNET_COMPILE_CACHE_DIR=<dir>``;
``rtc_dir``) (under a temporary name, then renamed, so processes never race on one
file) and ``nvcc`` builds ``librtc.so`` beside it (``kernels/build.py``;
``-fmad=false -prec-div=true -prec-sqrt=true``, no fast math). The digest
covers the generated text, the engine header and the flags, so each body
builds once, whatever the shape, and a second process reuses the library
on disk. ``n`` is an argument of the C entry, not of the build.
``rtc_kernel.compiles`` counts the bodies made ready in this process
(built, or found built on disk), one per body.

Host path: one ``ctypes`` call per push. The pointer array and the packed
plan are made once per (body, elements, device, addresses mod 16) key;
a push writes the data pointers into the array and calls. The C entry
makes the refs' device current for the launch.

Dispatch: ``rtc_kernel`` runs the plain version only for tensors on the
CPU. CUDA tensors launch the kernel or raise ``MXNetError`` (a failed
build or launch included); nothing falls back. ``rtc_kernel.launches``
counts launches, never plain runs.
"""
from __future__ import annotations

import ctypes
import itertools
import os
import threading
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import build, rtc_codegen, stream

__all__ = ["rtc_kernel", "rtc_plain", "check_tensors", "rtc_dir", "FLAGS"]

FLAGS = ("-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "rtc")
_F32 = torch.float32
_LOCK = threading.Lock()     # bodies may be built from several threads


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _tensor_like(v, like):
    return v if isinstance(v, torch.Tensor) else \
        torch.full_like(like, float(v))


def _first_tensor(args):
    return next(a for a in args if isinstance(a, torch.Tensor))


class _TorchJnp(object):
    """The ``jnp`` of the plain version: exactly the checker's functions,
    over torch tensors (a constant argument becomes a full tensor)."""

    exp = staticmethod(torch.exp)
    log = staticmethod(torch.log)
    sqrt = staticmethod(torch.sqrt)
    tanh = staticmethod(torch.tanh)
    abs = staticmethod(torch.abs)

    @staticmethod
    def maximum(a, b):
        t = _first_tensor((a, b))
        return torch.maximum(_tensor_like(a, t), _tensor_like(b, t))

    @staticmethod
    def minimum(a, b):
        t = _first_tensor((a, b))
        return torch.minimum(_tensor_like(a, t), _tensor_like(b, t))

    @staticmethod
    def where(c, a, b):
        t = _first_tensor((a, b))
        return torch.where(c, _tensor_like(a, t), _tensor_like(b, t))


class _Ref(object):
    """A ref over one tensor: ``ref[...]`` reads it, ``ref[...] = v``
    copies into it."""

    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t

    def __getitem__(self, key):
        return self.t

    def __setitem__(self, key, value):
        self.t.copy_(value)


def rtc_plain(ck, ins, outs):
    """Plain PyTorch version: run the checked (lowered) body with ``jnp``
    bound to the torch namespace above and refs over ``ins`` and
    ``outs``; writes ``outs`` in place."""
    scope = {"jnp": _TorchJnp}
    exec(ck.code, scope)  # noqa: S102 - the checked body, compiled once
    with torch.no_grad():
        scope["_kernel"](*[_Ref(t) for t in list(ins) + list(outs)])


# ---------------------------------------------------------------------------
# kernel build and launch
# ---------------------------------------------------------------------------
def _refuse_tensors(ck, ins, outs):
    """Raise the error that names the first tensor ``check_tensors``
    refuses."""
    ref = outs[0]
    for t in itertools.chain(ins, outs):
        if t.dtype != _F32:
            raise MXNetError("rtc: dtype %s is not supported (float32 only)"
                             % t.dtype)
        if tuple(t.shape) != tuple(ref.shape):
            raise MXNetError("rtc: every ref must have the output's shape %s;"
                             " got %s (no broadcasting across refs)"
                             % (tuple(ref.shape), tuple(t.shape)))
        if t.device != ref.device:
            raise MXNetError("rtc: refs on %s and %s" % (t.device,
                                                          ref.device))
        if not t.is_contiguous():
            raise MXNetError("rtc: refs must be contiguous")


def check_tensors(ck, ins, outs):
    """Raise unless every tensor is a contiguous float32 tensor of one
    shape on one device, with as many inputs and outputs as the body has
    refs, and fewer than 2**31 elements. Reads tensor metadata only:
    device indices first (no device objects), whole devices only off the
    card, where every index is -1."""
    if len(ins) != ck.n_in or len(outs) != ck.n_out:
        raise MXNetError("rtc: the body takes %d input(s) and %d output(s);"
                         " got %d and %d" % (ck.n_in, ck.n_out, len(ins),
                                              len(outs)))
    ref = outs[0]
    shape, dev = ref.shape, ref.get_device()
    for ts in (ins, outs):
        for t in ts:
            if t.dtype is not _F32 or t.shape != shape \
                    or t.get_device() != dev or not t.is_contiguous() \
                    or (dev < 0 and t.device != ref.device):
                _refuse_tensors(ck, ins, outs)
    if ref.numel() >= 2 ** 31:
        raise MXNetError("rtc: %d elements is too many (< 2**31)"
                         % ref.numel())


def rtc_dir(tag):
    """The directory of the body whose CUDA text has digest ``tag`` (its
    ``rtc.cu`` and ``librtc.so``): under the compile cache's ``cuda/rtc/``
    when one is in force (``build.cache_root``), else the checkout's
    ``build/rtc/``."""
    root = build.cache_root()
    return os.path.join(root, "cuda", "rtc", tag) if root else \
        os.path.join(_BUILD_DIR, tag)


def _write_source(text, tag):
    """Save ``text`` as ``rtc.cu`` in ``rtc_dir(tag)`` unless it is there;
    the write goes to a name of this process first and is renamed into
    place."""
    d = rtc_dir(tag)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "rtc.cu")
    if not os.path.exists(path):
        tmp = "%s.%d.tmp" % (path, os.getpid())
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return path


def _build(ck):
    """Generate, save and build the body's CUDA (or load the library
    built from the same text); returns its ``mx_rtc``."""
    text = rtc_codegen.cuda_source(ck)
    tag = build.digest(text, FLAGS)[:32]
    src = _write_source(text, tag)
    lib = build.nvcc_library(src, os.path.join(os.path.dirname(src),
                                               "librtc.so"), FLAGS)
    fn = lib.mx_rtc
    P = ctypes.c_void_p
    fn.argtypes = [P, P, ctypes.c_longlong, P, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    return fn


_LIBS = {}      # body digest -> mx_rtc of its library
_CALLS = {}     # (body digest, n, device, addresses mod 16) -> _Call


class _Call(NamedTuple):
    """What a push hands ``mx_rtc``, made once per key: the C array of
    the refs' pointers (``ptrs``; inputs at address ``ins``, outputs at
    ``outs``) and the packed plan (``packed``, at ``plan``)."""
    fn: object
    ptrs: object
    ins: int
    outs: int
    packed: object
    plan: int


def _library(ck):
    """The body's ``mx_rtc``, built (or loaded) on first use."""
    fn = _LIBS.get(ck.digest)
    if fn is None:
        fn = _build(ck)
        with _LOCK:
            if ck.digest not in _LIBS:
                _LIBS[ck.digest] = fn
                rtc_kernel.compiles += 1
            fn = _LIBS[ck.digest]
    return fn


def _prepare(ck, key):
    """The ``_Call`` of the key, made on first use."""
    _, n, _, offsets = key
    fn = _library(ck)
    ptrs = (ctypes.c_uint64 * len(offsets))()
    packed = stream.plan(n, offsets, ck.n_in, ck.n_out).packed()
    arr = (ctypes.c_longlong * len(packed))(*packed)
    base = ctypes.addressof(ptrs)
    call = _CALLS[key] = _Call(fn, ptrs, base, base + 8 * ck.n_in, arr,
                               ctypes.addressof(arr))
    return call


def _launch(call, ptrs, n, dev):
    """Launch the prepared ``call`` over the CUDA refs at ``ptrs``
    (inputs, then outputs) of ``n`` elements on device ``dev``'s current
    stream."""
    call.ptrs[:] = ptrs
    err = call.fn(call.ins, call.outs, n, call.plan, dev,
                  torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise MXNetError("rtc: kernel launch failed with CUDA error %d"
                         % err)
    rtc_kernel.launches += 1


def rtc_kernel(ck, ins, outs):
    """Compute the checked body over ``ins`` into ``outs`` (lists of
    tensors). CPU tensors take the plain version; CUDA tensors launch the
    body's CUDA kernel or raise."""
    check_tensors(ck, ins, outs)
    o = outs[0]
    if not o.is_cuda:
        if o.device.type == "cpu":
            return rtc_plain(ck, ins, outs)
        raise MXNetError("rtc: tensors on %s are not supported" % o.device)
    n = o.numel()
    if n == 0:
        return None
    ptrs = [t.data_ptr() for t in ins] + [t.data_ptr() for t in outs]
    dev = o.get_device()
    key = (ck.digest, n, dev, tuple([p & 15 for p in ptrs]))
    _launch(_CALLS.get(key) or _prepare(ck, key), ptrs, n, dev)
    return None


rtc_kernel.launches = 0
rtc_kernel.compiles = 0
