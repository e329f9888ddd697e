"""Runtime user kernels (``mx.rtc``) for Hopper: a Triton kernel generated
from each checked body, beside its plain PyTorch version.

What it replaces: ``PallasKernel.__call__`` (``mxnet_tpu/rtc.py:33``,
``pl.pallas_call`` at ``:49``), built by ``Rtc`` (``:59``), which compiles
a user's body over refs once per (shapes, dtypes) key. With no grid there,
each ref is the whole array; here too.

What bounds it on the H100: bytes. A body in the supported language does
a few operations per element, far below the card's ~295 operations per
byte, so the least time is one read of every input and one write of every
output at the memory rate. The design does just that: one fused pass, a
flat 1-D grid of ``BLOCK`` = 1024 elements per program, every input loaded
once and every output stored once, with masks at the ragged edge.

Build: ``rtc_codegen.triton_source`` writes the kernel's text; the
launcher saves it as ``build/rtc/<sha256 of body and key>.py`` (written
under a temporary name, then renamed, so processes never race on one
file) and imports it from there, because Triton reads a kernel's source
from its file. One build per (body, shape, ref counts, device) key;
``N`` is a compile-time constant of that build, so Triton compiles once
per key too. ``rtc_kernel.compiles`` counts builds.

Dispatch: ``rtc_kernel`` runs the plain version only for tensors on the
CPU. CUDA tensors launch the kernel or raise; nothing falls back.
``rtc_kernel.launches`` counts launches, never plain runs.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import sys

import torch

from ..base import MXNetError
from . import rtc_codegen

__all__ = ["rtc_kernel", "rtc_plain", "check_tensors", "BLOCK"]

BLOCK = 1024        # elements per program: 8 per thread at 4 warps
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "rtc")


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
def check_tensors(ck, ins, outs):
    """Raise unless every tensor is a contiguous float32 tensor of one
    shape on one device, with as many inputs and outputs as the body has
    refs, and fewer than 2**31 elements (int32 offsets)."""
    if len(ins) != ck.n_in or len(outs) != ck.n_out:
        raise MXNetError("rtc: the body takes %d input(s) and %d output(s);"
                         " got %d and %d" % (ck.n_in, ck.n_out, len(ins),
                                              len(outs)))
    ref = outs[0]
    for t in list(ins) + list(outs):
        if t.dtype != torch.float32:
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
    if ref.numel() >= 2 ** 31:
        raise MXNetError("rtc: %d elements is too many (< 2**31)"
                         % ref.numel())


def _write_source(text, name):
    """Save ``text`` as ``build/rtc/<name>.py`` unless it is there; the
    write goes to a name of this process first and is renamed into
    place."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    path = os.path.join(_BUILD_DIR, name + ".py")
    if not os.path.exists(path):
        tmp = "%s.%d.tmp" % (path, os.getpid())
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return path


def _build_triton(ck, key):
    """Generate, save and import the kernel for ``key``; returns its
    ``@triton.jit`` function."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(_REPO_ROOT, "build", "triton"))
    text = rtc_codegen.triton_source(ck)
    name = "rtc_" + hashlib.sha256(
        (text + repr(key)).encode()).hexdigest()[:32]
    path = _write_source(text, name)
    mod_name = "mxnet_tpu_torch_" + name
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    rtc_kernel.compiles += 1
    return mod.rtc_kernel


_BUILT = {}     # (body digest, shape, n_in, n_out, device) -> jit function


def _launcher(ck, key):
    """The built kernel of ``key``, built on first use."""
    fn = _BUILT.get(key)
    if fn is None:
        fn = _BUILT[key] = _build_triton(ck, key)
    return fn


def rtc_kernel(ck, ins, outs):
    """Compute the checked body over ``ins`` into ``outs`` (lists of
    tensors). CPU tensors take the plain version; CUDA tensors launch the
    generated Triton kernel or raise."""
    check_tensors(ck, ins, outs)
    if outs[0].device.type == "cpu":
        return rtc_plain(ck, ins, outs)
    if outs[0].device.type != "cuda":
        raise MXNetError("rtc: tensors on %s are not supported"
                         % outs[0].device)
    n = outs[0].numel()
    if n == 0:
        return None
    key = (ck.digest, tuple(outs[0].shape), ck.n_in, ck.n_out,
           str(outs[0].device))
    fn = _launcher(ck, key)
    grid = (-(-n // BLOCK),)
    fn[grid](*ins, *outs, N=n, BLOCK=BLOCK, num_warps=4)
    rtc_kernel.launches += 1
    return None


rtc_kernel.launches = 0
rtc_kernel.compiles = 0
