"""Runtime user kernels (PyTorch counterpart of ``mxnet_tpu/rtc.py``).

The kernel language is the JAX package's: a Python body over
``<name>_ref`` refs, read and written whole with ``[...]``, with ``jnp.``
calls, so one body text runs through both packages. The port accepts the
subset that one fused elementwise float32 pass computes (see
``kernels/rtc_codegen.py``) and checks a body once, at construction:
anything outside it raises ``MXNetError`` on the CPU and on the card
alike. On a CUDA device a body runs as CUDA generated from it on the
port's streaming engine and built with nvcc (``kernels/rtc.py``); on the
CPU, as its plain PyTorch version.

    rtc = mx.rtc.Rtc('axpy', [('x', x), ('y', y)], [('z', z)],
                     "z_ref[...] = x_ref[...] * 2.0 + y_ref[...]")
    rtc.push([x, y], [z])
"""
from __future__ import annotations

import inspect
import textwrap

import numpy as onp
import torch

from .base import MXNetError, torch_dtype
from .context import Context, current_context
from .ndarray import NDArray
from .kernels import rtc as _kernels
from .kernels.rtc_codegen import check_kernel

__all__ = ["Rtc", "RefKernel", "PallasKernel"]


def _tensors(inputs):
    """Input tensors on one device, and that device's context. NDArrays
    and tensors keep their device; numpy arrays join it (the default
    context when no input has one)."""
    devices = {x._read().device if isinstance(x, NDArray) else x.device
               for x in inputs if isinstance(x, (NDArray, torch.Tensor))}
    if len(devices) > 1:
        raise MXNetError("rtc: inputs on more than one device: %s"
                         % sorted(str(d) for d in devices))
    if devices:
        device = devices.pop()
        ctx = Context("cpu") if device.type == "cpu" else \
            Context("gpu", device.index or 0)
    else:
        ctx = current_context()
        device = ctx.torch_device()
    out = []
    for x in inputs:
        t = x._read() if isinstance(x, NDArray) else \
            x if isinstance(x, torch.Tensor) else \
            torch.as_tensor(onp.asarray(x), device=device)
        out.append(t.contiguous())
    return out, ctx


class RefKernel(object):
    """A user kernel over refs: ``kernel_fn(*input_refs, *output_refs)``.

    ``RefKernel(kernel_fn)(inputs, out_shapes, out_dtypes=None)`` returns
    the outputs as NDArrays on the inputs' device. ``kernel_fn`` is a
    Python function (its source is checked, not its closure) or the text
    of one; the refs it writes are its outputs and must be its last
    parameters. ``interpret`` is accepted for scripts written for the JAX
    package and has no effect."""

    def __init__(self, kernel_fn, name="rtc_kernel"):
        if isinstance(kernel_fn, str):
            src = kernel_fn
        else:
            try:
                src = inspect.getsource(kernel_fn)
            except (OSError, TypeError) as e:
                raise MXNetError("rtc: the kernel's source is not available "
                                 "(%s); pass its text instead" % e)
            # the function alone, without its decorators
            lines = textwrap.dedent(src).splitlines()
            while lines and lines[0].lstrip().startswith("@"):
                lines.pop(0)
            src = "\n".join(lines)
        self.name = name
        self._ck = check_kernel(src)

    def __call__(self, inputs, out_shapes, out_dtypes=None, interpret=None):
        ins, ctx = _tensors(inputs)
        if out_dtypes is None:
            out_dtypes = [ins[0].dtype] * len(out_shapes)
        outs = [torch.empty(tuple(s), dtype=torch_dtype(d),
                            device=ins[0].device)
                for s, d in zip(out_shapes, out_dtypes)]
        _kernels.rtc_kernel(self._ck, ins, outs)
        return [NDArray(o, ctx=ctx) for o in outs]


# scripts written for the JAX package name the callable form so
PallasKernel = RefKernel


class Rtc(object):
    """Source-text API of ``mx.rtc.Rtc(name, inputs, outputs, kernel)``:
    the body binds the input and output names to ``<name>_ref`` refs in
    order. The given arrays' shapes and dtypes are checked here too."""

    def __init__(self, name, inputs, outputs, kernel):
        self.name = name
        self.input_names = [n for n, _ in inputs]
        self.output_names = [n for n, _ in outputs]
        args = ", ".join(["%s_ref" % n for n in self.input_names]
                         + ["%s_ref" % n for n in self.output_names])
        src = "def _kernel(%s):\n%s\n" % (
            args, textwrap.indent(textwrap.dedent(kernel), "    "))
        self._ck = check_kernel(src, n_in=len(inputs))
        arrays = [a for _, a in list(inputs) + list(outputs)]
        shapes = {tuple(a.shape) for a in arrays}
        if len(shapes) > 1:
            raise MXNetError("rtc: every ref must have one shape; got %s"
                             % sorted(shapes))
        for a in arrays:
            if torch_dtype(a.dtype) != torch.float32:
                raise MXNetError("rtc: dtype %s is not supported (float32 "
                                 "only)" % (a.dtype,))

    def push(self, inputs, outputs, grid_dims=None, block_dims=None):
        """Run the kernel and leave the results in ``outputs``. The grid
        and block dims are accepted for the API and ignored: the kernel
        plans its own grid."""
        ins, _ = _tensors(inputs)
        device = ins[0].device
        # an output already on the inputs' device is written in place
        outs = [o._read() if o._read().device == device
                and o._read().is_contiguous() else
                torch.empty(o.shape, dtype=o._read().dtype, device=device)
                for o in outputs]
        _kernels.rtc_kernel(self._ck, ins, outs)
        for o, r in zip(outputs, outs):
            if r is not o._read():
                o._write(r)
        return outputs
