"""Test oracles (PyTorch counterpart of ``mxnet_tpu/test_utils.py``).

The contracts of MXNet 0.9.5's ``test_utils``: numpy is the ground truth
(``check_numeric_gradient`` by finite differences,
``check_symbolic_forward``/``backward``), and ``check_consistency`` runs
one symbol on a list of contexts and dtypes and holds outputs and
gradients to the most precise one (the CPU against the card).
``check_speed`` times forward (+ backward) by the host clock after
``nd.waitall()``. Arrays are made on the context under test.
"""
from __future__ import annotations

import time

import numpy as onp

from . import context as ctx_mod
from . import ndarray as nd

__all__ = ["default_context", "assert_almost_equal", "same", "rand_ndarray",
           "random_arrays", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward",
           "check_consistency", "check_speed", "simple_forward",
           "numeric_grad", "reldiff"]

_default_ctx = None


def default_context():
    """The context tests run on: the one set, else the current one."""
    global _default_ctx
    if _default_ctx is None:
        return ctx_mod.current_context()
    return _default_ctx


def set_default_context(ctx):
    global _default_ctx
    _default_ctx = ctx


def same(a, b):
    return onp.array_equal(a, b)


def reldiff(a, b):
    diff = onp.sum(onp.abs(a - b))
    norm = onp.sum(onp.abs(a)) + onp.sum(onp.abs(b))
    if diff == 0:
        return 0
    return diff / norm


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-8, names=("a", "b")):
    a = a.asnumpy() if isinstance(a, nd.NDArray) else onp.asarray(a)
    b = b.asnumpy() if isinstance(b, nd.NDArray) else onp.asarray(b)
    onp.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                err_msg="%s and %s differ" % names)


def random_arrays(*shapes):
    arrays = [onp.random.randn(*s).astype(onp.float32) for s in shapes]
    if len(arrays) == 1:
        return arrays[0]
    return arrays


def rand_ndarray(shape, ctx=None, dtype=onp.float32):
    return nd.array(onp.random.uniform(-1.0, 1.0, shape), ctx=ctx,
                    dtype=dtype)


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """Bind, run the forward and return the outputs as numpy arrays."""
    ctx = ctx or default_context()
    inputs = {k: nd.array(v, ctx=ctx) if not isinstance(v, nd.NDArray)
              else v for k, v in inputs.items()}
    ex = sym.simple_bind(ctx, grad_req="null",
                         **{k: v.shape for k, v in inputs.items()})
    for k, v in inputs.items():
        v.copyto(ex.arg_dict[k])
    ex.forward(is_train=is_train)
    outputs = [x.asnumpy() for x in ex.outputs]
    if len(outputs) == 1:
        return outputs[0]
    return outputs


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """Finite-difference gradients of the executor's summed outputs with
    respect to each array of ``location``."""
    for k, v in location.items():
        executor.arg_dict[k][:] = v
    approx_grads = {k: onp.zeros(v.shape, dtype=onp.float32)
                    for k, v in location.items()}

    executor.forward(is_train=use_forward_train)
    f_x = sum(out.asnumpy().sum() for out in executor.outputs)

    for k in location:
        old_value = location[k].copy()
        flat = old_value.reshape(-1)
        grad_flat = approx_grads[k].reshape(-1)
        for i in range(flat.size):
            flat[i] += eps
            executor.arg_dict[k][:] = old_value.reshape(location[k].shape)
            executor.forward(is_train=use_forward_train)
            f_eps = sum(out.asnumpy().sum() for out in executor.outputs)
            grad_flat[i] = (f_eps - f_x) / eps
            flat[i] -= eps
        executor.arg_dict[k][:] = old_value
    return approx_grads


def check_numeric_gradient(sym, location, aux_states=None,
                           numeric_eps=1e-3, rtol=1e-2, atol=None,
                           grad_nodes=None, use_forward_train=True, ctx=None):
    """Hold the executor's backward to finite differences (relative
    difference within ``rtol``)."""
    ctx = ctx or default_context()
    location = {k: onp.asarray(v, dtype=onp.float32)
                for k, v in location.items()}
    if grad_nodes is None:
        grad_nodes = list(location.keys())

    input_shapes = {k: v.shape for k, v in location.items()}
    arg_shapes, _, aux_shapes = sym.infer_shape(**input_shapes)
    arg_names = sym.list_arguments()

    args = {}
    args_grad = {}
    for name, shape in zip(arg_names, arg_shapes):
        args[name] = nd.array(
            location.get(name, onp.random.randn(*shape)), ctx=ctx)
        if name in grad_nodes:
            args_grad[name] = nd.zeros(shape, ctx=ctx)
    aux = [nd.zeros(s, ctx=ctx) for s in aux_shapes]
    if aux_states:
        for name, val in aux_states.items():
            idx = sym.list_auxiliary_states().index(name)
            aux[idx][:] = val

    executor = sym.bind(ctx, args, args_grad=args_grad, grad_req="write",
                        aux_states=aux)
    executor.forward(is_train=True)
    executor.backward()
    symbolic_grads = {k: executor.grad_dict[k].asnumpy()
                      for k in grad_nodes}

    check_loc = {k: args[k].asnumpy() for k in grad_nodes}
    numeric_gradients = numeric_grad(executor, check_loc, eps=numeric_eps,
                                     use_forward_train=use_forward_train)
    for name in grad_nodes:
        fd_grad = numeric_gradients[name]
        sym_grad = symbolic_grads[name]
        rel = reldiff(fd_grad, sym_grad)
        assert rel <= rtol, \
            "numeric check failed for %s: relative diff %g > %g\nfd=%s\n" \
            "sym=%s" % (name, rel, rtol, fd_grad, sym_grad)


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=1e-8,
                           aux_states=None, ctx=None):
    """Hold the forward outputs to the expected numpy arrays."""
    ctx = ctx or default_context()
    if isinstance(location, (list, tuple)):
        location = dict(zip(sym.list_arguments(), location))
    args = {k: nd.array(v, ctx=ctx) for k, v in location.items()}
    arg_shapes, _, aux_shapes = sym.infer_shape(
        **{k: v.shape for k, v in location.items()})
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name not in args:
            args[name] = nd.zeros(shape, ctx=ctx)
    aux = [nd.zeros(s, ctx=ctx) for s in aux_shapes]
    if aux_states is not None:
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(sym.list_auxiliary_states(), aux_states))
        for name, val in aux_states.items():
            idx = sym.list_auxiliary_states().index(name)
            aux[idx][:] = val
    executor = sym.bind(ctx, args, aux_states=aux, grad_req="null")
    executor.forward(is_train=False)
    for out, exp in zip(executor.outputs, expected):
        assert_almost_equal(out.asnumpy(), exp, rtol=rtol, atol=atol)
    return [o.asnumpy() for o in executor.outputs]


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=1e-8, aux_states=None, grad_req="write",
                            ctx=None):
    """Hold the backward's gradients to the expected numpy arrays."""
    ctx = ctx or default_context()
    if isinstance(location, (list, tuple)):
        location = dict(zip(sym.list_arguments(), location))
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(sym.list_arguments(), expected))
    args = {k: nd.array(v, ctx=ctx) for k, v in location.items()}
    args_grad = {k: nd.zeros(v.shape, ctx=ctx)
                 for k, v in location.items()}
    arg_shapes, _, aux_shapes = sym.infer_shape(
        **{k: v.shape for k, v in location.items()})
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name not in args:
            args[name] = nd.zeros(shape, ctx=ctx)
            args_grad[name] = nd.zeros(shape, ctx=ctx)
    aux = [nd.zeros(s, ctx=ctx) for s in aux_shapes]
    executor = sym.bind(ctx, args, args_grad=args_grad, grad_req=grad_req,
                        aux_states=aux)
    executor.forward(is_train=True)
    if out_grads is not None:
        out_grads = [nd.array(v, ctx=ctx) if not isinstance(v, nd.NDArray)
                     else v for v in out_grads]
    executor.backward(out_grads)
    for name, exp in expected.items():
        assert_almost_equal(executor.grad_dict[name].asnumpy(), exp,
                            rtol=rtol, atol=atol, names=("grad " + name,
                                                         "expected"))
    return {k: v.asnumpy() if v is not None else None
            for k, v in executor.grad_dict.items()}


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True):
    """Run one symbol on each context/dtype of ``ctx_list`` from the same
    random parameters and hold every output and gradient to those of the
    most precise dtype (``tol`` by dtype)."""
    if tol is None:
        tol = {onp.dtype(onp.float16): 1e-1, onp.dtype(onp.float32): 1e-3,
               onp.dtype(onp.float64): 1e-5}
    assert len(ctx_list) > 1

    executors = []
    for spec in ctx_list:
        spec = dict(spec)
        ctx = spec.pop("ctx")
        type_dict = spec.pop("type_dict", {})
        exe = sym.simple_bind(ctx, grad_req=grad_req, type_dict=type_dict,
                              **spec)
        executors.append(exe)

    # one random init shared by every executor
    exe0 = executors[0]
    inits = {}
    for name, arr in exe0.arg_dict.items():
        if arg_params and name in arg_params:
            inits[name] = onp.asarray(arg_params[name])
        else:
            inits[name] = onp.random.normal(
                size=arr.shape, scale=scale).astype(onp.float32)
    aux_inits = {}
    for name, arr in exe0.aux_dict.items():
        if aux_params and name in aux_params:
            aux_inits[name] = onp.asarray(aux_params[name])
        else:
            aux_inits[name] = onp.zeros(arr.shape, dtype=onp.float32)

    for exe in executors:
        for name, val in inits.items():
            exe.arg_dict[name][:] = val.astype(exe.arg_dict[name].dtype)
        for name, val in aux_inits.items():
            exe.aux_dict[name][:] = val.astype(exe.aux_dict[name].dtype)
        exe.forward(is_train=(grad_req != "null"))
        if grad_req != "null":
            exe.backward()

    dtypes = [onp.dtype(exe.outputs[0].dtype) for exe in executors]
    max_idx = onp.argmax([onp.finfo(d).precision if d.kind == "f" else 0
                          for d in dtypes])
    gt_exe = executors[max_idx]
    for i, exe in enumerate(executors):
        if i == max_idx:
            continue
        rtol = tol[dtypes[i]]
        for o_gt, o in zip(gt_exe.outputs, exe.outputs):
            try:
                assert_almost_equal(o.asnumpy().astype(onp.float64),
                                    o_gt.asnumpy().astype(onp.float64),
                                    rtol=rtol, atol=rtol)
            except AssertionError:
                if raise_on_err:
                    raise
        if grad_req != "null":
            for name in exe.grad_dict:
                g = exe.grad_dict[name]
                g_gt = gt_exe.grad_dict[name]
                if g is None or g_gt is None:
                    continue
                try:
                    assert_almost_equal(g.asnumpy().astype(onp.float64),
                                        g_gt.asnumpy().astype(onp.float64),
                                        rtol=rtol, atol=rtol)
                except AssertionError:
                    if raise_on_err:
                        raise
    return [exe.outputs for exe in executors]


def check_speed(sym, location=None, ctx=None, N=20, grad_req="write",
                typ="whole", **kwargs):
    """Seconds per forward (``typ="forward"``) or forward + backward
    (``"whole"``), over ``N`` runs after one warm-up run."""
    ctx = ctx or default_context()
    if location is None:
        arg_shapes, _, _ = sym.infer_shape(**kwargs)
        location = {name: onp.random.normal(size=shape, scale=1.0)
                    for name, shape in zip(sym.list_arguments(), arg_shapes)}
    else:
        kwargs = {k: v.shape for k, v in location.items()}
    exe = sym.simple_bind(ctx, grad_req=grad_req, **kwargs)
    for name, value in location.items():
        exe.arg_dict[name][:] = value

    if typ == "whole":
        # warm up
        exe.forward(is_train=True)
        exe.backward()
        for o in exe.outputs:
            o.wait_to_read()
        tic = time.time()
        for _ in range(N):
            exe.forward(is_train=True)
            exe.backward()
        nd.waitall()
        for o in exe.outputs:
            o.wait_to_read()
        toc = time.time()
        return (toc - tic) / N
    elif typ == "forward":
        exe.forward(is_train=False)
        for o in exe.outputs:
            o.wait_to_read()
        tic = time.time()
        for _ in range(N):
            exe.forward(is_train=False)
            for o in exe.outputs:
                o.wait_to_read()
        toc = time.time()
        return (toc - tic) / N
    else:
        raise ValueError("typ can only be whole or forward")
