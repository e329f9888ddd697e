"""Imperative autograd (PyTorch counterpart of ``mxnet_tpu/autograd.py``).

The API of MXNet 0.9.5's ``contrib.autograd``: ``set_is_training``,
``train_section``/``test_section``, ``mark_variables``,
``backward``/``compute_gradient`` and ``grad_and_loss``.

``ndarray.invoke`` runs every op under ``torch.no_grad()`` and writes its
results into NDArrays in place, so torch's own graph cannot serve as the
tape. As in the JAX package, the tape is a list of nodes (op, attrs,
input references, key), one per imperative call made while recording.
An input reference is resolved when the op is recorded: the output of an
earlier node, a marked variable, or a constant (its value copied then).
``compute_gradient`` replays the tape from the marked variables, as
``requires_grad`` leaves under ``torch.enable_grad()``, and takes one
``torch.autograd.grad`` over the requested outputs; each op replays with
the context it was recorded with, so Dropout draws the same mask. The
gradients land in the paired buffers honouring ``write``/``add``/``null``.
The tape is thread-local.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["set_is_training", "is_training", "is_recording", "train_section",
           "test_section", "mark_variables", "backward", "compute_gradient",
           "grad_and_loss", "record_op"]

_state = threading.local()


def _st():
    if not hasattr(_state, "training"):
        _state.training = False
        _state.tape = []          # list of _Node, in call order
        _state.node_of = {}       # id(tensor) -> (node, output index)
        _state.marked = {}        # id(tensor) -> (NDArray, grad NDArray, req)
    return _state


class _Node:
    __slots__ = ("op", "attrs", "ins", "outs", "octx")

    def __init__(self, op, attrs, ins, outs, octx):
        self.op = op
        self.attrs = attrs
        self.ins = ins        # ("node", node, i) | ("var", id) | ("const", t)
        self.outs = outs      # the output tensors (kept alive: ids stay unique)
        self.octx = octx


def set_is_training(train_mode):
    """Turn training (and recording) on or off; returns the previous
    value. Turning it off drops the tape."""
    st = _st()
    prev = st.training
    st.training = bool(train_mode)
    if not train_mode:
        st.tape = []
        st.node_of = {}
    return prev


def is_training():
    return _st().training


def is_recording():
    return _st().training


@contextlib.contextmanager
def train_section():
    """Record ops and run them in training mode inside the block."""
    prev = set_is_training(True)
    try:
        yield
    finally:
        _st().training = prev


record = train_section


@contextlib.contextmanager
def test_section():
    """Run ops in inference mode (no recording) inside the block."""
    prev = set_is_training(False)
    try:
        yield
    finally:
        _st().training = prev


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark NDArrays as variables to take gradients for, each paired with
    its gradient buffer (MXAutogradMarkVariables)."""
    st = _st()
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        st.marked[id(var._read())] = (var, grad, req)


def _ref(st, arr):
    t = arr._read()
    ent = st.node_of.get(id(t))
    if ent is not None:
        return ("node",) + ent
    if id(t) in st.marked:
        return ("var", id(t))
    return ("const", t.detach().clone())


def record_op(op, attrs, inputs, outputs, octx=None):
    """Put one imperative call on the tape (``ndarray.invoke`` calls this
    while recording)."""
    st = _st()
    node = _Node(op, dict(attrs), [_ref(st, x) for x in inputs],
                 [o._read() for o in outputs], octx)
    st.tape.append(node)
    for i, t in enumerate(node.outs):
        st.node_of[id(t)] = (node, i)


def compute_gradient(outputs, out_grads=None, retain_graph=False):
    """Gradients of ``outputs`` with respect to every marked variable,
    written into the paired buffers (MXAutogradComputeGradient). Head
    gradients default to ones."""
    from .registry import OpContext

    st = _st()
    if not st.marked:
        raise ValueError("no variables marked for gradient")
    marked = list(st.marked.items())
    leaves = {vid: var._read().detach().clone().requires_grad_(True)
              for vid, (var, _, _) in marked}
    memo = {}

    def run(node):
        if id(node) not in memo:
            ins = [value(r) for r in node.ins]
            octx = node.octx or OpContext(is_train=True)
            memo[id(node)] = node.op.fcompute(node.attrs, ins, octx)
        return memo[id(node)]

    def value(r):
        if r[0] == "node":
            return run(r[1])[r[2]]
        if r[0] == "var":
            return leaves[r[1]]
        return r[1]

    with torch.enable_grad():
        outs = [value(_ref(st, o)) for o in outputs]
    if out_grads is None:
        heads = [torch.ones_like(o) for o in outs]
    else:
        heads = [g._read() if hasattr(g, "_read") else
                 torch.as_tensor(g, device=o.device)
                 for g, o in zip(out_grads, outs)]
    pairs = [(o, h.to(o.dtype)) for o, h in zip(outs, heads)
             if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs],
                                [leaves[vid] for vid, _ in marked],
                                [h for _, h in pairs], allow_unused=True) \
        if pairs else [None] * len(marked)
    for (vid, (var, gbuf, req)), g in zip(marked, grads):
        if req == "null" or gbuf is None:
            continue
        if g is None:
            g = torch.zeros_like(var._read())
        if req == "add":
            gbuf._write(gbuf._read() + g)
        else:
            gbuf._write(g)
    if not retain_graph:
        st.tape = []
        st.node_of = {}


backward = compute_gradient


def grad_and_loss(func, argnum=None):
    """A function that returns the gradients of ``func``'s summed outputs
    with respect to its arguments (all, or those at ``argnum``) and that
    sum (contrib.autograd.grad_and_loss, as the JAX package returns it).
    It records on a tape of its own, leaving the caller's untouched."""

    def wrapped(*args):
        from .ndarray import NDArray, zeros
        nums = tuple(range(len(args))) if argnum is None else \
            ((argnum,) if isinstance(argnum, int) else tuple(argnum))
        variables = [args[i] for i in nums]
        grads = [zeros(v.shape, ctx=v.context, dtype=v.dtype)
                 for v in variables]
        st = _st()
        saved = (st.training, st.tape, st.node_of, st.marked)
        st.tape, st.node_of, st.marked = [], {}, {}
        try:
            mark_variables(variables, grads)
            st.training = True
            out = func(*args)
            outs = out if isinstance(out, (list, tuple)) else [out]
            loss = sum(o._read().sum() for o in outs)
            compute_gradient(list(outs))
        finally:
            st.training, st.tape, st.node_of, st.marked = saved
        return grads, NDArray(loss.detach(), ctx=args[0].context)

    return wrapped
