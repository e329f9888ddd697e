"""Torch bridge (python/mxnet/torch.py / plugin/torch in the reference; the
port's counterpart of ``mxnet_tpu/torch.py``), exported as ``mx.torch``.

The reference bridges Lua-torch modules and criterions into the symbolic
graph as the ``TorchModule`` / ``TorchCriterion`` ops: ``lua_string``
constructs an ``nn`` module whose parameters become graph arguments.
Here, as in the JAX package, ``lua_string`` is a PyTorch constructor
expression evaluated with ``nn``/``torch``/``F`` bound (``"nn.Linear(4,
3)"`` works verbatim for the constructors Lua-nn and torch.nn share).
The JAX package runs the module on the host through a callback; the port
runs it where the op's tensors are, through ``torch.func.
functional_call`` with the graph's parameter tensors, so autograd goes
straight through it and its parameters live on the card.

The JAX package's semantics:

* ``TorchModule(lua_string, num_data, num_params, num_outputs)`` —
  arguments ``data_0..`` then the module's parameter names
  (``named_parameters()``, dots -> underscores, as the reference's
  ListArguments maps Lua fields).
* ``TorchCriterion(lua_string, label_shape, grad_scale)`` — inputs
  (data, label); output shape ``(batch,)`` filled with the scalar
  ``loss * grad_scale``; its backward feeds ``dloss/dpred * grad_scale``
  and ignores the head gradient (a loss head, as SoftmaxOutput).

A training forward of a ``TorchModule`` draws from torch's generator
seeded from the node's key (``random.key_generator``'s seed), so a
stochastic layer (Dropout) repeats bit for bit on one device. A module's
buffers (BatchNorm's running statistics) live in the cached module, not
in the graph: use the native BatchNorm for layers with statistics.
"""
from __future__ import annotations

import contextlib

import torch

from .base import MXNetError
from .registry import register as _register

__all__ = ["pytorch_function"]

_MOD_CACHE = {}


def _build(lua_string):
    """Construct (and cache) the module of a constructor expression,
    evaluated with ``nn``/``torch``/``F`` bound."""
    if lua_string not in _MOD_CACHE:
        ns = {"nn": torch.nn, "torch": torch, "F": torch.nn.functional}
        try:
            m = eval(lua_string, ns)  # noqa: S307 — the reference runs
            # lua_string in a Lua VM the same way; the string is the
            # user's own model definition
        except Exception as e:
            raise MXNetError("TorchModule: constructor %r failed: %s"
                             % (lua_string, e))
        if not isinstance(m, torch.nn.Module):
            raise MXNetError("TorchModule: %r did not produce an "
                             "nn.Module" % (lua_string,))
        _MOD_CACHE[lua_string] = m.float()
    return _MOD_CACHE[lua_string]


def _on(m, device):
    """The cached module with its buffers on ``device``."""
    for b in m.buffers():
        if b.device != device:
            return m.to(device)
        break
    return m


def _param_names(m):
    return [n.replace(".", "_") for n, _ in m.named_parameters()]


def _tm_args(attrs):
    names = ["data_%d" % i for i in range(int(attrs.get("num_data", 1)))]
    try:
        names += _param_names(_build(attrs["lua_string"]))
    except (MXNetError, KeyError):
        names += ["param_%d" % i
                  for i in range(int(attrs.get("num_params", 0)))]
    return tuple(names)


def _probe(m, shapes):
    """The module's outputs for data of ``shapes`` (eval mode), computed
    on the ``meta`` device: shapes only, no arithmetic anywhere."""
    meta = {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
            for n, t in list(m.named_parameters()) +
            list(m.named_buffers())}
    was_training = m.training
    m.train(False)
    try:
        with torch.no_grad():
            outs = torch.func.functional_call(
                m, meta, tuple(torch.empty(s, device="meta")
                               for s in shapes))
    finally:
        m.train(was_training)
    return outs if isinstance(outs, (tuple, list)) else (outs,)


def _tm_infer(attrs, in_shapes, aux):
    n_data = int(attrs["num_data"])
    m = _build(attrs["lua_string"])
    params = list(m.parameters())
    if len(params) != int(attrs["num_params"]):
        raise MXNetError(
            "TorchModule: num_params=%s but %r has %d parameters"
            % (attrs["num_params"], attrs["lua_string"], len(params)))
    for i, p in enumerate(params):
        in_shapes[n_data + i] = tuple(p.shape)
    if any(in_shapes[i] is None for i in range(n_data)):
        return in_shapes, None, aux
    outs = _probe(m, in_shapes[:n_data])
    if len(outs) != int(attrs["num_outputs"]):
        raise MXNetError(
            "TorchModule: num_outputs=%s but %r produced %d outputs"
            % (attrs["num_outputs"], attrs["lua_string"], len(outs)))
    return in_shapes, [tuple(o.shape) for o in outs], aux


def _seeded(key, device):
    """torch's generator on ``device`` seeded from ``key`` for the block,
    restored after it; a no-op without a key."""
    if key is None:
        return contextlib.nullcontext()
    from .random import key_generator
    seed = key_generator(key, "cpu").initial_seed()
    devices = [device] if device.type == "cuda" else []

    @contextlib.contextmanager
    def block():
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(seed)
            yield

    return block()


@_register("TorchModule", arg_names=_tm_args,
           num_outputs=lambda attrs: int(attrs["num_outputs"]),
           infer_shape=_tm_infer, needs_rng=True,
           attr_types={"lua_string": str, "num_data": int,
                       "num_params": int, "num_outputs": int})
def _torch_module(attrs, ins, octx):
    """The module applied to ``data_0..`` with the graph's parameter
    tensors, on their device; gradients by autograd."""
    n_data = int(attrs["num_data"])
    m = _build(attrs["lua_string"])
    if ins[0].device.type == "meta":
        return [torch.empty(s, device="meta")
                for s in (tuple(o.shape) for o in _probe(
                    m, [tuple(x.shape) for x in ins[:n_data]]))]
    m = _on(m, ins[0].device)
    names = [n for n, _ in m.named_parameters()]
    params = dict(zip(names, ins[n_data:]))
    m.train(bool(octx.is_train))
    with _seeded(octx.key if octx.is_train else None, ins[0].device):
        outs = torch.func.functional_call(m, params, tuple(ins[:n_data]))
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return [o.float() if o.is_floating_point() else o for o in outs]


def _tc_infer(attrs, in_shapes, aux):
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, None, aux
    lshape = tuple(attrs.get("label_shape", ()) or ())
    in_shapes[1] = (dshape[0],) + lshape
    return in_shapes, [(dshape[0],)], aux


def _apply(crit, pred, label):
    """``crit(pred, label)``: class-index criterions (NLLLoss,
    CrossEntropyLoss) want Long targets, regression ones Float; decided
    once per criterion (cached on it), and only a dtype complaint
    triggers the Long retry."""
    lab = label.float()
    wants_long = getattr(crit, "_mxtorch_wants_long", None)
    if wants_long:
        return crit(pred, lab.long())
    try:
        out = crit(pred, lab)
        crit._mxtorch_wants_long = False
        return out
    except RuntimeError as e:
        if wants_long is None and any(
                w in str(e) for w in ("Long", "dtype", "'Float'")):
            out = crit(pred, lab.long())
            crit._mxtorch_wants_long = True
            return out
        raise


class _Criterion(torch.autograd.Function):
    """The loss broadcast to ``(batch,)`` times ``scale``; its backward is
    ``dloss/dpred * scale`` whatever the head gradient."""

    @staticmethod
    def forward(ctx, pred, label, crit, scale):
        with torch.enable_grad():
            p = pred.detach().float().requires_grad_(True)
            loss = _apply(crit, p, label)
            (g,) = torch.autograd.grad(loss, (p,))
        ctx.save_for_backward((g * scale).to(pred.dtype))
        ctx.label_shape = label.shape
        return torch.full((pred.shape[0],), float(loss.detach()) * scale,
                          dtype=torch.float32, device=pred.device)

    @staticmethod
    def backward(ctx, _):
        (g,) = ctx.saved_tensors
        return g, None, None, None


@_register("TorchCriterion", arg_names=("data", "label"),
           infer_shape=_tc_infer,
           attr_types={"lua_string": str, "label_shape": tuple,
                       "grad_scale": float})
def _torch_criterion(attrs, ins, octx):
    pred, label = ins
    if pred.device.type == "meta":
        return [torch.empty((pred.shape[0],), device="meta")]
    crit = _on(_build(attrs["lua_string"]), pred.device)
    scale = float(attrs.get("grad_scale", 1.0))
    return [_Criterion.apply(pred, label, crit, scale)]


def pytorch_function(fn, name="torch_fn"):
    """Wrap a PyTorch callable as an imperative NDArray function: it
    receives the arrays' tensors where they are and its tensors come back
    as NDArrays on the first array's context."""
    from .context import cpu
    from .ndarray import NDArray

    def wrapped(*args):
        ctx = next((a.context for a in args if isinstance(a, NDArray)),
                   cpu())
        t_args = [a._read() if isinstance(a, NDArray) else a for a in args]
        out = fn(*t_args)
        if isinstance(out, (list, tuple)):
            return [NDArray(o.detach(), ctx=ctx) for o in out]
        return NDArray(out.detach(), ctx=ctx)

    wrapped.__name__ = name
    return wrapped
