"""Executor — eager evaluation of a bound Symbol on PyTorch.

PyTorch counterpart of ``mxnet_tpu/executor.py``. Where the JAX package
lowers the whole symbol to one jitted XLA program and differentiates it
with ``jax.vjp``, this executor walks the graph's topological order
eagerly, one registered op at a time, and differentiates with torch
autograd:

* ``forward(is_train=True)`` runs the graph with autograd recording on the
  arguments whose gradient is requested, and keeps the graph for
  ``backward``; ``forward(is_train=False)`` runs under ``no_grad``.
* ``backward`` takes ``torch.autograd.grad`` of the outputs (head
  gradients default to ones; loss ops ignore them) and writes the
  gradients honouring grad_req ``write``/``add``/``null``.
* aux states (BatchNorm moving stats) are written back after each
  training forward.

Segmented (rematerialised) and pipelined evaluation are not in this
slice of the port.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .registry import OpContext
from . import ndarray as nd

__all__ = ["Executor", "fuse_bn_relu"]


def fuse_bn_relu(symbol):
    """Graph pass: collapse BatchNorm→Activation(relu) pairs into one
    BatchNorm node carrying ``_fused_relu=True``.

    Rationale: the pair is the hottest pattern in conv nets, and fusing
    it routes training through the hand-written BatchNorm kernels
    (ops/nn.py _BNTrainCore) with the ReLU mask recomputed in-register
    during the backward — the post-activation tensor is
    never re-read (or saved) by the backward at all.  On an HBM-bound
    ResNet step this removes whole activation sweeps.

    Fusion applies only when the Activation is the *sole* consumer of
    the BatchNorm output (otherwise the pre-ReLU value is needed) and
    the BatchNorm does not expose mean/var (`output_mean_var`).  The
    rewrite builds new nodes; the input symbol is never mutated.  The
    fused node takes the Activation's name, so head/loss wiring and
    debug output names stay stable; the BatchNorm's parameter and aux
    Variables (gamma/beta/moving stats) are reused unchanged, so
    arg/aux lists and checkpoints are unaffected.
    """
    from .symbol import Symbol, _Node

    order = symbol._topo()
    n_cons = {}
    for nd in order:
        for (s, oi) in nd.inputs:
            key = (id(s), oi)
            n_cons[key] = n_cons.get(key, 0) + 1
    for (h, oi) in symbol._heads:
        key = (id(h), oi)
        n_cons[key] = n_cons.get(key, 0) + 1

    new_of = {}   # id(old node) -> new node
    fused_away = set()   # id(BatchNorm nodes absorbed into a fused node)

    def resolve(nd):
        return new_of.get(id(nd), nd)

    changed = False
    for nd in order:
        if nd.op is None:
            continue
        if (nd.op.name == "Activation"
                and nd.attrs.get("act_type", "relu") == "relu"
                and len(nd.inputs) == 1 and nd.inputs[0][1] == 0):
            src = nd.inputs[0][0]
            if (src.op is not None and src.op.name == "BatchNorm"
                    and id(src) not in fused_away
                    and n_cons.get((id(src), 0), 0) == 1
                    and not src.attrs.get("output_mean_var", False)
                    # never move a node across a placement boundary: the
                    # fused node carries the Activation's ctx_group, so
                    # the pair must agree (pipeline stages are split on
                    # per-node ctx_group — _split_pipeline_stages)
                    and src._attr_dict.get("ctx_group")
                    == nd._attr_dict.get("ctx_group")):
                b = resolve(src)
                fused = _Node(
                    b.op, nd.name,
                    attrs=dict(b.attrs, _fused_relu=True),
                    inputs=[(resolve(s), oi) for (s, oi) in b.inputs],
                    attr_dict=dict(nd._attr_dict),
                    auto_named=nd.auto_named)
                new_of[id(nd)] = fused
                fused_away.add(id(src))
                changed = True
                continue
        new_inputs = [(resolve(s), oi) for (s, oi) in nd.inputs]
        if any(a is not b for (a, _), (b, _) in zip(new_inputs, nd.inputs)):
            new_of[id(nd)] = _Node(
                nd.op, nd.name, attrs=nd.attrs, inputs=new_inputs,
                is_aux=nd.is_aux, attr_dict=nd._attr_dict,
                auto_named=nd.auto_named)
    if not changed:
        return symbol
    return Symbol([(resolve(h), oi) for (h, oi) in symbol._heads])


def _build_eval(symbol):
    """The symbol's DAG as a function
    (arg_vals, aux_vals, is_train) -> (outs, new_aux) over tensors."""
    order = symbol._topo()
    arg_nodes = [n for n in order if n.op is None and not n.is_aux]
    aux_nodes = [n for n in order if n.op is None and n.is_aux]
    op_nodes = [n for n in order if n.op is not None]
    heads = symbol._heads
    aux_ids = {id(n) for n in aux_nodes}

    def eval_fn(arg_vals, aux_vals, is_train):
        env = {}
        for n, v in zip(arg_nodes, arg_vals):
            env[(id(n), 0)] = v
        for n, v in zip(aux_nodes, aux_vals):
            env[(id(n), 0)] = v
        aux_out = {id(n): v for n, v in zip(aux_nodes, aux_vals)}
        octx = OpContext(is_train=is_train)
        for n in op_nodes:
            res = n.op.fcompute(n.attrs, [env[(id(s), oi)]
                                          for (s, oi) in n.inputs], octx)
            n_out = n.op.num_outputs(n.attrs)
            for oi in range(n_out):
                env[(id(n), oi)] = res[oi]
            n_args = len(n.op.list_arguments(n.attrs))
            for (src, _), newv in zip(n.inputs[n_args:], res[n_out:]):
                if id(src) in aux_ids:
                    aux_out[id(src)] = newv.detach()
        outs = tuple(env[(id(n), oi)] for (n, oi) in heads)
        return outs, tuple(aux_out[id(n)] for n in aux_nodes)

    return eval_fn


class Executor:
    """Runnable binding of a Symbol to argument/gradient/aux NDArrays."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = ctx
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self.arg_names = arg_names
        self.aux_names = aux_names
        self.arg_arrays = self._normalize(args, arg_names, "args")
        self.aux_arrays = self._normalize(aux_states or [], aux_names,
                                          "aux_states")
        self.arg_dict = dict(zip(arg_names, self.arg_arrays))
        self.aux_dict = dict(zip(aux_names, self.aux_arrays))

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null") for n in arg_names}
        if args_grad is None:
            self.grad_arrays = [None] * len(arg_names)
        elif isinstance(args_grad, dict):
            self.grad_arrays = [args_grad.get(n) for n in arg_names]
        else:
            self.grad_arrays = list(args_grad) + \
                [None] * (len(arg_names) - len(args_grad))
        self.grad_dict = dict(zip(arg_names, self.grad_arrays))
        self._diff_idx = [i for i, n in enumerate(arg_names)
                          if self._grad_req.get(n, "null") != "null"
                          and self.grad_dict.get(n) is not None]

        self._eval_fn = _build_eval(symbol)
        _, out_shapes, _ = symbol.infer_shape(
            **{n: a.shape for n, a in self.arg_dict.items()})
        self.outputs = [nd.zeros(s, ctx=ctx) for s in out_shapes]
        self.output_dict = dict(zip(symbol.list_outputs(), self.outputs))
        self._graph = None   # (outputs, leaves) of the last train forward

    @staticmethod
    def _normalize(arrays, names, what):
        if isinstance(arrays, dict):
            missing = [n for n in names if n not in arrays]
            if missing:
                raise MXNetError("missing %s: %s" % (what, missing))
            return [arrays[n] for n in names]
        arrays = list(arrays)
        if len(arrays) != len(names):
            raise MXNetError("%s length %d != expected %d"
                             % (what, len(arrays), len(names)))
        return arrays

    def forward(self, is_train=False, **kwargs):
        """Run the graph; returns the output NDArrays. kwargs are copied
        into the bound input arrays first."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown input %s" % k)
            self.arg_dict[k][:] = v
        vals = [a._read() for a in self.arg_arrays]
        aux_vals = [a._read() for a in self.aux_arrays]
        self._graph = None
        if is_train and self._diff_idx:
            leaves = []
            for i in self._diff_idx:
                vals[i] = vals[i].detach().requires_grad_(True)
                leaves.append(vals[i])
            with torch.enable_grad():
                outs, new_aux = self._eval_fn(vals, aux_vals, True)
            self._graph = (outs, leaves)
        else:
            with torch.no_grad():
                outs, new_aux = self._eval_fn(vals, aux_vals, bool(is_train))
            if is_train:   # nothing to differentiate: backward is a no-op
                self._graph = ((), [])
        for o, v in zip(self.outputs, outs):
            o._t = v.detach()
        if is_train:
            for a, v in zip(self.aux_arrays, new_aux):
                if v is not a._t:
                    a._write(v)
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the last training forward, written into the grad
        arrays honouring grad_req write/add."""
        if self._graph is None:
            raise MXNetError("backward() needs a forward(is_train=True) "
                             "first")
        outs, leaves = self._graph
        self._graph = None
        if not leaves:
            return
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, nd.NDArray):
                out_grads = [out_grads]
            heads = [g._read() if isinstance(g, nd.NDArray) else
                     torch.as_tensor(g, device=o.device)
                     for g, o in zip(out_grads, outs)]
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    leaves, [h for _, h in pairs],
                                    allow_unused=True)
        for i, g in zip(self._diff_idx, grads):
            name = self.arg_names[i]
            buf = self.grad_dict[name]
            if g is None:
                g = torch.zeros_like(buf._read())
            if self._grad_req[name] == "add":
                buf._write(buf._read() + g)
            else:
                buf._write(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                arr.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise ValueError("Found name \"%s\" not in arguments" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                arr.copyto(self.aux_dict[name])
            elif not allow_extra_params:
                raise ValueError("Found name \"%s\" not in aux" % name)
