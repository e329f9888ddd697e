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
  training forward;
* with a monitor callback installed (``set_monitor_callback``, as
  ``Monitor.install`` does) every op output is handed to it, while the
  monitor is active;
* ``reshape`` binds the symbol again at new input shapes, keeping every
  array whose shape does not change (the parameters).

``_build_eval_segmented`` is the rematerialising evaluator of the fused
route's ``remat`` policies (about √N segments under
``torch.utils.checkpoint``). Pipelined evaluation is not in this slice
of the port.

Randomness: an evaluator takes one key for the whole forward (``key=``,
from ``random.next_key``, drawn by the caller once per training forward
or step) and gives the i-th op node that ``needs_rng``, in topological
order, ``random.fold_in(key, i)``. The segmented evaluator hands each
segment its nodes' keys as arguments, and the ops draw from the key alone
(``random.key_uniform``), so the backward's replay of a segment draws the
masks of its first run: remat never changes a mask.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError
from .registry import OpContext
from . import ndarray as nd
from . import random as _random

__all__ = ["Executor", "fuse_bn_relu"]


def _run_node(n, env, octx, aux_ids, aux_sink, tap=None, key=None):
    """Evaluate op node ``n`` from ``env`` (slot -> tensor) into ``env``;
    hand each aux update to ``aux_sink(id, tensor)`` and each output to
    ``tap``. ``key`` is the node's key (``needs_rng`` ops only)."""
    if n.op.needs_rng:
        octx = OpContext(is_train=octx.is_train, device=octx.device, key=key)
    res = n.op.fcompute(n.attrs, [env[(id(s), oi)] for (s, oi) in n.inputs],
                        octx)
    n_out = n.op.num_outputs(n.attrs)
    for oi in range(n_out):
        env[(id(n), oi)] = res[oi]
    if tap is not None:
        if n_out == 1:
            tap("%s_output" % n.name, res[0])
        else:
            for oi in range(n_out):
                tap("%s_output%d" % (n.name, oi), res[oi])
    n_args = len(n.op.list_arguments(n.attrs))
    for (src, _), newv in zip(n.inputs[n_args:], res[n_out:]):
        if id(src) in aux_ids:
            aux_sink(id(src), newv.detach())


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


def _rng_ordinals(op_nodes):
    """{id(node): i} over the op nodes that draw, in topological order."""
    return {id(n): i for i, n in
            enumerate(n for n in op_nodes if n.op.needs_rng)}


def _node_keys(key, ordinals):
    """{id(node): its key} for one forward's ``key`` (none without one)."""
    if key is None:
        return {}
    return {nid: _random.fold_in(key, i) for nid, i in ordinals.items()}


def _build_eval(symbol):
    """The symbol's DAG as a function
    (arg_vals, aux_vals, is_train, tap=None, key=None) -> (outs, new_aux)
    over tensors. The function's ``needs_rng`` says whether any node
    draws (the caller then passes a key for a training forward)."""
    order = symbol._topo()
    arg_nodes = [n for n in order if n.op is None and not n.is_aux]
    aux_nodes = [n for n in order if n.op is None and n.is_aux]
    op_nodes = [n for n in order if n.op is not None]
    heads = symbol._heads
    aux_ids = {id(n) for n in aux_nodes}
    ordinals = _rng_ordinals(op_nodes)

    def eval_fn(arg_vals, aux_vals, is_train, tap=None, key=None):
        env = {}
        for n, v in zip(arg_nodes, arg_vals):
            env[(id(n), 0)] = v
        for n, v in zip(aux_nodes, aux_vals):
            env[(id(n), 0)] = v
        aux_out = {id(n): v for n, v in zip(aux_nodes, aux_vals)}
        # ops without inputs (_zeros) create on the arguments' device
        octx = OpContext(is_train=is_train,
                         device=arg_vals[0].device if arg_vals else None)
        keys = _node_keys(key, ordinals)
        for n in op_nodes:
            _run_node(n, env, octx, aux_ids, aux_out.__setitem__, tap,
                      keys.get(id(n)))
        outs = tuple(env[(id(n), oi)] for (n, oi) in heads)
        return outs, tuple(aux_out[id(n)] for n in aux_nodes)

    eval_fn.needs_rng = bool(ordinals)
    return eval_fn


def _build_eval_segmented(symbol, remat="full", n_segments=None):
    """Like :func:`_build_eval`, training only, with the op sequence split
    into about √N contiguous segments, each run under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: only the
    values that cross a segment boundary stay alive from the forward to
    the backward, and the backward replays one segment at a time (the
    JAX package's ``_build_eval_segmented``, with the same liveness
    plan, computed once here).

    ``remat`` is a canonical policy (``precision.canon_remat``):
    ``"full"`` recomputes everything inside a segment; ``"dots"`` and
    ``"bn_stats"`` keep convolution and matmul outputs through
    ``create_selective_checkpoint_contexts``; a callable is used as the
    selective-checkpoint policy itself.

    The aux updates (BatchNorm moving stats) are taken from the first
    forward only: ops compute them out of place and the segment returns
    them, so a segment the backward replays never applies the EMA
    again. Each segment takes its nodes' keys as arguments, so a replay
    draws the first run's masks (the keys of the plain evaluator). No
    monitor taps. The returned function carries ``segments``, the
    op-node names of each segment, and ``needs_rng``."""
    import functools

    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    from .precision.policy import remat_checkpoint_policy

    order = symbol._topo()
    op_nodes = [n for n in order if n.op is not None]
    n_ops = len(op_nodes)
    if n_ops == 0:
        # nothing to checkpoint: the plain evaluator is already optimal
        return _build_eval(symbol)
    arg_nodes = [n for n in order if n.op is None and not n.is_aux]
    aux_nodes = [n for n in order if n.op is None and n.is_aux]
    heads = symbol._heads
    aux_ids = {id(n) for n in aux_nodes}
    if n_segments is None:
        n_segments = max(1, int(math.ceil(math.sqrt(n_ops))))
    seg_size = int(math.ceil(n_ops / float(n_segments)))
    segments = [op_nodes[i:i + seg_size]
                for i in range(0, n_ops, seg_size)]

    # liveness: per segment, the slots it reads from before it and the
    # products read after it (or heads)
    head_slots = {(id(n), oi) for (n, oi) in heads}
    produced_in, consumed_in = {}, {}
    for si, seg in enumerate(segments):
        for n in seg:
            for oi in range(n.op.num_outputs(n.attrs)):
                produced_in[(id(n), oi)] = si
            for (src, oi) in n.inputs:
                consumed_in.setdefault((id(src), oi), set()).add(si)
    plan = []   # (segment, in_slots, out_slots, aux ids it updates)
    for si, seg in enumerate(segments):
        in_slots, seen = [], set()
        for n in seg:
            for (src, oi) in n.inputs:
                slot = (id(src), oi)
                if produced_in.get(slot, -1) != si and slot not in seen:
                    seen.add(slot)
                    in_slots.append(slot)
        out_slots, aux_updates = [], []
        for n in seg:
            for oi in range(n.op.num_outputs(n.attrs)):
                slot = (id(n), oi)
                if any(sj > si for sj in consumed_in.get(slot, ())) or \
                        slot in head_slots:
                    out_slots.append(slot)
            if n.op.aux_names:
                n_args = len(n.op.list_arguments(n.attrs))
                aux_updates.extend(id(src) for (src, _) in
                                   n.inputs[n_args:] if id(src) in aux_ids)
        plan.append((seg, tuple(in_slots), tuple(out_slots),
                     tuple(aux_updates)))

    ordinals = _rng_ordinals(op_nodes)
    seg_rng = [tuple(id(n) for n in seg if id(n) in ordinals)
               for seg in segments]
    policy = remat_checkpoint_policy(remat)
    kwargs = {"use_reentrant": False}
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)

    def eval_fn(arg_vals, aux_vals, is_train, tap=None, key=None):
        if tap is not None:
            raise MXNetError("segmented remat has no monitor taps")
        env = {}
        for n, v in zip(arg_nodes, arg_vals):
            env[(id(n), 0)] = v
        for n, v in zip(aux_nodes, aux_vals):
            env[(id(n), 0)] = v
        aux_out = {id(n): v for n, v in zip(aux_nodes, aux_vals)}
        octx = OpContext(is_train=is_train,
                         device=arg_vals[0].device if arg_vals else None)
        keys = _node_keys(key, ordinals)
        for (seg, in_slots, out_slots, aux_updates), rng_ids in zip(
                plan, seg_rng):

            def seg_fn(seg_keys, *in_vals, _seg=seg, _in=in_slots,
                       _out=out_slots, _upd=aux_updates):
                local = dict(zip(_in, in_vals))
                upd = {}
                for n in _seg:
                    _run_node(n, local, octx, aux_ids, upd.__setitem__,
                              key=seg_keys.get(id(n)))
                return (tuple(local[s] for s in _out)
                        + tuple(upd[a] for a in _upd))

            seg_keys = {i: keys[i] for i in rng_ids if i in keys}
            res = checkpoint(seg_fn, seg_keys, *[env[s] for s in in_slots],
                             **kwargs)
            for slot, v in zip(out_slots, res):
                env[slot] = v
            for aid, v in zip(aux_updates, res[len(out_slots):]):
                aux_out[aid] = v
        outs = tuple(env[(id(n), oi)] for (n, oi) in heads)
        return outs, tuple(aux_out[id(n)] for n in aux_nodes)

    eval_fn.segments = [[n.name for n in seg] for seg in segments]
    eval_fn.needs_rng = bool(ordinals)
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
        self._monitor_callback = None

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
        # one key per training forward; eval draws none
        key = _random.next_key() if is_train and self._eval_fn.needs_rng \
            else None
        self._graph = None
        tap = None
        if self._monitor_active():
            cb = self._monitor_callback

            def tap(name, val):
                cb(name, nd.NDArray(val.detach(), ctx=self._ctx,
                                    writable=False))
        if is_train and self._diff_idx:
            leaves = []
            for i in self._diff_idx:
                vals[i] = vals[i].detach().requires_grad_(True)
                leaves.append(vals[i])
            with torch.enable_grad():
                outs, new_aux = self._eval_fn(vals, aux_vals, True, tap,
                                              key)
            self._graph = (outs, leaves)
        else:
            with torch.no_grad():
                outs, new_aux = self._eval_fn(vals, aux_vals, bool(is_train),
                                              tap, key)
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

    def debug_str(self):
        """The graph as the reference's debug string: the outputs, then
        each op node in evaluation order."""
        lines = ["Symbol outputs: %s"
                 % ", ".join(self._symbol.list_outputs())]
        for n in self._symbol._topo():
            if n.op is not None:
                lines.append("Op:%s, Name=%s" % (n.op.name, n.name))
        lines.append("Memory planning: delegated to PyTorch's caching "
                     "allocator")
        return "\n".join(lines)

    def set_monitor_callback(self, callback):
        """Hand every op output of later forwards to
        ``callback(name, NDArray)``."""
        self._monitor_callback = callback

    def _monitor_active(self):
        cb = self._monitor_callback
        if cb is None:
            return False
        # a Monitor gates its taps with ``activated`` (tic/toc); a plain
        # callable taps every forward
        return getattr(getattr(cb, "__self__", None), "activated",
                       True) is not False

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor bound at the input shapes in ``kwargs``.

        An array whose shape does not change is the same array in the
        new executor (parameters, their gradients, aux states). As in
        the reference, an array not named in ``kwargs`` may change shape
        only with ``partial_shaping``; one that grows needs
        ``allow_up_sizing`` and is allocated anew; one that does not
        grow becomes a view of the old array's storage."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def resize(name, new_shape, arr, specified):
            new_shape = tuple(new_shape)
            if arr.shape == new_shape:
                return arr
            if not (partial_shaping or specified):
                raise MXNetError(
                    "Shape of unspecified array %s changed. This can cause "
                    "the new executor to not share parameters with the old "
                    "one. Set partial_shaping=True if intended." % name)
            n = math.prod(new_shape)
            if n > arr.size:
                if not allow_up_sizing:
                    raise MXNetError(
                        "New shape of %s larger than original; set "
                        "allow_up_sizing=True to allocate a new array."
                        % name)
                return nd.zeros(new_shape, ctx=arr.context, dtype=arr.dtype)
            return nd.NDArray(arr._read().reshape(-1)[:n].view(new_shape),
                              ctx=arr.context)

        new_args, grads = {}, None
        if any(g is not None for g in self.grad_arrays):
            grads = {}
        for name, new_shape, arr in zip(self.arg_names, arg_shapes,
                                        self.arg_arrays):
            new_args[name] = resize(name, new_shape, arr, name in kwargs)
            g = self.grad_dict.get(name)
            if g is not None:
                grads[name] = resize("grad of " + name, new_shape, g,
                                     name in kwargs)
        new_aux = {name: resize(name, new_shape, arr, True)
                   for name, new_shape, arr in zip(
                       self.aux_names, aux_shapes, self.aux_arrays)}
        ex = Executor(self._symbol, self._ctx, new_args, grads,
                      self._grad_req, new_aux)
        ex._monitor_callback = self._monitor_callback
        return ex

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
