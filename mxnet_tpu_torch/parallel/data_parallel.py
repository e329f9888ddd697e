"""The data-parallel train step over the process group (PyTorch
counterpart of ``mxnet_tpu/parallel/data_parallel.py``).

The JAX package compiles forward, backward, the cross-device gradient
``psum`` and the optimizer into one jitted program over a mesh whose
``dp`` axis shards the batch. Here every rank runs the step eagerly on
its row block of the global batch: forward and backward (BatchNorm
reducing its statistics over the global batch through the cross-rank
split of the hand-written kernel), one SUM all-reduce of the gradients
(the ``psum``; ``rescale_grad`` is 1/global batch), then the pure
per-parameter update, identical on every rank. Parameters and optimizer
state are replicated; ``init`` broadcasts rank 0's parameters.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import random as _random
from ..base import MXNetError
from ..executor import _build_eval
from ..precision.policy import index_inputs

__all__ = ["DataParallelTrainStep", "sgd_step_fn", "adam_step_fn"]


def sgd_step_fn(momentum=0.0, wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """(init_state, apply) of SGD, with momentum when ``momentum``: the
    fused-op math of ``ops/optimizer_ops.py``."""
    from ..ops.optimizer_ops import _sgd_update, _sgd_mom_update

    def init_state(p):
        return torch.zeros_like(p) if momentum else ()

    def apply(p, g, s, lr):
        attrs = {"lr": lr, "wd": wd, "rescale_grad": rescale_grad,
                 "momentum": momentum}
        if clip_gradient:
            attrs["clip_gradient"] = clip_gradient
        if momentum:
            new_p, new_s = _sgd_mom_update(attrs, [p, g, s], None)
            return new_p, new_s
        (new_p,) = _sgd_update(attrs, [p, g], None)
        return new_p, ()

    return init_state, apply


def adam_step_fn(beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                 rescale_grad=1.0, clip_gradient=None):
    """(init_state, apply) of Adam."""
    from ..ops.optimizer_ops import _adam_update

    def init_state(p):
        return (torch.zeros_like(p), torch.zeros_like(p))

    def apply(p, g, s, lr):
        attrs = {"lr": lr, "wd": wd, "rescale_grad": rescale_grad,
                 "beta1": beta1, "beta2": beta2, "epsilon": epsilon}
        if clip_gradient:
            attrs["clip_gradient"] = clip_gradient
        new_p, m, v = _adam_update(attrs, [p, g, s[0], s[1]], None)
        return new_p, (m, v)

    return init_state, apply


class DataParallelTrainStep:
    """One data-parallel train step of a loss-headed symbol.

    Parameters
    ----------
    symbol : Symbol
        The loss-headed network (e.g. a SoftmaxOutput head).
    mesh : parallel.mesh.Mesh
        A 'dp' mesh over the ranks (``data_parallel_mesh()``); its size
        must be the runtime's world size.
    step_fn : (init_state, apply) from :func:`sgd_step_fn` or
        :func:`adam_step_fn`.
    data_names / label_names : the inputs (not trained).
    context : Context, optional
        The rank's device (default: the current context).
    compute_dtype : optional
        Parameters stay float32 masters; the forward runs in this dtype
        (``torch.bfloat16``) and each gradient comes back as float32.
    """

    def __init__(self, symbol, mesh, step_fn, data_names=("data",),
                 label_names=("softmax_label",), dtype=onp.float32,
                 compute_dtype=None, context=None):
        from ..context import current_context
        from ..dist.runtime import get_runtime
        self.runtime = get_runtime()
        if mesh.size != self.runtime.size:
            raise MXNetError("the mesh spans %d devices but the world has "
                             "%d ranks" % (mesh.size, self.runtime.size))
        self.symbol = symbol
        self.mesh = mesh
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.input_names = list(data_names) + list(label_names)
        self.label_names = list(label_names)
        # labels and indices (index_inputs) stay float32 under compute_dtype
        self._keep_f32 = set(label_names) | index_inputs(symbol)
        self.param_names = [n for n in self.arg_names
                            if n not in self.input_names]
        self._eval_fn = _build_eval(symbol)
        self._needs_rng = self._eval_fn.needs_rng
        self._init_state, self._apply = step_fn
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.context = context or current_context()
        self.device = self.context.torch_device()

    def _scope(self):
        from ..ops.nn import cross_rank_bn
        return cross_rank_bn(self.runtime if self.runtime.size > 1
                             else None)

    # ------------------------------------------------------------------
    def init(self, initializer, data_shapes):
        """Infer shapes, run the initializer, place on the rank's device
        and broadcast rank 0's values. ``data_shapes`` are the rank's
        (local) input shapes. Returns (params, states, aux) dicts."""
        from .. import ndarray as nd
        from ..context import cpu
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**data_shapes)
        params, aux = {}, {}
        for name, shape in zip(self.arg_names, arg_shapes):
            if name in self.input_names:
                continue
            buf = nd.zeros(shape, ctx=cpu(), dtype=self.dtype)
            initializer(name, buf)
            params[name] = buf._read().to(self.device)
        for name, shape in zip(self.aux_names, aux_shapes):
            buf = nd.zeros(shape, ctx=cpu(), dtype=self.dtype)
            initializer(name, buf)
            aux[name] = buf._read().to(self.device)
        self.runtime.broadcast_tensors_(list(params.values())
                                        + list(aux.values()))
        states = {n: self._init_state(params[n]) for n in self.param_names}
        return params, states, aux

    def shard_batch(self, inputs):
        """Host dict of the GLOBAL batch -> this rank's row block of
        each input on its device."""
        from ..dist.staging import stage_sharded
        rt = self.runtime
        return {k: stage_sharded(v, self.device, None, rt.rank, rt.size)
                for k, v in inputs.items()}

    def _vals(self, params, inputs):
        cdt = self.compute_dtype
        vals = []
        for n in self.arg_names:
            v = params[n] if n in params else inputs[n]
            if cdt is not None and n not in self._keep_f32 and \
                    v.is_floating_point():
                v = v.to(cdt)
            vals.append(v)
        return vals

    def __call__(self, params, states, aux, inputs, lr):
        """One step: returns (new_params, new_states, new_aux, outputs)."""
        key = _random.next_key() if self._needs_rng else None
        leaves = {n: params[n].detach().requires_grad_(True)
                  for n in self.param_names}
        with self._scope(), torch.enable_grad():
            outs, new_aux = self._eval_fn(
                self._vals(leaves, inputs),
                [aux[n] for n in self.aux_names], True, key=key)
            heads = [torch.ones_like(o) for o in outs]
            pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
            names = list(leaves)
            got = torch.autograd.grad([o for o, _ in pairs],
                                      [leaves[n] for n in names],
                                      [h for _, h in pairs],
                                      allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None
                 else g.to(params[n].dtype) for n, g in zip(names, got)]
        self.runtime.allreduce_tensors_(grads)
        new_params, new_states = {}, {}
        with torch.no_grad():
            for n, g in zip(names, grads):
                new_params[n], new_states[n] = self._apply(
                    params[n], g, states[n], float(lr))
        new_aux_d = {n: v.detach() for n, v in zip(self.aux_names, new_aux)}
        return new_params, new_states, new_aux_d, \
            tuple(o.detach().float() for o in outs)

    def forward(self, params, aux, inputs):
        """An eval forward on the rank's rows."""
        key = _random.next_key() if self._needs_rng else None
        with torch.no_grad():
            outs, _ = self._eval_fn(self._vals(params, inputs),
                                    [aux[n] for n in self.aux_names],
                                    False, key=key)
        return tuple(o.float() for o in outs)
