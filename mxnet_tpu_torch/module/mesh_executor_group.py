"""MeshExecutorGroup — the fused one-program training route (PyTorch
counterpart of ``mxnet_tpu/module/mesh_executor_group.py``), on one
device.

The JAX package runs a training step as ONE jitted XLA program:
forward, backward, optimizer and the metric tally, with nothing read back
to the host. Here the step is one Python function over tensors,
``_step_math``, run eagerly on the card:

* ``forward(is_train=True)`` only stages the batch (one host→card copy
  per input into the bound input tensors). ``backward()`` defers too
  when an optimizer is attached. ``update()`` then runs
  :meth:`step_update`: forward, backward (torch autograd), the
  optimizer's pure per-parameter apply (``Updater.fused_apply_or_none``)
  and the metric tally, in that one function. The lr and wd of every
  parameter travel to the card in one copy; nothing is read back.
* A read of the outputs or gradients before ``update()`` runs the
  deferred work at once (the arrays carry a ``force`` hook, as the JAX
  package's lazy chunks do): outputs materialise a train forward (the
  BatchNorm moving-stat EMA applied once, from a snapshot the step later
  re-runs from), gradients a forward + backward, after which ``update()``
  takes the classic update route. A forward that supersedes a deferred
  one runs it first, so no batch is dropped.
* Precision: parameters stay float32 masters; under
  ``compute_dtype="bfloat16"`` they, and every input but the labels and
  the indices (an Embedding's token ids), are cast to bfloat16 INSIDE the
  autograd graph, so each gradient reaches its master as float32. Outputs come back as float32. A policy with a loss
  scale keeps a (scale, good steps, skipped) triple on the device:
  scaled head gradients, unscaled float32 gradients, and an update that
  is skipped, on the device, when a gradient is not finite. An
  ``act_cast`` policy (``int8_act``, ``fp8``, ``int8_serve``,
  ``fp8_native``) round-trips every input but those through its
  narrow format after that cast, and an eval forward runs inside the
  policy's GEMM scope (``precision.quant``).
* ``remat`` trains through ``executor._build_eval_segmented``.
* Keys (nets with Dropout or ``rrelu``): ``forward(is_train=True)``
  draws one ``random.next_key()``, which the deferred step, a
  materialised forward and the forward + backward all use, so the
  classic route (one key per ``Executor.forward``) draws the same masks;
  a grouped step draws one key and splits it into K; eval, ``predict``,
  ``score`` and ``score_stacked`` draw none. A net without such ops
  draws nothing.
* Data parallelism (``_dp``, a ``dist.DistRuntime`` of R ranks set by
  ``Module.bind``): the group holds this rank's row block; every
  training forward and
  backward runs inside ``ops.nn.cross_rank_bn`` (BatchNorm over the
  global batch) and, unless a ``dist_async`` store reduces instead,
  ``_grads_of`` sums the gradients over the ranks in one all-reduce per
  dtype, the JAX step's ``psum``.
* :meth:`step_update_grouped` runs K whole steps in one call over a
  (K, batch, ...) block staged with one copy per input, each step with
  its own lr row; K sequential steps give the same bits.
* The device metric tally (:meth:`enable_device_metric`,
  :meth:`score_device`): the metric's ``fused_stat`` rows add into a
  (sums float32, counts int32) pair on the device; the metric reads it
  back once.
* The guardian's health word (:meth:`enable_health`): a (flags int32,
  first_bad int32, count int32, loss ring float32) word on the device
  that every step folds its observation into, as the loss-scale triple
  rides — non-finite loss, gradients or updated parameters set a flag
  bit, ``first_bad`` keeps the step ordinal of the first bad one and the
  ring the step's loss scalar; :meth:`health_poll` is its only readback,
  at the epoch or commit boundary. A skipped overflow step of the loss
  scaler has non-finite gradients and sets its flag, as in the JAX
  package. With ``probe_period=N`` every N-th step (a grouped step
  counts as one) also runs a second time from copies of the same
  parameters, states, aux and staged inputs, and the two runs' updated
  parameters are compared bitwise on the device (the SDC probe).
* Programs: each (kind, input shapes) pair's first run is this route's
  "compile" (cuDNN picks its algorithms, the allocator grows). It is
  reported to an attached ``telemetry.CompileWatch`` and, while
  telemetry is enabled, counted (``telemetry.introspect``: FLOPs and
  bytes) into the process ``ProgramInventory``, whose train-step entry
  is the live roofline's basis (:meth:`roofline_basis`).

Storage, shapes, ``reshape``, ``set_params``/``get_params`` and
``shared_group`` are the classic group's (this class extends
``DataParallelExecutorGroup``), so parameter tensors keep their storage
across reshapes and serving buckets share them. Monitors need per-op taps
and ``Module.install_monitor`` moves to the classic group for them, as in
the JAX package.

Device augmentation (``device_augment={name: data.DeviceAugment}``):
the bound data input keeps its model view (float32 NCHW) while
``data_shapes`` lists the wire entries (the uint8 NHWC block and its crop
and mirror parameter inputs), which is what batches carry. At staging
(``_stage``, ``stage_stacked``) the wire block and its parameters go to
the device and ``_apply_device_augment`` turns them into the float32
batch, as its own call outside ``_step_math``: the step computes on the
same tensor a host-augmented feed would copy in. Tensors already on the
device (a ``DeviceLoader`` batch) are copied on the device, never read
back.

Left for later slices of the port (each refused where it is asked for):
mesh axes, parameter sharding and pipeline microbatches, CUDA-graph
capture of the step. ``MXNET_XLA_COMPILER_OPTIONS`` is XLA's own and has
no counterpart.
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as onp
import torch

from .. import faults as _faults
from .. import ndarray as nd
from .. import random as _random
from .. import telemetry
from ..base import MXNetError
from ..data.augment import crop_input_name, mirror_input_name, unwrap
from ..executor import _build_eval_segmented
from ..precision.policy import (fake_cast, index_inputs, loss_scale_config,
                                state_np_dtype)
from ..precision.quant import trace_gemm_scope
from .executor_group import DataParallelExecutorGroup

__all__ = ["MeshExecutorGroup", "HEALTH_LOSS_NONFINITE",
           "HEALTH_GRAD_NONFINITE", "HEALTH_PARAM_NONFINITE",
           "HEALTH_SDC_MISMATCH"]

# guardian health-word flag bits (mxnet_tpu_torch.guardian reads these)
HEALTH_LOSS_NONFINITE = 1
HEALTH_GRAD_NONFINITE = 2
HEALTH_PARAM_NONFINITE = 4
HEALTH_SDC_MISMATCH = 8

# ops whose CUDA backward adds with atomics (grid_sample, interpolate):
# two runs of a net holding one need not agree bit for bit
_NONDETERMINISTIC_OPS = ("BilinearSampler", "SpatialTransformer")

# inventory owner names, one per group
_OWNERS = itertools.count()


class _Deferred(nd.NDArray):
    """An NDArray whose value may still be pending: reading it first runs
    ``force`` (the group's materialisation of a deferred forward or
    backward)."""

    __slots__ = ("_v", "force")

    def __init__(self, arr):
        self.force = None
        nd.NDArray.__init__(self, arr._read(), ctx=arr.context)

    @property
    def _t(self):
        if self.force is not None:
            self.force()
        return self._v

    @_t.setter
    def _t(self, value):
        self._v = value


def _tally_add(stat, labels, outs, acc):
    """Fold one batch's metric statistic into a (sums float32, counts
    int32) device tally: counts ride int32, which a float32 tally would
    stop counting at 2^24. Python numbers in a row become device scalars
    without a copy (``new_full``)."""
    rows = stat(torch, labels, outs)
    if isinstance(rows, tuple):
        rows = [rows]
    sums, counts = acc

    def as_dev(v, like):
        if isinstance(v, torch.Tensor):
            return v.to(like.dtype)
        return like.new_full((), v)

    sums = sums + torch.stack([as_dev(s, sums) for s, _ in rows])
    counts = counts + torch.stack([as_dev(c, counts) for _, c in rows])
    return sums, counts


def _tree_where(pred, new, old):
    """Per-leaf select over an optimizer-state tree (None passes through):
    the loss scaler's skipped-step selection."""
    if new is None:
        return None
    if isinstance(new, (tuple, list)):
        return tuple(_tree_where(pred, a, b) for a, b in zip(new, old))
    return torch.where(pred, new, old)


def _grads_finite(grads):
    """0-d bool tensor: every gradient is finite (the loss scaler's
    overflow probe, on the device)."""
    return torch.stack([torch.isfinite(g).all()
                        for g in grads.values()]).all()


def _ls_update(cfg, scale, good, finite):
    """The dynamic loss-scale transition (the standard AMP rule, on the
    device): an overflow halves the scale and zeroes the growth counter;
    ``window`` consecutive finite steps double it, clamped to
    [scale_min, scale_max]."""
    grew = (good + 1) >= cfg["window"]
    up = torch.clamp_max(scale * 2.0, cfg["scale_max"])
    down = torch.clamp_min(scale * 0.5, cfg["scale_min"])
    new_scale = torch.where(finite, torch.where(grew, up, scale), down)
    new_good = torch.where(finite, torch.where(grew, 0, good + 1),
                           0).to(good.dtype)
    return new_scale, new_good


def _ls_step(cfg, ls, finite):
    """One transition of the (scale, good, skips) triple: the AMP rule on
    (scale, good) and a count of skipped updates."""
    scale, good, skips = ls
    new_scale, new_good = _ls_update(cfg, scale, good, finite)
    return new_scale, new_good, skips + (~finite).to(skips.dtype)


def _all_finite(tensors):
    """0-d bool tensor: every element of every tensor is finite. One
    concatenation and one reduction, whatever the number of tensors."""
    return torch.isfinite(torch.cat([t.reshape(-1).float()
                                     for t in tensors])).all()


def _health_update(cfg, health, inputs, outs, grads, new_params, grad_names,
                   label_names):
    """Fold one step's numeric-health observation into the guardian word
    ``(flags int32, first_bad int32, count int32, ring float32)``: pure
    reads of values the step computed, so the parameters' math is
    untouched, and nothing read back. ``flags`` gathers the sentinel
    bits, ``first_bad`` keeps the step ordinal (since the last
    ``health_reset``) of the FIRST bad observation, ``count`` counts
    steps and slot ``count % window`` of ``ring`` takes the step's loss
    scalar for the host's spike judge."""
    flags, first_bad, count, ring = health
    bad = (torch.where(torch.isfinite(outs[0]).all(), 0,
                       HEALTH_LOSS_NONFINITE)
           | torch.where(_all_finite(grads.values()), 0,
                         HEALTH_GRAD_NONFINITE)
           | torch.where(_all_finite(new_params[n] for n in grad_names), 0,
                         HEALTH_PARAM_NONFINITE)).to(flags.dtype)
    new_flags = flags | bad
    first_bad = torch.where((flags == 0) & (new_flags != 0), count,
                            first_bad)
    scalar = None
    stat = cfg.get("stat")
    if stat is not None:
        # the spike metric's fused statistic over this batch (sum/count
        # of its first slot: for the default cross-entropy, the batch's
        # mean loss). A statistic that cannot run on this model's label
        # and output shapes must not take the step down: the ring then
        # carries the coarse output mean, and the downgrade is recorded
        try:
            rows = stat(torch, [inputs[n] for n in label_names], outs)
            if isinstance(rows, tuple):
                rows = [rows]
            s, c = rows[0]
            s = torch.as_tensor(s, dtype=torch.float32, device=ring.device)
            c = torch.as_tensor(c, dtype=torch.float32, device=ring.device)
            scalar = s / torch.clamp_min(c, 1.0)
        except Exception as exc:  # noqa: BLE001 - any failure degrades
            cfg["stat"] = None
            cfg["stat_degraded"] = "%s: %s" % (type(exc).__name__, exc)
            import logging
            logging.getLogger("mxnet_tpu_torch.guardian").warning(
                "guardian spike metric cannot run over this model's "
                "label/output shapes (%s); falling back to the coarse "
                "output-mean loss scalar", cfg["stat_degraded"])
    if scalar is None:
        scalar = outs[0].float().mean()
    slot = torch.remainder(count, int(cfg["window"])).long().reshape(1)
    ring = ring.scatter(0, slot, scalar.reshape(1).to(ring.dtype))
    return new_flags, first_bad, count + 1, ring


def _bits(t):
    """``t``'s bit pattern as integers of its width: a NaN payload equals
    itself, +0 and -0 differ."""
    width = {8: torch.int64, 4: torch.int32, 2: torch.int16,
             1: torch.uint8}[t.element_size()]
    return t.view(width)


def _sdc_fold(a_params, b_params, health, grad_names):
    """Fold an SDC probe's verdict into the health word: the two runs'
    updated parameters compared BITWISE; any difference sets the SDC
    flag. The probed step already counted (its health update ran in
    the first run), so its ordinal is ``count - 1``."""
    flags, first_bad, count, ring = health
    neq = torch.stack([(_bits(a_params[n]) != _bits(b_params[n])).any()
                       for n in grad_names]).any()
    new_flags = flags | torch.where(neq, HEALTH_SDC_MISMATCH,
                                    0).to(flags.dtype)
    first_bad = torch.where((flags == 0) & (new_flags != 0),
                            torch.clamp_min(count - 1, 0), first_bad)
    return new_flags, first_bad, count, ring


def _flat_leaves(t):
    """The tensors of a tree of tuples and lists, in order."""
    if isinstance(t, torch.Tensor):
        return [t]
    if isinstance(t, (tuple, list)):
        return [leaf for v in t for leaf in _flat_leaves(v)]
    return []


def _clone_tree(t):
    """Fresh copies of every tensor in a tree of tuples, lists and dicts
    (None and other leaves pass through)."""
    if isinstance(t, torch.Tensor):
        return t.clone()
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_clone_tree(v) for v in t)
    return t


class MeshExecutorGroup(DataParallelExecutorGroup):
    """The fused route's group on one device (module docstring)."""

    fused = True

    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, fixed_param_names=None,
                 grad_req="write", shared_group=None, compute_dtype=None,
                 remat=None, precision=None, device_augment=None):
        self._precision = precision
        # {data input name: DeviceAugment}, needed by bind_exec below
        self._device_augment = dict(device_augment or {})
        self.compute_dtype = compute_dtype
        self._cdt = state_np_dtype(compute_dtype, None)   # None: float32
        self._index_names = index_inputs(symbol)   # kept float32, as labels
        self.remat = remat
        self._ls_cfg = loss_scale_config(precision)
        self._ls_state = None
        self._step_enabled = False
        self._pending_fwd = False    # a staged train forward not yet run
        self._pending_bwd = False    # a deferred fwd+bwd awaiting update()
        self._train_staged = False   # a train batch is staged
        self._last_aux = None        # aux before a materialised forward
        self._held = None            # (outputs, leaves) of that forward
        self._outputs_from = None    # "fwd" | "bwd" | None
        self._key = None             # the staged train forward's key
        self._metric_stat = None
        self._metric_live = None
        self._metric_acc = None
        self._metric_slots = 1
        self._metric_step_done = False
        self._shared_out = False
        self._health_cfg = None      # the guardian's word (enable_health)
        self._health_state = None
        self._probe_count = 0
        self._programs_seen = set()  # (kind, input signature) run so far
        self._program_names = {}     # base kind -> inventory entry name
        self._inventory_owner = "module%d" % next(_OWNERS)
        self._compile_watch = None   # set by CompileWatch.attach
        super().__init__(symbol, contexts, data_shapes, label_shapes,
                         param_names, for_training, fixed_param_names,
                         grad_req, shared_group, inputs_need_grad=False)
        if shared_group is not None:
            shared_group._shared_out = True
        self._grad_names = [n for n in param_names
                            if self.grad_req.get(n, "null") != "null"]
        self._grad_set = frozenset(self._grad_names)
        self._remat_eval_fn = _build_eval_segmented(self.symbol, remat) \
            if remat is not None and for_training else None

    # ------------------------------------------------------------ wiring
    def _model_data_shapes(self, data_shapes):
        """The symbol's view of ``data_shapes``: each augmented input's
        wire entry becomes its model shape (B, C, H, W) and the augment
        parameter inputs drop out."""
        if not self._device_augment:
            return list(data_shapes)
        names = [n for n, _ in data_shapes]
        missing = [n for n in self._device_augment if n not in names]
        if missing:
            raise MXNetError("device_augment names input(s) %r but the bind "
                             "provides %r" % (missing, names))
        params = set()
        for name in self._device_augment:
            params.update((crop_input_name(name), mirror_input_name(name)))
        out = []
        for name, shape in data_shapes:
            if name in params:
                continue
            aug = self._device_augment.get(name)
            out.append((name, aug.model_shape(shape[0]) if aug is not None
                        else tuple(shape)))
        return out

    def model_view_shapes(self, data_batch):
        """The model-view shapes of a batch's data inputs (what the bound
        arrays must hold), for the re-bind check of ``Module.forward``."""
        bound = set(n for n, _ in self._bind_data_shapes)
        shapes = []
        for (name, _), arr in zip(self.data_shapes, data_batch.data):
            if name not in bound:
                continue
            aug = self._device_augment.get(name)
            shape = tuple(arr.shape)
            if aug is not None and shape[1:] == aug.wire_shape:
                shape = aug.model_shape(shape[0])
            shapes.append(shape)
        return shapes

    def bind_exec(self, data_shapes, label_shapes, shared_group=None):
        self._wire_data_shapes = list(data_shapes)
        super().bind_exec(self._model_data_shapes(data_shapes), label_shapes,
                          shared_group)

    def _wire(self, ex, data_shapes, label_shapes):
        """The classic wiring, with the outputs and gradients made
        deferrable; ``data_shapes`` keeps the wire entries under device
        augmentation."""
        for i, name in enumerate(ex.arg_names):
            g = ex.grad_arrays[i]
            if g is not None and not isinstance(g, _Deferred):
                ex.grad_arrays[i] = ex.grad_dict[name] = _Deferred(g)
        for i, o in enumerate(ex.outputs):
            if not isinstance(o, _Deferred):
                ex.outputs[i] = _Deferred(o)
        ex.output_dict = dict(zip(self.symbol.list_outputs(), ex.outputs))
        super()._wire(ex, data_shapes, label_shapes)
        self._bind_data_shapes = list(data_shapes)
        if self._device_augment:
            self.data_shapes = self._wire_data_shapes
        self._label_names = [n for n, _ in (label_shapes or [])]
        self._input_names = [n for n in self.arg_names
                             if n not in self.param_names]

    def reshape(self, data_shapes, label_shapes):
        self._flush()
        self._held = None
        self._wire_data_shapes = list(data_shapes)
        super().reshape(self._model_data_shapes(data_shapes), label_shapes)

    def set_params(self, arg_params, aux_params):
        self._flush()
        self._held = None
        super().set_params(arg_params, aux_params)

    @property
    def _eval_fn(self):
        return self.execs[0]._eval_fn

    @property
    def _needs_rng(self):
        return self._eval_fn.needs_rng

    @property
    def _param_dict(self):
        ex = self.execs[0]
        return {n: ex.arg_dict[n] for n in self.param_names}

    @property
    def _grad_dict(self):
        ex = self.execs[0]
        return {n: ex.grad_dict[n] for n in self._grad_names}

    @property
    def _aux_dict(self):
        return dict(self.execs[0].aux_dict)

    def _set_force(self, fn, grads=False):
        ex = self.execs[0]
        for o in ex.outputs:
            o.force = fn
        if grads:
            for n in self._grad_names:
                ex.grad_dict[n].force = fn

    def _clear_force(self):
        ex = self.execs[0]
        for o in ex.outputs:
            o.force = None
        for n in self._grad_names:
            ex.grad_dict[n].force = None

    # ----------------------------------------------------------- compute
    def _params_now(self):
        ex = self.execs[0]
        return {n: ex.arg_dict[n]._read() for n in self.param_names}

    def _aux_now(self):
        return [a._read() for a in self.execs[0].aux_arrays]

    def _inputs_now(self):
        ex = self.execs[0]
        return {n: ex.arg_dict[n]._read() for n in self._input_names}

    def _arg_vals(self, params, inputs, leaves=None):
        """The symbol's argument values: parameters (as autograd leaves
        where ``leaves`` collects them) and inputs, each but the labels
        and the indices (``precision.policy.index_inputs``: token ids
        above 256 do not survive bfloat16) cast to the compute dtype
        inside the graph. Under a policy's ``act_cast`` every other
        floating input then takes its low-bit round trip
        (``precision.fake_cast``), in training and in eval alike."""
        cdt = self._cdt
        labels = set(self._label_names) | self._index_names
        act_cast = getattr(self._precision, "act_cast", None)
        vals = []
        for n in self.arg_names:
            if n in params:
                v = params[n]
                if leaves is not None and n in self._grad_set:
                    v = v.detach().requires_grad_(True)
                    leaves[n] = v
            else:
                v = inputs[n]
            if cdt is not None and n not in labels and \
                    v.is_floating_point() and v.dtype != cdt:
                v = v.to(cdt)
            if act_cast is not None and n not in params and \
                    n not in labels and v.is_floating_point():
                v = fake_cast(v, act_cast)
            vals.append(v)
        return vals

    def _forward_only(self, params, aux, inputs, is_train, key=None,
                      tap=None):
        """A forward without gradients: (float32 outputs, new aux). An
        eval forward runs inside the policy's GEMM scope
        (``precision.quant.trace_gemm_scope``: a calibration pass, native
        int8/fp8 products, or a no-op), whose site counters restart
        here. ``tap(name, tensor)`` sees every op output (the serving
        cache's trace names the node it stops at)."""
        scope = self._dp_scope() if is_train else \
            trace_gemm_scope(self._precision)
        with torch.no_grad(), scope:
            outs, new_aux = self._eval_fn(
                self._arg_vals(params, inputs), aux, is_train, tap=tap,
                key=key)
        return tuple(o.float() for o in outs), new_aux

    def _fwd_bwd(self, params, aux, inputs, heads=None, scale=None,
                 key=None):
        """Forward and backward: (float32 outputs, new aux, gradients by
        name in the parameters' dtype). Head gradients default to ones
        (loss heads ignore them); ``scale`` multiplies them and divides
        the gradients (the dynamic loss scale); ``key`` is the forward's
        key."""
        outs, new_aux, leaves = self._fwd_graph(params, aux, inputs, key)
        grads = self._grads_of(outs, leaves, params, heads, scale)
        return tuple(o.detach().float() for o in outs), new_aux, grads

    def _fwd_graph(self, params, aux, inputs, key=None):
        """A training forward that keeps its autograd graph: (outputs,
        new aux, the parameters' leaves by name)."""
        leaves = {}
        vals = self._arg_vals(params, inputs, leaves)
        fn = self._remat_eval_fn or self._eval_fn
        with torch.enable_grad(), self._dp_scope():
            outs, new_aux = fn(vals, aux, True, key=key)
        return outs, new_aux, leaves

    def _grads_of(self, outs, leaves, params, heads=None, scale=None):
        """The gradients by name of ``_fwd_graph``'s outputs under the
        head gradients (``_fwd_bwd``)."""
        if heads is None:
            hs = [torch.ones_like(o) for o in outs]
        else:
            hs = [h.to(o.dtype) for h, o in zip(heads, outs)]
        if scale is not None:
            hs = [h * scale.to(h.dtype) for h in hs]
        pairs = [(o, h) for o, h in zip(outs, hs) if o.requires_grad]
        names = list(leaves)
        # the scope reaches a remat recompute inside the backward
        with self._dp_scope():
            got = torch.autograd.grad([o for o, _ in pairs],
                                      [leaves[n] for n in names],
                                      [h for _, h in pairs],
                                      allow_unused=True)
        grads = {}
        for n, g in zip(names, got):
            if g is None:
                g = torch.zeros_like(params[n])
            grads[n] = g.to(params[n].dtype)
        if scale is not None:
            inv = 1.0 / scale
            grads = {n: g * inv for n, g in grads.items()}
        if self._reduce_grads:
            # the data-parallel psum: every gradient summed over the ranks
            # (one SUM all-reduce per dtype) before the optimizer
            self._dp.allreduce_tensors_(list(grads.values()))
        return grads

    def _step_math(self, fa, params, aux, states, inputs, lrs, wds,
                   macc=None, ls=None, health=None, key=None):
        """ONE training step as one function of tensors: forward,
        backward, the optimizer's apply on every parameter with a
        gradient, the metric tally, the loss-scale transition and the
        guardian's health word. Nothing in it reads a value back to the
        host."""
        if ls is None:
            outs, new_aux, grads = self._fwd_bwd(params, aux, inputs,
                                                 key=key)
            finite = None
        else:
            outs, new_aux, grads = self._fwd_bwd(params, aux, inputs,
                                                 scale=ls[0], key=key)
            finite = _grads_finite(grads)
        new_params = dict(params)
        new_states = []
        for k, n in enumerate(self._grad_names):
            p, s = fa(torch, params[n], grads[n], states[k], lrs[k],
                      wds[k])
            if finite is not None:
                # overflow: skip the whole update (parameter and state)
                p = torch.where(finite, p, params[n])
                s = _tree_where(finite, s, states[k])
            new_params[n] = p
            new_states.append(s)
        if macc is not None:
            macc = _tally_add(self._metric_stat,
                              [inputs[n] for n in self._label_names],
                              outs, macc)
        if ls is not None:
            ls = _ls_step(self._ls_cfg, ls, finite)
        if health is not None:
            health = _health_update(self._health_cfg, health, inputs, outs,
                                    grads, new_params, self._grad_names,
                                    self._label_names)
        return outs, new_aux, grads, new_params, new_states, macc, ls, health

    # ------------------------------------------------------------ writes
    def _write_outs(self, outs):
        for o, v in zip(self.execs[0].outputs, outs):
            o.force = None
            o._t = v

    def _write_aux(self, new_aux):
        for a, v in zip(self.execs[0].aux_arrays, new_aux):
            if v is not a._read():
                a._write(v)

    def _write_grads(self, grads):
        ex = self.execs[0]
        for n, g in grads.items():
            buf = ex.grad_dict[n]
            buf.force = None
            buf._write(g)

    # ----------------------------------------------------- forward/back
    def _stage(self, data_batch, is_train=False):
        """Copy the batch into the bound input tensors, as the classic
        group does: one host→card copy per input, or a copy on the card
        for a tensor already there (after the stream wait a
        ``DeviceLoader`` batch carries). Under device augmentation the
        wire block and its parameters go to the device first and the
        augment's float32 output is what is copied in."""
        if self._device_augment:
            inputs = {name: self._device_value(arr) for (name, _), arr
                      in zip(self.data_shapes, data_batch.data)}
            inputs = self._apply_device_augment(inputs, is_train)
            ex = self.execs[0]
            for name, _ in self._bind_data_shapes:
                if name in inputs:
                    ex.arg_dict[name][:] = inputs[name]
        else:
            for src, dst in zip(data_batch.data, self.data_arrays):
                dst[0][:] = src
        if self.label_arrays is not None and data_batch.label:
            for src, dst in zip(data_batch.label, self.label_arrays):
                if src is not None:
                    dst[0][:] = src

    def _device_value(self, arr, as_float=False):
        """A batch entry as a tensor on the group's device (float32 with
        ``as_float``): host values take one (pinned, asynchronous) copy,
        tensors already there pass through."""
        v = unwrap(arr)
        dev = self.contexts[0].torch_device()
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=torch.float32) if as_float \
                else v.to(device=dev)
        return self._to_device(onp.asarray(v, onp.float32) if as_float
                               else onp.asarray(v))

    def _apply_device_augment(self, inputs, is_train, grouped=False):
        """Replace each augmented input's wire block (and its parameter
        inputs, which are popped) with the augment's float32 model batch.
        An input already in the model view passes through. Grouped
        (K, B, ...) blocks run as K·B rows and are reshaped back."""
        lead = 2 if grouped else 1
        for name, aug in self._device_augment.items():
            v = inputs.get(name)
            if v is None:
                continue
            crop = inputs.pop(crop_input_name(name), None)
            mirror = inputs.pop(mirror_input_name(name), None)
            if tuple(v.shape[lead:]) != aug.wire_shape:
                continue    # already the model view
            if not grouped:
                inputs[name] = aug.apply(v, crop, mirror, train=is_train)
                continue
            k, b = v.shape[0], v.shape[1]
            flat = aug.apply(
                v.reshape((k * b,) + tuple(v.shape[2:])),
                None if crop is None else crop.reshape(k * b, 2),
                None if mirror is None else mirror.reshape(k * b),
                train=is_train)
            inputs[name] = flat.reshape((k, b) + tuple(flat.shape[1:]))
        return inputs

    def _flush(self):
        """Run whatever a new batch would supersede: a deferred
        forward + backward, or a staged train forward (its EMA)."""
        if self._pending_bwd:
            self._materialize_backward()
        elif self._pending_fwd:
            self._materialize_forward()

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._flush()
        self._stage(data_batch, is_train)
        self._last_aux = None
        self._held = None
        self._pending_fwd = self._pending_bwd = False
        self._key = _random.next_key() if is_train and self._needs_rng \
            else None
        if not is_train:
            self._train_staged = False
            inputs = self._inputs_now()
            with self._program("fwd_eval", inputs):
                outs, _ = self._forward_only(self._params_now(),
                                             self._aux_now(), inputs, False)
            self._write_outs(outs)
            self._outputs_from = "fwd"
            return
        self._train_staged = True
        self._pending_fwd = True
        self._outputs_from = None
        self._set_force(self._materialize_forward)

    def _materialize_forward(self):
        """Outputs read before the backward: run the train forward now,
        keeping the aux it started from so the step re-runs from it (the
        EMA is applied once), and its autograd graph, from which a
        ``backward`` takes the gradients without a second forward (a
        module that feeds another, ``backward(out_grads=)``)."""
        if not self._pending_fwd:
            return
        self._pending_fwd = False
        self._clear_force()
        aux = self._aux_now()
        self._last_aux = [a.clone() for a in aux]
        inputs = self._inputs_now()
        with self._program("fwd_train", inputs):
            if self._grad_names:
                graph, new_aux, leaves = self._fwd_graph(
                    self._params_now(), aux, inputs, self._key)
                self._held = (graph, leaves)
                outs = tuple(o.detach().float() for o in graph)
            else:
                outs, new_aux = self._forward_only(
                    self._params_now(), aux, inputs, True, self._key)
        self._write_outs(outs)
        self._write_aux(new_aux)
        self._outputs_from = "fwd"

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True")
        if self._outputs_from == "bwd":
            return      # the forward + backward of this batch already ran
        if not self._train_staged:
            raise MXNetError("backward() needs a forward(is_train=True) "
                             "first")
        self._pending_fwd = False
        if out_grads is None and self._step_enabled:
            # deferred: update() runs the whole step as one function
            self._pending_bwd = True
            self._set_force(self._materialize_backward, grads=True)
            self._outputs_from = "bwd"
            return
        self._clear_force()
        self._run_fwd_bwd(out_grads)

    def _run_fwd_bwd(self, out_grads=None):
        heads = None
        if out_grads is not None:
            if isinstance(out_grads, nd.NDArray):
                out_grads = [out_grads]
            dev = self.contexts[0].torch_device()
            heads = [g._read() if isinstance(g, nd.NDArray) else
                     torch.as_tensor(g, device=dev) for g in out_grads]
        if self._held is not None:
            # the materialised forward's graph: outputs and aux are written
            graph, leaves = self._held
            self._held = self._last_aux = None
            self._write_grads(self._grads_of(graph, leaves,
                                             self._params_now(), heads))
            self._outputs_from = "bwd"
            return
        aux = self._last_aux if self._last_aux is not None \
            else self._aux_now()
        inputs = self._inputs_now()
        with self._program("fwd_bwd", inputs):
            outs, new_aux, grads = self._fwd_bwd(
                self._params_now(), aux, inputs, heads, key=self._key)
        self._last_aux = None
        self._write_outs(outs)
        self._write_aux(new_aux)
        self._write_grads(grads)
        self._outputs_from = "bwd"

    def _materialize_backward(self):
        """Gradients or outputs read while a step was deferred: run the
        forward + backward now (parameters still before the update);
        ``update()`` then takes the classic route."""
        if not self._pending_bwd:
            return
        self._pending_bwd = False
        self._clear_force()
        self._run_fwd_bwd()

    # --------------------------------------------------------- the step
    def _optimizer_rows(self, updater, steps):
        """Count ``steps`` updates of every parameter with a gradient and
        return (state keys, states, one host array of ``steps`` lr rows
        followed by the wd row): the lr of each step read at its own
        count, as sequential steps read it."""
        opt = updater.optimizer
        ex = self.execs[0]
        keys = [i for i, n in enumerate(self.param_names)
                if n in self._grad_set]
        states = [updater.read_state_tree(k, ex.arg_dict[n])
                  for k, n in zip(keys, self._grad_names)]
        get_lr = getattr(opt, "_fused_lr", opt._get_lr)
        rows = []
        for _ in range(steps):
            row = []
            for k in keys:
                opt._update_count(k)
                row.append(get_lr(k))
            rows.append(row)
        rows.append([opt._get_wd(k) for k in keys])
        return keys, states, onp.asarray(rows, onp.float32)

    def _to_device(self, host):
        """One host→card copy of a host array (pinned, asynchronous on
        the card)."""
        t = torch.from_numpy(onp.ascontiguousarray(host))
        dev = self.contexts[0].torch_device()
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t

    def _step_extras(self):
        """The metric tally, the loss-scale triple and the health word,
        created on the device at first use (None where not in use)."""
        dev = self.contexts[0].torch_device()
        macc = None
        if self._metric_stat is not None:
            if self._metric_acc is None:
                self._metric_acc = (
                    torch.zeros(self._metric_slots, dtype=torch.float32,
                                device=dev),
                    torch.zeros(self._metric_slots, dtype=torch.int32,
                                device=dev))
            macc = self._metric_acc
        return macc, self._ls_current(), self._health_current()

    def _commit(self, updater, keys, res):
        outs, new_aux, grads, new_params, new_states, macc, ls, health = res
        self._write_outs(outs)
        self._write_aux(new_aux)
        self._write_grads(grads)
        ex = self.execs[0]
        for n in self._grad_names:
            ex.arg_dict[n]._write(new_params[n])
        for k, st in zip(keys, new_states):
            updater.write_state_tree(k, st)
        if macc is not None:
            self._metric_acc = macc
            self._metric_step_done = True
        if ls is not None:
            self._ls_state = ls
        if health is not None:
            self._health_state = health
        self._last_aux = None
        self._outputs_from = "bwd"

    def _launch_step(self, kind, inputs, run, args, extra=None):
        """Run one step (``run(*args)``, args = (params, aux, states,
        inputs, rest...)) as program ``kind``; on an SDC-probe step run it
        a second time from copies of the same arguments and fold the
        bitwise comparison of the two runs' updated parameters into the
        health word. The first run is the committed one."""
        hcfg = self._health_cfg
        probe = False
        if hcfg and hcfg["probe_period"]:
            probe = self._probe_count % hcfg["probe_period"] == 0
            self._probe_count += 1
        if not probe:
            with self._program(kind, inputs, extra):
                return run(*args)
        n = self._probe_count - 1
        copies = _clone_tree(args)
        if _faults.armed():
            # guardian.sdc seam (kind=value): add the injected delta to
            # one element of the second run's parameter copy, on the
            # device — a deterministic mismatch, so the detect->rollback
            # chain downstream is the real one
            delta = _faults.value("guardian.sdc", None, probe=n)
            if delta is not None:
                with torch.no_grad():
                    copies[0][self._grad_names[0]].view(-1)[0] += \
                        float(delta)
        with self._program(kind, inputs, extra):
            res = run(*args)
        again = run(*copies)
        telemetry.registry().scope("guardian").counter("sdc_checks").add()
        health = _sdc_fold(res[3], again[3], res[7], self._grad_names)
        return res[:7] + (health,)

    @contextlib.contextmanager
    def _program(self, kind, inputs, extra=None):
        """Bracket one run of program ``kind`` on ``inputs`` (a dict of
        tensors). The first run of each (kind, input shapes and dtypes)
        is this route's compile: it is reported to the attached
        CompileWatch and, while telemetry is enabled, counted into the
        process ProgramInventory. Later runs pay one set lookup."""
        sig = tuple(sorted((n, tuple(v.shape), str(v.dtype))
                           for n, v in inputs.items()))
        if (kind, sig) in self._programs_seen:
            yield
            return
        self._programs_seen.add((kind, sig))
        if self._compile_watch is not None:
            self._compile_watch.note_program(
                kind, {n: shape for n, shape, _ in sig})
        if not telemetry.enabled():
            yield
            return
        counter = telemetry.ProgramCounter()
        with counter:
            yield
        base = kind.split(":")[0]
        meta = {"batch_size": self.batch_size,
                "precision_mode": self.precision_mode_name(),
                "ops": counter.ops, "kernel_calls": counter.kernels}
        meta.update(extra or {})
        self._program_names[base] = telemetry.inventory().register(
            "%s.%s" % (self._inventory_owner, base), kind=base,
            device_kind=self._device_kind(), meta=meta,
            flops=counter.flops, bytes_accessed=counter.bytes)

    def _device_kind(self):
        dev = self.contexts[0].torch_device()
        return torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else dev.type

    def _note_optimizer_analytic(self, states):
        """Register the optimizer-update traffic the fused step folds in
        as an analytic inventory entry (the JAX package's account): read
        w and g and write w in float32, plus a read and a write of every
        state leaf at its storage dtype."""
        if "optimizer_update" in self._program_names or \
                not telemetry.enabled():
            return
        leaves = _flat_leaves(states)
        n_par = sum(self._param_dict[n].size for n in self._grad_names)
        state_bytes = sum(t.numel() * t.element_size() for t in leaves)
        self._program_names["optimizer_update"] = \
            telemetry.inventory().register(
                "%s.optimizer_update" % self._inventory_owner,
                kind="optimizer_update", analytic=True,
                flops=4.0 * n_par,
                bytes_accessed=4.0 * 3 * n_par + 2.0 * state_bytes,
                device_kind=self._device_kind(),
                meta={"fused_into": "%s.train_step" % self._inventory_owner,
                      "n_params": n_par,
                      "n_state": sum(t.numel() for t in leaves),
                      "state_bytes": state_bytes,
                      "precision_mode": self.precision_mode_name()})

    def program_basis(self, base_kinds):
        """Counted per-STEP (flops, bytes) and the card's peaks for the
        first of ``base_kinds`` this group has registered, or None. A
        grouped entry divides by its ``batch_group``."""
        inv = telemetry.inventory()
        for base in base_kinds:
            name = self._program_names.get(base)
            a = inv.analyze(name) if name is not None else None
            if not a or not a.get("flops"):
                continue
            k = max(int(a["meta"].get("batch_group", 1)), 1)
            pt, pb = telemetry.device_peaks(a["device_kind"],
                                            self.compute_dtype or "float32")
            return {"program": name, "kind": base,
                    "flops_per_step": a["flops"] / k,
                    "bytes_per_step": a["bytes_accessed"] / k,
                    "peak_tflops": pt, "peak_hbm_gbps": pb,
                    "precision_mode": self.precision_mode_name()}
        return None

    def roofline_basis(self):
        """The FLOPs/bytes basis of ``fit``'s live roofline: the counted
        train step (grouped when the fit runs grouped); when only the
        forward + backward was counted (the classic update ran), the
        optimizer's traffic is added analytically, as the JAX package
        does."""
        basis = self.program_basis(("train_step_grouped", "train_step"))
        if basis is not None:
            return basis
        basis = self.program_basis(("fwd_bwd",))
        if basis is not None:
            n_par = sum(self._param_dict[n].size for n in self._grad_names)
            basis["flops_per_step"] += 4.0 * n_par
            basis["bytes_per_step"] += 5.0 * 4 * n_par
        return basis

    def step_update(self, updater):
        """Run the deferred forward + backward AND the optimizer as one
        step (``_step_math``). Returns False, for the caller to take the
        classic update route, when no step is deferred or the optimizer
        has no pure apply. The updater's states and update counts end up
        as ``Updater.update_multi`` leaves them."""
        if not self._pending_bwd:
            return False
        fa = updater.fused_apply_or_none()
        if fa is None:
            return False
        self._pending_bwd = False
        self._held = None       # the step runs forward and backward itself
        self._clear_force()
        keys, states, rows = self._optimizer_rows(updater, 1)
        lw = self._to_device(rows)
        aux = self._last_aux if self._last_aux is not None \
            else self._aux_now()
        macc, ls, health = self._step_extras()
        inputs = self._inputs_now()
        key = self._key

        def run(params, aux, states, inputs, lw, macc, ls, health):
            return self._step_math(fa, params, aux, states, inputs, lw[0],
                                   lw[1], macc, ls, health, key)

        res = self._launch_step(
            "train_step" + self._health_kind_tag(), inputs, run,
            (self._params_now(), aux, states, inputs, lw, macc, ls, health))
        self._note_optimizer_analytic(states)
        self._commit(updater, keys, res)
        return True

    def stage_stacked(self, stacked, is_train=True):
        """Place a dict of name -> (K, batch, ...) blocks (numpy, NDArray
        or tensor) on the device, ONE copy per block (none for a block
        already there), run the device augment over the block, and
        zero-fill the bound inputs the block does not provide (labels at
        predict time). A dict this returned passes through unchanged."""
        dev = self.contexts[0].torch_device()
        keep = set()
        for name in self._device_augment:
            keep.update((name, crop_input_name(name),
                         mirror_input_name(name)))
        inputs, K = {}, 0
        for name, arr in stacked.items():
            t = self._device_value(arr, as_float=name not in keep)
            K = t.shape[0]
            inputs[name] = t
        inputs = self._apply_device_augment(inputs, is_train, grouped=True)
        ex = self.execs[0]
        for name in self._input_names:
            if name not in inputs:
                shape = tuple(ex.arg_dict[name].shape)
                inputs[name] = torch.zeros((K,) + shape, device=dev)
        return inputs

    def step_update_grouped(self, updater, stacked_data):
        """Run K whole training steps — forward, backward, optimizer and
        metric tally — in one call over a (K, batch, ...) block staged
        with one copy per input. Every step's lr row is computed on the
        host before launch at its own update count, so schedules that
        change mid-group (and Adam's bias correction) match K sequential
        steps, bit for bit. Returns False when the step is not available
        for this optimizer."""
        if not (self._step_enabled and self.for_training):
            return False
        fa = updater.fused_apply_or_none()
        if fa is None:
            return False
        self._flush()
        inputs = self.stage_stacked(stacked_data)
        K = next(iter(inputs.values())).shape[0]
        keys, states, rows = self._optimizer_rows(updater, K)
        lw = self._to_device(rows)
        macc, ls, health = self._step_extras()
        # K independent keys from one draw, as the JAX package's grouped
        # step splits its key
        step_keys = _random.split(_random.next_key(), K) \
            if self._needs_rng else [None] * K

        def run(params, aux, states, inputs, lw, macc, ls, health):
            res = None
            for k in range(K):
                res = self._step_math(fa, params, aux, states,
                                      {n: v[k] for n, v in inputs.items()},
                                      lw[k], lw[K], macc, ls, health,
                                      step_keys[k])
                _, aux, _, params, states, macc, ls, health = res
            return res

        # the program is the per-step function run K times: its
        # signature is one step's shapes, so a tail group of another K
        # runs no new program
        res = self._launch_step(
            "train_step_grouped" + self._health_kind_tag(),
            {n: v[0] for n, v in inputs.items()}, run,
            (self._params_now(), self._aux_now(), states, inputs, lw, macc,
             ls, health), extra={"batch_group": K})
        self._note_optimizer_analytic(states)
        self._commit(updater, keys, res)
        self._train_staged = False
        return True

    def score_stacked(self, stacked_data):
        """Eval forwards of K batches staged with one copy per input:
        a tuple of stacked (K, ...) float32 outputs."""
        self._flush()
        inputs = self.stage_stacked(stacked_data, is_train=False)
        K = next(iter(inputs.values())).shape[0]
        params, aux = self._params_now(), self._aux_now()
        with self._program("fwd_eval_stacked",
                           {n: v[0] for n, v in inputs.items()},
                           {"batch_group": K}):
            outs = [self._forward_only(params, aux,
                                       {n: v[k] for n, v in inputs.items()},
                                       False)[0] for k in range(K)]
        return tuple(torch.stack(o) for o in zip(*outs))

    # ------------------------------------------------------ loss scale
    def precision_mode_name(self):
        """The recorded precision-mode name ('f32' without a policy)."""
        from ..precision.policy import mode_name
        return mode_name(self._precision)

    def _ls_current(self):
        """The device (scale, good steps, skipped) triple, created from
        the policy's configuration at first use (None: no scaling)."""
        if self._ls_cfg is None:
            return None
        if self._ls_state is None:
            dev = self.contexts[0].torch_device()
            self._ls_state = (
                torch.full((), self._ls_cfg["init"], dtype=torch.float32,
                           device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
        return self._ls_state

    def loss_scale(self):
        """The current loss scale as a host float (None: no scaling);
        the configured initial scale before the first step. Reads the
        device: for monitoring, never on the step path."""
        if self._ls_cfg is None:
            return None
        if self._ls_state is None:
            return float(self._ls_cfg["init"])
        return float(self._ls_state[0])

    def scale_skips(self):
        """Updates the loss scaler skipped so far (None: no scaling)."""
        if self._ls_cfg is None:
            return None
        if self._ls_state is None:
            return 0
        return int(self._ls_state[2])

    # -------------------------------------------- guardian health word
    def enable_health(self, window=32, stat_metric=None, probe_period=0):
        """Arm the device health word (module docstring): later steps
        thread it, and :meth:`health_poll` reads it back off the step
        path. ``stat_metric`` (an EvalMetric with a device statistic,
        e.g. CrossEntropy) defines the ring's per-step loss scalar; None
        falls back to the first output's mean. ``probe_period=N`` also
        runs every N-th step twice and compares the updated parameters
        bitwise (the SDC probe), which needs runs that repeat bit for
        bit: on the card it refuses unless cuDNN is deterministic with
        its autotuner off, and it refuses nets holding an op whose CUDA
        backward adds with atomics."""
        probe_period = int(probe_period or 0)
        if probe_period:
            self._check_probe_determinism()
        stat = None
        if stat_metric is not None and self._label_names:
            stat = stat_metric.fused_stat()
        self._health_cfg = {"window": int(window), "stat": stat,
                            "probe_period": probe_period}
        self._health_state = None
        self._probe_count = 0

    def _check_probe_determinism(self):
        if self.contexts[0].torch_device().type != "cuda":
            return
        if not torch.backends.cudnn.deterministic or \
                torch.backends.cudnn.benchmark:
            raise MXNetError(
                "the SDC probe compares two runs bit for bit and needs "
                "torch.backends.cudnn.deterministic = True and "
                "torch.backends.cudnn.benchmark = False (now %s and %s); "
                "set them before arming it"
                % (torch.backends.cudnn.deterministic,
                   torch.backends.cudnn.benchmark))
        ops = sorted({n.op.name for n in self.symbol._topo()
                      if n.op is not None and (
                          n.op.name in _NONDETERMINISTIC_OPS or
                          (n.op.name == "UpSampling" and
                           n.attrs.get("sample_type") == "bilinear"))})
        if ops:
            raise MXNetError(
                "the SDC probe compares two runs bit for bit, and the "
                "CUDA backward of %s adds with atomics; arm the guardian "
                "without the probe (sdc_probe_period=0)" % ", ".join(ops))

    def disable_health(self):
        self._health_cfg = None
        self._health_state = None

    def _health_kind_tag(self):
        """The program-kind tag an armed health word adds to a step (its
        window shapes the ring)."""
        cfg = self._health_cfg
        return "" if cfg is None else ":h%d" % cfg["window"]

    def _health_current(self):
        """The device health word, (re)created at first use: flags 0,
        first_bad -1, count 0, ring NaN-filled."""
        if self._health_cfg is None:
            return None
        if self._health_state is None:
            dev = self.contexts[0].torch_device()
            i32 = {"dtype": torch.int32, "device": dev}
            self._health_state = (
                torch.zeros((), **i32), torch.full((), -1, **i32),
                torch.zeros((), **i32),
                torch.full((self._health_cfg["window"],), float("nan"),
                           dtype=torch.float32, device=dev))
        return self._health_state

    def health_poll(self):
        """Read the health word back to the host — OFF the step path (the
        guardian calls this at the epoch or commit boundary only):
        ``{"flags", "first_bad", "count", "ring"}``, or None when unarmed
        or no step has run."""
        if self._health_cfg is None or self._health_state is None:
            return None
        flags, first_bad, count, ring = self._health_state
        head = torch.stack([flags, first_bad, count]).cpu().tolist()
        return {"flags": int(head[0]), "first_bad": int(head[1]),
                "count": int(head[2]),
                "ring": ring.cpu().numpy().astype(onp.float32)}

    def health_reset(self):
        """Zero the health word (the guardian's epoch bracket): the next
        step re-creates it, so ``count`` is the step ordinal within the
        polling window."""
        self._health_state = None

    # ------------------------------------------------------------ reads
    def get_outputs(self, merge_multi_context=True):
        outs = list(self.execs[0].outputs)
        for o in outs:
            o._read()       # run any deferred work
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        raise MXNetError("inputs_need_grad is not supported on the fused "
                         "route; set MXNET_MODULE_FUSED=0")

    def install_monitor(self, mon):
        raise MXNetError("a monitor needs the per-executor route; "
                         "Module re-binds onto it automatically")

    # ------------------------------------------------ device metric tally
    def enable_device_metric(self, eval_metric):
        """Fold ``eval_metric``'s statistic into the step: each step adds
        its (sum, count) rows to a device tally, which ``get()`` reads
        back once. Installed by ``Module.fit`` only. Returns True when
        installed (a metric with a device statistic, the step on)."""
        self.disable_device_metric()
        if not (self._step_enabled and self.for_training and
                self._label_names):
            return False
        stat = eval_metric.fused_stat()
        if stat is None:
            return False
        self._metric_stat = stat
        self._metric_slots = getattr(stat, "n_slots", 1)
        self._metric_live = eval_metric
        self._metric_step_done = False
        self._metric_acc = None
        eval_metric._bind_device_tally(self._read_metric_tally,
                                       self._zero_metric_tally)
        return True

    def disable_device_metric(self):
        """Detach any live tally: what it holds is folded into its metric
        first; later steps stop adding to it."""
        if self._metric_live is not None:
            self._metric_live._drain_device()
            self._metric_live._unbind_device_tally()
        self._metric_stat = None
        self._metric_live = None
        self._metric_acc = None
        self._metric_step_done = False

    def score_device(self, eval_data, eval_metric, num_batch=None):
        """Evaluate with the metric tallied on the device: one forward
        per batch and ONE readback at the end. A batch shorter than the
        bound one runs zero-padded and only its real rows are tallied.
        Returns ``(name_value_pairs, batches_seen)``, or None when the
        metric has no device statistic or the iterator's shapes are not
        the bound ones (the host loop re-binds for them)."""
        stat = eval_metric.fused_stat()
        if stat is None or not self._label_names:
            return None
        bound = [tuple(s) for _, s in self.data_shapes]
        given = [tuple(d[1]) for d in getattr(eval_data, "provide_data",
                                              None) or []]
        if given and not all(g[1:] == b[1:] and g[0] <= b[0]
                             for g, b in zip(given, bound)):
            return None     # other shapes: the host loop re-binds for them
        self._flush()
        from ..io import DataBatch
        from .base_module import pad_batch_rows
        dev = self.contexts[0].torch_device()
        slots = getattr(stat, "n_slots", 1)
        acc = (torch.zeros(slots, dtype=torch.float32, device=dev),
               torch.zeros(slots, dtype=torch.int32, device=dev))
        params, aux = self._params_now(), self._aux_now()
        seen = 0
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            if not batch.label or all(lb is None for lb in batch.label):
                raise MXNetError("score() needs labels; batch %d has none"
                                 % nbatch)
            rows = batch.data[0].shape[0]
            if 0 < rows < self.batch_size:
                batch = DataBatch(
                    data=[pad_batch_rows(d, self.batch_size)
                          for d in batch.data],
                    label=[None if lb is None else
                           pad_batch_rows(lb, self.batch_size)
                           for lb in batch.label])
            self._stage(batch)
            inputs = self._inputs_now()
            with self._program("fwd_eval_stat", inputs):
                outs, _ = self._forward_only(params, aux, inputs, False)
            labels = [inputs[n] for n in self._label_names]
            if 0 < rows < self.batch_size:
                outs = tuple(o[:rows] if o.dim() >= 1 and
                             o.shape[0] == self.batch_size else o
                             for o in outs)
                labels = [lb[:rows] for lb in labels]
            acc = _tally_add(stat, labels, outs, acc)
            seen = nbatch + 1
        self._train_staged = False
        eval_metric.reset()
        eval_metric._fold_tally(self._pack_tally(*acc))
        return eval_metric.get_name_value(), seen

    @staticmethod
    def _pack_tally(sums, counts):
        """A (sums, counts) device tally as a numpy (n, 2) float64 array:
        one readback (both columns exact in float64)."""
        both = torch.stack([sums.double(), counts.double()], dim=1)
        return both.cpu().numpy()

    def _read_metric_tally(self):
        if self._metric_acc is None:
            return onp.zeros((self._metric_slots, 2), onp.float64)
        return self._pack_tally(*self._metric_acc)

    def _zero_metric_tally(self):
        self._metric_acc = None

    def update_metric(self, eval_metric, labels):
        if eval_metric is self._metric_live and self._metric_step_done:
            # the step already added this batch's rows to the device tally
            self._metric_step_done = False
            return
        eval_metric.update(labels, self.get_outputs())
