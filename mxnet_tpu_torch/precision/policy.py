"""Precision policies — declarative, opt-in byte and FLOP levers
(PyTorch counterpart of ``mxnet_tpu/precision/policy.py``).

A :class:`PrecisionPolicy` names one point in the precision trade space
and the Module / Updater / executor stack applies it at its seams:

* ``compute_dtype="bfloat16"`` — parameters (float32 masters) and inputs
  are cast to bfloat16 inside the step's autograd graph, so activations,
  convolutions and GEMMs run in bfloat16 on the tensor cores and every
  gradient reaches its float32 master as float32. BatchNorm keeps float32
  statistics and moving stats.
* ``opt_state_dtype="bfloat16"`` — optimizer state (momentum, Adam
  moments) is STORED as bfloat16 while parameters stay float32 masters;
  the fused per-parameter apply upcasts to float32, computes, and rounds
  back on the way out (:func:`wrap_fused_apply`).
* ``remat=...`` — a named checkpoint policy for the segmented evaluator
  (``executor._build_eval_segmented``): ``"none"``, ``"full"``
  (recompute everything inside a segment), ``"dots_saveable"`` (keep
  convolution and matmul outputs), ``"offload_bn_stats"`` (as
  ``dots_saveable``, see :func:`remat_checkpoint_policy`), or a
  selective-checkpoint policy callable.
* ``loss_scale=`` / ``loss_scale_window=`` — a dynamic loss scale that
  lives on the device (:func:`loss_scale_config`).
* ``act_cast="int8"|"fp8"`` — the experimental low-bit input seam: every
  non-label input takes a value-level round trip through the narrow
  format (:func:`fake_cast`) in training and in eval.
* ``weight_quant="int8"`` / ``narrow_math="int8"|"fp8"`` — the
  serving-only levers of :mod:`mxnet_tpu_torch.precision.quant`:
  weight-only int8 storage (the decode engine) and native int8 / fp8
  GEMMs behind the FullyConnected and Convolution seams (eval forwards).

Every mode keeps the repo's contracts: exact within-mode reproducibility
(same mode and seed give bit-identical parameters), and the ``f32`` mode
changes nothing against no policy at all.
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch

from ..base import MXNetError

__all__ = ["PrecisionPolicy", "MODES", "resolve", "register_mode",
           "mode_name", "canon_dtype", "canon_remat", "state_np_dtype",
           "wrap_fused_apply", "remat_checkpoint_policy",
           "loss_scale_config", "fake_cast", "to_e4m3"]

# |x| above this casts to NaN in e4m3 (the JAX package's ml_dtypes cast:
# 448 is the largest finite value and 464, halfway to the next binade,
# still rounds to it); torch's own cast saturates instead
E4M3_NAN_ABOVE = 464.0


# ---------------------------------------------------------------------------
# canonicalization
# ---------------------------------------------------------------------------
def canon_dtype(d, field="dtype"):
    """Canonical storage-dtype spelling: ``None`` (float32 / follow the
    parameter) or ``"bfloat16"``; accepts the common aliases."""
    if d is None:
        return None
    if d is torch.float32:
        return None
    if d is torch.bfloat16:
        return "bfloat16"
    s = str(d).lower()
    if s in ("f32", "fp32", "float32"):
        return None
    if s in ("bf16", "bfloat16"):
        return "bfloat16"
    raise MXNetError(
        "precision %s must be None/'float32' or 'bfloat16' (got %r)"
        % (field, d))


def canon_remat(r):
    """Canonical remat-policy name: ``None`` (no remat), ``"full"``,
    ``"dots"`` (dots_saveable), ``"bn_stats"`` (offload_bn_stats), or a
    selective-checkpoint policy callable passed through."""
    if r is None or callable(r):
        return r
    s = str(r).lower()
    if s == "none":
        return None
    if s == "full":
        return "full"
    if s in ("dots", "dots_saveable"):
        return "dots"
    if s in ("bn_stats", "offload_bn_stats"):
        return "bn_stats"
    raise MXNetError(
        "remat policy must be one of 'none', 'full', 'dots_saveable', "
        "'offload_bn_stats' or a checkpoint-policy callable (got %r)"
        % (r,))


def state_np_dtype(name, weight_dtype):
    """The dtype optimizer-state zeros are allocated with for a canonical
    ``state_dtype`` spelling (``None`` follows the weight):
    ``torch.bfloat16`` for ``"bfloat16"``."""
    if name is None:
        return weight_dtype
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise MXNetError("unknown state dtype %r" % (name,))


# the ops that read an input as indices, by the input's position: bfloat16
# keeps 8 significant bits, so it holds every integer only up to 256 (an
# Embedding id of 8,200 would read row 8,192), and the compute-dtype cast
# leaves a variable that feeds nothing but these in float32
_INDEX_ARGS = {"Embedding": 0, "take": 1, "batch_take": 1, "one_hot": 0,
               "pick": 1, "gather_nd": 1}
# the sequence ops read their lengths as indices: position 1, an input
# they take only under use_sequence_length
_LENGTH_ARGS = frozenset(("SequenceLast", "SequenceMask", "SequenceReverse"))
# the ops that only move their first input's elements (views, slices,
# repeats, copies): ids that pass through one are still ids
_SHAPE_OPS = frozenset((
    "Reshape", "SwapAxis", "transpose", "Flatten", "expand_dims",
    "slice_axis", "slice", "SliceChannel", "reverse", "repeat", "tile",
    "broadcast_axis", "broadcast_to", "BlockGrad", "_CrossDeviceCopy"))


def _index_pos(node):
    """The position of ``node``'s input that it reads as indices, or
    None."""
    name = node.op.name
    if name in _LENGTH_ARGS:
        return 1 if node.attrs.get("use_sequence_length", False) else None
    return _INDEX_ARGS.get(name)


def index_inputs(symbol):
    """The names of ``symbol``'s variables whose every path ends in an
    index argument (``_INDEX_ARGS``, the sequence ops' lengths), directly
    or through shape-only ops (``_SHAPE_OPS``): the inputs that stay
    float32 under the compute dtype and ``act_cast``, as the labels do.
    A shape op on the way whose output also feeds anything else, or is
    one of the symbol's outputs, leaves the variable to be cast."""
    order = symbol._topo()
    uses = {}
    for node in order:
        for i, (src, _) in enumerate(node.inputs):
            uses.setdefault(id(src), []).append((node, i))
    heads = {id(n) for n, _ in symbol._heads}
    only = {}
    for node in reversed(order):         # every consumer before its inputs
        dsts = uses.get(id(node), ())
        only[id(node)] = bool(dsts) and id(node) not in heads and all(
            i == _index_pos(dst) or (i == 0 and dst.op.name in _SHAPE_OPS
                                     and only[id(dst)])
            for dst, i in dsts)
    return frozenset(n.name for n in order if n.op is None and only[id(n)])


# ---------------------------------------------------------------------------
# the policy object + named-mode registry
# ---------------------------------------------------------------------------
class PrecisionPolicy(object):
    """One named point in the precision trade space (module docstring).

    All fields default to the float32 baseline; a policy with every field
    at its default is a no-op and trains bit-identically to a module
    constructed without one."""

    __slots__ = ("name", "compute_dtype", "opt_state_dtype", "remat",
                 "act_cast", "weight_quant", "narrow_math", "calibration",
                 "loss_scale", "loss_scale_window", "experimental")

    def __init__(self, name=None, compute_dtype=None, opt_state_dtype=None,
                 remat=None, act_cast=None, weight_quant=None,
                 narrow_math=None, calibration=None, loss_scale=None,
                 loss_scale_window=None, experimental=False):
        self.compute_dtype = canon_dtype(compute_dtype, "compute_dtype")
        self.opt_state_dtype = canon_dtype(opt_state_dtype,
                                           "opt_state_dtype")
        self.remat = canon_remat(remat)
        if act_cast not in (None, "int8", "fp8"):
            raise MXNetError("act_cast must be None, 'int8' or 'fp8' "
                             "(got %r)" % (act_cast,))
        self.act_cast = act_cast
        if weight_quant not in (None, "int8"):
            raise MXNetError("weight_quant must be None or 'int8' "
                             "(got %r)" % (weight_quant,))
        self.weight_quant = weight_quant
        if narrow_math not in (None, "int8", "fp8"):
            raise MXNetError("narrow_math must be None, 'int8' or 'fp8' "
                             "(got %r)" % (narrow_math,))
        self.narrow_math = narrow_math
        # a calibration table or None; not part of the mode name
        self.calibration = calibration
        # None means "the environment's value at bind time"
        # (loss_scale_config reads the knobs lazily)
        self.loss_scale = None if loss_scale is None else float(loss_scale)
        self.loss_scale_window = None if loss_scale_window is None \
            else int(loss_scale_window)
        self.experimental = bool(experimental)
        self.name = str(name) if name else self._auto_name()

    def _auto_name(self):
        """Deterministic name from the canonical fields, so an ad-hoc
        policy recorded into a checkpoint manifest matches the policy a
        resumed run builds from the same flags."""
        parts = []
        if self.compute_dtype:
            parts.append("compute=%s" % self.compute_dtype)
        if self.opt_state_dtype:
            parts.append("opt=%s" % self.opt_state_dtype)
        if self.remat is not None:
            parts.append("remat=%s" % (self.remat if not
                                       callable(self.remat) else "custom"))
        if self.act_cast:
            parts.append("act=%s" % self.act_cast)
        if self.weight_quant:
            parts.append("wq=%s" % self.weight_quant)
        if self.narrow_math:
            parts.append("nm=%s" % self.narrow_math)
        # the loss scale changes numerics, so a scale-only policy must not
        # take the f32 baseline's name (manifests compare by name)
        if self.loss_scale is not None:
            parts.append("ls=%g" % self.loss_scale)
        if self.loss_scale_window is not None:
            parts.append("lsw=%d" % self.loss_scale_window)
        if not parts:
            return "f32"
        return "custom(%s)" % ",".join(parts)

    def is_default(self):
        """True when this policy changes nothing against float32."""
        return (self.compute_dtype is None and self.opt_state_dtype is None
                and self.remat is None and self.act_cast is None
                and self.weight_quant is None and self.narrow_math is None
                and self.loss_scale is None)

    def serving_only(self):
        """True when the policy only makes sense for inference (quantized
        weight storage, native narrow GEMMs)."""
        return self.weight_quant is not None or self.narrow_math is not None

    def describe(self):
        return {"name": self.name,
                "compute_dtype": self.compute_dtype or "float32",
                "opt_state_dtype": self.opt_state_dtype or "float32",
                "remat": ("custom" if callable(self.remat)
                          else (self.remat or "none")),
                "act_cast": self.act_cast,
                "weight_quant": self.weight_quant,
                "narrow_math": self.narrow_math,
                "calibration_digest": (None if self.calibration is None
                                       else self.calibration.digest()),
                "loss_scale": self.loss_scale,
                "loss_scale_window": self.loss_scale_window,
                "experimental": self.experimental}

    def __repr__(self):
        return "PrecisionPolicy(%r)" % (self.describe(),)


MODES = {
    # the reference point: trains bit-identically to no policy at all
    "f32": PrecisionPolicy("f32"),
    # activations and gradients in bfloat16, float32 masters
    "bf16": PrecisionPolicy("bf16", compute_dtype="bfloat16"),
    # optimizer state stored bfloat16, float32 masters and update math
    "bf16_opt": PrecisionPolicy("bf16_opt", opt_state_dtype="bfloat16"),
    # bfloat16 optimizer state + dots_saveable remat
    "combined": PrecisionPolicy("combined", opt_state_dtype="bfloat16",
                                remat="dots_saveable"),
    # the quantized modes (precision/quant.py): the first two train with
    # a low-bit input seam, the last three serve only
    "int8_act": PrecisionPolicy("int8_act", compute_dtype="bfloat16",
                                act_cast="int8", experimental=True),
    "fp8": PrecisionPolicy("fp8", compute_dtype="bfloat16",
                           act_cast="fp8", experimental=True),
    "int8_weight": PrecisionPolicy("int8_weight", weight_quant="int8"),
    "int8_serve": PrecisionPolicy("int8_serve", act_cast="int8",
                                  narrow_math="int8"),
    "fp8_native": PrecisionPolicy("fp8_native", compute_dtype="bfloat16",
                                  act_cast="fp8", narrow_math="fp8",
                                  experimental=True),
}


def register_mode(policy):
    """Register a custom named mode (overwrites an existing name)."""
    if not isinstance(policy, PrecisionPolicy):
        raise MXNetError("register_mode takes a PrecisionPolicy")
    MODES[policy.name] = policy
    return policy


def resolve(spec=None):
    """Resolve a mode name / :class:`PrecisionPolicy` / None into a
    policy (or None = the implicit float32 baseline). ``None`` consults
    ``MXNET_PRECISION_MODE``; experimental modes also need
    ``MXNET_PRECISION_EXPERIMENTAL=1``."""
    if spec is None:
        spec = os.environ.get("MXNET_PRECISION_MODE") or None
        if spec is None:
            return None
    if isinstance(spec, PrecisionPolicy):
        pol = spec
    else:
        pol = MODES.get(str(spec))
        if pol is None:
            raise MXNetError(
                "unknown precision mode %r; known modes: %s (or pass a "
                "PrecisionPolicy)" % (spec, sorted(MODES)))
    if pol.experimental and os.environ.get(
            "MXNET_PRECISION_EXPERIMENTAL", "0") != "1":
        raise MXNetError(
            "precision mode %r is experimental; set "
            "MXNET_PRECISION_EXPERIMENTAL=1 to opt in" % pol.name)
    return pol


def mode_name(policy):
    """The recorded mode name of a resolved policy (None -> 'f32'): the
    one spelling checkpoint manifests and the serving check compare."""
    return "f32" if policy is None else policy.name


# ---------------------------------------------------------------------------
# the applying pieces
# ---------------------------------------------------------------------------
def wrap_fused_apply(fa, state_dtype):
    """Wrap an optimizer's per-parameter apply so narrow-stored state
    computes in float32 master math: state leaves upcast to float32 at
    entry, the new state rounds back to ``state_dtype`` (round to
    nearest even) on the way out. The parameter update consumes the
    UNROUNDED float32 state; between steps the state lives, and
    round-trips through checkpoints, at the storage dtype, which keeps
    within-mode resume bit-exact."""
    dt = state_np_dtype(state_dtype, None)

    def _cast(t, dtype):
        if t is None:
            return None
        if isinstance(t, (tuple, list)):
            return tuple(_cast(x, dtype) for x in t)
        return t.to(dtype)

    def wrapped(xp, p, g, s, lr, wd):
        new_p, new_s = fa(xp, p, g, _cast(s, torch.float32), lr, wd)
        return new_p, _cast(new_s, dt)

    return wrapped


# aten operators whose outputs "dots" keeps: convolutions and matrix
# products (the counterpart of jax's dots_saveable)
_WHOLE = threading.local()


@contextlib.contextmanager
def recompute_whole():
    """A block whose operations a selective remat policy recomputes, none
    kept: for a composite op whose internals the policy must not split
    (PyTorch's CPU RNN writes into its products in place, so a kept
    product would be read back changed)."""
    _WHOLE.depth = getattr(_WHOLE, "depth", 0) + 1
    try:
        yield
    finally:
        _WHOLE.depth -= 1


def _dot_ops():
    aten = torch.ops.aten
    return {aten.convolution.default, aten.mm.default, aten.addmm.default,
            aten.bmm.default}


def to_e4m3(x):
    """``x`` cast to ``torch.float8_e4m3fn`` with the JAX package's
    overflow rule: a value above ``E4M3_NAN_ABOVE`` in magnitude, or not
    finite, becomes NaN (torch's cast would saturate it to ±448). Every
    fp8 cast of the port goes through here."""
    ok = x.abs() <= E4M3_NAN_ABOVE
    return torch.where(ok, x, torch.full_like(x, float("nan"))).to(
        torch.float8_e4m3fn)


def fake_cast(v, kind):
    """The experimental low-bit input cast: a value-level round trip
    through the narrow format (fake quantization), so the numerics see
    the precision loss while the surrounding compute stays in ``v``'s
    dtype. ``int8``: symmetric per-tensor scale onto the [-127, 127]
    grid, in float32 and in the JAX package's order (amax, scale, divide,
    round half to even, clip, multiply); ``fp8``: an e4m3 round trip
    (:func:`to_e4m3`)."""
    if kind == "fp8":
        return to_e4m3(v).to(v.dtype)
    if kind == "int8":
        vf = v.float()
        amax = vf.abs().amax()
        # device tensors, not Python numbers: the card divides by a host
        # scalar as a multiply by its reciprocal
        scale = torch.where(amax > 0, amax / _const(127.0, v.device),
                            _const(1.0, v.device))
        q = torch.clamp(torch.round(vf / scale), -127.0, 127.0)
        return (q * scale).to(v.dtype)
    raise MXNetError("unknown act_cast %r" % (kind,))


_CONSTS = {}


def _const(value, device):
    """A cached float32 0-d tensor on ``device``. A tensor made under a
    trace (``torch.export``'s fake tensors) is the trace's own and is
    never cached: a later eager call or trace must not find it."""
    from torch._subclasses.fake_tensor import is_fake
    key = (float(value), device)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(float(value), dtype=torch.float32, device=device)
        if not is_fake(t):
            _CONSTS[key] = t
    return t


def remat_checkpoint_policy(remat):
    """The selective-checkpoint policy for a canonical remat spec
    (:func:`canon_remat` output), for
    ``torch.utils.checkpoint.create_selective_checkpoint_contexts``:
    ``"full"`` maps to None (recompute everything inside a segment);
    ``"dots"`` keeps convolution and matmul outputs; a callable passes
    through.

    ``"bn_stats"`` keeps what ``"dots"`` keeps. In the JAX package it also
    keeps the BatchNorm statistics so that a replayed segment skips the
    statistics sweep; here the BatchNorm core computes its statistics and
    its output in the same single pass over a channel's slab (one kernel
    launch on the card), so a kept statistic would save no sweep, and the
    replay recomputes them bit for bit. Inside ``recompute_whole`` nothing
    is kept."""
    if callable(remat):
        return remat
    if remat == "full":
        return None
    if remat in ("dots", "bn_stats"):
        from torch.utils.checkpoint import CheckpointPolicy
        keep = _dot_ops()

        def policy(ctx, op, *args, **kwargs):
            if op in keep and not getattr(_WHOLE, "depth", 0):
                return CheckpointPolicy.MUST_SAVE
            return CheckpointPolicy.PREFER_RECOMPUTE

        return policy
    raise MXNetError("unknown remat policy %r" % (remat,))


def loss_scale_config(policy):
    """Dynamic-loss-scale configuration for a policy, or None when the
    policy does not scale. The scale lives ON THE DEVICE as a (scale
    float32, good steps int32, skipped int32) triple carried through the
    step: gradients found non-finite skip the update and halve the scale;
    after ``window`` consecutive finite steps the scale doubles (clamped
    to [1, 2^24]); nothing is read back on the step path.

    Fields left at None resolve here, at bind time, from
    ``MXNET_PRECISION_LOSS_SCALE`` (default 2^15) and
    ``MXNET_PRECISION_SCALE_WINDOW`` (default 2000)."""
    if policy is None or (policy.loss_scale is None
                          and policy.act_cast is None):
        return None
    init = policy.loss_scale if policy.loss_scale is not None else \
        float(os.environ.get("MXNET_PRECISION_LOSS_SCALE",
                             str(2.0 ** 15)))
    window = policy.loss_scale_window \
        if policy.loss_scale_window is not None else \
        int(os.environ.get("MXNET_PRECISION_SCALE_WINDOW", "2000"))
    return {"init": float(init), "window": int(window),
            "scale_max": 2.0 ** 24, "scale_min": 1.0}
