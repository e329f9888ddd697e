"""Continuous-batching decode engine: slot-structured step-wise serving
for sequence models (the port's counterpart of
``mxnet_tpu/serving/decode.py``).

The Predictor/DynamicBatcher stack serves one-shot fixed-shape requests;
an autoregressive LM is served as a decode loop, one launch per step over
a batch in which sequences join and retire mid-flight. The engine keeps
the JAX package's three disciplines, in eager PyTorch:

* **bucketed-by-length prefill** — a prompt runs through one program per
  power-of-two length bucket, padded up; a per-row length mask makes the
  padding a ``torch.where`` select, so the bucketed prefill is bit for
  bit the whole-sequence forward at the exact length
  (:meth:`DecodeEngine.prefill_parity`). Longer prompts chunk through the
  top bucket, carrying the slot's state.
* **slot-structured decode state** — the recurrent state (the LSTM's
  h/c, the transformer's token window) lives on the device as one dict
  of ``(slots, ...)`` tensors. It is never written in place: a step
  builds new rows and selects ``where(active, new, old)``; a prefill
  writes its real rows into a copy with ``index_copy`` (the JAX scatter's
  ``mode="drop"`` becomes a choice of rows made on the host).
* **continuous batching** — between steps the scheduler thread admits
  queued sequences into free slots and retires finished ones, then runs
  ONE step over all ``slots`` rows whatever the occupancy. A row's
  result depends only on that row, and the step's shapes never change,
  so a request's token stream at occupancy N equals, bit for bit, the
  same request decoded alone.

Each step moves one packed int64 vector host→device (tokens, active
mask, step counters, seeds; from a pinned buffer on the card) and reads
one ``(slots,)`` vector back; that readback is the step's
synchronisation point. The step is eager: its operators are dispatched
one by one (a CUDA graph of it is ROADMAP A4). No step runs a
hand-written kernel: the JAX package computes this path with ``jnp``
under ``jit``, outside any Pallas kernel.

A "compile" here is a program's first run (the Predictor's rule):
:meth:`DecodeEngine.warmup` runs state init, every prefill bucket and
one step on scratch state, and ``stats()["compiles"]`` stays frozen
afterwards under any occupancy churn.

Precision (``precision=``, every mode the JAX engine takes): the
parameters are staged once in the mode's compute dtype (``bf16``:
bfloat16 weights, float32 recurrent state, each product in its operands'
promoted dtype, as ``jnp`` promotes); under ``int8_weight`` the device
holds per-channel int8 weights and float32 scales
(``precision.quant.QuantLeaf``) and each step, prefill and parity
reference widens them (``dequant_params``), so the bytes a step receives
(:meth:`DecodeEngine.step_argument_bytes`) count the int8 storage.

Persistent executable cache (``warmup(cache_dir=)`` or
``MXNET_COMPILE_CACHE_DIR``; :mod:`mxnet_tpu_torch.serving.cache`): state
init, the step and each prefill bucket are traced once with
``torch.export`` (parameters and state as inputs) into entries keyed by
the model's digest, the mode, the program and its shapes, the sampler's
temperature and the backend; a warm replica loads them, traces nothing,
and streams bit for bit as the cold one. Fault seams:
``serving.decode_worker`` (the scheduler tick), ``serving.decode_step``
(each step launch) and ``serving.decode_abandon`` (the oldest active
request's client walks away mid-stream).

Quick start::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving.decode import DecodeEngine, LSTMCharLM

    model = LSTMCharLM(vocab_size=32, num_hidden=32, num_embed=16)
    eng = DecodeEngine(model, model.init_params(seed=0), slots=4)
    eng.warmup()                       # every program's first run
    reqs = [eng.submit(prompt, max_new_tokens=16) for prompt in prompts]
    streams = [r.result(timeout=60) for r in reqs]
    eng.shutdown(drain=True)

Env knobs: ``MXNET_SERVE_DECODE_SLOTS`` (default slot count),
``MXNET_SERVE_DECODE_MAX_STEPS`` (per-request generation cap),
``MXNET_SERVE_DECODE_TTFT_SLO_MS`` / ``MXNET_SERVE_DECODE_TOKEN_SLO_MS``
(default SLO objectives), ``MXNET_SERVE_MAX_WORKER_RESTARTS``.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import logging
import os
import threading
import time

import numpy as onp
import torch
import torch.nn.functional as F

from .. import faults as _faults
from .. import telemetry
from ..base import MXNetError, torch_dtype
from ..context import Context, gpu
from ..precision import quant as _quant
from ..precision.policy import resolve as _resolve_precision, state_np_dtype
from ..telemetry.slo import SLOTracker
from .errors import (QueueFull, RequestAbandoned, RequestTimeout,
                     ServerClosed, TenantShed, WorkerCrashed)
from .stats import DECODE_TRACE_PHASES, ServingStats

__all__ = ["DecodeModel", "LSTMCharLM", "TransformerLM", "DecodeRequest",
           "DecodeEngine", "PREFILL_ROWS", "exact_softmax",
           "counter_uniform"]

logger = logging.getLogger("mxnet_tpu_torch.serving")

# prefill programs run a fixed tiny row batch: row 0 is the admitted
# request, the rest are masked padding (length 0, slot index = slots, so
# they never land). Two rows, not one: a 1-row matrix product takes a
# matrix-vector path that may round differently, and the prefill_parity
# reference runs the same two rows.
PREFILL_ROWS = 2

_M32 = 0xFFFFFFFF


def _env_int(name, default):
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _host(v):
    """NDArray / tensor / array-like -> numpy."""
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return onp.asarray(v)


def _init_uniform(shapes, seed, scale):
    """The JAX package's ``init_params`` formula: numpy ``RandomState``
    uniforms in [-scale, scale), drawn in sorted name order."""
    rng = onp.random.RandomState(int(seed))
    return {k: (rng.rand(*s) * 2 - 1).astype(onp.float32) * scale
            for k, s in sorted(shapes.items())}


def _linear(x, w, b):
    """``x @ w.T + b`` in the operands' promoted dtype: a bfloat16 weight
    against float32 activations computes in float32, as ``jnp`` promotes
    (in float32 every cast is a no-op)."""
    dt = torch.promote_types(torch.promote_types(x.dtype, w.dtype), b.dtype)
    return F.linear(x.to(dt), w.to(dt), b.to(dt))


def _matmul(a, b):
    """``a @ b`` in the operands' promoted dtype (``jnp``'s rule)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _adopt(model, arrs, what):
    want = model.param_shapes()
    got = {k: tuple(v.shape) for k, v in arrs.items() if k in want}
    bad = [k for k in want if got.get(k) != want[k]]
    if bad:
        raise MXNetError("%s.from_params: missing/mismatched params %s "
                         "(want %s)" % (what, bad,
                                        {k: want[k] for k in bad}))
    model._adopted = {k: arrs[k] for k in want}
    return model


# ---------------------------------------------------------------------------
# model interface
# ---------------------------------------------------------------------------
class DecodeModel(object):
    """An autoregressive model the engine can serve.

    Subclasses define ``vocab_size``, :meth:`state_struct` (the
    per-sequence recurrent-state rows) and :meth:`step` (one token of
    batched forward math, row-independent, never writing its inputs).
    :meth:`prefill`, a length-masked loop over :meth:`step`, comes for
    free: padded positions leave the state through an exact ``where``
    select, and each row's logits are taken at its own last position.
    """

    vocab_size = None

    def state_struct(self):
        """``{name: (per_row_shape, dtype_str)}`` of the recurrent state;
        the engine allocates each as ``(slots,) + shape``."""
        raise NotImplementedError

    def step(self, params, tokens, state):
        """One decode step: ``(params, (B,) int64 tokens, state rows) ->
        (new state rows, (B, vocab) logits)``, row r depending only on
        row r's inputs."""
        raise NotImplementedError

    def signature(self):
        """Canonical config string (part of :meth:`params_digest`)."""
        raise NotImplementedError

    def params_digest(self, params):
        """sha256 of (config, parameter names, parameter bytes): two
        processes, or the two packages, holding bit-equal parameters agree
        on it."""
        h = hashlib.sha256(self.signature().encode())
        for k in sorted(params):
            h.update(k.encode())
            h.update(onp.ascontiguousarray(_host(params[k])).tobytes())
        return h.hexdigest()

    def prefill(self, params, tokens, lengths, state0):
        """Whole-prompt forward: ``tokens (B, L)``, per-row real
        ``lengths (B,)``, initial state rows ``state0``. Returns (state
        rows after each row's last real position, logits there).
        Positions ``t >= lengths[b]`` leave row ``b`` as it was."""
        B, L = tokens.shape
        logits = torch.zeros((B, int(self.vocab_size)), dtype=torch.float32,
                             device=tokens.device)
        last = lengths - 1
        state = dict(state0)
        for t in range(L):
            new_state, new_logits = self.step(params, tokens[:, t], state)
            keep = lengths > t
            state = {k: torch.where(
                keep.view((B,) + (1,) * (n.dim() - 1)), n, state[k])
                for k, n in new_state.items()}
            logits = torch.where((last == t)[:, None],
                                 new_logits.to(logits.dtype), logits)
        return state, logits


class LSTMCharLM(DecodeModel):
    """The char-LSTM of ``examples/decode_lm.py`` as a decode model.

    The step is :class:`mxnet_tpu_torch.rnn.LSTMCell`'s math (gate order
    [i, f, g, o], ``FullyConnected`` = ``x @ W.T + b``), so
    :meth:`from_params` adopts parameters trained through ``Module.fit``
    on the unfused ``lstm_l<i>_`` graph verbatim: ``embed_weight``,
    ``lstm_l<i>_{i2h,h2h}_{weight,bias}``, ``pred_{weight,bias}``.
    """

    def __init__(self, vocab_size, num_hidden=64, num_embed=32,
                 num_layers=1):
        self.vocab_size = int(vocab_size)
        self.num_hidden = int(num_hidden)
        self.num_embed = int(num_embed)
        self.num_layers = int(num_layers)

    def signature(self):
        return ("lstm_char_lm:vocab=%d;embed=%d;hidden=%d;layers=%d"
                % (self.vocab_size, self.num_embed, self.num_hidden,
                   self.num_layers))

    def state_struct(self):
        shape = (self.num_layers, self.num_hidden)
        return {"h": (shape, "float32"), "c": (shape, "float32")}

    def param_shapes(self):
        """``{name: shape}`` of the full parameter set."""
        V, E, H = self.vocab_size, self.num_embed, self.num_hidden
        shapes = {"embed_weight": (V, E),
                  "pred_weight": (V, H), "pred_bias": (V,)}
        for l in range(self.num_layers):
            in_dim = E if l == 0 else H
            shapes["lstm_l%d_i2h_weight" % l] = (4 * H, in_dim)
            shapes["lstm_l%d_i2h_bias" % l] = (4 * H,)
            shapes["lstm_l%d_h2h_weight" % l] = (4 * H, H)
            shapes["lstm_l%d_h2h_bias" % l] = (4 * H,)
        return shapes

    def init_params(self, seed=0, scale=0.1):
        """Deterministic random parameters, the JAX package's numpy
        formula: the two packages' dicts are equal bit for bit."""
        return _init_uniform(self.param_shapes(), seed, scale)

    @classmethod
    def from_params(cls, params, num_layers=None):
        """Adopt a trained parameter dict (numpy, NDArray or tensor
        values) of the unfused char-LM graph; the config is inferred from
        the shapes."""
        arrs = {k: _host(v) for k, v in params.items()}
        if num_layers is None:
            num_layers = len([k for k in arrs if k.endswith("_i2h_weight")])
        V, E = arrs["embed_weight"].shape
        H = arrs["lstm_l0_h2h_weight"].shape[1]
        return _adopt(cls(V, num_hidden=H, num_embed=E,
                          num_layers=num_layers), arrs, "LSTMCharLM")

    def step(self, params, tokens, state):
        x = params["embed_weight"][tokens]
        h_all, c_all = state["h"], state["c"]
        hs, cs = [], []
        for l in range(self.num_layers):
            p = "lstm_l%d_" % l
            gates = _linear(x, params[p + "i2h_weight"],
                            params[p + "i2h_bias"]) \
                + _linear(h_all[:, l], params[p + "h2h_weight"],
                          params[p + "h2h_bias"])
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c_all[:, l] \
                + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
            cs.append(c)
            x = h
        logits = _linear(x, params["pred_weight"], params["pred_bias"])
        return ({"h": torch.stack(hs, dim=1), "c": torch.stack(cs, dim=1)},
                logits)


class TransformerLM(DecodeModel):
    """The ``example/transformer-lm`` causal decoder as a decode model.

    The recurrent state is the sliding token window of the training
    length: each step writes the incoming token at its row's position
    (shifting left once the window is full) and re-runs the causal
    forward over the window, the math of the training graph
    (``FullyConnected`` = ``x @ W.T + b``, softmax over ``scores +
    causal_mask``), so :meth:`from_params` adopts trained parameters
    (``embed_weight``, ``pos_embed``,
    ``blk<i>_{att_{q,k,v,o},mlp_{fc1,fc2}}_{weight,bias}``,
    ``head_{weight,bias}``) verbatim. The mask (``triu(-1e9)``) is built
    here, never read from a checkpoint. Positions past a row's length
    hold zeros that the mask keeps out of every attended position.
    """

    def __init__(self, vocab_size, num_embed, num_heads, window,
                 num_blocks):
        self.vocab_size = int(vocab_size)
        self.num_embed = int(num_embed)
        self.num_heads = int(num_heads)
        self.window = int(window)
        self.num_blocks = int(num_blocks)
        if self.num_embed % self.num_heads:
            raise MXNetError(
                "TransformerLM: num_embed %d not divisible by num_heads %d"
                % (self.num_embed, self.num_heads))
        self._mask = onp.triu(
            onp.full((self.window, self.window), -1e9, onp.float32), k=1)
        self._masks = {}      # device -> the mask on it

    def signature(self):
        return ("transformer_lm:vocab=%d;embed=%d;heads=%d;window=%d;"
                "blocks=%d" % (self.vocab_size, self.num_embed,
                               self.num_heads, self.window,
                               self.num_blocks))

    def state_struct(self):
        return {"ctx": ((self.window,), "int32"), "len": ((), "int32")}

    def param_shapes(self):
        V, D, T = self.vocab_size, self.num_embed, self.window
        shapes = {"embed_weight": (V, D), "pos_embed": (1, T, D),
                  "head_weight": (V, D), "head_bias": (V,)}
        for i in range(self.num_blocks):
            for p in ("att_q", "att_k", "att_v", "att_o"):
                shapes["blk%d_%s_weight" % (i, p)] = (D, D)
                shapes["blk%d_%s_bias" % (i, p)] = (D,)
            shapes["blk%d_mlp_fc1_weight" % i] = (4 * D, D)
            shapes["blk%d_mlp_fc1_bias" % i] = (4 * D,)
            shapes["blk%d_mlp_fc2_weight" % i] = (D, 4 * D)
            shapes["blk%d_mlp_fc2_bias" % i] = (D,)
        return shapes

    def init_params(self, seed=0, scale=0.1):
        """Deterministic random parameters (the JAX package's formula)."""
        return _init_uniform(self.param_shapes(), seed, scale)

    @classmethod
    def from_params(cls, params, num_heads):
        """Adopt a trained parameter dict of the transformer-lm graph;
        everything but the head count is inferred from the shapes."""
        arrs = {k: _host(v) for k, v in params.items()}
        V, D = arrs["embed_weight"].shape
        T = arrs["pos_embed"].shape[1]
        blocks = len([k for k in arrs if k.startswith("blk")
                      and k.endswith("_att_q_weight")])
        return _adopt(cls(V, num_embed=D, num_heads=num_heads, window=T,
                          num_blocks=blocks), arrs, "TransformerLM")

    def _mask_on(self, device):
        from torch._subclasses.fake_tensor import is_fake
        m = self._masks.get(device)
        if m is None:
            m = torch.from_numpy(self._mask).to(device)
            if not is_fake(m):      # a trace's tensor is the trace's own
                self._masks[device] = m
        return m

    def _block(self, params, x, i):
        """One decoder block over the window: causal multi-head attention
        and an MLP, both residual."""
        B, T, D = x.shape
        H = self.num_heads
        DH = D // H

        def proj(name, inp):
            return _linear(inp, params["blk%d_%s_weight" % (i, name)],
                           params["blk%d_%s_bias" % (i, name)])

        def heads(p):                      # (B, T, D) -> (B, H, T, DH)
            return p.reshape(B, T, H, DH).permute(0, 2, 1, 3)

        q, k, v = (heads(proj(n, x)) for n in ("att_q", "att_k", "att_v"))
        scores = (q @ k.transpose(-1, -2)) * float(onp.float32(DH ** -0.5))
        att = exact_softmax(scores + self._mask_on(x.device))
        ctx = _matmul(att, v).permute(0, 2, 1, 3).reshape(B, T, D)
        x = x + proj("att_o", ctx)
        h = torch.relu(proj("mlp_fc1", x))
        return x + proj("mlp_fc2", h)

    def step(self, params, tokens, state):
        T = self.window
        ctx, ln = state["ctx"], state["len"]        # (B, T), (B,)
        full = ln >= T
        # window full: slide left one and write at T-1; else append.
        # where/scatter build new tensors: the state is never written
        ctx = torch.where(full[:, None], torch.roll(ctx, -1, dims=1), ctx)
        pos = torch.where(full, T - 1, ln).long()
        ctx = ctx.scatter(1, pos[:, None], tokens.to(ctx.dtype)[:, None])
        x = params["embed_weight"][ctx] + params["pos_embed"][0]
        for i in range(self.num_blocks):
            x = self._block(params, x, i)
        B, _, D = x.shape
        h = x.gather(1, pos.view(B, 1, 1).expand(B, 1, D)).squeeze(1)
        logits = _linear(h, params["head_weight"], params["head_bias"])
        return {"ctx": ctx, "len": torch.clamp(ln + 1, max=T)}, logits


def exact_softmax(scores):
    """Max-subtracted softmax over the last axis, written out (max,
    subtract, exp, sum, divide) as the JAX package's decode models and
    ``mx.sym.softmax`` compute it."""
    z = scores - scores.amax(dim=-1, keepdim=True)
    e = torch.exp(z)
    return e / e.sum(dim=-1, keepdim=True)


def _mul32(x, c):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, in 16-bit halves of ``c`` so that no intermediate
    passes 2**49 (an int64 product of two 32-bit values could pass
    2**63)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def counter_uniform(seeds, steps, vocab, cols=None):
    """The counter-hash uniforms of the sampler: ``(B, vocab)`` float32
    in [1e-7, 1 - 1e-7], a pure function of (seed, step, token id) equal
    bit for bit to the JAX package's uint32 arithmetic, done here in
    int64 masked to 32 bits after every operation. ``seeds``/``steps``
    are ``(B,)`` int64 tensors; ``cols`` the cached
    ``_mul32(arange(vocab), 0x85EBCA77)``."""
    if cols is None:
        cols = _mul32(torch.arange(vocab, dtype=torch.int64,
                                   device=seeds.device), 0x85EBCA77)
    ctr = seeds[:, None] ^ _mul32(steps[:, None], 0x9E3779B9)
    x = (ctr + cols[None, :]) & _M32
    for mult in (0x7FEB352D, 0x846CA68B):
        x = _mul32(x ^ (x >> 16), mult)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(u, 1e-7, 1.0 - 1e-7)


# ---------------------------------------------------------------------------
# request future
# ---------------------------------------------------------------------------
class DecodeRequest(object):
    """One submitted sequence: a future over its generated token stream.
    Thread-safe; resolved exactly once (tokens or an exception): shutdown
    and abandonment both resolve it, a future never hangs."""

    def __init__(self, req_id, prompt, max_new_tokens, seed,
                 timeout_ms=None):
        self.id = req_id
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.seed = int(seed) & _M32
        self.timeout_ms = None if timeout_ms is None else float(timeout_ms)
        self._lock = threading.Lock()
        self._emitted = []
        self._done = threading.Event()
        self._exc = None
        self._cancel = False
        self.outcome = None   # "ok" | "abandoned" | "error" | "timeout"
        self.slot = None
        self.bucket = None          # top prefill length bucket used
        self.t_submit = time.time()
        self.deadline = (None if self.timeout_ms is None
                         else self.t_submit + self.timeout_ms / 1000.0)
        self.t_admit = None
        self.t_first = None         # first token emitted (TTFT point)
        self.t_done = None

    # -- engine side ----------------------------------------------------
    def _append(self, tok):
        with self._lock:
            self._emitted.append(int(tok))

    def _resolve(self, outcome, exc=None):
        with self._lock:
            if self._done.is_set():
                return
            self.outcome = outcome
            self._exc = exc
        self._done.set()

    # -- client side ----------------------------------------------------
    def tokens(self):
        """The tokens emitted so far (readable while streaming and after
        abandonment)."""
        with self._lock:
            return list(self._emitted)

    def cancel(self):
        """Abandon the stream: the engine retires the slot at the next
        step boundary and the future resolves with
        :class:`RequestAbandoned`."""
        self._cancel = True

    def done(self):
        return self._done.is_set()

    @property
    def ttft_ms(self):
        if self.t_first is None:
            return None
        return (self.t_first - self.t_submit) * 1000.0

    def result(self, timeout=None):
        """Block for the full stream; raises the resolution error
        (:class:`RequestAbandoned`, :class:`WorkerCrashed`,
        :class:`ServerClosed`, :class:`RequestTimeout`) if the request
        did not complete."""
        if not self._done.wait(timeout):
            raise TimeoutError("decode request %s still streaming after "
                               "%.1fs" % (self.id, timeout or 0))
        if self._exc is not None:
            raise self._exc
        return self.tokens()


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
class DecodeEngine(object):
    """Continuous-batching decode scheduler over one slot-structured
    device state (module docstring).

    Parameters
    ----------
    model : DecodeModel
    params : dict
        Host parameters (numpy / NDArray / tensor values), copied to the
        device once in the mode's compute dtype (int8 + float32 scales
        under ``int8_weight``); ``None`` takes a ``from_params`` model's.
    slots : int
        Concurrent sequences (``MXNET_SERVE_DECODE_SLOTS`` default).
    max_prefill_len : int
        Top of the power-of-two prefill bucket ladder (from 4); longer
        prompts chunk through the top bucket carrying slot state.
    temperature : float
        0 = greedy argmax; > 0 samples with a counter-hash Gumbel keyed by
        (request seed, step): same request, same stream, at any
        occupancy.
    eos_id : int or None
        Token id that retires a sequence early.
    precision : None, a mode name or a PrecisionPolicy
        ``None`` consults ``MXNET_PRECISION_MODE`` (default ``f32``);
        ``bf16`` decodes with bfloat16 weights, ``int8_weight`` from
        per-channel int8 weights.
    ttft_slo_ms / token_slo_ms : float
        p95 objectives of the two SLO trackers (0 disables one).
    shed_on_breach : bool
        Shed new submits (:class:`TenantShed`) while the TTFT objective
        is in multi-window burn-rate breach.
    start : bool
        Start the scheduler thread now; ``start=False`` lets a caller
        queue a whole arrival transcript first, then :meth:`start`.
    context : Context, optional
        The device; ``None`` means ``gpu(0)``. Pass ``mx.cpu()`` to run
        on the CPU.
    """

    def __init__(self, model, params, slots=None, max_prefill_len=32,
                 temperature=0.0, eos_id=None, precision=None,
                 max_queue=256, ttft_slo_ms=None, token_slo_ms=None,
                 shed_on_breach=False, name="decode", start=True,
                 context=None):
        self._model = model
        self._name = str(name)
        self._slots = int(slots if slots is not None else
                          _env_int("MXNET_SERVE_DECODE_SLOTS", 8))
        if self._slots < 1:
            raise MXNetError("DecodeEngine needs slots >= 1")
        self._max_steps = _env_int("MXNET_SERVE_DECODE_MAX_STEPS", 256)
        self._temperature = float(temperature)
        self._eos_id = None if eos_id is None else int(eos_id)
        # resolve(None) is the implicit f32 baseline (None); the engine
        # always runs under a named policy
        self._policy = _resolve_precision(precision) \
            or _resolve_precision("f32")
        self._max_queue = int(max_queue)
        self._shed_on_breach = bool(shed_on_breach)
        self._max_restarts = _env_int("MXNET_SERVE_MAX_WORKER_RESTARTS", 100)
        if context is None:
            context = gpu(0)
        elif not isinstance(context, Context):
            raise MXNetError("DecodeEngine runs on one device: context must "
                             "be a Context (got %r)" % (context,))
        self._device = context.torch_device()

        if getattr(model, "_adopted", None) is not None and params is None:
            params = model._adopted
        host = {k: _host(v) for k, v in params.items()}
        self._digest = model.params_digest(host)
        self._cdt = state_np_dtype(self._policy.compute_dtype, torch.float32)
        self._weight_quant = self._policy.weight_quant

        def stage(v, cast=True):
            floating = onp.issubdtype(v.dtype, onp.floating)
            t = torch.from_numpy(onp.ascontiguousarray(
                v.astype(onp.float32) if floating else v)).to(self._device)
            return t.to(self._cdt) if floating and cast else t

        if self._weight_quant == "int8":
            # weight-only int8: per-channel int8 + float32 scales on the
            # device, widened at each use (_dense_params)
            self._params = {
                k: _quant.QuantLeaf(q=stage(v.q), s=stage(v.s, cast=False))
                if _quant.is_quantized(v) else stage(v)
                for k, v in _quant.quantize_params(host).items()}
        else:
            self._params = {k: stage(v) for k, v in host.items()}
        if self._temperature > 0.0:
            # a device tensor, not a Python number: the card divides by a
            # host scalar as a multiply by its reciprocal
            self._temp = torch.tensor(self._temperature, dtype=torch.float32,
                                      device=self._device)
            self._cols = _mul32(torch.arange(model.vocab_size,
                                             dtype=torch.int64,
                                             device=self._device),
                                0x85EBCA77)

        # power-of-two length-bucket ladder (Predictor idiom)
        top = max(4, int(max_prefill_len))
        b, buckets = 4, []
        while True:
            buckets.append(b)
            if b >= top:
                break
            b *= 2
        self._buckets = buckets

        self._stats = ServingStats(
            scope=telemetry.registry().unique_scope("decode"),
            phases=DECODE_TRACE_PHASES)
        self._g_occupancy = self._stats.scope.gauge("occupancy")
        self._c_steps = self._stats.scope.counter("steps")
        self._c_tokens = self._stats.scope.counter("tokens")
        self._c_prefills = self._stats.scope.counter("prefill_launches")
        self._c_abandoned = self._stats.scope.counter("abandoned")
        self._h_ttft = self._stats.scope.histogram("ttft_ms")

        if ttft_slo_ms is None:
            ttft_slo_ms = _env_float("MXNET_SERVE_DECODE_TTFT_SLO_MS", 500.0)
        if token_slo_ms is None:
            token_slo_ms = _env_float("MXNET_SERVE_DECODE_TOKEN_SLO_MS",
                                      100.0)
        self.slo_ttft = (SLOTracker(name="%s.ttft" % self._name,
                                    p95_ms=float(ttft_slo_ms))
                         if ttft_slo_ms else None)
        self.slo_token = (SLOTracker(name="%s.per_token" % self._name,
                                     p95_ms=float(token_slo_ms))
                          if token_slo_ms else None)

        # slot tables (touched only by the scheduler thread)
        n = self._slots
        self._slot_req = [None] * n
        self._active = onp.zeros((n,), onp.bool_)
        self._cur_tok = onp.zeros((n,), onp.int64)
        self._steps_in = onp.zeros((n,), onp.int64)
        self._seeds = onp.zeros((n,), onp.int64)
        # the step's one host->card copy goes from here (pinned on the
        # card); the step's readback syncs, so the next step may refill it
        self._step_buf = torch.empty(
            (4 * n,), dtype=torch.int64,
            pin_memory=self._device.type == "cuda")

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._closed = False
        self._drain = True
        self._restarts = 0
        self._n_steps = 0
        self._n_tokens = 0
        self._occ_sum = 0.0
        self._busy_s = 0.0
        self._ttft_ring = collections.deque(maxlen=4096)
        self._transcript = []
        self._warmup_report = {}
        self._ran = set()        # programs whose first run has happened
        self._programs = {}      # name -> exported program (cache)
        self._state = None
        self._thread = None
        if start:
            self.start()

    # -- device programs -------------------------------------------------
    def _device_scope(self):
        """No autograd, and the engine's card current: both are
        per-thread in torch, so every thread that runs a program enters
        this."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        if self._device.type == "cuda":
            stack.enter_context(torch.cuda.device(self._device))
        return stack

    def _first_run(self, name):
        """Count a program's first run as its compile (Predictor rule)."""
        with self._lock:
            if name in self._ran:
                return
            self._ran.add(name)
        self._stats.note_compile()

    def _upload(self, arrays, buf=None):
        """One host->device copy of int vectors, packed as int64 (through
        ``buf`` when given); returns the device views, shaped as given."""
        flat = onp.concatenate([onp.asarray(a, onp.int64).ravel()
                                for a in arrays])
        if buf is not None:
            buf.numpy()[:flat.size] = flat
            dev = buf[:flat.size].to(self._device, non_blocking=True)
        else:
            dev = torch.from_numpy(flat).to(self._device)
        out, off = [], 0
        for a in arrays:
            a = onp.asarray(a)
            out.append(dev[off:off + a.size].view(a.shape))
            off += a.size
        return out

    def _state_zeros(self, batch):
        return {k: torch.zeros((batch,) + tuple(shape),
                               dtype=torch_dtype(dt), device=self._device)
                for k, (shape, dt) in
                sorted(self._model.state_struct().items())}

    def _select(self, logits, steps, seeds):
        """Next-token rule of prefill (first token) and step: greedy
        argmax, or the counter-hash Gumbel when temperature > 0."""
        if self._temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        u = counter_uniform(seeds, steps, logits.shape[-1], self._cols)
        g = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() / self._temp + g, dim=-1)

    def _launch_init(self):
        self._first_run("state_init")
        program = self._programs.get("state_init")
        if program is not None:
            return self._state_of(program())
        return self._state_zeros(self._slots)

    # the programs as functions of flat tensors (what a trace captures and
    # an exported program takes): the parameter leaves (sorted names, an
    # int8 leaf as its payload and scales), then the state (sorted keys)
    def _param_leaves(self):
        out = []
        for k in sorted(self._params):
            v = self._params[k]
            out.extend([v.q, v.s] if _quant.is_quantized(v) else [v])
        return out

    def _params_of(self, leaves):
        """The dense parameters a step computes from, rebuilt from
        ``_param_leaves`` order (``_dense_params``'s rule)."""
        tree, i = {}, 0
        for k in sorted(self._params):
            if _quant.is_quantized(self._params[k]):
                tree[k] = _quant.QuantLeaf(q=leaves[i], s=leaves[i + 1])
                i += 2
            else:
                tree[k] = leaves[i]
                i += 1
        if self._weight_quant != "int8":
            return tree
        return _quant.dequant_params(tree, self._cdt)

    def _state_keys(self):
        return sorted(self._model.state_struct())

    def _state_of(self, leaves):
        return dict(zip(self._state_keys(), leaves))

    def _step_flat(self, *flat):
        n_p, n_s = len(self._param_leaves()), len(self._state_keys())
        params = self._params_of(flat[:n_p])
        state = self._state_of(flat[n_p:n_p + n_s])
        tokens, active, steps, seeds = flat[n_p + n_s:]
        state, nxt = self._step_math(params, state, tokens, active, steps,
                                     seeds)
        return [state[k] for k in self._state_keys()] + [nxt]

    def _prefill_flat(self, *flat):
        n_p, n_s = len(self._param_leaves()), len(self._state_keys())
        params = self._params_of(flat[:n_p])
        state = self._state_of(flat[n_p:n_p + n_s])
        rows, logits, first = self._prefill_math(params, state,
                                                 *flat[n_p + n_s:])
        return [rows[k] for k in self._state_keys()] + [logits, first]

    def step_device(self, state, tokens, active, steps, seeds):
        """The decode step on device tensors (``(slots,)`` int64 tokens,
        steps, seeds and a bool active mask): (new state, next tokens).
        Every row runs, whatever the occupancy; inactive rows keep their
        state and token through an exact ``where``. Enqueues only: no
        host synchronisation."""
        return self._step_math(self._dense_params(), state, tokens, active,
                               steps, seeds)

    def _step_math(self, params, state, tokens, active, steps, seeds):
        rows, logits = self._model.step(params, tokens, state)
        nxt = self._select(logits, steps, seeds)
        state = {k: torch.where(
            active.view((self._slots,) + (1,) * (n.dim() - 1)), n, state[k])
            for k, n in rows.items()}
        return state, torch.where(active, nxt, tokens)

    def _launch_step(self, state, tokens, active, steps, seeds, buf=None):
        self._first_run("step")
        d_tok, d_act, d_steps, d_seeds = self._upload(
            [tokens, active, steps, seeds], buf)
        program = self._programs.get("step")
        if program is None:
            return self.step_device(state, d_tok, d_act.bool(), d_steps,
                                    d_seeds)
        out = program(*self._param_leaves(),
                      *[state[k] for k in self._state_keys()], d_tok,
                      d_act.bool(), d_steps, d_seeds)
        return self._state_of(out[:-1]), out[-1]

    def _launch_prefill(self, L, state, tokens, lengths, idx, resume,
                        seeds):
        """One bucket-``L`` prefill of ``PREFILL_ROWS`` rows into slots
        ``idx`` (``idx == slots`` marks a padding row: it never lands).
        Returns (state, final-position logits, first tokens); the state
        is a new dict, the old one is never written."""
        self._first_run("prefill_%d" % L)
        pb, slots = PREFILL_ROWS, self._slots
        idx = onp.asarray(idx)
        real = onp.flatnonzero(idx < slots)   # rows that land, on the host
        d_tok, d_len, d_res, d_seeds, d_clip, d_real, d_dst, d_zero = \
            self._upload([tokens, lengths, resume, seeds,
                          onp.clip(idx, 0, slots - 1), real, idx[real],
                          onp.zeros((pb,), onp.int64)])
        program = self._programs.get("prefill_%d" % L)
        if program is None:
            rows, logits, first = self._prefill_math(
                self._dense_params(), state, d_tok, d_len, d_res.bool(),
                d_seeds, d_clip, d_zero)
        else:
            out = program(*self._param_leaves(),
                          *[state[k] for k in self._state_keys()], d_tok,
                          d_len, d_res.bool(), d_seeds, d_clip, d_zero)
            rows, logits, first = self._state_of(out[:-2]), out[-2], out[-1]
        if real.size:
            state = {k: s.index_copy(0, d_dst,
                                     rows[k].index_select(0, d_real)
                                     .to(s.dtype))
                     for k, s in state.items()}
        return state, logits, first

    def _prefill_math(self, params, state, d_tok, d_len, res, d_seeds,
                      d_clip, d_zero):
        """The prefill of ``PREFILL_ROWS`` rows from ``state``'s slots
        ``d_clip`` (where ``res``): (state rows, logits, first tokens).
        The rows' landing (a host-chosen count of rows) is the
        caller's."""
        pb = PREFILL_ROWS
        rows0 = {k: torch.where(res.view((pb,) + (1,) * (s.dim() - 1)),
                                s.index_select(0, d_clip), 0)
                 for k, s in state.items()}
        rows, logits = self._model.prefill(params, d_tok, d_len, rows0)
        return rows, logits, self._select(logits, d_zero, d_seeds)

    # -- bucket ladder and accounting ------------------------------------
    @property
    def buckets(self):
        return list(self._buckets)

    @property
    def slots(self):
        return self._slots

    @property
    def params_digest(self):
        return self._digest

    @property
    def device(self):
        return self._device

    def bucket_for(self, n):
        """Smallest length bucket that fits ``n`` prompt tokens (the top
        bucket for longer prompts: those chunk)."""
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _dense_params(self):
        """The dense parameter view a step or prefill computes from: the
        int8 leaves widened per channel into the compute dtype under
        ``int8_weight`` (bit for bit the same each call, so streams and
        the prefill-parity reference agree), the staged tensors
        otherwise."""
        if self._weight_quant != "int8":
            return self._params
        return _quant.dequant_params(self._params, self._cdt)

    def weight_bytes(self):
        """Bytes of the device-resident parameters: what every decode
        step reads again (int8 payloads and float32 scales under
        ``int8_weight``)."""
        return _quant.tree_bytes(self._params)

    def step_argument_bytes(self):
        """Bytes of the tensors the decode step receives: the parameters,
        the ``(slots, ...)`` state, and the four ``(slots,)`` int64
        vectors (tokens, active mask, step counters, seeds) of its one
        host->device copy."""
        state = sum(t.numel() * t.element_size()
                    for t in self._state_zeros(self._slots).values())
        return self.weight_bytes() + int(state) + 4 * self._slots * 8

    # -- warmup ------------------------------------------------------------
    def warmup(self, cache_dir=None):
        """Run every program once BEFORE traffic, on scratch state: state
        init, each prefill bucket (all rows padding) and one step (no row
        active), each read back. This sets up the card's library handles
        and grows the caching allocator; afterwards ``stats()['compiles']``
        stays frozen under any occupancy churn. Returns
        ``{name: {"warmup_ms", "source"}}``.

        ``cache_dir`` (default ``$MXNET_COMPILE_CACHE_DIR``; entries in
        its ``aot/``) turns on the persistent executable cache with the
        Predictor's key discipline: each program LOADS from its entry
        (``"deserialized"``: no trace) or is traced with ``torch.export``
        and committed (``"compiled"``, one compile), and the engine then
        runs it. Without one every program runs eagerly (``"eager"``)."""
        from . import cache as _cache
        aot = _cache.aot_dir(cache_dir)
        store = _cache.ExecutableCache(aot) if aot is not None else None
        if store is None:
            self._programs.clear()      # every program eager again
        watch = telemetry.compile_watch()
        pb, n = PREFILL_ROWS, self._slots
        z = onp.zeros((n,), onp.int64)
        pad = onp.full((pb,), n, onp.int64)
        zpb = onp.zeros((pb,), onp.int64)
        programs = [("state_init", 0, self._launch_init),
                    ("step", 1, lambda: self._launch_step(
                        self._state_zeros(n), z, z, z, z)[1])]
        for L in self._buckets:
            programs.append((
                "prefill_%d" % L, L,
                lambda L=L: self._launch_prefill(
                    L, self._state_zeros(n), onp.zeros((pb, L), onp.int64),
                    zpb, pad, zpb, zpb)[2]))
        report = {}
        with self._device_scope(), watch.warmup_scope():
            for name, bucket, run in programs:
                t0 = time.perf_counter()
                source = self._warm_program(name, bucket, store, watch) \
                    if store is not None else None
                if source is None and name not in self._ran:
                    watch.note_program("decode.%s" % name, {})
                out = run()
                for t in (out.values() if isinstance(out, dict) else [out]):
                    t.cpu()
                if name in self._programs:
                    # the first run checked the inputs against the traced
                    # shapes; later launches build them by the same rule
                    self._programs[name].validate_inputs = False
                ms = (time.perf_counter() - t0) * 1000.0
                self._stats.note_warmup_bucket(bucket, ms, source)
                report[name] = {"warmup_ms": round(ms, 3),
                                "source": source or "eager"}
            if self._state is None:
                self._state = self._launch_init()
        self._warmup_report = report
        return {k: dict(v) for k, v in report.items()}

    def _program_key(self, name, bucket):
        """The executable-cache key of one program: the model's digest,
        the mode, and what the trace froze besides (the program and its
        shapes, the sampler's temperature, the weight storage)."""
        from . import cache as _cache
        input_sig = ("decode.%s:model=%s;slots=%d;pb=%d;temp=%r;cdt=%s"
                     % (name, self._model.signature(), self._slots,
                        PREFILL_ROWS, self._temperature, self._cdt))
        if self._weight_quant:
            input_sig += ";wq=%s" % self._weight_quant
        return _cache.cache_key(self._digest, self._policy.name, bucket,
                                input_sig,
                                _cache.backend_signature(self._device))

    def _program_inputs(self, name):
        """(function of flat tensors, example tensors) of one program."""
        n, pb = self._slots, PREFILL_ROWS
        dev = self._device

        def ints(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=dev)

        if name == "state_init":
            return (lambda: [self._state_zeros(n)[k]
                             for k in self._state_keys()]), ()
        state = self._state_zeros(n)
        head = tuple(self._param_leaves()) + \
            tuple(state[k] for k in self._state_keys())
        if name == "step":
            return self._step_flat, head + (
                ints(n), torch.zeros((n,), dtype=torch.bool, device=dev),
                ints(n), ints(n))
        L = int(name.split("_")[1])
        return self._prefill_flat, head + (
            ints(pb, L), ints(pb),
            torch.zeros((pb,), dtype=torch.bool, device=dev), ints(pb),
            ints(pb), ints(pb))

    def _warm_program(self, name, bucket, store, watch):
        """Load-or-trace one program through the executable cache and
        install it: ``"deserialized"`` or ``"compiled"``."""
        from . import cache as _cache
        key = self._program_key(name, bucket)
        program, source = None, "compiled"
        try:
            program = _cache.load_program(store.load(key))
            source = "deserialized"
        except _cache.CacheMiss as e:
            log = logger.info if e.reason == "absent" else logger.warning
            log("decode program %s: executable cache %s: tracing afresh "
                "(%s)", name, e.reason, e.detail or store.path_for(key))
        except Exception as e:  # noqa: BLE001 - any load failure
            logger.warning("decode program %s: cached program failed to "
                           "load (%s): tracing afresh", name, e)
        if program is None:
            fn, args = self._program_inputs(name)
            ep = _cache.export_program(fn, args, "decode program %s" % name)
            self._stats.note_compile()
            watch.note_program("decode.%s" % name, {})
            store.store(key, _cache.program_bytes(ep))
            program = _cache.program_module(ep)
        if source == "deserialized":
            watch.note_cache_hit()
        else:
            watch.note_cache_miss()
        self._programs[name] = program
        with self._lock:
            self._ran.add(name)     # its first run is warmup, no compile
        return source

    def warmup_report(self):
        """Per-program outcome of the last :meth:`warmup`."""
        return {k: dict(v) for k, v in self._warmup_report.items()}

    # -- prefill parity ---------------------------------------------------
    def prefill_parity(self, prompt):
        """Bit-for-bit witness for the bucket ladder: the padded-bucket
        (and, past the top bucket, chunked) prefill's final-position
        logits for ``prompt`` equal a whole-sequence forward at the EXACT
        length, both on ``PREFILL_ROWS`` rows. Uses scratch state, never
        the live slots."""
        prompt = [int(t) for t in prompt]
        L = len(prompt)
        with self._device_scope():
            _, _, logits = self._run_prefill_chunks(
                self._state_zeros(self._slots), 0, prompt, 0)
            toks = onp.zeros((PREFILL_ROWS, L), onp.int64)
            toks[0, :] = prompt
            d_tok, d_len = self._upload(
                [toks, onp.array([L] + [0] * (PREFILL_ROWS - 1))])
            _, ref = self._model.prefill(self._dense_params(), d_tok, d_len,
                                         self._state_zeros(PREFILL_ROWS))
            return bool(torch.equal(ref[0].cpu(), logits[0].cpu()))

    # -- submission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, seed=0, timeout_ms=None):
        """Queue one sequence; returns its :class:`DecodeRequest` future.
        ``max_new_tokens`` is clamped to ``MXNET_SERVE_DECODE_MAX_STEPS``.
        Raises :class:`ServerClosed` after shutdown, :class:`QueueFull` at
        capacity, and :class:`TenantShed` when ``shed_on_breach`` and the
        TTFT objective is in breach. ``timeout_ms`` is an admission
        deadline: a request still queued past it fails with
        :class:`RequestTimeout` instead of prefilling."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise MXNetError("decode prompt must be non-empty")
        if any(t < 0 or t >= self._model.vocab_size for t in prompt):
            raise MXNetError("prompt token out of range [0, %d)"
                             % self._model.vocab_size)
        if self._closed:
            raise ServerClosed("decode engine is shut down")
        if (self._shed_on_breach and self.slo_ttft is not None
                and self.slo_ttft.breached_cached()):
            self._stats.note_shed()
            self.slo_ttft.record(outcome="reject")
            raise TenantShed("decode TTFT objective in multi-window breach "
                             "— request shed at admission")
        with self._cond:
            if self._closed:
                raise ServerClosed("decode engine is shut down")
            if len(self._queue) >= self._max_queue:
                self._stats.note_reject()
                if self.slo_ttft is not None:
                    self.slo_ttft.record(outcome="reject")
                raise QueueFull("decode queue at capacity (%d)"
                                % self._max_queue)
            req = DecodeRequest(
                self._stats.new_request_id(), prompt,
                min(int(max_new_tokens), self._max_steps), seed,
                timeout_ms=timeout_ms)
            self._queue.append(req)
            self._stats.note_request()
            self._cond.notify_all()
        return req

    def generate(self, prompt, max_new_tokens=32, seed=0, timeout=None):
        """Blocking convenience: :meth:`submit` + ``result()``."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           seed=seed).result(timeout=timeout)

    # -- scheduler --------------------------------------------------------
    def start(self):
        """Start the scheduler thread (no-op when running)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._thread = threading.Thread(
            target=self._loop, name="mxtorch-decode", daemon=True)
        self._thread.start()
        return self

    def _any_active(self):
        return bool(self._active.any())

    def _loop(self):
        with self._device_scope():
            while True:
                with self._cond:
                    while (not self._closed and not self._queue
                           and not self._any_active()
                           and not any(r is not None and r._cancel
                                       for r in self._slot_req)):
                        self._cond.wait(0.05)
                    no_drain = self._closed and not self._drain
                    done = (self._closed and not self._queue
                            and not self._any_active())
                if no_drain:
                    self._fail_pending(ServerClosed(
                        "decode engine shut down without drain"))
                    return
                if done:
                    return
                try:
                    self._tick()
                except Exception as e:  # noqa: BLE001 - supervised loop
                    if not self._on_crash(e):
                        return

    def _tick(self):
        if self._state is None:
            # lazy, so that an engine that was never warmed still works
            self._state = self._launch_init()
        if _faults.armed():
            _faults.check("serving.decode_worker", step=self._n_steps)
        self._admit_pending()
        if _faults.armed() and _faults.fires("serving.decode_abandon",
                                             step=self._n_steps):
            self._abandon_oldest()
        for s in range(self._slots):
            req = self._slot_req[s]
            if req is not None and req._cancel:
                self._retire(s, "abandoned", RequestAbandoned(
                    "decode request %s cancelled by the client after %d "
                    "tokens" % (req.id, len(req.tokens()))))
        if not self._any_active():
            return
        if _faults.armed():
            _faults.check("serving.decode_step", step=self._n_steps)
        t0 = time.perf_counter()
        n_active = int(self._active.sum())
        state, nxt = self._launch_step(
            self._state, self._cur_tok, self._active, self._steps_in,
            self._seeds, self._step_buf)
        nxt_host = nxt.cpu().numpy()       # the step's one readback
        self._state = state
        dt = time.perf_counter() - t0
        self._busy_s += dt
        self._n_steps += 1
        self._c_steps.add()
        self._occ_sum += n_active / float(self._slots)
        self._g_occupancy.set(round(n_active / float(self._slots), 4))
        self._stats.note_batch(self._slots, n_active)
        self._cur_tok = nxt_host.astype(onp.int64)
        for s in range(self._slots):
            if not self._active[s]:
                continue
            self._steps_in[s] += 1
            self._emit(s, int(nxt_host[s]))

    def _admit_pending(self):
        while True:
            with self._cond:
                if not self._queue:
                    return
                free = [s for s in range(self._slots)
                        if self._slot_req[s] is None]
                if not free:
                    return
                req = self._queue.popleft()
            if req._cancel:
                req._resolve("abandoned", RequestAbandoned(
                    "decode request %s cancelled while queued" % req.id))
                self._c_abandoned.add()
                continue
            if req.deadline is not None and time.time() > req.deadline:
                age_ms = (time.time() - req.t_submit) * 1000.0
                req._resolve("timeout", RequestTimeout(
                    "decode request %s expired after %.0f ms in queue "
                    "(deadline %.0f ms)" % (req.id, age_ms, req.timeout_ms)))
                self._stats.note_timeout(age_ms)
                if self.slo_ttft is not None:
                    self.slo_ttft.record(age_ms, "timeout")
                if telemetry.enabled():
                    self._stats.note_trace(
                        req.id, rows=1, bucket=0,
                        phases={"queue_wait_ms": age_ms, "prefill_ms": 0.0,
                                "decode_ms": 0.0, "resolve_ms": 0.0},
                        outcome="timeout", ts_end=time.time())
                continue
            try:
                self._admit(free[0], req)
            except BaseException:
                req._resolve("error", WorkerCrashed(
                    "decode scheduler crashed while prefilling request %s"
                    % req.id))
                self._stats.note_error()
                raise

    def _admit(self, slot, req):
        req.t_admit = time.time()
        req.slot = slot
        self._state, first_tok, _ = self._run_prefill_chunks(
            self._state, slot, req.prompt, req.seed, req=req)
        self._slot_req[slot] = req
        self._active[slot] = True
        self._cur_tok[slot] = first_tok
        self._steps_in[slot] = 1
        self._seeds[slot] = req.seed
        self._transcript.append(("admit", req.id, slot, self._n_steps))
        req.t_first = time.time()
        ttft = req.ttft_ms
        self._ttft_ring.append(ttft)
        self._h_ttft.observe(ttft)
        if self.slo_ttft is not None:
            self.slo_ttft.record(ttft, "ok")
        self._emit(slot, first_tok)

    def _run_prefill_chunks(self, state, slot, prompt, seed, req=None):
        """Run one prompt through the bucket ladder into ``slot`` of
        ``state``: each chunk pads to its bucket; later chunks gather the
        slot's row back (``resume``), so the state runs on. Returns
        (state, first generated token, final-chunk logits); only the last
        chunk's first token is read back."""
        top = self._buckets[-1]
        pos, resume = 0, False
        first = logits = None
        pb = PREFILL_ROWS
        seeds = onp.zeros((pb,), onp.int64)
        seeds[0] = int(seed) & _M32
        while pos < len(prompt):
            chunk = prompt[pos:pos + top]
            L = self.bucket_for(len(chunk))
            toks = onp.zeros((pb, L), onp.int64)
            toks[0, :len(chunk)] = chunk
            lengths = onp.zeros((pb,), onp.int64)
            lengths[0] = len(chunk)
            idx = onp.full((pb,), self._slots, onp.int64)
            idx[0] = slot
            res = onp.zeros((pb,), onp.int64)
            res[0] = resume
            state, logits, first = self._launch_prefill(
                L, state, toks, lengths, idx, res, seeds)
            self._c_prefills.add()
            self._stats.scope.counter("prefill_bucket_hits.%d" % L).add()
            if req is not None:
                req.bucket = L
            pos += len(chunk)
            resume = True
        return state, int(first[0]), logits

    def _emit(self, slot, tok):
        req = self._slot_req[slot]
        req._append(tok)
        self._n_tokens += 1
        self._c_tokens.add()
        if ((self._eos_id is not None and tok == self._eos_id)
                or len(req.tokens()) >= req.max_new_tokens):
            self._retire(slot, "ok")

    def _retire(self, slot, outcome, exc=None):
        req = self._slot_req[slot]
        req.t_done = time.time()
        n_tok = len(req.tokens())
        decode_ms = (req.t_done - req.t_first) * 1000.0 \
            if req.t_first else 0.0
        if outcome == "ok":
            self._stats.note_completed((req.t_done - req.t_submit) * 1000.0)
            if self.slo_token is not None and n_tok > 1:
                self.slo_token.record(decode_ms / (n_tok - 1), "ok")
        elif outcome == "abandoned":
            self._c_abandoned.add()
            if self.slo_token is not None:
                self.slo_token.record(decode_ms or None, "error")
        else:
            self._stats.note_error()
            if self.slo_token is not None:
                self.slo_token.record(decode_ms or None, "error")
        if telemetry.enabled():
            qw = ((req.t_admit - req.t_submit) * 1000.0
                  if req.t_admit else 0.0)
            pf = ((req.t_first - req.t_admit) * 1000.0
                  if req.t_first and req.t_admit else 0.0)
            self._stats.note_trace(
                req.id, rows=1, bucket=req.bucket or 0,
                phases={"queue_wait_ms": qw, "prefill_ms": pf,
                        "decode_ms": decode_ms, "resolve_ms": 0.0},
                outcome=outcome, ts_end=req.t_done)
        self._transcript.append(
            ("retire", req.id, slot, n_tok, outcome, self._n_steps))
        self._slot_req[slot] = None
        self._active[slot] = False
        req._resolve(outcome, exc)
        with self._cond:
            self._cond.notify_all()

    def _abandon_oldest(self):
        """The ``serving.decode_abandon`` seam's body: the oldest active
        request's client walks away mid-stream."""
        oldest, t = None, None
        for s in range(self._slots):
            req = self._slot_req[s]
            if req is not None and (t is None or req.t_admit < t):
                oldest, t = s, req.t_admit
        if oldest is not None:
            req = self._slot_req[oldest]
            self._retire(oldest, "abandoned", RequestAbandoned(
                "decode request %s abandoned mid-stream (injected client "
                "disconnect) after %d tokens" % (req.id, len(req.tokens()))))

    def _fail_pending(self, exc):
        """Resolve every queued and active request with ``exc`` (no-drain
        shutdown, restart budget spent): futures never hang."""
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
        for req in queued:
            req._resolve("error", exc)
            self._stats.note_error()
        for s in range(self._slots):
            if self._slot_req[s] is not None:
                self._retire(s, "error", exc)

    def _on_crash(self, e):
        """Supervised restart (the DynamicBatcher worker discipline).
        In-flight sequences survive a scheduler crash: the slot state
        lives on the device and the loop resumes stepping it. Returns
        False when the restart budget is spent (everything failed
        loudly)."""
        self._restarts += 1
        self._stats.note_worker_restart()
        logger.warning(
            "decode scheduler crashed (restart %d/%d): %s — slot state is "
            "device-resident, in-flight sequences resume",
            self._restarts, self._max_restarts, e, exc_info=True)
        if self._restarts > self._max_restarts:
            crash = WorkerCrashed("decode scheduler exceeded %d restarts"
                                  % self._max_restarts)
            crash.__cause__ = e
            with self._cond:
                self._closed = True
            self._fail_pending(crash)
            return False
        return True

    # -- lifecycle --------------------------------------------------------
    def shutdown(self, drain=True, timeout=None):
        """Stop the engine. ``drain=True`` finishes every queued and
        in-flight sequence first; ``drain=False`` resolves them all with
        :class:`ServerClosed` at once. Either way no future is left
        hanging."""
        with self._cond:
            self._closed = True
            self._drain = bool(drain)
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        if not drain:
            # for an engine whose thread never started
            self._fail_pending(ServerClosed(
                "decode engine shut down without drain"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)
        return False

    def release(self):
        """Drop the ``decode.<i>`` registry scope (a long-lived process
        discarding an engine)."""
        self._stats.release()

    # -- reading ----------------------------------------------------------
    def transcript(self):
        """The slot lifecycle: ``("admit", req_id, slot, step)`` and
        ``("retire", req_id, slot, n_tokens, outcome, step)`` in order.
        With a fixed arrival transcript (``start=False``, submit,
        :meth:`start`) it is a pure function of the arrivals."""
        return list(self._transcript)

    def request_traces(self):
        return self._stats.request_traces()

    def stats(self):
        """The ServingStats snapshot plus a ``decode`` section: steps,
        tokens, tokens_per_sec (over the steps' host wall time),
        avg_occupancy, TTFT percentiles, abandon count."""
        s = self._stats.snapshot()
        ttfts = sorted(self._ttft_ring)
        s["decode"] = {
            "slots": self._slots,
            "buckets": list(self._buckets),
            "steps": int(self._n_steps),
            "tokens": int(self._n_tokens),
            "tokens_per_sec": round(self._n_tokens / self._busy_s, 2)
            if self._busy_s > 0 else None,
            "avg_occupancy": round(self._occ_sum / self._n_steps, 4)
            if self._n_steps else None,
            "abandoned": int(self._c_abandoned.value),
            "ttft_ms": {
                "count": len(ttfts),
                "p50": ServingStats._pct(ttfts, 50),
                "p99": ServingStats._pct(ttfts, 99),
            },
            "precision_mode": self._policy.name,
            "weight_quant": self._weight_quant,
            "weight_bytes": self.weight_bytes(),
        }
        return s
