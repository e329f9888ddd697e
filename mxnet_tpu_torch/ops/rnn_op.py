"""The fused multi-layer ``RNN`` operator (PyTorch counterpart of
``mxnet_tpu/ops/rnn_op.py``): modes ``lstm``, ``gru``, ``rnn_tanh`` and
``rnn_relu``, uni- or bidirectional, any number of layers, with
``state_outputs``.

Parameters are one flat vector in the JAX package's (and cuDNN's
canonical) order: every layer's (W, R) matrices first, layer-major with
the directions inside, then every (bW, bR) bias in the same order. Gate
order is LSTM [i, f, g, o] and GRU [r, z, n] with
n = tanh(x·Wₙ + bWₙ + r ⊙ (h·Rₙ + bRₙ)), which is PyTorch's own.

The route: the flat vector is sliced into per-(layer, direction) views
and handed to ``torch._VF.lstm``/``gru``/``rnn_tanh``/``rnn_relu``
(time-major), which on a CUDA tensor is cuDNN's RNN. Gradients flow
back into the flat vector through the views. Since the views are not in
cuDNN's packed layout, cuDNN copies the weights into its own buffer on
every call (PyTorch warns so once). The JAX package computes the RNN
with ``lax.scan``, outside any Pallas kernel.

Dropout (``p`` > 0, training) masks every layer's output but the last,
as the JAX package does: the op then runs layer by layer and draws each
mask from the node's key (``random.fold_in(key, layer)``, through
``random.key_uniform``), never from cuDNN's own dropout, whose draws
come from torch's generator and would not repeat under remat or a
resume. ``lstm_state_clip_min``/``_max`` are accepted and ignored, as in
the JAX package.

Dtype: the op computes in the dtype of its inputs, as the JAX op does
(its ``_rnn`` has no dtype rule). Under the bfloat16 precision modes the
fused group casts the float32 master vector to bfloat16 inside the
autograd graph, so cuDNN runs on bfloat16 views of that vector, the
dropout masks (drawn from the same key as in float32) apply at bfloat16
width, and each gradient reaches its float32 master.

Under a selective remat policy (``remat="dots"``) the ``_VF`` call is
recomputed whole (``precision.policy.recompute_whole``): PyTorch's CPU
RNN adds into its matrix products in place, so a product the policy kept
would be read back changed and the gradients would be wrong.

``rnn_plain`` is a Python loop over time, the JAX package's
``_scan_layer`` step for step, in the same dtype rule: the tests and ``chip_smoke.py`` hold the
op against it. ``launches`` counts the ``_VF`` calls.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError
from ..registry import register

__all__ = ["rnn_param_size", "rnn_plain", "split_params", "launches"]

launches = 0


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def _rnn_args(attrs):
    if attrs.get("mode", "lstm") == "lstm":
        return ("data", "parameters", "state", "state_cell")
    return ("data", "parameters", "state")


def _rnn_num_outputs(attrs):
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """The flat parameter vector's length."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += g * state_size * (in_sz + state_size + 2) * d
    return size


def _rnn_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None, aux
    t, n, i = data
    h = int(attrs["state_size"])
    layers = int(attrs["num_layers"])
    bi = bool(attrs.get("bidirectional", False))
    d = 2 if bi else 1
    mode = attrs.get("mode", "lstm")
    in_shapes[1] = (rnn_param_size(layers, i, h, bi, mode),)
    in_shapes[2] = (layers * d, n, h)
    if mode == "lstm" and len(in_shapes) > 3:
        in_shapes[3] = (layers * d, n, h)
    outs = [(t, n, h * d)]
    if attrs.get("state_outputs", False):
        outs.append((layers * d, n, h))
        if mode == "lstm":
            outs.append((layers * d, n, h))
    return in_shapes, outs, aux


def split_params(params, num_layers, input_size, state_size, d, g):
    """Views (W, R, bW, bR) of the flat vector, one per (layer,
    direction), layer-major."""
    mats, biases, off = [], [], 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        for _ in range(d):
            w = params[off:off + g * state_size * in_sz].view(
                g * state_size, in_sz)
            off += g * state_size * in_sz
            r = params[off:off + g * state_size * state_size].view(
                g * state_size, state_size)
            off += g * state_size * state_size
            mats.append((w, r))
    for _ in range(num_layers * d):
        bw = params[off:off + g * state_size]
        br = params[off + g * state_size:off + 2 * g * state_size]
        off += 2 * g * state_size
        biases.append((bw, br))
    return [m + b for m, b in zip(mats, biases)]


def _config(attrs, ins):
    mode = attrs.get("mode", "lstm")
    if mode not in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        raise MXNetError("RNN: unknown mode %r" % mode)
    data = ins[0]
    h = int(attrs["state_size"])
    layers = int(attrs["num_layers"])
    d = 2 if attrs.get("bidirectional", False) else 1
    state0 = ins[2]
    cell0 = ins[3] if mode == "lstm" and len(ins) > 3 \
        else torch.zeros_like(state0)
    return mode, h, layers, d, data, ins[1], state0, cell0


def _dropout(attrs, octx, layer, x):
    """``x`` after ``layer`` with the node's dropout mask for it: kept
    values scaled by 1/(1 − p), as Dropout's; the identity after the last
    layer, in eval and at p = 0."""
    p = float(attrs.get("p", 0.0))
    if p <= 0 or not octx.is_train \
            or layer == int(attrs["num_layers"]) - 1:
        return x
    if octx.key is None:
        raise MXNetError("RNN dropout in training needs a key: run it "
                         "through an executor, which draws one per forward")
    keep = 1.0 - p
    mask = _random.key_uniform(_random.fold_in(octx.key, layer), x.shape,
                               x.device) < keep
    return torch.where(mask, x / float(torch.tensor(keep, dtype=x.dtype)),
                       0.0)


def _outputs(attrs, mode, x, hs, cs):
    outs = [x]
    if attrs.get("state_outputs", False):
        outs.append(hs)
        if mode == "lstm":
            outs.append(cs)
    return outs


def _vf(mode, x, h0, c0, weights, num_layers, bidirectional):
    """One ``torch._VF`` RNN call over time-major ``x``; returns
    (output, h_n, c_n or None)."""
    global launches
    from ..precision.policy import recompute_whole
    launches += 1
    fn = getattr(torch._VF, mode)
    hx = (h0, c0) if mode == "lstm" else h0
    with recompute_whole():
        res = fn(x, hx, weights, True, num_layers, 0.0,
                 torch.is_grad_enabled(), bidirectional, False)
    if mode == "lstm":
        return res[0], res[1], res[2]
    return res[0], res[1], None


@register("RNN", arg_names=_rnn_args, num_outputs=_rnn_num_outputs,
          attr_types={"state_size": int, "num_layers": int,
                      "bidirectional": bool, "mode": str, "p": float,
                      "state_outputs": bool, "lstm_state_clip_min": float,
                      "lstm_state_clip_max": float},
          infer_shape=_rnn_infer, needs_rng=True)
def _rnn(attrs, ins, octx):
    """The fused RNN over time-major data (T, N, I) -> (T, N, H·D)."""
    mode, h, layers, d, data, params, state0, cell0 = _config(attrs, ins)
    views = split_params(params, layers, data.shape[2], h, d, _gates(mode))
    weights = [t for v in views for t in v]
    bi = d == 2
    if float(attrs.get("p", 0.0)) <= 0 or not octx.is_train:
        x, hs, cs = _vf(mode, data, state0, cell0, weights, layers, bi)
        return _outputs(attrs, mode, x, hs, cs)
    x, hs, cs = data, [], []
    for layer in range(layers):
        sl = slice(layer * d, (layer + 1) * d)
        x, hn, cn = _vf(mode, x, state0[sl], cell0[sl],
                        weights[4 * d * layer:4 * d * (layer + 1)], 1, bi)
        hs.append(hn)
        cs.append(cn)
        x = _dropout(attrs, octx, layer, x)
    return _outputs(attrs, mode, x, torch.cat(hs),
                    torch.cat(cs) if mode == "lstm" else None)


def _sigmoid(x):
    return 1 / (1 + torch.exp(-x))


def _plain_layer(mode, x, h, c, w, r, bw, br, hid, reverse):
    """One direction of one layer, step by step (the JAX package's
    ``_scan_layer``)."""
    xw = torch.einsum("tni,gi->tng", x, w) + bw[None, None, :]
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    ys = [None] * x.shape[0]
    for t in steps:
        xt = xw[t]
        hr = h @ r.t() + br[None, :]
        if mode == "gru":
            rg = _sigmoid(xt[:, :hid] + hr[:, :hid])
            zg = _sigmoid(xt[:, hid:2 * hid] + hr[:, hid:2 * hid])
            ng = torch.tanh(xt[:, 2 * hid:] + rg * hr[:, 2 * hid:])
            h = (1 - zg) * ng + zg * h
            c = h
        else:
            pre = xt + hr
            if mode == "rnn_relu":
                h = torch.clamp_min(pre, 0)
            elif mode == "rnn_tanh":
                h = torch.tanh(pre)
            else:
                i, f, g, o = [pre[:, k * hid:(k + 1) * hid]
                              for k in range(4)]
                c = _sigmoid(f) * c + _sigmoid(i) * torch.tanh(g)
                h = _sigmoid(o) * torch.tanh(c)
        ys[t] = h
    return torch.stack(ys), h, c


def rnn_plain(attrs, ins, octx):
    """The ``RNN`` op as a Python loop over time, with the op's dropout
    masks: what the op is held against."""
    mode, h, layers, d, data, params, state0, cell0 = _config(attrs, ins)
    views = split_params(params, layers, data.shape[2], h, d, _gates(mode))
    x, hs, cs = data, [], []
    for layer in range(layers):
        outs = []
        for di in range(d):
            idx = layer * d + di
            ys, hn, cn = _plain_layer(mode, x, state0[idx], cell0[idx],
                                      *views[idx], h, di == 1)
            outs.append(ys)
            hs.append(hn)
            cs.append(cn)
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        x = _dropout(attrs, octx, layer, x)
    return _outputs(attrs, mode, x, torch.stack(hs), torch.stack(cs))
