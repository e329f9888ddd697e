"""CTCLoss and Correlation.

PyTorch counterpart of ``mxnet_tpu/ops/sequence_loss.py``. CTCLoss is the
JAX package's log-space forward recursion (``_ctc_loss_single``),
vectorised over the batch as a loop over time of (N, S) tensor ops;
autograd gives the backward. Its conventions stay: blank 0, labels
padded with trailing zeros (``S_valid = 2·num_valid + 1``), a finite
``NEG_INF = -1e30``, so an infeasible alignment costs ~1e30 and not
``inf``, and ``log_softmax`` applied inside. ``logaddexp`` is JAX's
(``max + log1p(exp(-|a − b|))``) with JAX's gradient
(``exp(a − out)``), so infeasible alignments back-propagate as they do
there. ``F.ctc_loss`` is not this function: it returns ``inf`` where this
returns ~1e30, and its CUDA backward is not deterministic.

The gradient reaches the log-probabilities through a product with the
one-hot of the extended labels rather than a gather's scatter, so the
card adds it in a fixed order.

Correlation (src/operator/correlation-inl.h, FlowNet) is the kernel-1
path: padding by ``max_displacement``, the mean over channels of a
product (or absolute difference) per displacement. ``kernel_size``,
``stride1`` and ``pad_size`` are declared and ignored, as in the JAX
package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import register

NEG_INF = -1e30


class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp`` and its custom JVP."""

    @staticmethod
    def forward(ctx, a, b):
        delta = a - b
        out = torch.where(torch.isnan(delta), a + b,
                          torch.maximum(a, b)
                          + torch.log1p(torch.exp(-torch.abs(delta))))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


class _Pick(torch.autograd.Function):
    """lp (T, N, C) at the classes ``onehot`` (N, S, C) picks: (T, N, S).
    A gather forward; the backward is the product with the one-hot."""

    @staticmethod
    def forward(ctx, lp, ext, onehot):
        ctx.save_for_backward(onehot)
        return lp.gather(2, ext[None].expand(lp.shape[0], -1, -1))

    @staticmethod
    def backward(ctx, g):
        onehot, = ctx.saved_tensors
        return torch.einsum("tns,nsc->tnc", g, onehot), None, None


def ctc_loss(lp, labels, blank=0):
    """CTC negative log likelihood (N,) of log-probabilities lp (T, N, C)
    against labels (N, L) int64, 0 = padding (``_ctc_loss_single`` of each
    sample)."""
    T, N, C = lp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = lp.device
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    s_valid = 2 * (labels > 0).sum(1) + 1
    skip = torch.zeros((N, S), dtype=torch.bool, device=dev)
    if L > 1:
        skip[:, 3::2] = labels[:, 1:] != labels[:, :-1]
    onehot = F.one_hot(ext, C).to(lp.dtype)
    lpe = _Pick.apply(lp, ext, onehot)                           # (T, N, S)
    neg = torch.full((N, 1), NEG_INF, dtype=lp.dtype, device=dev)
    alpha = torch.cat([lpe[0, :, :1],
                       lpe[0, :, 1:2] if L > 0 else neg[:, :0],
                       neg.expand(N, S - min(S, 2))], dim=1)
    for t in range(1, T):
        prev1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)[:, :S]
        prev2 = torch.where(skip, prev2, neg.expand(N, S))
        alpha = _LogAddExp.apply(_LogAddExp.apply(alpha, prev1), prev2) \
            + lpe[t]
    end1 = alpha.gather(1, (s_valid - 1).clamp_min(0)[:, None])[:, 0]
    end2 = alpha.gather(1, (s_valid - 2).clamp_min(0)[:, None])[:, 0]
    end2 = torch.where(s_valid >= 2, end2, neg[:, 0])
    return -_LogAddExp.apply(end1, end2)


def _ctc_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    if data is None or in_shapes[1] is None:
        return in_shapes, None, aux
    return in_shapes, [(data[1],)], aux


@register("CTCLoss", arg_names=("data", "label"),
          attr_types={"use_data_lengths": bool, "use_label_lengths": bool,
                      "blank_label": str},
          infer_shape=_ctc_infer, num_outputs=1,
          alias=("ctc_loss", "_contrib_CTCLoss"))
def _ctc_loss(attrs, ins, octx):
    """data (T, N, C) activations (softmax applied inside), label (N, L)
    1-based classes padded with 0; the per-sample loss (N,). Blank is
    class 0 (``blank_label='first'``)."""
    data, label = ins[0], ins[1]
    return [ctc_loss(torch.log_softmax(data, dim=-1), label.long())]


def _corr_infer(attrs, in_shapes, aux):
    d1 = in_shapes[0]
    if d1 is None:
        return in_shapes, None, aux
    md = int(attrs.get("max_displacement", 1))
    s2 = int(attrs.get("stride2", 1))
    d = 2 * (md // s2) + 1
    return in_shapes, [(d1[0], d * d, d1[2], d1[3])], aux


@register("Correlation", arg_names=("data1", "data2"),
          attr_types={"kernel_size": int, "max_displacement": int,
                      "stride1": int, "stride2": int, "pad_size": int,
                      "is_multiply": bool})
def _correlation(attrs, ins, octx):
    """out[:, k, y, x] = mean_c d1[:, c, y, x] · d2[:, c, y + dy, x + dx]
    over the displacements k = (dy, dx), |dy|, |dx| ≤ max_displacement in
    steps of stride2 (or the mean absolute difference)."""
    d1, d2 = ins
    H, W = d1.shape[2], d1.shape[3]
    md = int(attrs.get("max_displacement", 1))
    s2 = int(attrs.get("stride2", 1))
    multiply = attrs.get("is_multiply", True)
    d2p = F.pad(d2, (md, md, md, md))
    outs = []
    for dy in range(-md, md + 1, s2):
        for dx in range(-md, md + 1, s2):
            shifted = d2p[:, :, md + dy:md + dy + H, md + dx:md + dx + W]
            outs.append((d1 * shifted).mean(dim=1) if multiply
                        else (d1 - shifted).abs().mean(dim=1))
    return [torch.stack(outs, dim=1)]
