"""WarpCTC plugin op (reference plugin/warpctc/warpctc-inl.h).

PyTorch counterpart of ``mxnet_tpu/plugin/warpctc.py``: the port's CTC
recursion (``ops/sequence_loss.py``) under the plugin's contract, which
differs from CTCLoss:

- data: 2-D ``(input_length * minibatch, alphabet_size)``, time-major
  flattened activations;
- label: ``(minibatch * label_length,)``, 0-padded, blank = 0;
- output: softmax(data), same shape as data; the backward ignores the
  head gradient and injects d(Σ CTC loss)/d(logits), the SoftmaxOutput
  pattern.
"""
from __future__ import annotations

import torch

from ..ops.sequence_loss import ctc_loss
from ..registry import register


def _warpctc_infer(attrs, in_shapes, aux):
    data = in_shapes[0]
    out = [data] if data is not None else None
    if data is not None and in_shapes[1] is None:
        T = int(attrs["input_length"])
        L = int(attrs["label_length"])
        in_shapes = [data, (data[0] // T * L,)]
    return in_shapes, out, aux


class _WarpCTC(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, T, L):
        ctx.save_for_backward(data, label)
        ctx.T, ctx.L = T, L
        return torch.softmax(data, dim=-1)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        n = data.shape[0] // ctx.T
        with torch.enable_grad():
            logits = data.detach().reshape(ctx.T, n, data.shape[-1]) \
                .requires_grad_(True)
            loss = ctc_loss(torch.log_softmax(logits, dim=-1),
                            label.reshape(n, ctx.L).long()).sum()
            grad, = torch.autograd.grad(loss, logits)
        return grad.reshape(data.shape), None, None, None


@register("WarpCTC", arg_names=("data", "label"),
          attr_types={"label_length": int, "input_length": int},
          infer_shape=_warpctc_infer, num_outputs=1)
def _warpctc(attrs, ins, octx):
    return [_WarpCTC.apply(ins[0], ins[1].detach(),
                           int(attrs["input_length"]),
                           int(attrs["label_length"]))]
