"""Detection operators: MultiBoxTarget, MultiBoxDetection and Proposal
(src/operator/contrib/multibox_target, multibox_detection, proposal;
ROIPooling is in ``conv.py``).

PyTorch counterpart of ``mxnet_tpu/ops/detection.py``, vectorised over
the batch. Greedy NMS runs through the hand-written kernels of
``kernels/nms.py`` (their plain versions on the CPU). The three ops run
under ``torch.no_grad()``: in the JAX package's graphs no parameter gets
a gradient through them (MultiBoxTarget's outputs depend only on the
constant anchors and the label, Proposal's ROIs reach a loss only
through ROIPooling's ``round``/``floor``, MultiBoxDetection is inference
only).

Facts of the JAX package that the port copies:

* MultiBoxTarget has no hard-negative mining (``negative_mining_*`` and
  ``minimum_negative_samples`` are declared and ignored): every
  unmatched anchor is class 0. An anchor's forced match comes from the
  last label row whose best anchor it is, padded rows included, so a
  padded row (IoU column all −1, best anchor 0) after a real one erases
  a forced match onto anchor 0, as the JAX op's last-write-wins scatter
  does on XLA's CPU.
* MultiBoxDetection ignores ``nms_topk`` (NMS runs over all anchors);
  Proposal ignores ``rpn_min_size``.
* Ties in score keep index order: Proposal takes the first ``pre_n`` of a
  stable descending sort (``lax.top_k``'s order), NMS sorts −scores
  stably (``jnp.argsort``'s).
"""
from __future__ import annotations

import functools

import numpy as onp
import torch

from ..kernels.nms import iou_matrix, nms
from ..registry import register


def _mbt_infer(attrs, in_shapes, aux):
    anchor, label, cls_pred = in_shapes
    if anchor is None or label is None or cls_pred is None:
        return in_shapes, None, aux
    num_anchors = anchor[1]
    batch = label[0]
    return in_shapes, [(batch, num_anchors * 4), (batch, num_anchors * 4),
                       (batch, num_anchors)], aux


def _centres(anchors, eps=None):
    w = anchors[:, 2] - anchors[:, 0]
    h = anchors[:, 3] - anchors[:, 1]
    if eps is not None:
        w, h = torch.clamp_min(w, eps), torch.clamp_min(h, eps)
    return (w, h, (anchors[:, 0] + anchors[:, 2]) / 2,
            (anchors[:, 1] + anchors[:, 3]) / 2)


@register("_contrib_MultiBoxTarget",
          arg_names=("anchor", "label", "cls_pred"),
          attr_types={"overlap_threshold": float, "ignore_label": float,
                      "negative_mining_ratio": float,
                      "negative_mining_thresh": float, "variances": tuple,
                      "minimum_negative_samples": int},
          infer_shape=_mbt_infer, num_outputs=3)
@torch.no_grad()
def _multibox_target(attrs, ins, octx):
    """Assign ground truth to anchors (multibox_target-inl.h).

    anchor (1, A, 4); label (B, M, 5) [cls, x1, y1, x2, y2], cls < 0 a
    padded row; cls_pred (B, C, A) gives the dtype. Outputs loc_target
    (B, A·4), loc_mask (B, A·4) and cls_target (B, A), 0 the background
    and k + 1 class k."""
    anchor, label, cls_pred = ins
    A = anchor.shape[1]
    anchors = anchor.reshape(A, 4)
    thresh = float(attrs.get("overlap_threshold", 0.5))
    v = attrs.get("variances", (0.1, 0.1, 0.2, 0.2))
    aw, ah, acx, acy = _centres(anchors, 1e-8)
    B, M = label.shape[0], label.shape[1]

    valid = label[..., 0] >= 0                                   # (B, M)
    gt = label[..., 1:5]
    iou = iou_matrix(anchors.expand(B, A, 4), gt)                # (B, A, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)                 # the first maximum
    best_anchor = iou.argmax(dim=1)             # (B, M)
    # the last row whose best anchor is a: its validity and index win
    rows = torch.arange(M, device=label.device).expand(B, M)
    last = torch.full((B, A), -1, dtype=torch.int64, device=label.device)
    last = last.scatter_reduce(1, best_anchor, rows, "amax")
    has = last >= 0
    last = last.clamp_min(0)
    forced = has & valid.gather(1, last)
    gt_idx = torch.where(forced, last, best_gt)
    pos = (best_iou >= thresh) | forced

    g = gt.gather(1, gt_idx[..., None].expand(B, A, 4))
    gw, gh, gcx, gcy = _centres(g.reshape(-1, 4), 1e-8)
    shape = (B, A)
    tx = (gcx.reshape(shape) - acx) / aw / v[0]
    ty = (gcy.reshape(shape) - acy) / ah / v[1]
    tw = torch.log(gw.reshape(shape) / aw) / v[2]
    th = torch.log(gh.reshape(shape) / ah) / v[3]
    loc_t = torch.stack([tx, ty, tw, th], dim=2)
    loc_t = torch.where(pos[..., None], loc_t, torch.zeros_like(loc_t))
    loc_m = pos[..., None].expand(B, A, 4).to(loc_t.dtype)
    cls_t = torch.where(pos, label[..., 0].gather(1, gt_idx) + 1.0,
                        torch.zeros_like(best_iou))
    dt = cls_pred.dtype
    return [loc_t.reshape(B, -1).to(dt), loc_m.reshape(B, -1).to(dt),
            cls_t.to(dt)]


def _mbd_infer(attrs, in_shapes, aux):
    cls_prob, loc_pred, anchor = in_shapes
    if cls_prob is None or anchor is None:
        return in_shapes, None, aux
    return in_shapes, [(cls_prob[0], anchor[1], 6)], aux


def decode_detections(attrs, ins):
    """MultiBoxDetection's decoded (and clipped) boxes (B, A, 4), the
    best foreground scores (B, A) and which of them lie above
    ``threshold``."""
    cls_prob, loc_pred, anchor = ins
    B, C, A = cls_prob.shape
    v = attrs.get("variances", (0.1, 0.1, 0.2, 0.2))
    aw, ah, acx, acy = _centres(anchor.reshape(A, 4))
    loc = loc_pred.reshape(B, A, 4)
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw
    h = torch.exp(loc[..., 3] * v[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=2)
    if attrs.get("clip", True):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    scores = cls_prob[:, 1:].amax(dim=1)
    return boxes, scores, scores > float(attrs.get("threshold", 0.01))


@register("_contrib_MultiBoxDetection",
          arg_names=("cls_prob", "loc_pred", "anchor"),
          attr_types={"clip": bool, "threshold": float,
                      "background_id": int, "nms_threshold": float,
                      "force_suppress": bool, "variances": tuple,
                      "nms_topk": int},
          infer_shape=_mbd_infer)
@torch.no_grad()
def _multibox_detection(attrs, ins, octx):
    """Decode + NMS (multibox_detection-inl.h). Output (B, A, 6):
    [cls_id, score, x1, y1, x2, y2], cls_id −1 in suppressed slots."""
    cls_prob = ins[0]
    boxes, scores, valid = decode_detections(attrs, ins)
    cls_id = cls_prob[:, 1:].argmax(dim=1).to(cls_prob.dtype)
    keep = nms(boxes, torch.where(valid, scores, torch.full_like(scores,
                                                                 -1.0)),
               float(attrs.get("nms_threshold", 0.5)))
    out_id = torch.where(valid & keep, cls_id, torch.full_like(cls_id, -1.0))
    return [torch.cat([out_id[..., None], scores[..., None], boxes], dim=2)]


def _proposal_infer(attrs, in_shapes, aux):
    cls_prob = in_shapes[0]
    if cls_prob is None:
        return in_shapes, None, aux
    n = int(attrs.get("rpn_post_nms_top_n", 300))
    return in_shapes, [(cls_prob[0] * n, 5)], aux


@functools.lru_cache(maxsize=32)
def _rpn_anchors(H, W, stride, scales, ratios, device):
    """Every anchor of the (H, W) grid, (H·W·K, 4), K = ratios × scales
    base anchors centred at (stride − 1)/2, as the JAX op lays them."""
    base = []
    ctr = (stride - 1) / 2.0
    for r in ratios:
        ws = onp.round(onp.sqrt(stride * stride / r))
        hs = onp.round(ws * r)
        for s in scales:
            w, h = ws * s, hs * s
            base.append([ctr - (w - 1) / 2, ctr - (h - 1) / 2,
                         ctr + (w - 1) / 2, ctr + (h - 1) / 2])
    base = onp.asarray(base, onp.float32)
    gx, gy = onp.meshgrid(onp.arange(W) * stride, onp.arange(H) * stride)
    shifts = onp.stack([gx.ravel(), gy.ravel(), gx.ravel(), gy.ravel()],
                       axis=1)
    anchors = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)
    return torch.from_numpy(anchors.astype(onp.float32)).to(device), \
        len(base)


@register("_contrib_Proposal",
          arg_names=("cls_prob", "bbox_pred", "im_info"),
          attr_types={"rpn_pre_nms_top_n": int, "rpn_post_nms_top_n": int,
                      "threshold": float, "rpn_min_size": int,
                      "scales": tuple, "ratios": tuple,
                      "feature_stride": int, "output_score": bool,
                      "iou_loss": bool},
          infer_shape=_proposal_infer, alias=("Proposal",))
@torch.no_grad()
def _proposal(attrs, ins, octx):
    """RPN proposals (src/operator/contrib/proposal-inl.h): anchors on the
    feature grid, deltas decoded and clipped to ``im_info``, the ``pre_n``
    best by foreground score, NMS, then the ``post_n`` best kept (the
    suppressed ones fill up in score order when fewer survive). Output
    (B·post_n, 5) rois [batch_idx, x1, y1, x2, y2]."""
    cls_prob, bbox_pred, im_info = ins
    B, _, H, W = cls_prob.shape
    scales = attrs.get("scales", (4, 8, 16, 32))
    ratios = attrs.get("ratios", (0.5, 1, 2))
    scales = (scales,) if isinstance(scales, (int, float)) else scales
    ratios = (ratios,) if isinstance(ratios, (int, float)) else ratios
    anchors, K = _rpn_anchors(H, W, int(attrs.get("feature_stride", 16)),
                              tuple(scales), tuple(ratios), cls_prob.device)
    A = anchors.shape[0]
    pre_n = min(int(attrs.get("rpn_pre_nms_top_n", 6000)), A)
    post_n = min(int(attrs.get("rpn_post_nms_top_n", 300)), pre_n)

    scores = cls_prob[:, K:].reshape(B, K, H, W).permute(0, 2, 3, 1) \
        .reshape(B, -1)
    deltas = bbox_pred.reshape(B, K, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + 0.5 * (aw - 1)
    acy = anchors[:, 1] + 0.5 * (ah - 1)
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    w = torch.exp(torch.clamp(deltas[..., 2], -10, 10)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], -10, 10)) * ah
    xmax = (im_info[:, 1] - 1)[:, None]
    ymax = (im_info[:, 0] - 1)[:, None]
    zero = torch.zeros((), dtype=cx.dtype, device=cx.device)
    boxes = torch.stack([
        torch.clamp(cx - 0.5 * (w - 1), zero, xmax),
        torch.clamp(cy - 0.5 * (h - 1), zero, ymax),
        torch.clamp(cx + 0.5 * (w - 1), zero, xmax),
        torch.clamp(cy + 0.5 * (h - 1), zero, ymax)], dim=2)

    top = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = top.values[:, :pre_n], top.indices[:, :pre_n]
    top_boxes = boxes.gather(1, top_idx[..., None].expand(B, pre_n, 4))
    keep = nms(top_boxes, top_scores, float(attrs.get("threshold", 0.7)))
    ranked = torch.sort(torch.where(keep, top_scores,
                                    torch.full_like(top_scores, -onp.inf)),
                        dim=1, descending=True, stable=True).indices
    sel = ranked[:, :post_n]
    rois = top_boxes.gather(1, sel[..., None].expand(B, post_n, 4))
    bidx = torch.arange(B, dtype=cls_prob.dtype, device=cls_prob.device) \
        .repeat_interleave(post_n)
    return [torch.cat([bidx[:, None], rois.reshape(-1, 4)], dim=1)]
