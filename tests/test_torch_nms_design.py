"""The two decisions of the redesigned NMS kernels (``csrc/nms.cu``),
through their plain mirrors in ``mxnet_tpu_torch/kernels/nms.py``, against
the JAX package on the CPU. Held exactly.

* ``pair_decision``: the mask kernel decides a pair by the sign of
  ``inter − union·thresh`` (over 1 + thresh) where that cannot differ
  from the IEEE quotient's, and by the quotient elsewhere. Its bit equals the JAX
  package's float32 ``_iou_matrix(a, b) > thresh`` on every pair: 2^16
  pairs drawn around the IoU threshold as ``chip_smoke.py`` draws them at
  0.45 and 0.7 (and the pairs among them whose IoU is the threshold or the
  next float32 above it, which the fast test must leave to the division),
  random pairs at thresholds 0 and −0.1 (an IoU of 0 is above a negative
  threshold) and 1, the same scaled to corners near 1e19 (areas and their
  sums past float32's range), and the card's integer and clipped boxes at
  theirs.
* ``nms_scan_walk``: the scan kernel's walk (a tile at a time, from one
  free row to the next, near words ORed by the settler and far words by
  the other warps) equals ``nms_scan_plain`` and the JAX loop
  ``_nms_suppress`` at N ∈ {1, 63, 64, 65, 130, 1000}, with tied scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.detection import _iou_matrix, _nms_suppress

import chip_smoke
from mxnet_tpu_torch.kernels import nms as tnms

torch.set_num_threads(2)

DRAWS = 1 << 16


def _jax_bits(pairs, thresh):
    """The JAX package's float32 ``iou > thresh`` of each pair (M, 2, 4)."""
    p = jnp.asarray(pairs.numpy())
    iou = jax.vmap(lambda a, b: _iou_matrix(jnp, a[None], b[None])[0, 0])(
        p[:, 0], p[:, 1])
    return np.asarray(iou > np.float32(thresh))


def _random_pairs(rs, m):
    """(m, 2, 4) pairs: overlapping, disjoint, touching, identical, and
    zero-area boxes."""
    xy = rs.rand(m, 2, 2).astype(np.float32) * 4
    wh = rs.rand(m, 2, 2).astype(np.float32) * 3
    boxes = np.concatenate([xy, xy + wh], axis=2)
    boxes[::7, 1] = boxes[::7, 0]                             # identical
    boxes[1::7, 1, 0] = boxes[1::7, 0, 2]                     # touching
    boxes[2::7, :, 2] = boxes[2::7, :, 0]                     # zero area
    boxes[3::7, 1, 2:] = boxes[3::7, 1, :2]                   # one zero
    return torch.tensor(boxes)


def _image_pairs(boxes):
    """Every pair of one image's boxes (N, 4) as (N², 2, 4)."""
    n = boxes.shape[0]
    return torch.stack([boxes[:, None].expand(n, n, 4),
                        boxes[None].expand(n, n, 4)], dim=2).reshape(-1, 2, 4)


def _pairs(source, thresh):
    g = torch.Generator().manual_seed(21)
    if source == "drawn":
        return chip_smoke.jittered_pairs(thresh, g, draws=DRAWS)
    if source == "random":
        return _random_pairs(np.random.RandomState(21), DRAWS)
    if source == "huge":
        # corners near 1e19: areas past 2^127, sums of two areas and the
        # areas themselves past float32's largest (an IoU of 0 there)
        return _random_pairs(np.random.RandomState(21), DRAWS) * 7e18
    make = {"integer": chip_smoke.integer_boxes,
            "clipped": chip_smoke.clipped_boxes}[source]
    return _image_pairs(make(1, 256, g)[0][0])


@pytest.mark.parametrize("source,thresh", [
    ("drawn", 0.45), ("drawn", 0.7), ("random", 0.45), ("random", 0.0),
    ("random", -0.1), ("random", 1.0), ("integer", 0.5), ("clipped", 0.45),
    ("clipped", 0.0), ("huge", 0.45), ("huge", 0.7)])
def test_pair_decision_equals_the_jax_iou(source, thresh):
    pairs = _pairs(source, thresh)
    assert len(pairs) >= DRAWS
    bit, sure = tnms.pair_decision(pairs[:, 0], pairs[:, 1], thresh)
    np.testing.assert_array_equal(bit.numpy(), _jax_bits(pairs, thresh))
    if thresh <= 0:
        assert not sure.any()          # the exact decision on every pair
    elif source == "random":
        # the fast test settles nearly every pair but those of two boxes
        # of zero area (a union of 0) and those at the threshold (the
        # identical boxes' IoU of 1), which take the exact decision
        wh = (pairs[..., 2:] - pairs[..., :2]).clamp_min(0)
        iou = tnms.iou_matrix(pairs[:, :1], pairs[:, 1:])[:, 0, 0]
        off = (wh.prod(-1).sum(-1) > 0) & (iou != np.float32(thresh))
        assert float(sure[off].float().mean()) > 0.99
    elif source == "huge":
        # a pair whose union may overflow is left to the exact decision
        area = (pairs[..., 2:] - pairs[..., :2]).prod(-1).clamp_min(0)
        over = torch.isinf(area[:, 0] + area[:, 1])
        assert bool(over.any()) and not bool(sure[over].any())
    elif source == "drawn":
        # drawn within a few float32 steps of the threshold: both ways
        assert bool(sure.any()) and not bool(sure.all())


@pytest.mark.parametrize("thresh", [0.45, 0.7])
def test_pairs_at_the_threshold_take_the_division(thresh):
    g = torch.Generator().manual_seed(21)
    eq, up = chip_smoke.threshold_pairs(tnms, thresh, g, draws=DRAWS)
    assert len(eq) > 0 and len(up) > 0
    for pairs, want in ((eq, False), (up, True)):
        bit, sure = tnms.pair_decision(pairs[:, 0], pairs[:, 1], thresh)
        assert not sure.any()
        assert bool((bit == want).all())
        np.testing.assert_array_equal(bit.numpy(), _jax_bits(pairs, thresh))


def _sorted_image(n, seed):
    rs = np.random.RandomState(seed)
    xy = rs.rand(n, 2).astype(np.float32) * 20
    wh = rs.rand(n, 2).astype(np.float32) * 6
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = rs.rand(n).astype(np.float32)
    scores[::5] = scores[0]                                   # ties
    return boxes, scores


@pytest.mark.parametrize("n", [1, 63, 64, 65, 130, 1000])
def test_scan_walk_equals_the_plain_scan_and_the_jax_loop(n):
    boxes, scores = _sorted_image(n, n)
    order = np.argsort(-scores, kind="stable")
    boxes_s = torch.tensor(boxes[order])[None]
    mask = tnms.nms_mask_plain(boxes_s, 0.3)
    walk = tnms.nms_scan_walk(mask, n)
    np.testing.assert_array_equal(walk.numpy(),
                                  tnms.nms_scan_plain(mask, n).numpy())
    for near in (0, 1):                 # any split of near and far words
        assert torch.equal(tnms.nms_scan_walk(mask, n, near=near), walk)
    keep = np.zeros(n, bool)
    keep[order] = walk[0].numpy()
    want = np.asarray(_nms_suppress(jnp, jnp.asarray(boxes),
                                    jnp.asarray(scores), 0.3, n))
    np.testing.assert_array_equal(keep, want)
