"""The detection slice of the PyTorch port (mxnet_tpu_torch
``kernels/nms.py``, ``ops/detection.py``, ``ops/contrib.py``'s
MultiBoxPrior and the ``train_ssd``/``train_rcnn`` twins) against the
JAX package, on the CPU, where the NMS wrappers run their plain
versions.

Held exactly: NMS keep masks (random boxes; integer boxes whose IoU is
exactly the threshold, which the strict ``>`` keeps; the card's cases of
``chip_smoke.py`` phase 16 (a): integer boxes, boxes clipped to [0, 1],
boxes with corners up to 1e20, pairs whose float32 IoU is the threshold
or the next float32 above it),
MultiBoxTarget's
class targets and masks (the three label layouts of a padded row after a
forced match), MultiBoxDetection's class ids, Proposal's selected
anchors and their order (tied scores; fewer survivors than post_n),
MultiBoxPrior's anchors. Offsets, scores and boxes within rtol 1e-5,
atol 1e-6. One SSD training step of the twin's graph from the same
numpy parameters: outputs and every gradient within relative L2 1e-5
(the convolutions and the loss sums add in another order).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import registry as jreg
from mxnet_tpu.ops.detection import _iou_matrix, _nms_suppress

import chip_smoke
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import registry as treg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples import train_rcnn, train_ssd
from mxnet_tpu_torch.kernels import nms as tnms

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax(name, attrs, ins):
    op = jreg.get_op(name)
    return [np.asarray(o) for o in op.fcompute(
        jreg.parse_attrs(op, attrs), [jnp.asarray(v) for v in ins], None)]


def _port(name, attrs, ins):
    op = treg.get_op(name)
    return [o.numpy() for o in op.fcompute(
        treg.parse_attrs(op, attrs), [torch.tensor(v) for v in ins], None)]


def _boxes(rs, n, span=10.0):
    xy = rs.rand(n, 2).astype(np.float32) * span
    wh = rs.rand(n, 2).astype(np.float32) * span / 2
    return np.concatenate([xy, xy + wh], 1)


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 130])
def test_nms_keep_equals_the_jax_loop(n):
    rs = np.random.RandomState(n)
    boxes = np.stack([_boxes(rs, n), _boxes(rs, n)])
    scores = rs.rand(2, n).astype(np.float32)
    scores[:, ::5] = scores[:, :1]                       # ties
    keep = tnms.nms(torch.tensor(boxes), torch.tensor(scores), 0.3).numpy()
    for b in range(2):
        want = np.asarray(_nms_suppress(jnp, jnp.asarray(boxes[b]),
                                        jnp.asarray(scores[b]), 0.3, n))
        np.testing.assert_array_equal(keep[b], want)


def test_nms_at_exactly_the_threshold_keeps_both():
    # IoUs 0.5 exactly (50/100) and 0.25: with thresh 0.5 the strict >
    # keeps every box; just below it the second goes
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 5], [0, 0, 5, 5],
                      [20, 20, 30, 30]], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.6], np.float32)
    for thresh, want in ((0.5, [1, 1, 1, 1]), (0.49, [1, 0, 1, 1])):
        jk = np.asarray(_nms_suppress(jnp, jnp.asarray(boxes),
                                      jnp.asarray(scores), thresh, 4))
        tk = tnms.nms(torch.tensor(boxes)[None], torch.tensor(scores)[None],
                      thresh)[0].numpy()
        np.testing.assert_array_equal(jk, np.array(want, bool))
        np.testing.assert_array_equal(tk, jk)


@pytest.mark.parametrize("case,thresh", [("integer", 0.5),
                                         ("clipped", 0.45),
                                         ("integer", -0.1),
                                         ("clipped", 0.0),
                                         ("huge", 0.45)])
def test_nms_chip_cases_equal_the_jax_loop(case, thresh):
    # chip_smoke.py holds the kernels to the plain version on these boxes
    g = torch.Generator().manual_seed(16)
    make = {"integer": chip_smoke.integer_boxes,
            "clipped": chip_smoke.clipped_boxes,
            "huge": chip_smoke.huge_boxes}[case]
    boxes, scores = make(2, 200, g)
    keep = tnms.nms(boxes, scores, thresh).numpy()
    for b in range(2):
        want = np.asarray(_nms_suppress(jnp, jnp.asarray(boxes[b].numpy()),
                                        jnp.asarray(scores[b].numpy()),
                                        thresh, 200))
        np.testing.assert_array_equal(keep[b], want)
    iou = tnms.iou_matrix(boxes, boxes).triu(1)
    area = (boxes[..., 2:] - boxes[..., :2]).prod(-1)
    if case == "integer":
        assert int((iou == 0.5).sum()) > 0          # pairs at the threshold
    elif case == "huge":                            # unions past float32
        assert bool(torch.isinf(area[:, :, None] + area[:, None]).any())
        assert torch.equal(boxes[:, 5::5], boxes[:, 1:-4:5])
    else:
        assert int((area == 0).sum()) > 0 and int((scores == -1).sum()) > 0
        assert torch.equal(boxes[:, 5::5], boxes[:, 1:-4:5])


def _iou_fma_union(pairs):
    """The IoU of each pair (M, 2, 4) with (area_a + area_b) − iw·ih
    rounded once, as an fma computes it (float64 holds iw·ih exactly)."""
    p = pairs.numpy()
    a, b, zero = p[:, 0], p[:, 1], np.float32(0)
    iw = np.maximum(np.minimum(a[:, 2], b[:, 2])
                    - np.maximum(a[:, 0], b[:, 0]), zero)
    ih = np.maximum(np.minimum(a[:, 3], b[:, 3])
                    - np.maximum(a[:, 1], b[:, 1]), zero)
    areas = (np.maximum((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]), zero)
             + np.maximum((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]), zero))
    union = (areas.astype(np.float64)
             - iw.astype(np.float64) * ih).astype(np.float32)
    return (iw * ih) / union


def test_nms_pairs_at_the_threshold_decide_as_the_jax_iou():
    # chip_smoke.py's rounding case: the JAX IoU of every pair is exactly
    # the threshold (float32) or the next float32 above it; the strict >
    # says no, then yes. An IoU whose union is one fma flips some pairs,
    # so the card's check catches a contracted kernel
    t = np.float32(0.45)
    g = torch.Generator().manual_seed(16)
    eq, up = chip_smoke.threshold_pairs(tnms, 0.45, g, draws=1 << 16)
    assert len(eq) > 0 and len(up) > 0
    flips = 0
    for pairs, want, bit in ((eq, t, 0),
                             (up, np.nextafter(t, np.float32(1)), 1)):
        jiou = np.asarray(_iou_matrix(jnp, jnp.asarray(pairs[:, 0].numpy()),
                                      jnp.asarray(pairs[:, 1].numpy())))
        assert (jiou.diagonal() == want).all()
        words = tnms.nms_mask(pairs, 0.45)
        assert bool((((words[:, 0, 0] >> 1) & 1) == bit).all())
        flips += int(((_iou_fma_union(pairs) > t) != bool(bit)).sum())
    assert flips > 0


def test_nms_mask_words_hold_the_upper_triangle():
    rs = np.random.RandomState(3)
    boxes = torch.tensor(_boxes(rs, 70))[None]
    words = tnms.nms_mask(boxes, 0.2)
    assert words.shape == (1, 70, 2) and words.dtype == torch.int64
    iou = tnms.iou_matrix(boxes[0], boxes[0]).numpy()
    bits = ((words.numpy()[0][:, :, None] >> np.arange(64)) & 1) \
        .reshape(70, 128)[:, :70].astype(bool)
    want = (iou > 0.2) & np.triu(np.ones((70, 70), bool), 1)
    np.testing.assert_array_equal(bits, want)
    assert not (words.numpy()[0, :, 1] >> 6).any()       # padding past 70


def test_nms_wrappers_refuse_tensors_off_the_cpu_without_a_kernel():
    """Off the CPU a wrapper launches its kernel or raises: a meta tensor
    (not CUDA) is refused, never sent to the plain version."""
    with pytest.raises(MXNetError):
        tnms.nms_mask(torch.empty((1, 4, 4), device="meta"), 0.5)
    with pytest.raises(MXNetError):
        tnms.nms_scan(torch.empty((1, 4, 1), dtype=torch.int64,
                                  device="meta"), 4)


# ---------------------------------------------------------------------------
# MultiBoxTarget, MultiBoxDetection, Proposal, MultiBoxPrior
# ---------------------------------------------------------------------------
ANCHORS3 = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1]]],
                    np.float32)
GT = [0, 0, 0, .4, .4]            # IoU 0.64 with anchor 0
PAD = [-1, 0, 0, 0, 0]


@pytest.mark.parametrize("rows,want", [([GT, PAD, PAD], [0, 0, 0]),
                                       ([PAD, GT], [1, 0, 0]),
                                       ([GT], [1, 0, 0])])
def test_multibox_target_padded_row_erases_a_forced_match(rows, want):
    """A padded row's IoU column is all −1, so its best anchor is 0: after
    a real row it erases that row's forced match onto anchor 0 (the JAX
    op's last write wins); before it, it does not."""
    label = np.array([rows], np.float32)
    ins = [ANCHORS3, label, np.zeros((1, 2, 3), np.float32)]
    attrs = {"overlap_threshold": 0.99}
    j, t = _jax("_contrib_MultiBoxTarget", attrs, ins), \
        _port("_contrib_MultiBoxTarget", attrs, ins)
    np.testing.assert_array_equal(j[2][0], want)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)


def test_multibox_target_random_labels():
    rs = np.random.RandomState(4)
    A, B, M = 60, 3, 6
    anchors = np.sort(rs.rand(1, A, 2, 2).astype(np.float32), axis=2) \
        .transpose(0, 1, 3, 2).reshape(1, A, 4)
    label = np.full((B, M, 5), -1, np.float32)
    for b, m in enumerate((6, 2, 4)):
        label[b, :m, 0] = rs.randint(0, 3, m)
        xy = np.sort(rs.rand(m, 2, 2).astype(np.float32), axis=1)
        label[b, :m, 1:] = xy.transpose(0, 2, 1).reshape(m, 4)
    ins = [anchors, label, np.zeros((B, 4, A), np.float32)]
    for thresh in (0.3, 0.5):
        attrs = {"overlap_threshold": thresh}
        j = _jax("_contrib_MultiBoxTarget", attrs, ins)
        t = _port("_contrib_MultiBoxTarget", attrs, ins)
        np.testing.assert_array_equal(t[1], j[1])        # masks
        np.testing.assert_array_equal(t[2], j[2])        # class targets
        np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)
        assert (j[2] > 0).sum() >= 3


def test_multibox_detection_random():
    rs = np.random.RandomState(5)
    B, C, A = 2, 4, 150
    anchors = np.sort(rs.rand(1, A, 2, 2).astype(np.float32), axis=2) \
        .transpose(0, 1, 3, 2).reshape(1, A, 4)
    prob = rs.dirichlet(np.ones(C), (B, A)).transpose(0, 2, 1)
    ins = [prob.astype(np.float32),
           (rs.randn(B, A * 4) * 0.3).astype(np.float32), anchors]
    attrs = {"threshold": 0.3, "nms_threshold": 0.45}
    j = _jax("_contrib_MultiBoxDetection", attrs, ins)[0]
    t = _port("_contrib_MultiBoxDetection", attrs, ins)[0]
    np.testing.assert_array_equal(t[..., 0], j[..., 0])
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    kept = (j[..., 0] >= 0).sum(1)
    assert (kept > 0).all() and (kept < (j[..., 1] > 0.3).sum(1)).all()


def _rpn_inputs(rs, B, K, H, W, tied):
    fg = rs.rand(B, K, H, W).astype(np.float32)
    if tied:   # saturated softmax scores: many exact ties at 1.0 and 0.5
        fg[:, :, ::2] = 1.0
        fg[:, ::2, :, 1::3] = 0.5
    cls = np.concatenate([1 - fg, fg], axis=1)
    return cls, np.zeros((B, 4 * K, H, W), np.float32)


@pytest.mark.parametrize("tied", [False, True])
def test_proposal_selects_the_jax_anchors_in_its_order(tied):
    """Zero deltas make each ROI an anchor, clipped, with no rounding, so
    the ROIs are held bit for bit: the selected anchors and their
    order."""
    rs = np.random.RandomState(6)
    cls, deltas = _rpn_inputs(rs, 2, 6, 5, 7, tied)
    info = np.array([[40, 56, 1], [33, 50, 1]], np.float32)
    attrs = {"feature_stride": 8, "scales": (1.0, 2.0, 4.0),
             "ratios": (0.5, 2.0), "rpn_pre_nms_top_n": 120,
             "rpn_post_nms_top_n": 30, "threshold": 0.5}
    j = _jax("_contrib_Proposal", attrs, [cls, deltas, info])[0]
    t = _port("_contrib_Proposal", attrs, [cls, deltas, info])[0]
    assert j.shape == (60, 5)
    np.testing.assert_array_equal(t, j)


def test_proposal_fewer_survivors_than_post_n():
    """Heavily overlapping anchors leave fewer than post_n boxes after
    NMS: the suppressed ones fill up in score order, as in the JAX op."""
    rs = np.random.RandomState(7)
    cls, _ = _rpn_inputs(rs, 1, 3, 3, 3, True)
    deltas = (rs.randn(1, 12, 3, 3) * 0.1).astype(np.float32)
    info = np.array([[20, 20, 1]], np.float32)
    attrs = {"feature_stride": 4, "scales": (2.0, 2.5, 3.0),
             "ratios": (1.0,), "rpn_pre_nms_top_n": 27,
             "rpn_post_nms_top_n": 20, "threshold": 0.3}
    j = _jax("Proposal", attrs, [cls, deltas, info])[0]
    t = _port("Proposal", attrs, [cls, deltas, info])[0]
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    # the same boxes in the same order: rows agree one to one
    d = np.abs(t[:, None, 1:] - j[None, :, 1:]).max(-1)
    np.testing.assert_array_equal(d.argmin(1), np.arange(20))
    top = torch.tensor(t[:, 1:])
    iou = tnms.iou_matrix(top, top).numpy()
    survivors = np.where((np.triu(iou, 1) > 0.3).sum(0) == 0)[0]
    assert len(survivors) < 20


def test_multibox_prior_equals_the_jax_anchors():
    x = np.zeros((1, 3, 5, 4), np.float32)
    for attrs in ({"sizes": (0.5, 0.25), "ratios": (1.0, 2.0)},
                  {"sizes": (0.9,), "ratios": (1.0, 2.0, 0.5, 3.0),
                   "clip": True, "steps": (0.2, 0.25)}):
        j = _jax("_contrib_MultiBoxPrior", attrs, [x])[0]
        t = _port("_contrib_MultiBoxPrior", attrs, [x])[0]
        np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# the SSD twin's graph, one training step, and the twins
# ---------------------------------------------------------------------------
def _jax_script(path, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graph(sym):
    nodes = json.loads(sym.tojson())["nodes"]
    return [(n["op"], n.get("attrs"), n["inputs"]) for n in nodes]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ssd_step(pkg, sym, args, x, label):
    """Outputs and gradients of one forward + backward of the graph."""
    ctx = pkg.cpu()
    ex = sym.simple_bind(ctx, data=x.shape, label=label.shape)
    for k, v in args.items():
        ex.arg_dict[k][:] = v
    ex.arg_dict["data"][:] = x
    ex.arg_dict["label"][:] = label
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward()
    return outs, {k: ex.grad_dict[k].asnumpy() for k in args}


def test_ssd_training_step_matches_the_jax_graph():
    script = _jax_script("example/ssd/train_ssd.py", "jax_train_ssd")
    jsym = script.build_ssd()[0]
    tsym = train_ssd.build_ssd()[0]
    # the same graph: ops, attributes, wiring and arguments (auto-made node
    # names count per process in each package, so they are left out)
    assert _graph(tsym) == _graph(jsym)
    assert tsym.list_arguments() == jsym.list_arguments()
    rs = np.random.RandomState(8)
    x, label = train_ssd.synth_batch(rs, 4)
    shapes = dict(zip(jsym.list_arguments(),
                      jsym.infer_shape(data=x.shape,
                                       label=label.shape)[0]))
    args = {k: (rs.randn(*s) * 0.1).astype(np.float32)
            for k, s in shapes.items() if k not in ("data", "label")}
    jouts, jgrads = _ssd_step(jmx, jsym, args, x, label)
    touts, tgrads = _ssd_step(tmx, tsym, args, x, label)
    for j, t in zip(jouts, touts):
        assert _rel(t, j) < 1e-5
    for k in args:
        assert np.abs(jgrads[k]).max() > 0, k
        assert _rel(tgrads[k], jgrads[k]) < 1e-5, k


@pytest.mark.parametrize("recordio", [False, True])
def test_train_ssd_twin(recordio):
    argv = ["--cpu", "--num-epochs", "2", "--num-examples", "64",
            "--batch-size", "16"] + (["--use-recordio"] if recordio else [])
    res = train_ssd.main(argv)
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    args, aux = res["module"].get_params()
    assert all(np.isfinite(v.asnumpy()).all() for v in args.values())
    det = train_ssd.detect(args, aux, res["images"], tmx.cpu())
    assert det.shape == (8, 240, 6)      # 8²·3 + 4²·3 anchors
    assert ((det[..., 0] >= 0).sum(1) >= 1).all()


def test_train_rcnn_twin():
    res = train_rcnn.main(["--cpu", "--num-examples", "64",
                           "--num-epochs", "2"])
    assert np.isfinite(res["losses"]).all()
    rois = res["demo"]["rois"]
    assert rois.shape == (16, 5) and (rois[:, 0] == 0).all()
    assert (rois[:, 1:] >= 0).all() and (rois[:, 1:] <= 31).all()
    assert res["demo"]["cls"].shape == (16, 2)
