"""The vision operators of the PyTorch port (mxnet_tpu_torch
``ops/conv.py``'s ROIPooling and spatial ops, ``kernels/roi_pooling.py``,
``ops/contrib.py``'s transforms and the ``fcn_xs`` twin) against the JAX
package, on the CPU, where the ROI wrappers run their plain versions.

ROIPooling forward and input gradient against the JAX op (rtol 1e-5,
atol 1e-6): on a post-ReLU map full of zero ties, where the JAX op's
gradient splits equally among every position equal to the bin's max; on
ROIs whose bin edges land on integers and whose corners scale to halves
(rounded half to even); on empty and one-pixel bins. The bin counts
that the backward kernel divides by, exactly. Deconvolution, Crop and
the transforms of the FCN path, and the twin at its defaults.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import registry as treg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples import fcn_xs
from mxnet_tpu_torch.kernels import roi_pooling as troi

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _jax_roi(data, rois, pooled, scale, g):
    op = jreg.get_op("ROIPooling")
    attrs = jreg.parse_attrs(op, {"pooled_size": pooled,
                                  "spatial_scale": scale})
    out, vjp = jax.vjp(lambda d: op.fcompute(attrs, [d, jnp.asarray(rois)],
                                             None)[0], jnp.asarray(data))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _port_roi(data, rois, pooled, scale, g):
    d = torch.tensor(data, requires_grad=True)
    op = treg.get_op("ROIPooling")
    y = op.fcompute(treg.parse_attrs(op, {"pooled_size": pooled,
                                          "spatial_scale": scale}),
                    [d, torch.tensor(rois)], None)[0]
    y.backward(torch.tensor(g))
    return y.detach().numpy(), d.grad.numpy()


def _check_roi(data, rois, pooled, scale, seed=0):
    R, C = rois.shape[0], data.shape[1]
    g = np.random.RandomState(seed).randn(R, C, *pooled).astype(np.float32)
    jo, jg = _jax_roi(data, rois, pooled, scale, g)
    to, tg = _port_roi(data, rois, pooled, scale, g)
    np.testing.assert_array_equal(to, jo)        # a max is exact
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)
    return jo, jg


def test_roi_gradient_splits_among_zero_ties():
    """A 4×4 map of zeros with one −1 under a single 1×1 bin: the bin's
    max is 0 at 15 positions, each getting 1/15 of the head gradient."""
    data = np.zeros((1, 1, 4, 4), np.float32)
    data[0, 0, 2, 1] = -1.0
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)
    g = np.ones((1, 1, 1, 1), np.float32)
    jo, jg = _jax_roi(data, rois, (1, 1), 1.0, g)
    to, tg = _port_roi(data, rois, (1, 1), 1.0, g)
    want = np.full((4, 4), 1 / 15, np.float32)
    want[2, 1] = 0
    np.testing.assert_allclose(jg[0, 0], want, rtol=1e-6)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)
    _, count = troi.roi_pool_fwd(torch.tensor(data), torch.tensor(rois),
                                 (1, 1), 1.0)
    assert int(count) == 15


def test_roi_post_relu_map():
    rs = np.random.RandomState(1)
    data = np.maximum(rs.randn(2, 4, 13, 17), 0).astype(np.float32)
    rois = np.array([[0, 0, 0, 16, 12], [1, 3, 2, 9, 11], [0, 5, 5, 5, 5],
                     [1, 10, 1, 30, 30], [1, 0, 0, 16, 12],
                     [0, 2, 4, 7, 6]], np.float32)
    jo, jg = _check_roi(data, rois, (3, 4), 1.0)
    assert (jo == 0).mean() > 0.05 and (jg != 0).mean() > 0.05


@pytest.mark.parametrize("scale", [1.0, 0.5, 1.0 / 16])
def test_roi_integer_bin_edges_and_half_corners(scale):
    """rh = 6 over 3 bins and 7 over 2 put bin edges on integers and
    halves; corners at k/2 after scaling round half to even."""
    rs = np.random.RandomState(2)
    data = np.maximum(rs.randn(1, 3, 12, 12), 0).astype(np.float32)
    s = 1.0 / scale
    rois = np.array([[0, 0, 0, 5 * s, 5 * s], [0, 1 * s, 2 * s, 7 * s,
                                                 8 * s],
                     [0, 0.5 * s, 1.5 * s, 6.5 * s, 8.5 * s],
                     [0, 2.5 * s, 2.5 * s, 2.5 * s, 2.5 * s]], np.float32)
    _check_roi(data, rois, (3, 2), scale)
    _check_roi(data, rois, (6, 7), scale)


def test_roi_empty_and_one_pixel_bins():
    """More bins than pixels: some bins hold one pixel, ROIs partly or
    wholly off the map give empty bins (0, no gradient)."""
    rs = np.random.RandomState(3)
    data = rs.randn(2, 2, 6, 5).astype(np.float32)
    rois = np.array([[0, 1, 1, 2, 2], [1, 4, 3, 9, 9], [0, 8, 8, 12, 12],
                     [1, -3, -3, 0, 0]], np.float32)
    jo, _ = _check_roi(data, rois, (5, 5), 1.0)
    out, count = troi.roi_pool_fwd(torch.tensor(data), torch.tensor(rois),
                                   (5, 5), 1.0)
    assert (count.numpy() == 0).any() and (count.numpy() == 1).any()
    np.testing.assert_array_equal(out.numpy()[count.numpy() == 0], 0)


def test_roi_plain_backward_equals_autograd_of_the_op():
    rs = np.random.RandomState(4)
    data = np.maximum(rs.randn(1, 3, 9, 9), 0).astype(np.float32)
    rois = np.array([[0, 0, 0, 8, 8], [0, 2, 2, 6, 7]], np.float32)
    g = rs.randn(2, 3, 2, 2).astype(np.float32)
    _, tg = _port_roi(data, rois, (2, 2), 1.0, g)
    dx = troi.roi_pool_bwd_plain(torch.tensor(g), torch.tensor(data),
                                 torch.tensor(rois), (2, 2), 1.0)
    np.testing.assert_array_equal(dx.numpy(), tg)


def test_roi_wrappers_refuse_tensors_off_the_cpu_without_a_kernel():
    meta = torch.empty((1, 1, 4, 4), device="meta")
    with pytest.raises(MXNetError):
        troi.roi_pool_fwd(meta, torch.empty((1, 5), device="meta"), (2, 2),
                          1.0)


def _op(pkg_reg, name, attrs, ins, to):
    op = pkg_reg.get_op(name)
    return op.fcompute(pkg_reg.parse_attrs(op, attrs), [to(v) for v in ins],
                       None)[0]


def test_fcn_path_ops_match():
    """Deconvolution (stride 2, kernel 4) and Crop to the data, as the
    FCN twin's head uses them, forward and gradients through both."""
    rs = np.random.RandomState(5)
    score = rs.randn(2, 2, 8, 8).astype(np.float32)
    w = rs.randn(2, 2, 4, 4).astype(np.float32)
    like = np.zeros((2, 1, 16, 16), np.float32)
    g = rs.randn(2, 2, 16, 16).astype(np.float32)
    dattrs = {"kernel": (4, 4), "stride": (2, 2), "num_filter": 2,
              "adj": (0, 0)}
    cattrs = {"num_args": 2}

    def jf(s, w):
        up = _op(jreg, "Deconvolution", dattrs, [s, w], lambda v: v)
        return _op(jreg, "Crop", cattrs, [up, jnp.asarray(like)],
                   lambda v: v)

    jo, vjp = jax.vjp(jf, jnp.asarray(score), jnp.asarray(w))
    jgs, jgw = vjp(jnp.asarray(g))
    ts = torch.tensor(score, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    up = _op(treg, "Deconvolution", dattrs, [ts, tw], lambda v: v)
    to = _op(treg, "Crop", cattrs, [up, torch.tensor(like)], lambda v: v)
    to.backward(torch.tensor(g))
    assert to.shape == (2, 2, 16, 16)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgs), rtol=RTOL,
                               atol=ATOL)
    # the weight's gradient sums 2·8·8 products of both signs per entry,
    # in another order in each package: rtol 1e-4
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-4,
                               atol=ATOL)


def test_fft_round_trip_gains_n():
    """``tests/test_operator_parity.py``'s round trip, at its tolerances."""
    x = np.random.RandomState(6).rand(2, 8).astype(np.float32)
    f = tmx.nd.fft(tmx.nd.array(x, ctx=tmx.cpu()))
    back = tmx.nd.ifft(f).asnumpy()
    np.testing.assert_allclose(back, x * 8, rtol=1e-4, atol=1e-3)
    ref = np.fft.fft(x, axis=1)
    np.testing.assert_allclose(f.asnumpy()[:, 0::2], ref.real, rtol=1e-4,
                               atol=1e-4)


def test_fcn_xs_twin_passes_its_assert():
    res = fcn_xs.main(["--cpu"])
    assert res["accuracy"] > 0.95 and res["iou"] > 0.5
    assert res["ms_per_step"] > 0 and res["steps"] == 320
