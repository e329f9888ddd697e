"""The detection data pipeline of the PyTorch port (mxnet_tpu_torch
``image_det.py``: ``DetLabel``, ``DetAugmenter``, ``ImageDetRecordIter``;
``io_util.imdecode`` and ``nd.imdecode``) against the JAX package's, on
the CPU.

Both are host numpy code drawing the same numbers in the same order, so
from one pack and one seed the batches (data and padded labels) are
equal bit for bit, epoch after epoch, with mirror, pad, constrained crops
and every resize mode; so are the labels' geometry (project, mirror,
crop with each emit mode) and the augmenter's images. The pack is
written by the port's ``recordio`` and read by both packages.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import image_det as jdet

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import image_det as tdet

torch.set_num_threads(2)


def _label(objects, header=(2, 5)):
    return np.concatenate([np.asarray(header, np.float32),
                           np.asarray(objects, np.float32).ravel()])


def _write_pack(path, n=24, size=32, fmt=".png"):
    """Images with 1-3 bright squares and their detection labels, packed
    by the port's recordio (PNG: lossless, so both decoders agree)."""
    rng = np.random.RandomState(3)
    writer = tmx.recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = (rng.rand(size, size, 3) * 40).astype(np.uint8)
        objs = []
        for _ in range(rng.randint(1, 4)):
            w = rng.randint(6, 14)
            x0, y0 = rng.randint(0, size - w, 2)
            img[y0:y0 + w, x0:x0 + w] = 255
            objs.append([rng.randint(0, 3), x0 / size, y0 / size,
                         (x0 + w) / size, (y0 + w) / size])
        header = tmx.recordio.IRHeader(0, _label(objs), i, 0)
        writer.write(tmx.recordio.pack_img(header, img, img_fmt=fmt))
    writer.close()


def _epochs(mod, pkg_iter_kwargs, rec, n_epochs=2):
    it = mod.ImageDetRecordIter(rec, **pkg_iter_kwargs)
    out = []
    for _ in range(n_epochs):
        it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    return it, out


AUG_CASES = {
    "plain": {},
    "mirror_crop": dict(rand_mirror_prob=0.5, rand_crop_prob=0.7,
                        min_crop_scales=0.6, max_crop_scales=1.0,
                        min_crop_object_coverages=0.6),
    "pad_two_samplers_shrink": dict(
        rand_pad_prob=0.6, max_pad_scale=1.8, fill_value=90,
        rand_crop_prob=0.5, num_crop_sampler=2,
        min_crop_scales=(0.5, 0.8), max_crop_scales=(0.9, 1.0),
        min_crop_overlaps=(0.1, 0.3), crop_emit_mode="overlap",
        resize_mode="shrink"),
    "jitter_fit": dict(random_brightness_prob=0.5,
                       max_random_brightness=30,
                       random_contrast_prob=0.5, max_random_contrast=0.3,
                       resize_mode="fit", rand_mirror_prob=0.5),
}


@pytest.mark.parametrize("case", sorted(AUG_CASES))
def test_det_record_iter_batches_equal_the_jax_iterator(case, tmp_path):
    rec = str(tmp_path / "det.rec")
    _write_pack(rec)
    kw = dict(data_shape=(3, 24, 28), batch_size=5, shuffle=True, seed=11,
              mean_r=10.0, std_g=2.0, scale=1.0 / 255, label_pad_width=25,
              **AUG_CASES[case])
    jit, jb = _epochs(jdet, kw, rec)
    tit, tb = _epochs(tdet, kw, rec)
    assert tit.provide_label[0].shape == jit.provide_label[0].shape \
        == (5, 5, 5)
    assert tit.provide_data[0].shape == (5, 3, 24, 28)
    assert len(tb) == len(jb) and len(tb[0]) == len(jb[0]) == 5
    for je, te in zip(jb, tb):
        for (jd, jl, jp), (td, tl, tp) in zip(je, te):
            assert td.dtype == np.float32 and tp == jp
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
    assert jb[0][-1][2] == 1                      # 24 images, batches of 5
    tit.close()


def test_det_label_geometry_matches():
    raw = _label([[1, 0.1, 0.2, 0.5, 0.6], [3, 0.3, 0.3, 0.9, 0.8],
                  [0, 0.05, 0.05, 0.15, 0.15]])
    for box, kw in (((0.1, 0.1, 0.5, 0.5), {}),
                    ((0.0, 0.0, 0.6, 0.7), {"emit_mode": "overlap"}),
                    ((0.2, 0.2, 0.6, 0.6), {"min_overlap": 0.3}),
                    ((0.5, 0.5, 0.1, 0.1), {"min_object_coverage": 0.9})):
        j, t = jdet.DetLabel(raw), tdet.DetLabel(raw)
        assert t.try_crop(box, **kw) == j.try_crop(box, **kw)
        np.testing.assert_array_equal(t.to_array(), j.to_array())
        j.mirror(), t.mirror()
        j.try_pad((-0.2, -0.1, 1.5, 1.5)), t.try_pad((-0.2, -0.1, 1.5, 1.5))
        np.testing.assert_array_equal(t.to_array(), j.to_array())
    with pytest.raises(ValueError):
        tdet.DetLabel([2, 5, 1, 0, 0])


def test_det_augmenter_images_match():
    rs = np.random.RandomState(5)
    img = (rs.rand(30, 40, 3) * 255).astype(np.uint8)
    raw = _label([[1, 0.1, 0.2, 0.5, 0.6], [2, 0.5, 0.4, 0.9, 0.9]])
    kw = dict(resize=36, rand_crop_prob=1.0, min_crop_scales=0.5,
              rand_pad_prob=1.0, max_pad_scale=1.5, rand_mirror_prob=0.5,
              seed=9)
    ja = jdet.DetAugmenter((3, 20, 20), **kw)
    ta = tdet.DetAugmenter((3, 20, 20), **kw)
    for _ in range(4):
        jl, tl = jdet.DetLabel(raw), tdet.DetLabel(raw)
        np.testing.assert_array_equal(ta(img, tl), ja(img, jl))
        np.testing.assert_array_equal(tl.to_array(), jl.to_array())


def test_image_namespace_and_imdecode():
    assert tmx.image.ImageDetRecordIter is tdet.ImageDetRecordIter
    assert tmx.image.DetAugmenter is tdet.DetAugmenter
    import cv2
    rs = np.random.RandomState(6)
    img = (rs.rand(7, 9, 3) * 255).astype(np.uint8)
    buf = cv2.imencode(".png", img)[1].tobytes()
    j = jmx.nd.imdecode(buf).asnumpy()
    with tmx.cpu():
        t = tmx.nd.imdecode(buf)
    assert t.context == tmx.cpu() and t.dtype == np.float32
    np.testing.assert_array_equal(t.asnumpy(), j)
    np.testing.assert_array_equal(t.asnumpy(), img.astype(np.float32))
    out = tmx.nd.zeros((7, 9, 3), ctx=tmx.cpu())
    with tmx.cpu():
        assert tmx.nd.imdecode(buf, out=out, mean=np.float32(2.0)) is out
    np.testing.assert_array_equal(out.asnumpy(), img - np.float32(2.0))
