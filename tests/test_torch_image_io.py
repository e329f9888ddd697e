"""RecordIO, the record reader, batch assembly, the image iterators and the
rest of ``io.py`` in the PyTorch port (``mxnet_tpu_torch.recordio``,
``.io_runtime``, ``.image``, ``.io``), held on the CPU to the contracts
of ``tests/test_image_io.py`` and ``tests/test_io.py``, and crossed with
the JAX package: ``pack``/``unpack`` bytes equal, files written by either
package read back byte for byte in the other, and ``assemble_batch`` and
``ImageRecordIter`` batches bit for bit (``.npy`` packs, and image packs
decoded by the same library, with ``rand_crop`` off: the host path's crop
draws race across the decode threads). Both packages' batch assembly
runs through its numpy path in these crossings (the native OpenMP loop
multiplies by 1/std where the numpy path divides; the native paths are
crossed in ``test_torch_runtime.py``). ``ImageRecordIter(device_augment=
True)`` agrees with the host path within atol 1e-4, the JAX test's limit.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu import runtime as jrt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image, io_runtime, recordio
from mxnet_tpu_torch import io as mio
from mxnet_tpu_torch.base import MXNetError

torch.set_num_threads(2)

CPU = mx.cpu()


def _png_bytes(arr):
    from PIL import Image
    import io as pyio
    bio = pyio.BytesIO()
    Image.fromarray(arr).save(bio, format="PNG")
    return bio.getvalue()


def _images(n, hw, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, hw + (3,), dtype=np.uint8) for _ in range(n)]


def _make_rec(tmp_path, n=24, hw=(36, 36), fmt="png", name="imgs.rec"):
    """A pack of n random images (PNG, JPEG through PIL, or raw .npy)
    with labels i % 5."""
    path = str(tmp_path / name)
    rec = recordio.MXRecordIO(path, "w")
    labels = []
    for i, img in enumerate(_images(n, hw)):
        label = float(i % 5)
        labels.append(label)
        header = recordio.IRHeader(0, label, i, 0)
        if fmt == "png":
            rec.write(recordio.pack(header, _png_bytes(img)))
        elif fmt == "pil-jpeg":
            from PIL import Image
            import io as pyio
            bio = pyio.BytesIO()
            Image.fromarray(img).save(bio, format="JPEG")
            rec.write(recordio.pack(header, bio.getvalue()))
        else:
            rec.write(recordio.pack_img(header, img, img_fmt=".npy"))
    rec.close()
    return path, labels


@pytest.fixture
def jax_numpy_assembly(monkeypatch):
    """Route both packages' readers and assembly through their numpy
    paths."""
    from mxnet_tpu_torch import runtime as trt
    monkeypatch.setattr(jrt, "get_lib", lambda: None)
    monkeypatch.setattr(trt, "get_lib", lambda: None)


# ----------------------------------------------------------------------
# RecordIO
# ----------------------------------------------------------------------
def test_recordfile_roundtrip(tmp_path):
    path = str(tmp_path / "t.rec")
    rec = recordio.MXRecordIO(path, "w")
    rs = np.random.RandomState(0)
    payloads = [rs.bytes(rs.randint(1, 200)) for _ in range(30)]
    for p in payloads:
        rec.write(p)
    rec.close()
    rf = io_runtime.RecordFile(path)
    assert len(rf) == 30
    for i, p in enumerate(payloads):
        assert rf.read(i) == p
    rd = recordio.MXRecordIO(path, "r")
    for p in payloads:
        assert rd.read() == p
    assert rd.read() is None
    rf.close()


def test_recordfile_empty_file(tmp_path):
    path = str(tmp_path / "empty.rec")
    open(path, "wb").close()
    assert len(io_runtime.RecordFile(path)) == 0


def test_indexed_recordio(tmp_path):
    path = str(tmp_path / "x.rec")
    idx_path = str(tmp_path / "x.idx")
    rec = recordio.MXIndexedRecordIO(idx_path, path, "w")
    for i in range(10):
        rec.write_idx(i, b"record%d" % i)
    rec.close()
    rd = recordio.MXIndexedRecordIO(idx_path, path, "r")
    assert rd.read_idx(7) == b"record7"
    assert rd.read_idx(0) == b"record0"
    assert rd.keys == list(range(10))


def test_pack_unpack_header():
    h = recordio.IRHeader(0, 3.0, 42, 0)
    h2, payload = recordio.unpack(recordio.pack(h, b"payload"))
    assert h2.label == 3.0 and h2.id == 42
    assert payload == b"payload"
    h = recordio.IRHeader(4, np.array([1, 2, 3, 4], np.float32), 1, 0)
    h2, payload = recordio.unpack(recordio.pack(h, b"x"))
    np.testing.assert_array_equal(h2.label, [1, 2, 3, 4])
    assert h2.flag == 4 and payload == b"x"


@pytest.mark.parametrize("case", ["scalar", "vector", "npy", "jpg", "png"])
def test_pack_bytes_equal_jax(case):
    """pack / pack_img produce the JAX package's bytes, and each unpacks
    the other's record to the same header and payload."""
    img = _images(1, (12, 10))[0]
    if case == "scalar":
        args = (recordio.IRHeader(0, 7.0, 3, 9), b"abc")
        mine, want = recordio.pack(*args), jrec.pack(*args)
    elif case == "vector":
        lab = np.array([0.5, 2.0, 3.25], np.float32)
        mine = recordio.pack(recordio.IRHeader(3, lab, 1, 2), b"xy")
        want = jrec.pack(jrec.IRHeader(3, lab, 1, 2), b"xy")
    else:
        h = recordio.IRHeader(0, 1.0, 5, 0)
        mine = recordio.pack_img(h, img, img_fmt="." + case)
        want = jrec.pack_img(h, img, img_fmt="." + case)
    assert mine == want
    for unpack in (recordio.unpack, jrec.unpack):
        ha, pa = unpack(mine)
        hb, pb = recordio.unpack(want)
        assert ha.flag == hb.flag and ha.id == hb.id and ha.id2 == hb.id2
        np.testing.assert_array_equal(np.asarray(ha.label),
                                      np.asarray(hb.label))
        assert bytes(pa) == bytes(pb)
    if case in ("npy", "png"):
        _, a = recordio.unpack_img(mine)
        _, b = jrec.unpack_img(want)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_read_both_ways(tmp_path, writer):
    """A plain and an indexed pack written by one package read back byte
    for byte through the other's sequential reader, indexed reader and
    random-access reader."""
    w, r = (jrec, recordio) if writer == "jax" else (recordio, jrec)
    rs = np.random.RandomState(1)
    payloads = [rs.bytes(rs.randint(0, 90)) for _ in range(17)]
    path, idx = str(tmp_path / "a.rec"), str(tmp_path / "a.idx")
    rec = w.MXIndexedRecordIO(idx, path, "w")
    for i, p in enumerate(payloads):
        rec.write_idx(i, p)
    rec.close()
    seq = r.MXRecordIO(path, "r")
    assert [seq.read() for _ in payloads] == payloads
    assert seq.read() is None
    ind = r.MXIndexedRecordIO(idx, path, "r")
    assert [ind.read_idx(i) for i in (16, 3, 0)] == \
        [payloads[16], payloads[3], payloads[0]]
    for rf in (io_runtime.RecordFile(path), jrt.RecordFile(path)):
        assert len(rf) == len(payloads)
        assert [bytes(rf.read(i)) for i in range(len(rf))] == payloads


# ----------------------------------------------------------------------
# batch assembly
# ----------------------------------------------------------------------
def test_assemble_batch_matches_numpy():
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 255, (6, 20, 22, 3), dtype=np.uint8)
    mean = np.array([100.0, 110.0, 120.0])
    std = np.array([50.0, 55.0, 60.0])
    mirror = np.array([1, 0, 1, 0, 1, 0], np.uint8)
    out = io_runtime.assemble_batch(imgs, mean=mean, std=std, mirror=mirror,
                                    out_hw=(20, 22))
    for i in range(6):
        ref = imgs[i].astype(np.float32)
        if mirror[i]:
            ref = ref[:, ::-1]
        ref = (ref - mean) / std
        np.testing.assert_allclose(out[i], ref.transpose(2, 0, 1),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("crop", [False, True])
def test_assemble_batch_bitwise_jax(jax_numpy_assembly, crop):
    rng = np.random.RandomState(4)
    imgs = rng.randint(0, 255, (5, 14, 16, 3), dtype=np.uint8)
    kw = dict(mean=np.array([123.68, 116.28, 103.53], np.float32),
              std=np.array([58.4, 57.1, 57.4], np.float32),
              mirror=np.array([0, 1, 1, 0, 1], np.uint8))
    if crop:
        kw.update(crop_yx=(rng.randint(0, 5, 5), rng.randint(0, 5, 5)),
                  out_hw=(10, 12))
    out = np.empty((5, 3) + kw.get("out_hw", (14, 16)), np.float32)
    mine = io_runtime.assemble_batch(imgs, out=out, **kw)
    assert mine is out
    np.testing.assert_array_equal(mine, jrt.assemble_batch(imgs, **kw))


# ----------------------------------------------------------------------
# ImageRecordIter / ImageIter
# ----------------------------------------------------------------------
def test_image_record_iter(tmp_path):
    path, labels = _make_rec(tmp_path)
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                               batch_size=8, rand_crop=True,
                               rand_mirror=True, mean_r=123, mean_g=117,
                               mean_b=104)
    batches = list(it)
    assert len(batches) == 3
    assert batches[0].data[0].shape == (8, 3, 32, 32)
    assert batches[0].data[0].context == CPU
    assert batches[0].label[0].shape == (8,)
    np.testing.assert_array_equal(batches[0].label[0].asnumpy(), labels[:8])
    it.reset()
    assert len(list(it)) == 3
    it.close()


@pytest.mark.parametrize("fmt", ["npy", "pil-jpeg"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_image_record_iter_bitwise_jax(tmp_path, jax_numpy_assembly, fmt,
                                       scale):
    """Two epochs of shuffled, mirrored batches (and a padded tail) equal
    the JAX package's bit for bit, labels and pads too."""
    path, _ = _make_rec(tmp_path, n=20, hw=(36, 40), fmt=fmt)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=8,
              shuffle=True, rand_mirror=True, mean_r=123.68, mean_g=116.28,
              mean_b=103.53, std_r=58.4, std_g=57.1, std_b=57.4,
              scale=scale, seed=5, preprocess_threads=2)
    mine, want = mx.io.ImageRecordIter(**kw), jmx.io.ImageRecordIter(**kw)
    for _ in range(2):
        a, b = list(mine), list(want)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.data[0].asnumpy(),
                                          y.data[0].asnumpy())
            np.testing.assert_array_equal(x.label[0].asnumpy(),
                                          y.label[0].asnumpy())
            assert x.pad == y.pad
        mine.reset()
        want.reset()
    mine.close()


def test_defer_batches_and_draws_equal_jax(tmp_path, jax_numpy_assembly):
    """device_augment='defer': the uint8 wire batches and the per-batch
    crop/mirror draws equal the JAX package's, over two epochs."""
    path, _ = _make_rec(tmp_path, n=20, hw=(32, 32), fmt="npy")
    kw = dict(path_imgrec=path, data_shape=(3, 28, 28), batch_size=8,
              shuffle=True, rand_crop=True, rand_mirror=True,
              device_augment="defer", augment_pad=2, seed=9,
              mean_r=10.0, std_b=2.0)
    mine, want = mx.io.ImageRecordIter(**kw), jmx.io.ImageRecordIter(**kw)
    assert [(d.name, d.shape) for d in mine.provide_data] == \
        [(d.name, d.shape) for d in want.provide_data]
    assert [d.name for d in mine.provide_data] == \
        ["data", "data.aug_crop", "data.aug_mirror"]
    for _ in range(2):
        for x, y in zip(mine, want):
            assert len(x.data) == len(y.data) == 3
            for a, b in zip(x.data, y.data):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        mine.reset()
        want.reset()
    mine.close()


def test_defer_argument_checks(tmp_path):
    path, _ = _make_rec(tmp_path, n=4, fmt="npy")
    with pytest.raises(ValueError, match="augment_pad"):
        mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                              batch_size=2, rand_crop=True,
                              device_augment="defer")
    with pytest.raises(ValueError, match="defer"):
        mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                              batch_size=2, augment_pad=2)


def test_device_augment_matches_host_path(tmp_path):
    """device_augment=True ships uint8 NHWC to the context and runs
    mirror/normalize/transpose there: within atol 1e-4 of the host path
    (the JAX test's limit; here it agrees bit for bit)."""
    path, _ = _make_rec(tmp_path)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=8,
              rand_mirror=True, mean_r=123.0, mean_g=117.0, mean_b=104.0,
              std_r=58.0, std_g=57.0, std_b=57.0, scale=2.0, seed=5)
    host = mx.io.ImageRecordIter(**kw)
    dev = mx.io.ImageRecordIter(device_augment=True, ctx=CPU, **kw)
    for _ in range(2):
        a, b = next(host), next(dev)
        np.testing.assert_allclose(a.data[0].asnumpy(),
                                   b.data[0].asnumpy(), atol=1e-4)
        np.testing.assert_array_equal(a.label[0].asnumpy(),
                                      b.label[0].asnumpy())


def test_device_augment_without_cuda_raises(tmp_path):
    """The default context is gpu(0): without CUDA the iterator refuses
    instead of quietly normalizing on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    path, _ = _make_rec(tmp_path, n=4)
    with pytest.raises(MXNetError, match="CUDA"):
        mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                              batch_size=2, device_augment=True)


def test_process_pool_decode_matches_threads(tmp_path):
    """preprocess_processes=N decodes in spawned worker processes that
    import only the port: byte-identical batches to the thread path."""
    path, _ = _make_rec(tmp_path, n=16)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=8,
              seed=5, mean_r=10.0)
    t = mx.io.ImageRecordIter(**kw)
    p = mx.io.ImageRecordIter(preprocess_processes=2, **kw)
    try:
        for _ in range(2):
            np.testing.assert_array_equal(next(t).data[0].asnumpy(),
                                          next(p).data[0].asnumpy())
        p.reset()
        t.reset()
        np.testing.assert_array_equal(next(t).data[0].asnumpy(),
                                      next(p).data[0].asnumpy())
    finally:
        p.close()
        t.close()


def test_round_batch_and_set_epoch(tmp_path):
    """round_batch=False leaves a short tail with pad set; the shuffle
    order of epoch k is a pure function of (seed, k): set_epoch replays
    it on a fresh iterator, and epoch_coord reports it."""
    path, _ = _make_rec(tmp_path, n=20, fmt="npy")
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=8,
              shuffle=True, seed=3)
    short = list(mx.io.ImageRecordIter(round_batch=False, **kw))
    assert [b.data[0].shape[0] for b in short] == [8, 8, 4]
    assert short[-1].pad == 4
    it = mx.io.ImageRecordIter(**kw)
    epochs = []
    for _ in range(3):
        epochs.append([b.label[0].asnumpy() for b in it])
        it.reset()
    assert it.epoch_coord == 3
    assert not all(np.array_equal(a, b)
                   for a, b in zip(epochs[0], epochs[1]))
    fresh = mx.io.ImageRecordIter(**kw)
    fresh.set_epoch(2)
    assert fresh.epoch_coord == 2
    for a, b in zip(epochs[2], [b.label[0].asnumpy() for b in fresh]):
        np.testing.assert_array_equal(a, b)


def test_image_iter_imglist(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    files = []
    for i in range(6):
        arr = rng.randint(0, 255, (40, 40, 3), dtype=np.uint8)
        fname = "img%d.png" % i
        Image.fromarray(arr).save(str(tmp_path / fname))
        files.append((i % 3, fname))
    it = image.ImageIter(batch_size=3, data_shape=(3, 32, 32),
                         imglist=files, path_root=str(tmp_path))
    batch = next(iter(it))
    assert batch.data[0].shape == (3, 3, 32, 32)
    np.testing.assert_array_equal(batch.label[0].asnumpy(), [0, 1, 2])


def test_image_iter_rec_equals_jax(tmp_path):
    """ImageIter over a pack with the center-crop augmenter list: the JAX
    package's batches bit for bit."""
    path, _ = _make_rec(tmp_path, n=7, hw=(36, 36))
    kw = dict(batch_size=4, data_shape=(3, 32, 32), path_imgrec=path,
              mean=True, std=True)
    a = list(image.ImageIter(**kw))
    b = list(jmx.image.ImageIter(**kw))
    assert len(a) == len(b) == 2 and a[1].pad == b[1].pad == 1
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.data[0].asnumpy(),
                                      y.data[0].asnumpy())


def test_augmenters():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (50, 60, 3), dtype=np.uint8)
    out = image.resize_short(img, 40)
    assert min(out.shape[:2]) == 40
    out, _ = image.center_crop(img, (32, 32))
    assert out.shape[:2] == (32, 32)
    out, _ = image.random_crop(img, (32, 32))
    assert out.shape[:2] == (32, 32)
    out, _ = image.random_size_crop(img, (28, 28))
    assert out.shape[:2] == (28, 28)
    normed = image.color_normalize(img, np.array([100., 100., 100.]),
                                   np.array([50., 50., 50.]))
    assert abs(normed.mean()) < 1.5
    augs = image.CreateAugmenter((3, 32, 32), rand_crop=True,
                                 rand_mirror=True, mean=True, std=True)
    x = img
    for a in augs:
        x = a(x)
    assert x.shape == (32, 32, 3)
    # the deterministic helpers equal the JAX package's
    for fn, args in ((image.resize_short, (img, 40)),
                     (lambda s, z: image.center_crop(s, z)[0],
                      (img, (32, 28))),
                     (image.fixed_crop, (img, 3, 4, 20, 30, (16, 16)))):
        jfn = {image.resize_short: jmx.image.resize_short,
               image.fixed_crop: jmx.image.fixed_crop}.get(
                   fn, lambda s, z: jmx.image.center_crop(s, z)[0])
        np.testing.assert_array_equal(fn(*args), jfn(*args))


def test_imdecode_without_decoder_raises(monkeypatch):
    """Neither cv2 nor PIL importable: imdecode names the missing
    decoder; a raw .npy payload still decodes."""
    png = _png_bytes(_images(1, (4, 4))[0])
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(MXNetError, match="cv2.*PIL"):
        image.imdecode(png)
    img = _images(1, (6, 5))[0]
    _, payload = recordio.unpack(recordio.pack_img(
        recordio.IRHeader(0, 0.0, 0, 0), img, img_fmt=".npy"))
    out = image._decode_resize_crop(payload, -1, 4, 4, lambda h, w: (1, 0))
    np.testing.assert_array_equal(out, img[1:5, 0:4])
    # and pack_img with no encoder writes the raw payload
    rec = recordio.pack_img(recordio.IRHeader(0, 0.0, 0, 0), img)
    assert recordio.unpack(rec)[1][:6] == b"\x93NUMPY"


def test_prefetching_image_iter(tmp_path):
    path, _ = _make_rec(tmp_path, n=16)
    base = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                                 batch_size=8)
    with mio.PrefetchingIter(base) as pre:
        assert len(list(pre)) == 2
    base.close()


@pytest.mark.parametrize("dev_aug", [False, True])
def test_cache_decoded_matches_streaming(tmp_path, dev_aug):
    """cache_decoded=True decodes once into a uint8 NHWC cache and serves
    batches by gather: every batch equals the streaming path bit for bit,
    on the host-assembly and the device_augment routes."""
    path, _ = _make_rec(tmp_path, n=20, hw=(40, 40))
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=8,
              shuffle=True, rand_mirror=True, mean_r=10.0, std_b=2.0,
              scale=0.5, seed=3)
    if dev_aug:
        kw.update(device_augment=True, ctx=CPU)
    ref = mx.io.ImageRecordIter(**kw)
    cac = mx.io.ImageRecordIter(cache_decoded=True, **kw)
    for _ in range(2):
        for a, b in zip(ref, cac):
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
        ref.reset()
        cac.reset()


def test_cache_decoded_rejects_rand_crop(tmp_path):
    path, _ = _make_rec(tmp_path, n=4, hw=(40, 40))
    with pytest.raises(ValueError, match="rand_crop"):
        mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                              batch_size=2, rand_crop=True,
                              cache_decoded=True)


def test_decode_threads_named_daemons_and_joined(tmp_path):
    path, _ = _make_rec(tmp_path, n=8)
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                               batch_size=4, preprocess_threads=3)
    pool = [t for t in threading.enumerate()
            if t.name.startswith("imagerec-decode")]
    assert len(pool) >= 3 and all(t.daemon for t in pool)
    next(it)
    it.close()
    it.close()
    assert not any(t.is_alive() for t in it.pool._threads)


def test_decode_error_raised_in_order(tmp_path):
    """A record that fails to decode raises at its batch."""
    path = str(tmp_path / "bad.rec")
    rec = recordio.MXRecordIO(path, "w")
    for i, img in enumerate(_images(8, (32, 32))):
        payload = b"not an image" if i == 5 else _png_bytes(img)
        rec.write(recordio.pack(recordio.IRHeader(0, 0.0, i, 0), payload))
    rec.close()
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                               batch_size=4)
    next(it)
    with pytest.raises(Exception):
        next(it)
    it.close()


# ----------------------------------------------------------------------
# io.py: CSVIter, ResizeIter, PrefetchingIter, re-exports
# ----------------------------------------------------------------------
def test_resize_iter():
    data = np.arange(20).reshape(10, 2).astype(np.float32)
    base = mio.NDArrayIter(data, np.zeros(10), batch_size=5)
    resized = mio.ResizeIter(base, size=5)
    got = [b.data[0].asnumpy() for b in resized]
    assert len(got) == 5
    np.testing.assert_array_equal(got[2], data[:5])     # wrapped around
    resized.reset()
    assert len(list(resized)) == 5
    assert len(list(mio.ResizeIter(
        mio.NDArrayIter(data, np.zeros(10), batch_size=1), size=3))) == 3


def test_prefetching_iter():
    data = np.arange(40).reshape(10, 4).astype(np.float32)
    base = mio.NDArrayIter(data, np.zeros(10), batch_size=5)
    pre = mio.PrefetchingIter(base)
    batches = list(pre)
    assert len(batches) == 2
    assert batches[0].data[0].shape == (5, 4)
    pre.reset()
    assert len(list(pre)) == 2
    pre.close()


def test_prefetching_iter_two_sources_renamed():
    a = np.arange(20).reshape(10, 2).astype(np.float32)
    pre = mio.PrefetchingIter(
        [mio.NDArrayIter(a, np.zeros(10), batch_size=5),
         mio.NDArrayIter(a * 2, np.ones(10), batch_size=5)],
        rename_data=[{"data": "x"}, {"data": "y"}])
    assert [d.name for d in pre.provide_data] == ["x", "y"]
    b = next(pre)
    assert len(b.data) == 2 and len(b.label) == 2
    np.testing.assert_array_equal(b.data[1].asnumpy(), 2 * a[:5])
    pre.close()


def test_prefetching_iter_lifecycle():
    """close() joins the workers, is idempotent, works as a context
    manager, and a closed iterator refuses further use."""
    data = np.arange(40).reshape(10, 4).astype(np.float32)
    pre = mio.PrefetchingIter(mio.NDArrayIter(data, np.zeros(10),
                                              batch_size=5))
    threads = list(pre.prefetch_threads)
    assert all(t.is_alive() and t.daemon for t in threads)
    next(pre)
    pre.close()
    assert all(not t.is_alive() for t in threads)
    pre.close()
    with pytest.raises(MXNetError):
        pre.reset()
    with pytest.raises(MXNetError):
        pre.iter_next()
    with mio.PrefetchingIter(mio.NDArrayIter(data, np.zeros(10),
                                             batch_size=5)) as pre2:
        threads = list(pre2.prefetch_threads)
        assert len(list(pre2)) == 2
    assert all(not t.is_alive() for t in threads)


def test_prefetching_iter_reset_races():
    """reset() during an in-flight prefetch, and back-to-back resets,
    synchronize with the worker: every post-reset epoch delivers the full
    sequence with no stale batch."""
    data = np.arange(40).reshape(10, 4).astype(np.float32)
    labels = np.arange(10).astype(np.float32)
    with mio.PrefetchingIter(mio.NDArrayIter(data, labels,
                                             batch_size=5)) as pre:
        for trial in range(5):
            first = next(pre)
            np.testing.assert_array_equal(first.data[0].asnumpy(), data[:5])
            pre.reset()
            pre.reset()
            batches = list(pre)
            assert len(batches) == 2, trial
            np.testing.assert_array_equal(batches[0].data[0].asnumpy(),
                                          data[:5])
            np.testing.assert_array_equal(batches[1].data[0].asnumpy(),
                                          data[5:])
            pre.reset()


def test_csv_iter(tmp_path):
    rs = np.random.RandomState(2)
    data = rs.rand(10, 3).astype(np.float32)
    labels = np.arange(10).astype(np.float32)
    data_path = str(tmp_path / "data.csv")
    label_path = str(tmp_path / "label.csv")
    np.savetxt(data_path, data, delimiter=",")
    np.savetxt(label_path, labels, delimiter=",")
    it = mio.CSVIter(data_csv=data_path, data_shape=(3,),
                     label_csv=label_path, batch_size=4)
    want = jmx.io.CSVIter(data_csv=data_path, data_shape=(3,),
                          label_csv=label_path, batch_size=4)
    batches = list(it)
    assert len(batches) == 3 and batches[2].pad == 2
    np.testing.assert_allclose(batches[0].data[0].asnumpy(), data[:4],
                               rtol=1e-5)
    for a, b in zip(batches, want):
        np.testing.assert_array_equal(a.data[0].asnumpy(),
                                      b.data[0].asnumpy())
        np.testing.assert_array_equal(a.label[0].asnumpy(),
                                      b.label[0].asnumpy())
    assert len(list(mio.CSVIter(data_csv=data_path, data_shape=(3,),
                                batch_size=4, round_batch=False))) == 2


def test_io_reexports_and_descs():
    assert mio.ImageRecordIter is image.ImageRecordIter
    assert mio.ImageRecordUInt8Iter is image.ImageRecordIter
    assert mio.ImageIter is image.ImageIter
    with pytest.raises(AttributeError):
        mio.NoSuchIter
    d = mio.DataDesc("data", (4, 3))
    assert d.name == "data" and d.shape == (4, 3)
    assert mio.DataDesc.get_batch_axis("NCHW") == 0
    assert mio.DataDesc.get_batch_axis("TNC") == 1
    assert mio.DataDesc.get_batch_axis(None) == 0
    descs = mio.DataDesc.get_list([("a", (2,)), ("b", (3,))],
                                  [("a", np.uint8), ("b", np.float32)])
    assert [x.dtype for x in descs] == [np.uint8, np.float32]
