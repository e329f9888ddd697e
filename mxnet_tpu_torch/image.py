"""Image iterators and augmenters (PyTorch counterpart of
``mxnet_tpu/image.py``, the reference's ``python/mxnet/image.py`` and its
C++ augmenter chain).

Decode uses cv2 when it can be imported, else PIL; a record whose payload
is a raw ``.npy`` array (``recordio.pack_img(..., img_fmt=".npy")``)
needs neither. Augmentation geometry is numpy on the host; batch assembly
is ``runtime.assemble_batch`` (host path), or, with
``ImageRecordIter(device_augment=True)``, mirror/normalize/transpose on
the card from uint8 NHWC batches, or, with ``device_augment="defer"``,
the bound module's deferred augment (``data.DeviceAugment``). The
detection pipeline (``image_det.py``) is re-exported here.
"""
from __future__ import annotations

import io as _pyio
import os
import queue
import random
import threading
from concurrent.futures import Future

import numpy as onp
import torch

from . import recordio
from . import runtime
from .base import MXNetError
from .context import cpu, current_context
from .io import DataIter, DataBatch, DataDesc
from .ndarray import NDArray

__all__ = ["imdecode", "scale_down", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "ResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "HorizontalFlipAug",
           "ColorNormalizeAug", "CastAug", "CreateAugmenter", "ImageIter",
           "ImageRecordIter"]


def _no_decoder(what):
    return MXNetError(
        "%s needs an image library: neither cv2 (opencv-python) nor PIL "
        "(Pillow) can be imported; install one, or pack raw arrays with "
        "recordio.pack_img(..., img_fmt='.npy')" % what)


def imdecode(buf, to_rgb=True):
    """Decode image bytes to a HWC uint8 numpy array (RGB unless
    ``to_rgb=False``)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(onp.frombuffer(buf, dtype=onp.uint8), 1)
        if to_rgb:
            img = img[:, :, ::-1]
        return img
    try:
        from PIL import Image
    except ImportError:
        raise _no_decoder("imdecode")
    img = onp.asarray(Image.open(_pyio.BytesIO(bytes(buf))).convert("RGB"))
    if not to_rgb:
        img = img[:, :, ::-1]
    return img


def _resize(img, w, h):
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    try:
        from PIL import Image
    except ImportError:
        raise _no_decoder("resize")
    return onp.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def scale_down(src_size, size):
    """Scale ``size`` down to fit in ``src_size``."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size):
    """Resize so that the shorter edge is ``size``."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return _resize(src, new_w, new_h)


def fixed_crop(src, x0, y0, w, h, size=None):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _resize(out, size[0], size[1])
    return out


def random_crop(src, size):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src.astype(onp.float32) - mean
    if std is not None:
        src = src / std
    return src


def random_size_crop(src, size, min_area=0.08, ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """Random area and aspect crop (GoogLeNet style)."""
    h, w = src.shape[:2]
    area = h * w
    for _ in range(10):
        new_area = random.uniform(min_area, 1.0) * area
        new_ratio = random.uniform(*ratio)
        new_w = int(round((new_area * new_ratio) ** 0.5))
        new_h = int(round((new_area / new_ratio) ** 0.5))
        if random.random() < 0.5:
            new_w, new_h = new_h, new_w
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            return fixed_crop(src, x0, y0, new_w, new_h, size), \
                (x0, y0, new_w, new_h)
    return center_crop(src, size)


# -- augmenter functors (CreateAugmenter's building blocks) ---------------
def ResizeAug(size):
    def aug(src):
        return resize_short(src, size)
    return aug


def RandomCropAug(size):
    def aug(src):
        return random_crop(src, size)[0]
    return aug


def RandomSizedCropAug(size, min_area=0.08, ratio=(3. / 4., 4. / 3.)):
    def aug(src):
        return random_size_crop(src, size, min_area, ratio)[0]
    return aug


def CenterCropAug(size):
    def aug(src):
        return center_crop(src, size)[0]
    return aug


def HorizontalFlipAug(p=0.5):
    def aug(src):
        if random.random() < p:
            return src[:, ::-1]
        return src
    return aug


def ColorNormalizeAug(mean, std=None):
    def aug(src):
        return color_normalize(src, mean, std)
    return aug


def CastAug():
    def aug(src):
        return src.astype(onp.float32)
    return aug


def BrightnessJitterAug(brightness):
    def aug(src):
        alpha = 1.0 + random.uniform(-brightness, brightness)
        return onp.clip(src.astype(onp.float32) * alpha, 0, 255)
    return aug


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, **kwargs):
    """The standard augmenter list."""
    auglist = []
    size = (data_shape[2], data_shape[1])
    if resize > 0:
        auglist.append(ResizeAug(resize))
    if rand_resize:
        if not rand_crop:
            raise ValueError("rand_resize needs rand_crop")
        auglist.append(RandomSizedCropAug(size))
    elif rand_crop:
        auglist.append(RandomCropAug(size))
    else:
        auglist.append(CenterCropAug(size))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(CastAug())
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


def _host_nd(arr):
    """A host numpy array as a CPU NDArray (no copy)."""
    return NDArray(torch.from_numpy(onp.ascontiguousarray(arr)), ctx=cpu())


class ImageIter(DataIter):
    """Python image iterator over a ``.lst`` image list, an in-memory
    ``imglist`` or a RecordIO file, with an augmenter list."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        if not (path_imgrec or path_imglist or isinstance(imglist, list)):
            raise ValueError("ImageIter needs path_imgrec, path_imglist or "
                             "an imglist")
        if path_imgrec:
            self.rec = runtime.RecordFile(path_imgrec)
            self.imglist = None
            self.seq = list(range(len(self.rec)))
        else:
            self.rec = None
            if path_imglist:
                imglist = []
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        label = onp.array([float(x) for x in parts[1:-1]],
                                          dtype=onp.float32)
                        imglist.append((label, parts[-1]))
            else:
                imglist = [(onp.array([float(x[0])], dtype=onp.float32), x[1])
                           for x in imglist]
            self.imglist = imglist
            self.path_root = path_root or ""
            self.seq = list(range(len(imglist)))

        self.shuffle = shuffle
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.aug_list = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **kwargs)
        self.cur = 0
        self.data_name = data_name
        self.label_name = label_name
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(label_name, (batch_size, label_width)
                                       if label_width > 1 else (batch_size,))]
        self.reset()

    def reset(self):
        if self.shuffle:
            random.shuffle(self.seq)
        self.cur = 0

    def next_sample(self):
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.rec is not None:
            header, img_bytes = recordio.unpack(self.rec.read(idx))
            return header.label, imdecode(img_bytes)
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root, fname), "rb") as f:
            img = imdecode(f.read())
        return label, img

    def next(self):
        c, h, w = self.data_shape
        batch_data = onp.zeros((self.batch_size, c, h, w), onp.float32)
        batch_label = onp.zeros((self.batch_size, self.label_width),
                                onp.float32)
        i = 0
        while i < self.batch_size:
            try:
                label, img = self.next_sample()
            except StopIteration:
                if i == 0:
                    raise
                break
            for aug in self.aug_list:
                img = aug(img)
            batch_data[i] = onp.asarray(img, onp.float32).transpose(2, 0, 1)
            batch_label[i] = onp.atleast_1d(label)[:self.label_width]
            i += 1
        pad = self.batch_size - i
        label_out = batch_label if self.label_width > 1 else \
            batch_label[:, 0]
        return DataBatch([_host_nd(batch_data)], [_host_nd(label_out)],
                         pad=pad)


def _decode_resize_crop(img_bytes, resize, th, tw, pick_crop):
    """Record payload -> cropped uint8 HWC (shared by the thread and the
    process decode paths, so the two never diverge). ``pick_crop(h, w)``
    -> (y0, x0) gives the crop origin."""
    if bytes(img_bytes[:6]) == b"\x93NUMPY":
        # a raw (uncompressed) payload: decoding is a buffer read
        img = onp.load(_pyio.BytesIO(bytes(img_bytes)), allow_pickle=False)
    else:
        img = imdecode(img_bytes)
    if resize > 0:
        img = resize_short(img, resize)
    h, w = img.shape[:2]
    if h < th or w < tw:
        img = _resize(img, max(tw, w), max(th, h))
        h, w = img.shape[:2]
    y0, x0 = pick_crop(h, w)
    return img[y0:y0 + th, x0:x0 + tw]


def _proc_worker_init(path):
    global _PROC_REC
    _PROC_REC = runtime.RecordFile(path)


def _proc_decode_one(args):
    """Decode, resize and crop one record in a worker process (uint8 HWC
    out). The crop origin comes from a per-record rng seeded from (seed,
    idx): processes cannot share the parent's rng stream."""
    idx, resize, th, tw, rand_crop, seed = args
    header, img_bytes = recordio.unpack(_PROC_REC.read(idx))

    def pick(h, w):
        if not rand_crop:
            return (h - th) // 2, (w - tw) // 2
        r = random.Random(seed ^ (idx * 2654435761 & 0xffffffff))
        return r.randint(0, h - th), r.randint(0, w - tw)

    img = _decode_resize_crop(img_bytes, resize, th, tw, pick)
    return img, onp.atleast_1d(header.label)


class _DecodePool(object):
    """Named daemon decode threads with an ordered ``map``: an error in a
    worker is raised at its item's position."""

    def __init__(self, workers, name):
        self._q = queue.SimpleQueue()
        self._threads = [threading.Thread(target=self._work,
                                          name="%s-%d" % (name, i),
                                          daemon=True)
                         for i in range(max(1, int(workers)))]
        self._shutdown = False
        for t in self._threads:
            t.start()

    def _work(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, arg = item
            try:
                fut.set_result(fn(arg))
            except Exception as exc:  # noqa: BLE001 — raised in order
                fut.set_exception(exc)
            # hold nothing while idle: fn may be a bound method of the
            # iterator, whose collection shuts this pool down
            del item, fut, fn, arg

    def map(self, fn, items):
        futs = []
        for a in items:
            fut = Future()
            self._q.put((fut, fn, a))
            futs.append(fut)
        return [f.result() for f in futs]

    def shutdown(self, wait=True):
        if self._shutdown:
            return
        self._shutdown = True
        for _ in self._threads:
            self._q.put(None)
        if wait:
            for t in self._threads:
                t.join()


class ImageRecordIter(DataIter):
    """RecordIO image iterator with threaded (or process) decode and
    batch assembly.

    Decode runs on ``preprocess_threads`` named daemon threads, or with
    ``preprocess_processes=N`` on a ``spawn`` process pool whose workers
    import only this package. The crop geometry is chosen per sample;
    then, per batch:

    * default: ``runtime.assemble_batch`` on the host (float32 NCHW,
      ``(x - mean) / (std / scale)``, mirror drawn from the iterator's
      ``random.Random(seed)``);
    * ``device_augment=True``: the uint8 NHWC batch goes to ``ctx``
      (default the current context, ``gpu(0)``) and mirror, normalize and
      transpose run there;
    * ``device_augment="defer"``: raw uint8 NHWC wire batches plus the
      per-batch draws of a :class:`~mxnet_tpu_torch.data.DeviceAugment`
      (exposed as ``device_augment_spec``); the bound module runs
      pad/crop/mirror/normalize at staging. Decode geometry is then the
      center crop, so it composes with ``cache_decoded``; crop randomness
      comes from ``augment_pad``.

    ``cache_decoded=True`` decodes every image once into a uint8 NHWC
    host cache and serves batches by gather. ``round_batch`` fills the
    last batch from the epoch's head (else it is short); ``set_epoch``
    pins the epoch coordinate that the shuffle order and the deferred
    draws are functions of.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, scale=1.0, resize=-1, preprocess_threads=4,
                 preprocess_processes=0, device_augment=False,
                 augment_pad=0, cache_decoded=False, round_batch=True,
                 data_name="data", label_name="softmax_label", seed=0,
                 ctx=None, **kwargs):
        super().__init__(batch_size)
        self.rec = runtime.RecordFile(path_imgrec)
        self._path_imgrec = path_imgrec
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.mean = onp.array([mean_r, mean_g, mean_b], onp.float32)
        self.std = onp.array([std_r, std_g, std_b], onp.float32)
        self.scale = scale
        self.resize = resize
        self.round_batch = round_batch
        self.seed = seed
        self.rng = random.Random(seed)
        self.device_augment = device_augment
        self._defer = device_augment == "defer"
        self._device = None
        if device_augment and not self._defer:
            # where the batch is normalized; a gpu context without CUDA
            # raises here rather than quietly staying on the host
            self._device = (ctx or current_context()).torch_device()
            self._dev_consts = None
        self._aug_spec = None
        self._batch_seq = 0
        if self._defer:
            from .data.augment import DeviceAugment
            c, th, tw = self.data_shape
            if rand_crop and not augment_pad:
                raise ValueError(
                    "rand_crop with device_augment='defer' needs "
                    "augment_pad>0: crop randomness comes from the "
                    "deferred pad-and-crop, not from decode")
            self._aug_spec = DeviceAugment(
                (c, th, tw), rand_crop=rand_crop,
                rand_mirror=rand_mirror, pad=augment_pad,
                mean=self.mean, std=self.std, scale=scale, seed=seed)
            self.device_augment_spec = {data_name: self._aug_spec}
        elif augment_pad:
            raise ValueError(
                "augment_pad is the deferred pad-and-crop knob; it needs "
                "device_augment='defer'")
        if preprocess_processes > 0:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            # spawn, not fork: the parent may hold a CUDA context, which
            # must not be forked
            self.pool = ProcessPoolExecutor(
                max_workers=preprocess_processes,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_proc_worker_init, initargs=(path_imgrec,))
            self._proc_mode = True
        else:
            self.pool = _DecodePool(preprocess_threads, "imagerec-decode")
            self._proc_mode = False
        self.cache_decoded = cache_decoded
        self._cache = None
        if cache_decoded and rand_crop and not self._defer:
            raise ValueError(
                "cache_decoded caches one deterministic decode per "
                "image; rand_crop needs fresh geometry every epoch — "
                "use the streaming path for random-crop training, or "
                "device_augment='defer' (the crop runs at staging)")
        self.seq = list(range(len(self.rec)))
        self.cur = 0
        # decode-time crop geometry: random only on the host-augment
        # streaming path
        self._decode_rand_crop = bool(rand_crop) and not self._defer
        if self._defer:
            self.provide_data = self._aug_spec.data_descs(data_name,
                                                          batch_size)
        else:
            self.provide_data = [DataDesc(data_name,
                                          (batch_size,) + self.data_shape)]
        self._data_name = data_name
        self.provide_label = [DataDesc(label_name, (batch_size, label_width)
                                       if label_width > 1 else (batch_size,))]
        self.reset()

    def reset(self):
        self._epoch = getattr(self, "_epoch", -1) + 1
        self._reshuffle()
        self.cur = 0
        self._batch_seq = 0

    def _reshuffle(self):
        """Epoch k's order is a pure function of ``(seed, k)``, drawn from
        the fixed base order, so ``set_epoch(k)`` replays it whatever the
        number of resets before."""
        if not self.shuffle:
            return
        from .data.augment import fold_seed
        rs = onp.random.RandomState(
            fold_seed(self.seed ^ 0x5bd1e995, self._epoch, 0))
        self.seq = list(range(len(self.rec)))
        rs.shuffle(self.seq)

    def set_epoch(self, epoch):
        """Pin the epoch coordinate (the resume-replay contract)."""
        self._epoch = int(epoch)
        self._batch_seq = 0
        self._reshuffle()

    @property
    def epoch_coord(self):
        return self._epoch

    def _decode_one(self, idx):
        header, img_bytes = recordio.unpack(self.rec.read(idx))
        c, th, tw = self.data_shape

        def pick(h, w):
            if not self._decode_rand_crop:
                return (h - th) // 2, (w - tw) // 2
            return self.rng.randint(0, h - th), self.rng.randint(0, w - tw)

        img = _decode_resize_crop(img_bytes, self.resize, th, tw, pick)
        return img, onp.atleast_1d(header.label)

    def _device_preprocess(self, imgs_u8, mirror):
        """uint8 NHWC batch -> normalized float32 NCHW on the device: the
        copy is the uint8 batch (4x smaller than float32 NCHW), then the
        cast, the mirror and ``(x - mean) / std`` there, as the host
        assembly computes them."""
        dev = self._device
        if self._dev_consts is None:
            self._dev_consts = (
                torch.from_numpy(self.mean).to(dev),
                torch.from_numpy((self.std / self.scale)
                                 .astype(onp.float32)).to(dev))
        mean, std = self._dev_consts
        x = torch.from_numpy(onp.ascontiguousarray(imgs_u8))
        if dev.type == "cuda":
            x = x.pin_memory().to(dev, non_blocking=True)
        xf = x.to(torch.int32).to(torch.float32)
        if mirror is not None:
            flip = torch.from_numpy(mirror).to(dev) != 0
            xf = torch.where(flip[:, None, None, None], xf.flip(2), xf)
        xf = torch.sub(xf, mean)
        xf = torch.div(xf, std)
        return xf.permute(0, 3, 1, 2).contiguous()

    def _fill_cache(self):
        """Decode every record once into a uint8 NHWC array + labels."""
        c, th, tw = self.data_shape
        n = len(self.rec)
        cache = onp.empty((n, th, tw, c), onp.uint8)
        lw = self.label_width
        labels = onp.empty((n, lw), onp.float32)
        all_idx = list(range(n))
        if self._proc_mode:
            work = [(i, self.resize, th, tw, False, self.seed)
                    for i in all_idx]
            results = self.pool.map(_proc_decode_one, work, chunksize=16)
        else:
            results = self.pool.map(self._decode_one, all_idx)
        for i, (img, lab) in zip(all_idx, results):
            cache[i] = img
            labels[i] = lab[:lw]
        self._cache = (cache, labels)
        # the decode pool is never used again on this path
        self.pool.shutdown(wait=True)

    def next(self):
        if self.cur >= len(self.seq):
            raise StopIteration
        idxs = self.seq[self.cur:self.cur + self.batch_size]
        self.cur += self.batch_size
        pad = self.batch_size - len(idxs)
        if pad > 0 and self.round_batch:
            idxs = idxs + self.seq[:pad]
        if self.cache_decoded:
            if self._cache is None:
                self._fill_cache()
            cache, cl = self._cache
            imgs = cache[idxs]
            labels = cl[idxs]
        else:
            if self._proc_mode:
                c, th, tw = self.data_shape
                ep_seed = self.seed ^ (self._epoch * 0x9e3779b1 & 0xffffffff)
                work = [(i, self.resize, th, tw, self._decode_rand_crop,
                         ep_seed) for i in idxs]
                results = list(self.pool.map(_proc_decode_one, work,
                                             chunksize=4))
            else:
                results = self.pool.map(self._decode_one, idxs)
            imgs = onp.stack([r[0] for r in results])
            labels = onp.stack([r[1] for r in results])
        label_out = labels if self.label_width > 1 else labels[:, 0]
        # float32, as the JAX package's nd.array makes them (a record's
        # scalar label unpacks as a Python float)
        label_nd = _host_nd(label_out.astype(onp.float32))
        if self._defer:
            spec = self._aug_spec
            params = spec.draw(self._data_name, self._epoch,
                               self._batch_seq, imgs.shape[0])
            self._batch_seq += 1
            data = [imgs] + [
                params[d.name]
                for d in spec.param_descs(self._data_name, imgs.shape[0])]
            return DataBatch(data, [label_nd], pad=pad)
        mirror = None
        if self.rand_mirror:
            mirror = onp.array(
                [self.rng.random() < 0.5 for _ in range(len(idxs))],
                onp.uint8)
        if self.device_augment:
            batch = NDArray(self._device_preprocess(imgs, mirror))
        else:
            std = self.std / self.scale
            batch = _host_nd(runtime.assemble_batch(
                imgs, mean=self.mean, std=std, mirror=mirror))
        return DataBatch([batch], [label_nd], pad=pad)

    def close(self):
        """Shut the decode pool down (idempotent)."""
        pool = getattr(self, "pool", None)
        if pool is not None:
            pool.shutdown(wait=True)

    def __del__(self):
        # an iterator dropped without close() still stops its workers
        pool = getattr(self, "pool", None)
        if pool is not None:
            try:
                pool.shutdown(wait=False)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass


# the detection pipeline lives in its own module; re-exported here so the
# reference surface (mx.image) finds it
from .image_det import (DetAugmenter, DetLabel,  # noqa: E402,F401
                        ImageDetRecordIter)

__all__ += ["DetLabel", "DetAugmenter", "ImageDetRecordIter"]
