"""OpenCV plugin (reference plugin/opencv/opencv.py + cv_api.cc; the
port's counterpart of ``mxnet_tpu/plugin/opencv.py``).

The reference routes cv2 decode/resize/border through C-API entry points
into NDArray; here the same surface wraps the host image ops
``ndarray._cvimdecode``/``_cvimresize``/``_cvcopyMakeBorder`` (cv2 when
it imports, PIL otherwise; without either, decode and resize raise
``MXNetError`` naming both) and returns CPU NDArrays, as host image work
does throughout the port.
"""
from __future__ import annotations

import random

from .. import ndarray as nd
from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc


def imdecode(str_img, flag=1):
    """Decode an encoded image buffer to an HWC NDArray, BGR channel
    order — cv2 semantics, like the reference plugin (opencv.py:13-28);
    mx.image.imdecode is the RGB-ordered counterpart."""
    return nd._cvimdecode(str_img, flag, to_rgb=False)


def resize(src, size, interp=2):
    """Resize ``src`` (HWC NDArray) to ``size`` = (w, h)."""
    return nd._cvimresize(src, size[0], size[1], interp)


def copyMakeBorder(src, top, bot, left, right, border_type=0, value=0):
    """Pad an HWC NDArray (cv2.copyMakeBorder semantics)."""
    return nd._cvcopyMakeBorder(src, top, bot, left, right, border_type,
                                value)


def scale_down(src_size, size):
    """Scale size down to fit in src_size, preserving aspect ratio."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop src at (x0, y0) size (w, h), optionally resize to ``size``."""
    out = nd.crop(src, begin=(y0, x0, 0), end=(y0 + h, x0 + w,
                                               int(src.shape[2])))
    if size is not None and (w, h) != size:
        out = resize(out, size, interp)
    return out


def random_crop(src, size):
    """Random crop to exactly ``size`` = (w, h); returns (img, (x0,y0,w,h))."""
    h, w, _ = src.shape
    new_w, new_h = scale_down((w, h), size)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size)
    return out, (x0, y0, new_w, new_h)


class ImageListIter(DataIter):
    """Iterator over (label, path) image lists with decode + resize
    (reference plugin/opencv/opencv.py ImageListIter)."""

    def __init__(self, root, flist, batch_size, size, mean=None):
        import os

        import numpy as onp
        super().__init__(batch_size)
        self.root = root
        self.list = list(flist)
        self.cur = 0
        self.batch_size = batch_size
        self.size = tuple(size)
        if mean is not None:
            self.mean = onp.array(mean, onp.float32)
        else:
            self.mean = None
        self.provide_data = [DataDesc(
            "data", (batch_size, self.size[1], self.size[0], 3))]
        self.provide_label = [DataDesc("label", (batch_size,))]
        self._os = os

    def reset(self):
        self.cur = 0

    def next(self):
        import numpy as onp
        if self.cur + self.batch_size > len(self.list):
            raise StopIteration
        imgs, labels = [], []
        for line in self.list[self.cur:self.cur + self.batch_size]:
            label, fname = line.split("\t")[:2]
            with open(self._os.path.join(self.root, fname.strip()),
                      "rb") as f:
                img = imdecode(f.read())
            img = resize(img, self.size)
            arr = img.asnumpy().astype(onp.float32)
            if self.mean is not None:
                arr -= self.mean
            imgs.append(arr)
            labels.append(float(label))
        self.cur += self.batch_size
        return DataBatch([nd.array(onp.stack(imgs), ctx=cpu())],
                         [nd.array(onp.array(labels, onp.float32),
                                   ctx=cpu())])
