"""Image decode helper backing mx.nd.imdecode (src/io/image_io.cc:304).

PyTorch port's counterpart of ``mxnet_tpu/io_util.py``.
"""
from __future__ import annotations

import io as _pyio

import numpy as onp

from .ndarray import array


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0,
             channels=3, mean=None):
    """Decode an encoded image byte string to a float32 NDArray (HWC, BGR
    like the reference's OpenCV path), on the current context. Uses cv2
    when present, else PIL, else raises. With ``out`` the result is
    copied into it and ``out`` returned; ``mean`` is subtracted when
    given."""
    buf = onp.frombuffer(bytes(str_img), dtype=onp.uint8)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(buf, 1 if channels == 3 else 0)
    else:
        try:
            from PIL import Image
        except ImportError:
            raise ImportError("imdecode requires cv2 or PIL")
        img = onp.asarray(Image.open(_pyio.BytesIO(bytes(str_img))))
        if channels == 3 and img.ndim == 3:
            img = img[:, :, ::-1]  # RGB -> BGR to match OpenCV
    if img is None:
        raise ValueError("cannot decode image")
    if mean is not None:
        img = img.astype(onp.float32) - mean
    res = array(img.astype(onp.float32))
    if out is not None:
        res.copyto(out)
        return out
    return res
