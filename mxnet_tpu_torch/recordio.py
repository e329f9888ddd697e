"""RecordIO file format (PyTorch port's copy of ``mxnet_tpu/recordio.py``;
host code only, numpy).

Binary-compatible with the reference and with the JAX package: records
framed by the dmlc magic ``0xced7230a`` + masked-length word, payload
padded to 4 bytes; image records use IRHeader (flag, label, id, id2)
packed little-endian. A file written by either package reads back byte
for byte in the other. The random-access mmap reader is
``io_runtime.RecordFile``.
"""
from __future__ import annotations

import collections
import io as _pyio
import os
import struct

import numpy as onp

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "unpack_img", "pack_img"]

_MAGIC = 0xced7230a
_LMASK = 0x1fffffff


class MXRecordIO(object):
    """Sequential RecordIO reader/writer (``flag`` "r" or "w")."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def __del__(self):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def _need(self, writable):
        if self.writable != writable:
            raise ValueError("%s is open for %s" % (
                self.uri, "writing" if self.writable else "reading"))

    def write(self, buf):
        self._need(True)
        self.handle.write(struct.pack("<II", _MAGIC, len(buf) & _LMASK))
        self.handle.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        """The next record's payload, or None at the end of the file."""
        self._need(False)
        head = self.handle.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise ValueError("Invalid RecordIO magic in %s" % self.uri)
        length = lrec & _LMASK
        buf = self.handle.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        return buf

    def tell(self):
        return self.handle.tell()


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a ``.idx`` sidecar (key<TAB>offset per line) for
    random access."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        self._need(False)
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.keys.append(key)
        self.idx[key] = pos


IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an IRHeader + payload into one record string. A scalar label
    rides the header (``flag`` 0); a vector label follows it as float32
    with ``flag`` its length."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        header = header._replace(flag=0)
        packed = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                             header.id2)
    else:
        label = onp.asarray(header.label, dtype=onp.float32)
        packed = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                             header.id2) + label.tobytes()
    return packed + s


def unpack(s):
    """Unpack a record into (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = onp.frombuffer(s[:header.flag * 4], dtype=onp.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """Unpack an image record to (IRHeader, ndarray): cv2 decodes when it
    can be imported, else the payload is read as the raw ``.npy`` that
    ``pack_img``'s last fallback writes."""
    header, s = unpack(s)
    try:
        import cv2
        img = cv2.imdecode(onp.frombuffer(s, dtype=onp.uint8), iscolor)
    except ImportError:
        img = onp.load(_pyio.BytesIO(bytes(s)), allow_pickle=False)
    return header, img


def _pack_npy(header, img):
    bio = _pyio.BytesIO()
    onp.save(bio, onp.asarray(img), allow_pickle=False)
    return pack(header, bio.getvalue())


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image into a record: encoded by cv2, else PIL, else as raw
    ``.npy`` bytes. ``img_fmt=".npy"`` forces the raw payload (no decode
    at read time; what a host whose image decode cannot keep up with the
    card, or one without cv2 and PIL, packs)."""
    if img_fmt == ".npy":
        return _pack_npy(header, img)
    try:
        import cv2
        encode_params = None
        if img_fmt in (".jpg", ".jpeg"):
            encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        elif img_fmt == ".png":
            # PNG takes a 0-9 compression level, not JPEG's 0-100 quality
            encode_params = [cv2.IMWRITE_PNG_COMPRESSION, min(quality, 9)]
        ret, buf = cv2.imencode(img_fmt, img, encode_params)
        if not ret:
            raise ValueError("cv2 failed to encode the image as %s"
                             % img_fmt)
        return pack(header, buf.tobytes())
    except ImportError:
        pass
    try:
        from PIL import Image
        fmt = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG"}.get(
            img_fmt.lstrip("."), None)
        if fmt is not None:
            bio = _pyio.BytesIO()
            Image.fromarray(onp.asarray(img)).save(bio, format=fmt,
                                                   quality=quality)
            return pack(header, bio.getvalue())
    except ImportError:
        pass
    return _pack_npy(header, img)
