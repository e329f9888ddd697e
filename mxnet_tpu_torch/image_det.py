"""Detection data pipeline: box-aware augmentation + RecordIO iterator.

PyTorch port's counterpart of ``mxnet_tpu/image_det.py``, host numpy
code like it, drawing the same numbers in the same order from the same
seed, so that one pack gives the same batches in both packages.

Reference counterparts:
- ``src/io/image_det_aug_default.cc`` (DefaultImageDetAugmenter +
  ImageDetLabel): random crop samplers with IOU/coverage constraints,
  box-projecting pad, coordinate-flipping mirror, force/shrink/fit resize.
- ``src/io/iter_image_det_recordio.cc`` (ImageDetRecordIter): recordio
  parsing of variable-length detection labels + batching with -1 padding.

Decode and augmentation geometry run on the host; the batch comes out
as CPU NDArrays, and the bound module moves it to its device.

Label wire format (image_det_aug_default.cc:238-261)::

    [header_width, object_width, (extra header...),
     id, xmin, ymin, xmax, ymax, (extra...),   # object 0
     id, xmin, ymin, xmax, ymax, (extra...),   # object 1 ...]

Coordinates are normalized to [0, 1] relative to the image.
"""
from __future__ import annotations

import random

import numpy as onp

from . import runtime
from . import recordio
from .io import DataBatch, DataDesc, DataIter
from .image import _host_nd, _resize, imdecode

__all__ = ["DetLabel", "DetAugmenter", "ImageDetRecordIter"]


class DetLabel(object):
    """Structured view of a raw detection label vector (ImageDetLabel,
    image_det_aug_default.cc:194). Objects are an (N, object_width) float
    array with columns [id, xmin, ymin, xmax, ymax, extra...]."""

    def __init__(self, raw):
        raw = onp.asarray(raw, dtype=onp.float32).ravel()
        if raw.size < 7:
            raise ValueError("detection label needs >= 7 floats "
                             "(2 header + 5 per object), got %d" % raw.size)
        header_width = int(raw[0])
        self.object_width = int(raw[1])
        if header_width < 2 or self.object_width < 5:
            raise ValueError("invalid detection label header (%d, %d)"
                             % (header_width, self.object_width))
        body = raw[header_width:]
        if body.size % self.object_width:
            raise ValueError("label body %d not divisible by object width "
                             "%d" % (body.size, self.object_width))
        self.header = raw[:header_width].copy()
        self.objects = body.reshape(-1, self.object_width).copy()

    def to_array(self):
        return onp.concatenate([self.header, self.objects.ravel()])

    # ------------------------------------------------------------ geometry
    def project(self, box):
        """Re-express all boxes relative to region ``box`` = (x, y, w, h),
        clipping to [0, 1] (ImageDetObject::Project)."""
        x, y, w, h = box
        o = self.objects
        o[:, 1] = onp.maximum(0.0, (o[:, 1] - x) / w)
        o[:, 2] = onp.maximum(0.0, (o[:, 2] - y) / h)
        o[:, 3] = onp.minimum(1.0, (o[:, 3] - x) / w)
        o[:, 4] = onp.minimum(1.0, (o[:, 4] - y) / h)

    def mirror(self):
        """Flip x-coordinates (ImageDetObject::HorizontalFlip)."""
        o = self.objects
        left = 1.0 - o[:, 3].copy()
        o[:, 3] = 1.0 - o[:, 1]
        o[:, 1] = left

    def _ious(self, box):
        x, y, w, h = box
        o = self.objects
        ix = onp.maximum(0.0, onp.minimum(o[:, 3], x + w)
                         - onp.maximum(o[:, 1], x))
        iy = onp.maximum(0.0, onp.minimum(o[:, 4], y + h)
                         - onp.maximum(o[:, 2], y))
        inter = ix * iy
        area_o = (o[:, 3] - o[:, 1]) * (o[:, 4] - o[:, 2])
        return inter, area_o

    def try_crop(self, box, min_overlap=0.0, max_overlap=1.0,
                 min_sample_coverage=0.0, max_sample_coverage=1.0,
                 min_object_coverage=0.0, max_object_coverage=1.0,
                 emit_mode="center", emit_overlap_thresh=0.3):
        """Validate crop ``box`` against the constraint set; on success,
        drop boxes outside the crop (per ``emit_mode``) and project the
        rest. Returns False (unmodified) if constraints fail or no box
        survives (ImageDetLabel::TryCrop)."""
        if len(self.objects) == 0:
            return True
        x, y, w, h = box
        inter, area_o = self._ious(box)
        area_c = w * h
        iou = inter / (area_c + area_o - inter + 1e-12)
        cov_sample = inter / (area_c + 1e-12)
        cov_object = inter / (area_o + 1e-12)
        constrained = (min_overlap > 0.0 or max_overlap < 1.0
                       or min_sample_coverage > 0.0
                       or max_sample_coverage < 1.0
                       or min_object_coverage > 0.0
                       or max_object_coverage < 1.0)
        if constrained:
            ok = onp.ones(len(self.objects), dtype=bool)
            if min_overlap > 0.0 or max_overlap < 1.0:
                ok &= (iou >= min_overlap) & (iou <= max_overlap)
            if min_sample_coverage > 0.0 or max_sample_coverage < 1.0:
                ok &= ((cov_sample >= min_sample_coverage)
                       & (cov_sample <= max_sample_coverage))
            if min_object_coverage > 0.0 or max_object_coverage < 1.0:
                ok &= ((cov_object >= min_object_coverage)
                       & (cov_object <= max_object_coverage))
            if not ok.any():
                return False
        # emit: which boxes stay in the cropped sample
        if emit_mode == "center":
            cx = (self.objects[:, 1] + self.objects[:, 3]) * 0.5
            cy = (self.objects[:, 2] + self.objects[:, 4]) * 0.5
            keep = ((cx >= x) & (cx <= x + w) & (cy >= y) & (cy <= y + h))
        elif emit_mode == "overlap":
            keep = cov_object > emit_overlap_thresh
        else:
            raise ValueError("unknown crop_emit_mode %r" % emit_mode)
        if not keep.any():
            return False
        self.objects = self.objects[keep]
        self.project(box)
        return True

    def try_pad(self, box):
        """Project boxes into the enlarged canvas ``box`` (TryPad)."""
        self.project(box)
        return True


class DetAugmenter(object):
    """Box-aware augmentation chain (DefaultImageDetAugmenter,
    image_det_aug_default.cc:383-660). Applies, in reference order:
    color jitter -> mirror -> pad -> crop samplers -> resize mode."""

    def __init__(self, data_shape,
                 resize=-1,
                 rand_crop_prob=0.0, num_crop_sampler=1,
                 min_crop_scales=(0.0,), max_crop_scales=(1.0,),
                 min_crop_aspect_ratios=(1.0,), max_crop_aspect_ratios=(1.0,),
                 min_crop_overlaps=(0.0,), max_crop_overlaps=(1.0,),
                 min_crop_sample_coverages=(0.0,),
                 max_crop_sample_coverages=(1.0,),
                 min_crop_object_coverages=(0.0,),
                 max_crop_object_coverages=(1.0,),
                 max_crop_trials=(25,),
                 crop_emit_mode="center", emit_overlap_thresh=0.3,
                 rand_pad_prob=0.0, max_pad_scale=1.0, fill_value=127,
                 rand_mirror_prob=0.0,
                 random_brightness_prob=0.0, max_random_brightness=0.0,
                 random_contrast_prob=0.0, max_random_contrast=0.0,
                 resize_mode="force", seed=0):
        def per_sampler(v):
            v = list(v) if isinstance(v, (list, tuple)) else [v]
            if num_crop_sampler > 1 and len(v) == 1:
                v = v * num_crop_sampler
            if len(v) != num_crop_sampler:
                raise ValueError("# of parameters/crop_samplers mismatch")
            return v

        self.data_shape = tuple(data_shape)
        self.resize = resize
        self.rand_crop_prob = rand_crop_prob
        self.num_crop_sampler = num_crop_sampler
        self.min_crop_scales = per_sampler(min_crop_scales)
        self.max_crop_scales = per_sampler(max_crop_scales)
        self.min_crop_aspect_ratios = per_sampler(min_crop_aspect_ratios)
        self.max_crop_aspect_ratios = per_sampler(max_crop_aspect_ratios)
        self.min_crop_overlaps = per_sampler(min_crop_overlaps)
        self.max_crop_overlaps = per_sampler(max_crop_overlaps)
        self.min_crop_sample_coverages = per_sampler(
            min_crop_sample_coverages)
        self.max_crop_sample_coverages = per_sampler(
            max_crop_sample_coverages)
        self.min_crop_object_coverages = per_sampler(
            min_crop_object_coverages)
        self.max_crop_object_coverages = per_sampler(
            max_crop_object_coverages)
        self.max_crop_trials = per_sampler(max_crop_trials)
        self.crop_emit_mode = crop_emit_mode
        self.emit_overlap_thresh = emit_overlap_thresh
        self.rand_pad_prob = rand_pad_prob
        self.max_pad_scale = max_pad_scale
        self.fill_value = fill_value
        self.rand_mirror_prob = rand_mirror_prob
        self.random_brightness_prob = random_brightness_prob
        self.max_random_brightness = max_random_brightness
        self.random_contrast_prob = random_contrast_prob
        self.max_random_contrast = max_random_contrast
        self.resize_mode = resize_mode
        self.rng = random.Random(seed)

    # ------------------------------------------------------------- pieces
    def _generate_crop_box(self, idx, img_aspect, r=None):
        """GenerateCropBox (image_det_aug_default.cc:459)."""
        r = r if r is not None else self.rng
        scale = r.uniform(self.min_crop_scales[idx],
                         self.max_crop_scales[idx]) + 1e-12
        min_ratio = max(self.min_crop_aspect_ratios[idx] / img_aspect,
                        scale * scale)
        max_ratio = min(self.max_crop_aspect_ratios[idx] / img_aspect,
                        1.0 / (scale * scale))
        if min_ratio > max_ratio:
            return None
        ratio = (r.uniform(min_ratio, max_ratio)) ** 0.5
        w = min(1.0, scale * ratio)
        h = min(1.0, scale / ratio)
        x0 = r.uniform(0.0, 1.0 - w)
        y0 = r.uniform(0.0, 1.0 - h)
        return (x0, y0, w, h)

    def _generate_pad_box(self, threshold=1.05, r=None):
        """GeneratePadBox (image_det_aug_default.cc:479)."""
        r = r if r is not None else self.rng
        scale = r.uniform(1.0, self.max_pad_scale)
        if scale < threshold:
            return None
        x0 = r.uniform(0.0, scale - 1.0)
        y0 = r.uniform(0.0, scale - 1.0)
        return (-x0, -y0, scale, scale)

    # -------------------------------------------------------------- apply
    def __call__(self, img, label, rng=None):
        """img: HWC uint8; label: DetLabel (modified in place). Returns the
        augmented image (reference Process, same op order). ``rng`` lets
        callers pass a per-sample engine (the reference keeps per-thread
        prnds_[tid]) so threaded decode stays deterministic."""
        r = rng if rng is not None else self.rng
        if self.resize > 0:
            h, w = img.shape[:2]
            if h > w:
                img = _resize(img, self.resize, self.resize * h // w)
            else:
                img = _resize(img, self.resize * w // h, self.resize)

        # color jitter (boxes unaffected)
        if (self.random_brightness_prob > 0
                and r.random() < self.random_brightness_prob):
            delta = r.uniform(-1, 1) * self.max_random_brightness
            img = onp.clip(img.astype(onp.float32) + delta, 0,
                           255).astype(onp.uint8)
        if (self.random_contrast_prob > 0
                and r.random() < self.random_contrast_prob):
            c = r.uniform(-1, 1) * self.max_random_contrast
            img = onp.clip(img.astype(onp.float32) * (1.0 + c), 0,
                           255).astype(onp.uint8)

        # mirror
        if (self.rand_mirror_prob > 0
                and r.random() < self.rand_mirror_prob):
            label.mirror()
            img = img[:, ::-1]

        # pad out to a larger canvas, boxes projected into it
        if self.rand_pad_prob > 0 and self.max_pad_scale > 1.0:
            if r.random() < self.rand_pad_prob:
                box = self._generate_pad_box(r=r)
                if box is not None:
                    label.try_pad(box)
                    x, y, s = box[0], box[1], box[2]
                    h, w = img.shape[:2]
                    canvas = onp.full((int(s * h), int(s * w), img.shape[2]),
                                      self.fill_value, dtype=img.dtype)
                    top, left = int(-y * h), int(-x * w)
                    canvas[top:top + h, left:left + w] = img
                    img = canvas

        # constrained random crop: shuffle samplers, first success wins
        if self.rand_crop_prob > 0 and self.num_crop_sampler > 0:
            if r.random() < self.rand_crop_prob:
                order = list(range(self.num_crop_sampler))
                r.shuffle(order)
                done = False
                for idx in order:
                    if done:
                        break
                    for _ in range(self.max_crop_trials[idx]):
                        h, w = img.shape[:2]
                        box = self._generate_crop_box(idx, w / h, r=r)
                        if box is None:
                            continue
                        x, y, bw, bh = box
                        # reject degenerate sub-pixel crops before the
                        # label commit: the final resize can't handle a
                        # 0-sized slice
                        y0, y1 = int(y * h), int((y + bh) * h)
                        x0, x1 = int(x * w), int((x + bw) * w)
                        if y1 - y0 < 1 or x1 - x0 < 1:
                            continue
                        if label.try_crop(
                                box, self.min_crop_overlaps[idx],
                                self.max_crop_overlaps[idx],
                                self.min_crop_sample_coverages[idx],
                                self.max_crop_sample_coverages[idx],
                                self.min_crop_object_coverages[idx],
                                self.max_crop_object_coverages[idx],
                                self.crop_emit_mode,
                                self.emit_overlap_thresh):
                            img = img[y0:y1, x0:x1]
                            done = True
                            break

        # final resize to data_shape
        _, th, tw = self.data_shape
        h, w = img.shape[:2]
        if self.resize_mode == "force":
            img = _resize(img, tw, th)
        elif self.resize_mode in ("shrink", "fit"):
            if self.resize_mode == "fit" or h > th or w > tw:
                ratio = min(th / h, tw / w)
                img = _resize(img, max(1, int(w * ratio)),
                              max(1, int(h * ratio)))
            # place into the fixed canvas and project boxes into it
            h, w = img.shape[:2]
            canvas = onp.full((th, tw, img.shape[2]), self.fill_value,
                              dtype=img.dtype)
            canvas[:h, :w] = img
            label.project((0.0, 0.0, tw / w, th / h))
            img = canvas
        else:
            raise ValueError("unknown resize_mode %r" % self.resize_mode)
        return img


class ImageDetRecordIter(DataIter):
    """RecordIO detection iterator (iter_image_det_recordio.cc:563).

    Emits data (B, C, H, W) float32 and label (B, max_objects,
    object_width): each row [id, xmin, ymin, xmax, ymax, extra...], rows
    padded with -1 (the reference's BatchLoader pads the flattened vector
    the same way; MultiBoxTarget treats id<0 as padding).
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_pad_width=0, shuffle=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 round_batch=True, data_name="data", label_name="label",
                 preprocess_threads=4, seed=0, **aug_kwargs):
        from concurrent.futures import ThreadPoolExecutor

        super().__init__(batch_size)
        # mmap'd indexed reads + threaded decode, same machinery as
        # ImageRecordIter (the reference's parser/prefetcher split)
        self.rec = runtime.RecordFile(path_imgrec)
        self.pool = ThreadPoolExecutor(max_workers=preprocess_threads,
                                       thread_name_prefix="imagedet-decode")
        self.data_shape = tuple(data_shape)
        self.shuffle = shuffle
        self.round_batch = round_batch
        self.mean = onp.array([mean_r, mean_g, mean_b], onp.float32)
        self.std = onp.array([std_r, std_g, std_b], onp.float32)
        self.scale = scale
        self.rng = random.Random(seed)
        self._base_seed = seed
        self._epoch = -1  # reset() below brings it to 0
        self.aug = DetAugmenter(data_shape, seed=seed, **aug_kwargs)

        # scan for max label width (iter_image_det_recordio.cc:270
        # max_label_width pass) unless caller fixed label_pad_width
        self.object_width = None
        max_obj = 1
        for i in range(len(self.rec)):
            header, _ = recordio.unpack(self.rec.read(i))
            lab = DetLabel(onp.asarray(header.label))
            if self.object_width is None:
                self.object_width = lab.object_width
            elif self.object_width != lab.object_width:
                raise ValueError("inconsistent object widths in recordio")
            max_obj = max(max_obj, len(lab.objects))
        if self.object_width is None:
            raise ValueError("empty detection recordio %s" % path_imgrec)
        if label_pad_width:
            padded_obj = (label_pad_width // self.object_width)
            if padded_obj < max_obj:
                raise ValueError(
                    "label_pad_width %d too small for %d objects of width "
                    "%d" % (label_pad_width, max_obj, self.object_width))
            max_obj = padded_obj
        self.max_objects = max_obj

        self.seq = list(range(len(self.rec)))
        self.cur = 0
        self.data_name = data_name
        self.label_name = label_name
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(
            label_name, (batch_size, self.max_objects, self.object_width))]
        self.reset()

    def reset(self):
        if self.shuffle:
            self.rng.shuffle(self.seq)
        self.cur = 0
        self._epoch += 1

    def _load_one(self, idx):
        header, payload = recordio.unpack(self.rec.read(idx))
        if payload[:6] == b"\x93NUMPY":
            # raw-npy fallback payload written by pack_img without cv2
            import io as _io
            img = onp.load(_io.BytesIO(bytes(payload)), allow_pickle=False)
        else:
            img = imdecode(payload)  # RGB
        if img.ndim == 2:
            img = onp.stack([img] * 3, axis=-1)
        label = DetLabel(onp.asarray(header.label))
        # per-sample engine keyed on (iterator seed, sample, epoch):
        # deterministic regardless of decode-thread scheduling (the
        # reference keeps per-thread prnds_[tid])
        rng = random.Random(hash((self._base_seed, idx, self._epoch)))
        img = self.aug(img, label, rng=rng)
        out = onp.full((self.max_objects, self.object_width), -1.0,
                       onp.float32)
        n = min(len(label.objects), self.max_objects)
        out[:n] = label.objects[:n]
        return img, out

    def next(self):
        if self.cur >= len(self.seq):
            raise StopIteration
        idxs = self.seq[self.cur:self.cur + self.batch_size]
        self.cur += self.batch_size
        pad = self.batch_size - len(idxs)
        if pad > 0:
            # the batch is ALWAYS full-size (provide_data contract); pad
            # says how many tail entries are filler. round_batch wraps to
            # the head (reference BatchLoader round_batch_), otherwise the
            # last real sample repeats.
            idxs = idxs + (self.seq[:pad] if self.round_batch
                           else [idxs[-1]] * pad)
        samples = list(self.pool.map(self._load_one, idxs))
        imgs = onp.stack([s[0] for s in samples]).astype(onp.float32)
        imgs = (imgs - self.mean) / (self.std / self.scale)
        data = imgs.transpose(0, 3, 1, 2)
        labels = onp.stack([s[1] for s in samples])
        return DataBatch([_host_nd(data)], [_host_nd(labels)], pad=pad,
                         index=onp.asarray(idxs, dtype=onp.int64))

    def close(self):
        """Stop the decode threads and close the record file."""
        self.pool.shutdown(wait=True)
        self.rec.close()
