"""DeviceAugment — crop, mirror and normalize of uint8 wire batches on the
card (PyTorch counterpart of ``mxnet_tpu/data/augment.py``).

* The iterator delivers **uint8 NHWC** wire batches (4x fewer bytes over
  PCIe than float32 NCHW) plus tiny per-batch augment-parameter arrays
  (crop offsets, mirror flags).
* The bound ``MeshExecutorGroup`` runs pad -> per-row crop -> mirror ->
  u8 -> i32 -> f32 -> normalize -> NHWC->NCHW as its own call at staging
  time (``_apply_device_augment``), never inside the step function, so
  the step computes on exactly the float32 batch a host-augmented feed
  would give it.
* Randomness is drawn on the host from ``(seed, epoch, batch_index)``
  with TransformIter's SplitMix fold: the stream is bitwise identical at
  any worker count, replays across ``reset()``/resume (``set_epoch``
  pins the epoch), and equals the JAX package's draws bit for bit (both
  are numpy ``RandomState`` streams from the same seeds).
* :meth:`DeviceAugment.apply_host` is the numpy reference, equal to
  :meth:`DeviceAugment.apply` bit for bit: the mirror moves bytes, the
  casts are exact, and the normalize is two separately rounded float32
  operations, ``(x - mean)`` then ``* norm``, with ``norm`` computed once
  on the host. They stay two tensor operations (no fused multiply-add),
  so the card rounds as numpy does.

Eval (``train=False``) always takes the deterministic center crop with no
mirror.
"""
from __future__ import annotations

import os

import numpy as onp
import torch

from ..base import MXNetError
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["DeviceAugment", "DeviceAugmentIter", "fold_seed",
           "crop_input_name", "mirror_input_name"]


def fold_seed(seed, epoch, index):
    """SplitMix-style fold of ``(seed, epoch, index)``: adjacent batches
    land on unrelated streams and the value is a pure function of the
    stream position, never of worker identity or wall time."""
    x = (int(seed) * 0x9e3779b97f4a7c15
         + int(epoch) * 0xbf58476d1ce4e5b9
         + int(index) * 0x94d049bb133111eb) & 0xffffffffffffffff
    x ^= x >> 31
    return x & 0x7fffffff


def crop_input_name(name):
    """Input name of a data input's per-row crop offsets."""
    return name + ".aug_crop"


def mirror_input_name(name):
    """Input name of a data input's per-row mirror flags."""
    return name + ".aug_mirror"


def _placement_default():
    return "host" if os.environ.get(
        "MXNET_DATA_DEVICE_AUGMENT", "1") == "0" else "device"


def unwrap(arr):
    """The raw value of a batch entry (an NDArray's tensor, else as is)."""
    return arr._read() if hasattr(arr, "_read") else arr


def as_host(arr):
    """A batch entry as a numpy array (a tensor on the card is read back)."""
    v = unwrap(arr)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return onp.asarray(v)


class DeviceAugment(object):
    """Declarative augment spec applied to uint8 wire batches.

    Parameters
    ----------
    shape : tuple
        Model-view ``(C, H, W)``: what the symbol's data input consumes.
    rand_crop : bool
        Random-crop an ``(H, W)`` window from the (padded) wire image
        during training. Eval always center-crops.
    rand_mirror : bool
        Random horizontal flip (p=0.5) during training.
    pad : int
        Zero-pad ``pad`` pixels on every spatial edge before cropping
        (the CIFAR pad-and-crop recipe: wire 32x32, pad 4, crop 32).
    mean, std : float or sequence
        Per-channel normalize: ``out = (x - mean) * (scale / std)`` with
        the factor computed once in float32 on the host, so the card and
        the numpy reference multiply by the same operand.
    scale : float
        ``ImageRecordIter(scale=)`` semantics; ``scale=1/255`` with mean 0
        and std 1 gives a plain ``x / 255`` feed.
    in_shape : tuple, optional
        Wire spatial size ``(H_in, W_in)`` (default ``(H, W)``); with
        ``H_in > H`` the crop window is ``H_in + 2*pad - H`` pixels.
    seed : int
        Root of the per-batch parameter draws.
    """

    def __init__(self, shape, rand_crop=False, rand_mirror=False, pad=0,
                 mean=0.0, std=1.0, scale=1.0, in_shape=None, seed=0):
        c, h, w = (int(s) for s in shape)
        self.shape = (c, h, w)
        self.pad = int(pad)
        if self.pad < 0:
            raise MXNetError("pad must be >= 0 (got %d)" % self.pad)
        hin, win = (int(s) for s in (in_shape or (h, w)))
        self.in_shape = (hin, win)
        self._window = (hin + 2 * self.pad - h, win + 2 * self.pad - w)
        if self._window[0] < 0 or self._window[1] < 0:
            raise MXNetError(
                "crop target %r larger than padded wire image %r"
                % ((h, w), (hin + 2 * self.pad, win + 2 * self.pad)))
        self.rand_crop = bool(rand_crop)
        self.rand_mirror = bool(rand_mirror)
        self.mean = onp.broadcast_to(
            onp.asarray(mean, onp.float32), (c,)).copy()
        self.std = onp.broadcast_to(
            onp.asarray(std, onp.float32), (c,)).copy()
        self.scale = float(scale)
        self._norm = (onp.float32(self.scale) / self.std) \
            .astype(onp.float32)
        self.seed = int(seed)
        self._consts = {}

    # -- shapes ---------------------------------------------------------
    @property
    def wire_shape(self):
        """Per-image wire layout: ``(H_in, W_in, C)`` uint8 HWC."""
        return self.in_shape + (self.shape[0],)

    def model_shape(self, batch_size):
        """What the symbol sees: ``(B, C, H, W)`` float32 NCHW."""
        return (int(batch_size),) + self.shape

    @property
    def has_rand_crop(self):
        """Random crop only matters when there is crop freedom."""
        return self.rand_crop and (self._window[0] > 0
                                   or self._window[1] > 0)

    def data_descs(self, name, batch_size):
        """provide_data entries of a wire batch of this spec: the u8 image
        block first, then the augment-parameter inputs."""
        b = int(batch_size)
        descs = [DataDesc(name, (b,) + self.wire_shape,
                          dtype=onp.uint8, layout="NHWC")]
        descs.extend(self.param_descs(name, b))
        return descs

    def param_descs(self, name, batch_size):
        b = int(batch_size)
        descs = []
        if self.has_rand_crop:
            descs.append(DataDesc(crop_input_name(name), (b, 2),
                                  dtype=onp.int32, layout=None))
        if self.rand_mirror:
            descs.append(DataDesc(mirror_input_name(name), (b,),
                                  dtype=onp.uint8, layout=None))
        return descs

    # -- deterministic parameter draws ---------------------------------
    def draw(self, name, epoch, index, batch_size):
        """Per-batch augment parameters as ``{input name: host array}``,
        a pure function of ``(seed, epoch, index)``. The draw order is
        part of the contract: crop rows, crop cols, then mirror flags,
        always from one ``RandomState``."""
        rng = onp.random.RandomState(fold_seed(self.seed, epoch, index))
        b = int(batch_size)
        out = {}
        if self.has_rand_crop:
            wy, wx = self._window
            oy = rng.randint(0, wy + 1, size=b)
            ox = rng.randint(0, wx + 1, size=b)
            out[crop_input_name(name)] = onp.stack(
                [oy, ox], axis=1).astype(onp.int32)
        if self.rand_mirror:
            out[mirror_input_name(name)] = (
                rng.random_sample(b) < 0.5).astype(onp.uint8)
        return out

    # -- on the card ----------------------------------------------------
    def is_model_view(self, x):
        """True when ``x`` is already the augmented float NCHW batch (a
        float iterator fed to an augment-bound module): it then passes
        through untouched."""
        return (x.dtype not in (onp.uint8, torch.uint8)
                and tuple(x.shape[1:]) == self.shape)

    def _device_consts(self, device):
        key = str(device)
        if key not in self._consts:
            self._consts[key] = (
                torch.from_numpy(self.mean).to(device),
                torch.from_numpy(self._norm).to(device))
        return self._consts[key]

    def apply(self, x, crop=None, mirror=None, train=True):
        """uint8 NHWC wire batch (a tensor, on the card or the CPU) ->
        normalized float32 NCHW on the same device. ``crop``/``mirror``
        are the per-row parameter tensors (ignored at eval: center crop,
        no mirror)."""
        if self.is_model_view(x):
            return x.float()
        c, h, w = self.shape
        b = x.shape[0]
        if self.pad:
            p = self.pad
            padded = x.new_zeros((b, x.shape[1] + 2 * p, x.shape[2] + 2 * p,
                                  x.shape[3]))
            padded[:, p:p + x.shape[1], p:p + x.shape[2]] = x
            x = padded
        wy, wx = self._window
        if wy or wx:
            if train and self.has_rand_crop and crop is not None:
                crop = crop.to(device=x.device, dtype=torch.long)
                rows = crop[:, 0:1] + torch.arange(h, device=x.device)
                cols = crop[:, 1:2] + torch.arange(w, device=x.device)
                bidx = torch.arange(b, device=x.device)[:, None, None]
                x = x[bidx, rows[:, :, None], cols[:, None, :]]
            else:
                cy, cx = wy // 2, wx // 2
                x = x[:, cy:cy + h, cx:cx + w, :]
        if train and self.rand_mirror and mirror is not None:
            # the mirror moves uint8 bytes, before any arithmetic
            flip = mirror.to(x.device) != 0
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
        mean, norm = self._device_consts(x.device)
        xf = x.to(torch.int32).to(torch.float32)
        # two operations, each rounded once, as numpy does below
        xf = torch.sub(xf, mean)
        xf = torch.mul(xf, norm)
        return xf.permute(0, 3, 1, 2).contiguous()

    # -- the host reference --------------------------------------------
    def apply_host(self, x, crop=None, mirror=None, train=True):
        """Numpy reference of :meth:`apply`: the same pad/crop/mirror
        geometry and the same float32 operand order."""
        x = as_host(x)
        if self.is_model_view(x):
            return x.astype(onp.float32, copy=False)
        c, h, w = self.shape
        if self.pad:
            p = self.pad
            x = onp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
        wy, wx = self._window
        if wy or wx:
            if train and self.has_rand_crop and crop is not None:
                rows = [img[oy:oy + h, ox:ox + w, :]
                        for img, (oy, ox) in zip(x, as_host(crop))]
                x = onp.stack(rows)
            else:
                cy, cx = wy // 2, wx // 2
                x = x[:, cy:cy + h, cx:cx + w, :]
        if train and self.rand_mirror and mirror is not None:
            flip = as_host(mirror).astype(bool)
            x = onp.where(flip[:, None, None, None], x[:, :, ::-1, :], x)
        xf = x.astype(onp.int32).astype(onp.float32)
        xf = (xf - self.mean) * self._norm
        return onp.ascontiguousarray(xf.transpose(0, 3, 1, 2))

    def __repr__(self):
        return ("DeviceAugment(shape=%r, in_shape=%r, pad=%d, "
                "rand_crop=%r, rand_mirror=%r, seed=%d)"
                % (self.shape, self.in_shape, self.pad, self.rand_crop,
                   self.rand_mirror, self.seed))


class DeviceAugmentIter(DataIter):
    """Attach a :class:`DeviceAugment` to a u8-HWC-emitting source.

    ``placement="device"`` (default): batches pass through as uint8 wire
    blocks plus the spec's per-batch parameter arrays, and the iterator
    exposes ``device_augment_spec`` so ``Module.fit`` binds the augment
    (u8 staged bytes, no host float work).

    ``placement="host"`` (or ``MXNET_DATA_DEVICE_AUGMENT=0``): the SAME
    draws are applied on the host through :meth:`DeviceAugment
    .apply_host` and float32 NCHW batches are delivered.

    Epoch coordinate: ``reset()`` advances it, ``set_epoch`` (called by
    ``fit`` with the true epoch index) pins it. ``train=False`` builds the
    eval variant: no draws, center crop in both placements.
    """

    def __init__(self, data_iter, augment, data_name=None,
                 placement=None, train=True):
        super().__init__(getattr(data_iter, "batch_size", 0))
        self._iter = data_iter
        self._augment = augment
        src = data_iter.provide_data
        self._name = data_name or src[0][0]
        if tuple(src[0][1][1:]) != augment.wire_shape:
            raise MXNetError(
                "source delivers %r per image but the augment spec "
                "expects wire shape %r (uint8 HWC)"
                % (tuple(src[0][1][1:]), augment.wire_shape))
        self.placement = placement or _placement_default()
        if self.placement not in ("device", "host"):
            raise MXNetError("placement must be 'device' or 'host' "
                             "(got %r)" % (self.placement,))
        self.augment_placement = self.placement
        self._train = bool(train)
        b = self.batch_size
        if self.placement == "device":
            self.provide_data = augment.data_descs(self._name, b) \
                if self._train else \
                [DataDesc(self._name, (b,) + augment.wire_shape,
                          dtype=onp.uint8, layout="NHWC")]
            self.device_augment_spec = {self._name: augment}
        else:
            self.provide_data = [DataDesc(self._name,
                                          augment.model_shape(b))]
            self.device_augment_spec = {}
        self.provide_label = data_iter.provide_label
        self._epoch = 0
        self._seq = 0

    @property
    def epoch_coord(self):
        return self._epoch

    def set_epoch(self, epoch):
        self._epoch = int(epoch)
        self._seq = 0

    def reset(self):
        self._iter.reset()
        self._epoch += 1
        self._seq = 0

    def next(self):
        batch = self._iter.next()
        aug = self._augment
        img = unwrap(batch.data[0])
        params = aug.draw(self._name, self._epoch, self._seq,
                          img.shape[0]) if self._train else {}
        self._seq += 1
        if self.placement == "device":
            data = [img] + [params[d.name] for d in
                            aug.param_descs(self._name, img.shape[0])
                            if d.name in params]
        else:
            data = [aug.apply_host(
                img, params.get(crop_input_name(self._name)),
                params.get(mirror_input_name(self._name)),
                train=self._train)]
        return DataBatch(data=data, label=batch.label, pad=batch.pad,
                         index=batch.index)

    def iter_next(self):
        try:
            self._current = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getpad(self):
        return self._current.pad

    def getindex(self):
        return self._current.index

    def close(self):
        inner = getattr(self._iter, "close", None)
        if callable(inner):
            inner()
