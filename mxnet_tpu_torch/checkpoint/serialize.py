"""Durable array serialization for the checkpoint manager (PyTorch
counterpart of ``mxnet_tpu/checkpoint/serialize.py``, one device).

* **atomic file writes**: write a ``.tmp`` sibling, ``fsync``,
  ``os.replace``, then ``fsync`` the directory so the rename is durable.
  A crash at any point leaves the old file or a stray ``.tmp`` that
  readers ignore.
* **host snapshots**: :func:`snapshot` copies an NDArray, tensor or
  numpy array to a fresh host numpy array (one full shard), synchronously:
  the caller may mutate the original in place as soon as it returns.
* **self-describing array files**: one ``.npy`` per array plus its
  crc32/shape/dtype in the manifest, verified on read.

The layout (``FORMAT``, the manifest's keys, the file names, ``rng.npz``)
is the JAX package's, so each package restores the other's entries.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import zlib

import numpy as onp
import torch

from ..base import MXNetError

FORMAT = "mxnet_tpu.checkpoint/v1"

__all__ = ["FORMAT", "fsync_dir", "atomic_write_stream",
           "atomic_write_bytes", "write_bytes", "write_array",
           "read_array", "snapshot", "assemble", "write_json",
           "read_json", "dump_rng", "load_rng", "params_digest"]


def _dtype_name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return onp.dtype(dtype).name


def params_digest(symbol_json, arrays):
    """Structural identity of a (symbol, parameter set) pair: sha256
    over the symbol JSON plus every array's canonical
    ``name|shape|dtype`` line, sorted by name. Parameter VALUES do not
    enter it: two checkpoints of one architecture share a digest, and
    any drift in layer widths, parameter set or dtype changes it.

    ``arrays`` maps name -> anything with ``shape``/``dtype`` (NDArray,
    tensor, numpy). Scalars hash as shape ``()``.
    """
    h = hashlib.sha256()
    h.update(str(symbol_json).encode("utf-8"))
    for name in sorted(arrays):
        v = arrays[name]
        shape = tuple(getattr(v, "shape", ()))
        dtype = _dtype_name(getattr(v, "dtype", onp.float32))
        h.update(("\n%s|%s|%s" % (name, shape, dtype)).encode("utf-8"))
    return h.hexdigest()


def fsync_dir(path):
    """fsync a directory so a rename/create inside it is durable.
    Best-effort: some filesystems reject directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_bytes(path, payload):
    """Write + fsync ``payload`` at ``path`` (no atomicity by itself:
    used inside a staged entry whose rename is the commit). Returns the
    payload's crc32."""
    with open(path, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    return zlib.crc32(payload) & 0xFFFFFFFF


def atomic_write_stream(fname, write_cb):
    """Crash-safe single-file write: ``write_cb(fileobj)`` streams into
    a ``.tmp`` sibling, which is fsynced and renamed over ``fname``."""
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        write_cb(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fname)
    fsync_dir(os.path.dirname(os.path.abspath(fname)) or ".")


def atomic_write_bytes(fname, payload):
    """Crash-safe single-file write of an in-memory payload."""
    atomic_write_stream(fname, lambda f: f.write(payload))


def write_json(path, obj):
    return write_bytes(path, json.dumps(obj, indent=1,
                                        sort_keys=True).encode("utf-8"))


def read_json(path):
    with open(path, "rb") as f:
        return json.loads(f.read().decode("utf-8"))


def write_array(path, arr):
    """Write one array as .npy (+fsync); returns its manifest entry."""
    arr = onp.ascontiguousarray(arr)
    crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
    with open(path, "wb") as f:
        onp.save(f, arr, allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())
    return {"shape": list(arr.shape), "dtype": onp.dtype(arr.dtype).name,
            "crc32": crc}


def read_array(path, meta):
    """Load one array, verifying shape/dtype/crc32 against its manifest
    entry: a truncated or bit-flipped file fails here, loudly."""
    with open(path, "rb") as f:
        arr = onp.load(f, allow_pickle=False)
    if list(arr.shape) != list(meta["shape"]) or \
            onp.dtype(arr.dtype).name != meta["dtype"]:
        raise MXNetError(
            "checkpoint shard %s does not match its manifest: "
            "got %s/%s, manifest says %s/%s"
            % (path, arr.shape, arr.dtype, meta["shape"], meta["dtype"]))
    crc = zlib.crc32(onp.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
    if crc != meta["crc32"]:
        raise MXNetError("checkpoint shard %s failed its crc32 check "
                         "(corrupt or truncated write)" % path)
    return arr


def snapshot(value):
    """A host copy of a checkpointable value as ``[(None, ndarray)]``
    (one full shard). A tensor on the card is copied with a blocking
    ``.cpu()``, so the snapshot holds the value at the time of the call
    whatever the card runs next; a host value is copied too, since the
    caller's buffer may be reused."""
    if hasattr(value, "_read"):              # NDArray (possibly a view)
        value = value._read()
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            # no precision mode writes one: parameters and aux stay
            # float32 masters, and bfloat16 optimizer state travels in the
            # optimizer payload as uint16 words (Updater.get_states)
            raise MXNetError("a bfloat16 array is not a checkpoint array: "
                             "parameters and aux are float32 in every "
                             "precision mode")
        return [(None, value.detach().cpu().numpy().copy())]
    return [(None, onp.array(value))]


def assemble(shape, dtype, shards):
    """The global host array from ``[(index, ndarray)]``: one full
    shard. Entries written shard by shard across a device mesh come
    with the port's distributed slice."""
    shape = tuple(int(s) for s in shape)
    if len(shards) != 1 or shards[0][0] is not None:
        raise MXNetError("this checkpoint array was saved in %d mesh "
                         "shards; the port restores single-device "
                         "entries (mesh entries come with the dist "
                         "slice)" % len(shards))
    arr = shards[0][1]
    if tuple(arr.shape) != shape:
        raise MXNetError("checkpoint array shape %s != manifest %s"
                         % (arr.shape, shape))
    return onp.asarray(arr, dtype=dtype)


# ---------------------------------------------------------------------------
# RNG state (mxnet_tpu_torch.random.get_state() dict) <-> one npz file
# ---------------------------------------------------------------------------
def dump_rng(path, state):
    """Write ``state`` as ``rng.npz``: numpy's legacy state under the JAX
    package's keys, ``jax_key`` as the key ``PRNGKey(seed)`` gives (so
    the JAX package restores a port entry), and the seed, the number of
    executor keys drawn since it and each torch generator's state."""
    kind, keys, pos, has_gauss, cached = state["numpy"]
    seed = int(state["seed"])
    devices = sorted(state["torch"])
    torch_states = {"torch_state_%d" % i: onp.asarray(state["torch"][d],
                                                      onp.uint8)
                    for i, d in enumerate(devices)}
    buf = io.BytesIO()
    onp.savez(buf, jax_key=onp.array([seed >> 32 & 0xFFFFFFFF,
                                      seed & 0xFFFFFFFF], onp.uint32),
              np_kind=onp.array(kind), np_keys=onp.asarray(keys),
              np_pos=onp.array(pos), np_has_gauss=onp.array(has_gauss),
              np_cached=onp.array(cached), torch_seed=onp.array(seed),
              keys_drawn=onp.array(int(state.get("keys_drawn", 0))),
              torch_devices=onp.array(devices, dtype=str), **torch_states)
    return write_bytes(path, buf.getvalue())


def load_rng(path):
    """Read ``rng.npz`` as a ``random.get_state()`` dict. An entry of the
    JAX package has no torch generators and draws no port keys; its seed
    is read from the low word of ``jax_key``."""
    with onp.load(path, allow_pickle=False) as z:
        drawn = int(z["keys_drawn"]) if "keys_drawn" in z.files else 0
        if "torch_seed" in z.files:
            seed = int(z["torch_seed"])
            devices = [str(d) for d in z["torch_devices"]]
            gens = {d: onp.asarray(z["torch_state_%d" % i], onp.uint8)
                    for i, d in enumerate(devices)}
        else:
            seed, gens = int(onp.asarray(z["jax_key"])[-1]), {}
        return {"seed": seed, "keys_drawn": drawn, "torch": gens,
                "numpy": (str(z["np_kind"]), onp.asarray(z["np_keys"]),
                          int(z["np_pos"]), int(z["np_has_gauss"]),
                          float(z["np_cached"]))}
