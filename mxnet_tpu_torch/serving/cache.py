"""Persistent serving compile cache — replica warm start as a load, not a
retrace (the port's counterpart of ``mxnet_tpu/serving/cache.py``).

The JAX package's replica compiles its bucket ladder with XLA and keeps
the executables on disk. The port runs eager PyTorch, so it has two
other things to keep, in the same two layers:

* **process-wide build cache** — ``MXNET_COMPILE_CACHE_DIR=<dir>`` (read
  at every build) or :func:`enable_persistent_compile_cache` moves every
  ``nvcc`` build of the process under ``<dir>/cuda/``: the csrc kernels
  (``kernels/build.py cuda_library``) and the rtc bodies
  (``kernels/rtc.py rtc_dir``). The libraries stay digest-named and are written
  under a temporary name and renamed, so a second process pointed at the
  same directory loads them and runs **zero** ``nvcc``
  (``kernels.build.builds`` counts the runs).
* **per-bucket executable cache** — ``Predictor.warmup(cache_dir=)`` (and
  ``DecodeEngine.warmup``) trace each bucket's eval forward once with
  ``torch.export.export`` (parameters and aux states are *inputs* of the
  program, never constants) and commit the ``torch.export.save`` bytes
  as an atomic, crc-verified :class:`ExecutableCache` entry. A second
  replica warming from the same directory loads every bucket's program
  with ``torch.export.load`` and traces nothing; cold and warm replicas
  both serve through the exported program, which dispatches the same
  aten ops as the eager executor (no ``run_decompositions``), so served
  rows are bit for bit the executor's.

A hit saves the trace and the export (seconds a bucket for a deep net on
the host). It does not save the first run's library handle setup (cuDNN
picks its algorithms for the bucket's shapes) and the caching
allocator's growth: those happen at the program's first launch and stay
in the bucket's ``warmup_ms``.

The cache key is the contract. An entry is keyed by

* ``params_digest`` — sha256 of the symbol JSON + every parameter's
  name/shape/dtype (:func:`mxnet_tpu_torch.checkpoint.params_digest`, the
  rule checkpoint manifests record), so an architecture drift refuses the
  entry while two checkpoints of one architecture share programs
  (parameter VALUES are runtime inputs);
* ``precision_mode`` — the resolved policy name: a program traced under
  one mode's casts served under another would be other numbers;
* ``bucket`` + ``input_sig`` — the padded batch size and the input row
  shapes the program was specialized to, plus what a trace freezes into
  the program besides: the serving policy's eval fields and, under a
  calibrated mode, the calibration table's digest (the static scales are
  constants of the traced program);
* ``backend_sig`` — platform, device, device name and count, and the
  torch and CUDA versions: a trace fixes the device of every tensor it
  makes.

Every mismatch path — drifted digest, other mode, other backend,
truncated or bit-flipped entry, a crashed ``.tmp-*`` partial — falls back
LOUDLY to a fresh trace (a warning naming the drifted field); a stale
program is never served. Entries commit with the checkpoint subsystem's
idiom: write a ``.tmp-*`` sibling, fsync, ``os.replace``; a ``.tmp-*``
file is never loadable.

A net ``torch.export`` cannot trace (a ``Custom`` node's numpy round
trip, the detection ops' data-dependent shapes) makes
``warmup(cache_dir=)`` raise ``MXNetError`` naming the node (ROADMAP
A12); it never falls back silently.
"""
from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import threading
import uuid
import zlib

import torch

from ..base import MXNetError

__all__ = ["CacheMiss", "ExecutableCache", "cache_key", "input_signature",
           "enable_persistent_compile_cache", "backend_signature",
           "export_program", "load_program", "program_bytes",
           "program_module",
           "untraceable_node", "KEY_FIELDS", "UNTRACEABLE_OPS"]

_MAGIC = b"MXTORCHEXEC1\n"
_FORMAT = 1
_TMP_PREFIX = ".tmp-"
_SUFFIX = ".mxexec"

# key fields that must match field by field for an entry to load; the
# order is the order mismatch warnings report them in
KEY_FIELDS = ("params_digest", "precision_mode", "bucket", "input_sig",
              "backend_sig")

# ops whose forward a trace cannot capture: the reason names the node's
# trouble in the refusal
UNTRACEABLE_OPS = {
    "Custom": "its forward is a numpy round trip through the host",
    "_contrib_MultiBoxDetection": "its NMS keeps a data-dependent count",
    "_contrib_Proposal": "its NMS keeps a data-dependent count",
}

_lock = threading.Lock()
traces = 0      # torch.export traces of this process (export_program)


def enable_persistent_compile_cache(cache_dir):
    """Build every CUDA library of the process under ``<cache_dir>/cuda/``
    (created if missing), so processes pointed at one directory share
    the ``nvcc`` builds; ``MXNET_COMPILE_CACHE_DIR`` does the same without
    a call. The same directory also serves as the default executable
    store of ``Predictor.warmup()`` and ``DecodeEngine.warmup()`` through
    that variable (``<dir>/aot/``). Returns True."""
    from ..kernels import build
    cache_dir = os.path.abspath(str(cache_dir))
    os.makedirs(os.path.join(cache_dir, "cuda"), exist_ok=True)
    build.set_cache_root(cache_dir)
    return True


def aot_dir(cache_dir=None):
    """The executable store a warmup uses: ``<cache_dir>/aot``, else
    ``$MXNET_COMPILE_CACHE_DIR/aot``, else None (no cache)."""
    if cache_dir is None:
        root = os.environ.get("MXNET_COMPILE_CACHE_DIR")
        return os.path.join(root, "aot") if root else None
    return os.path.join(str(cache_dir), "aot")


def backend_signature(device=None):
    """The program-portability boundary as one stable string: platform,
    device, device name and count, torch and CUDA versions. Two processes
    agreeing on it may exchange exported programs."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        dev = torch.device("cuda", idx)
        kind, n_dev = torch.cuda.get_device_name(idx), \
            torch.cuda.device_count()
    else:
        kind, n_dev = dev.type, 1
    return ";".join([
        "platform=%s" % dev.type,
        "device=%s" % dev,
        "device_kind=%s" % kind,
        "n_dev=%d" % int(n_dev),
        "torch=%s" % torch.__version__,
        "cuda=%s" % (torch.version.cuda or "none"),
    ])


def cache_key(params_digest, precision_mode, bucket, input_sig,
              backend_sig):
    """The full entry key as a plain dict (KEY_FIELDS order)."""
    return {
        "params_digest": str(params_digest),
        "precision_mode": str(precision_mode),
        "bucket": int(bucket),
        "input_sig": str(input_sig),
        "backend_sig": str(backend_sig),
    }


def input_signature(data_descs):
    """Canonical string of the input ROW shapes the bucket programs are
    specialized to (batch dim excluded: that is the bucket)."""
    return ";".join("%s:%s" % (name, tuple(shape[1:]))
                    for name, shape in sorted(data_descs))


class CacheMiss(Exception):
    """An entry could not be loaded. ``reason`` is ``absent`` (first run,
    informational), ``key-mismatch`` (an entry exists for this bucket
    under another key: loud) or ``corrupt`` (truncated, bit-flipped or
    unreadable: loud)."""

    def __init__(self, reason, detail=""):
        self.reason = reason
        self.detail = detail
        super().__init__("%s%s" % (reason, (": " + detail) if detail
                                   else ""))


def _entry_name(key):
    """File name of a key: every key field enters it (digest and mode
    spelled for humans, the whole key hashed in), so another key never
    resolves to the same file; the header check is defence in depth."""
    full = hashlib.sha256(
        "|".join(str(key[f]) for f in KEY_FIELDS)
        .encode("utf-8")).hexdigest()[:16]
    mode = "".join(c if c.isalnum() else "_"
                   for c in key["precision_mode"])[:24]
    return "%s-%s-b%d-%s%s" % (key["params_digest"][:12], mode,
                               key["bucket"], full, _SUFFIX)


class ExecutableCache(object):
    """Directory of atomic, crc-verified exported-program entries.

    One entry is the ``torch.export.save`` bytes of one program, framed
    as::

        MXTORCHEXEC1\\n
        <json header line: format, key fields, payload size, crc32>\\n
        <payload bytes>

    Commit is atomic (``.tmp-*`` sibling + fsync + ``os.replace``);
    readers only open the exact final name, so a crashed partial is
    invisible — a ``.tmp-*`` file is never loadable, by construction and
    by the explicit guard in :meth:`load`.
    """

    def __init__(self, directory):
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)

    def path_for(self, key):
        return os.path.join(self.directory, _entry_name(key))

    def entries(self):
        """Committed entry file names (``.tmp-*`` partials excluded)."""
        return sorted(
            os.path.basename(p)
            for p in glob.glob(os.path.join(self.directory, "*" + _SUFFIX))
            if not os.path.basename(p).startswith(_TMP_PREFIX))

    def sweep_partials(self):
        """Remove crashed ``.tmp-*`` partials (writer-side hygiene)."""
        for p in glob.glob(os.path.join(self.directory, _TMP_PREFIX + "*")):
            try:
                os.remove(p)
            except OSError:
                pass

    def store(self, key, payload):
        """Commit one entry (``payload``: bytes) atomically; returns its
        path."""
        from ..checkpoint.serialize import fsync_dir
        payload = bytes(payload)
        header = dict(key)
        header["format"] = _FORMAT
        header["size"] = len(payload)
        header["crc32"] = zlib.crc32(payload) & 0xFFFFFFFF
        final = self.path_for(key)
        tmp = os.path.join(self.directory, "%s%s-%s" % (
            _TMP_PREFIX, os.path.basename(final), uuid.uuid4().hex[:8]))
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(json.dumps(header, sort_keys=True).encode("utf-8"))
            f.write(b"\n")
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        fsync_dir(self.directory)
        from .. import faults as _faults
        if _faults.armed():
            # poisoned-entry seam: corrupt the COMMITTED entry (a storage
            # fault after a clean commit); the next replica's load must
            # refuse it loudly and trace afresh
            _faults.corrupt_file("serving.cache", self.directory,
                                 pattern=os.path.basename(final),
                                 bucket=key["bucket"])
        return final

    def load(self, key):
        """Load and verify one entry -> its payload bytes. Raises
        :class:`CacheMiss` on any failure; ``key-mismatch`` names the
        drifted field(s) when an entry for this bucket exists under
        another key."""
        path = self.path_for(key)
        name = os.path.basename(path)
        if name.startswith(_TMP_PREFIX):
            raise CacheMiss("corrupt", "refusing .tmp-* partial %s" % name)
        if not os.path.exists(path):
            drift = self._describe_drift(key)
            if drift:
                raise CacheMiss("key-mismatch", drift)
            raise CacheMiss("absent", name)
        try:
            with open(path, "rb") as f:
                magic = f.read(len(_MAGIC))
                if magic != _MAGIC:
                    raise CacheMiss("corrupt", "%s: bad magic" % name)
                header = json.loads(f.readline().decode("utf-8"))
                blob = f.read()
        except CacheMiss:
            raise
        except Exception as e:  # noqa: BLE001 - any read/parse failure
            raise CacheMiss("corrupt", "%s: %s" % (name, e)) from e
        if not isinstance(header, dict) or header.get("format") != _FORMAT:
            raise CacheMiss("corrupt", "%s: format %r" % (
                name, header.get("format") if isinstance(header, dict)
                else header))
        bad = [f for f in KEY_FIELDS if header.get(f) != key[f]]
        if bad:
            raise CacheMiss("key-mismatch", "%s: header disagrees on %s"
                            % (name, ", ".join(bad)))
        if len(blob) != header.get("size"):
            raise CacheMiss("corrupt", "%s: truncated (%d of %s bytes)"
                            % (name, len(blob), header.get("size")))
        if (zlib.crc32(blob) & 0xFFFFFFFF) != header.get("crc32"):
            raise CacheMiss("corrupt", "%s: crc32 mismatch" % name)
        return blob

    def _describe_drift(self, key):
        """When the exact entry is absent but other entries exist for
        this bucket, say which key fields drifted; "" when the directory
        simply has no entry for the bucket (a first-run miss)."""
        want_b = "-b%d-" % key["bucket"]
        for name in self.entries():
            if want_b not in name:
                continue
            try:
                with open(os.path.join(self.directory, name), "rb") as f:
                    if f.read(len(_MAGIC)) != _MAGIC:
                        continue
                    header = json.loads(f.readline().decode("utf-8"))
            except Exception:  # noqa: BLE001 - diagnostics only
                continue
            bad = [fld for fld in KEY_FIELDS if header.get(fld) != key[fld]]
            if bad:
                return ("entry %s exists for bucket %d but was built under "
                        "a different %s (e.g. %s=%r, want %r)"
                        % (name, key["bucket"], ", ".join(bad), bad[0],
                           header.get(bad[0]), key[bad[0]]))
        return ""


# ---------------------------------------------------------------------------
# programs: trace, serialize, load
# ---------------------------------------------------------------------------
def untraceable_node(symbol):
    """``(node name, op name, reason)`` of the first node of ``symbol``
    whose op a trace cannot capture (``UNTRACEABLE_OPS``), else None."""
    for n in symbol._topo():
        if n.op is not None and n.op.name in UNTRACEABLE_OPS:
            return n.name, n.op.name, UNTRACEABLE_OPS[n.op.name]
    return None


class _Program(torch.nn.Module):
    """``fn(*tensors)`` as the module ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return tuple(self._fn(*args))


def export_program(fn, args, what="program", where=None):
    """Trace ``fn(*args)`` (a function of tensors returning a sequence of
    tensors) with ``torch.export.export`` (non-strict: the Python of the
    executor and the ops runs as written). Every tensor the program reads
    must be in ``args``; a tensor it makes (zeros, an index vector)
    becomes part of the program. Raises ``MXNetError`` naming ``what``
    (and ``where()``, the node the trace stopped at, when given) if the
    trace fails. Counts into ``traces``."""
    global traces
    try:
        ep = torch.export.export(_Program(fn), tuple(args), strict=False)
    except Exception as e:  # noqa: BLE001 - torch.export's many errors
        at = where() if where is not None else ""
        first = (str(e).strip().splitlines() or [""])[0][:300]
        raise MXNetError(
            "torch.export could not trace %s%s (%s: %s); "
            "warmup(cache_dir=) needs a traceable net (ROADMAP A12)"
            % (what, " at %s" % at if at else "", type(e).__name__, first))
    with _lock:
        traces += 1
    return ep


def _drop_checks(gm):
    """Remove what the trace adds around the executor's ops and what they
    compute: the ``_assert_tensor_metadata`` checks (a dispatched op
    each, re-asserting the dtype and device the key already pins) and
    ``to`` casts to the dtype a tensor already has (each returns its
    input). The aten ops that compute stay as traced. Returns the
    number of nodes removed."""
    removed = 0
    for node in list(gm.graph.nodes):
        if node.op == "get_attr":
            sub = getattr(gm, node.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                removed += _drop_checks(sub)
            continue
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default \
                and not node.users:
            gm.graph.erase_node(node)
            removed += 1
        elif node.target is torch.ops.aten.to.dtype and \
                len(node.args) == 2 and not node.kwargs:
            src = node.args[0]
            val = getattr(src, "meta", {}).get("val")
            if val is not None and val.dtype == node.args[1]:
                node.replace_all_uses_with(src)
                gm.graph.erase_node(node)
                removed += 1
    if removed:
        gm.recompile()
    return removed


def program_module(ep):
    """The callable of an exported program, over the same positional
    tensors: ``ep.module()`` without the trace's own checks
    (``_drop_checks``). It still validates its inputs against the
    traced shapes on every call until ``validate_inputs`` is set False
    (the Predictor and the DecodeEngine do so after warmup's first run
    has passed the check)."""
    gm = ep.module()
    _drop_checks(gm)
    return gm


def program_bytes(ep):
    """The ``torch.export.save`` bytes of an exported program."""
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_program(payload):
    """An entry's payload back as a callable over the same positional
    tensors (``program_module`` of ``torch.export.load``)."""
    return program_module(torch.export.load(io.BytesIO(payload)))
