"""CheckpointManager: async, atomic step checkpoints (PyTorch counterpart
of ``mxnet_tpu/checkpoint/manager.py``, one device).

One manager owns one directory of step-numbered entries::

    <dir>/step_00000003/           committed entry (the rename IS the commit)
        manifest.json              per-array shapes/dtypes/crc32s
        a00001_s00.npy ...         one file per array
        optimizer.bin              raw optimizer-state bytes (optional)
        rng.npz                    RNG state (optional)
    <dir>/.tmp-step_00000004-*/    in-flight or crashed partial entry

Durability: every file of an entry is written and fsynced inside a
``.tmp-*`` staging directory, the directory is fsynced, and only then is
it renamed onto ``step_NNNNNNNN`` (and the parent fsynced). A crash at
any point leaves a committed entry or an ignorable ``.tmp-*``;
:meth:`latest` reports only entries whose manifest is in place.

Saves are **async** by default. ``save()`` snapshots every array to host
memory before it returns: a tensor on the card is copied with a blocking
``.cpu()``, since the port's optimizer updates weights in place and the
next step would otherwise overwrite what is being saved. Serialization
and the commit then run on the manager's own worker thread, overlapping
the next training step. ``save()`` is the error barrier: it waits for
the previous save and re-raises its failure first;
``wait_until_finished()`` does the same on demand. A save still pending
when the interpreter exits is drained.

The layout is the JAX package's (``serialize.FORMAT``, manifest keys,
file names). Its fault-injection seams and retry policy come with the
port's ``faults`` slice.
"""
from __future__ import annotations

import atexit
import logging
import os
import re
import shutil
import time
import uuid
import zlib
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

from .. import random as _random
from .. import telemetry
from ..base import MXNetError
from . import serialize

# one shared scope: checkpoint traffic is a per-process story
_TEL = telemetry.registry().scope("checkpoint")

__all__ = ["CheckpointManager", "Checkpoint", "is_checkpoint_dir"]

_STEP_FMT = "step_%08d"
_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_PREFIX = ".tmp-"
_MANIFEST = "manifest.json"

Checkpoint = namedtuple(
    "Checkpoint", ["step", "params", "optimizer_state", "extra", "rng"])
Checkpoint.__doc__ = """A restored checkpoint entry.

``params`` maps array name -> numpy array; ``optimizer_state`` is the raw
bytes handed to ``save()`` (or None); ``extra`` the JSON metadata dict;
``rng`` a ``random.get_state()`` dict (or None).
"""


def is_checkpoint_dir(path):
    """True if ``path`` is a directory holding at least one committed
    ``step_NNNNNNNN`` entry (tells a manager directory from a legacy
    file prefix that happens to name a directory)."""
    if not os.path.isdir(path):
        return False
    return any(_STEP_RE.match(name) and os.path.exists(
        os.path.join(path, name, _MANIFEST)) for name in os.listdir(path))


def _commit_entry(tmp_dir, final_dir):
    """The atomic commit: fsync the staged entry, rename it onto its step
    name, fsync the parent."""
    serialize.fsync_dir(tmp_dir)
    os.replace(tmp_dir, final_dir)
    serialize.fsync_dir(os.path.dirname(final_dir))


class CheckpointManager(object):
    """Owns a directory of atomic, step-numbered checkpoint entries.

    ``keep`` retains only the newest ``keep`` committed steps (None: all);
    ``keep_every`` also retains every step divisible by it.
    """

    def __init__(self, directory, keep=None, keep_every=None):
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)
        if keep is not None and keep < 1:
            raise ValueError("keep must be >= 1 (the latest entry is "
                             "never garbage-collected)")
        if keep_every is not None and keep_every < 1:
            raise ValueError("keep_every must be >= 1")
        self.keep = keep
        self.keep_every = keep_every
        self._pending = []     # [(future, step)]
        self._worker = None    # created by the first async save

    def _drain_at_exit(self):
        try:
            self.wait_until_finished()
        except MXNetError:   # cannot raise during shutdown: report it
            logging.getLogger(__name__).exception(
                "async checkpoint save failed during interpreter exit")

    def _sweep_partials(self):
        """Remove crashed ``.tmp-*`` partials. Only ``save`` calls this:
        a saver owns the directory, and a read-only manager on a
        directory a live trainer writes into must not touch its staging
        entries."""
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # ------------------------------------------------------------ query
    def _entry_dir(self, step):
        return os.path.join(self.directory, _STEP_FMT % step)

    def all_steps(self):
        """Sorted committed steps (entries with a manifest in place)."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 _MANIFEST)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest(self):
        """Newest committed step, or None. Never reports an in-flight,
        partial or crashed entry."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------- save
    def save(self, step, arrays, optimizer_state=None, extra=None,
             rng_state="auto", async_save=True):
        """Stage a new entry for ``step``.

        ``arrays`` maps name -> NDArray / tensor / numpy array. They are
        copied to host now (the caller may mutate the originals as soon
        as this returns); with ``async_save`` the write and the commit
        run on the worker thread. ``rng_state="auto"`` snapshots this
        thread's RNG state. Raises the previous async save's error
        first."""
        step = int(step)
        self.wait_until_finished()   # barrier + previous-save errors
        self._sweep_partials()
        if step in self.all_steps():
            raise MXNetError("checkpoint step %d already exists in %s"
                             % (step, self.directory))
        t0 = time.perf_counter()
        snaps = [(str(name), serialize.snapshot(value))
                 for name, value in arrays.items()]
        _TEL.counter("snapshot_ms").add((time.perf_counter() - t0) * 1e3)
        if rng_state == "auto":
            rng_state = _random.get_state()
        opt_bytes = bytes(optimizer_state) if optimizer_state is not None \
            else None
        extra = dict(extra or {})
        save_time = time.time()
        tmp = os.path.join(self.directory, "%s%s-%s" % (
            _TMP_PREFIX, _STEP_FMT % step, uuid.uuid4().hex[:8]))
        final = self._entry_dir(step)
        n_bytes = sum(arr.nbytes for _name, shards in snaps
                      for _idx, arr in shards)
        if opt_bytes is not None:
            n_bytes += len(opt_bytes)

        def job():
            t1 = time.perf_counter()
            try:
                self._write_entry(tmp, step, snaps, opt_bytes, extra,
                                  rng_state, save_time)
                _commit_entry(tmp, final)
                self._gc()
            except BaseException:
                _TEL.counter("save_errors").add()
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            _TEL.counter("saves").add()
            _TEL.counter("save_ms").add((time.perf_counter() - t1) * 1e3)
            _TEL.counter("bytes_written").add(n_bytes)
            _TEL.gauge("last_step").set(step)

        if not async_save:
            try:
                job()
            except Exception as exc:
                raise MXNetError("checkpoint save (step %d) failed"
                                 % step) from exc
            return step
        if self._worker is None:
            # one worker thread per manager keeps its saves in order;
            # the atexit hook reports a save that fails while the
            # interpreter drains the worker at exit
            self._worker = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint-save")
            atexit.register(self._drain_at_exit)
        self._pending.append((self._worker.submit(job), step))
        return step

    def _write_entry(self, tmp, step, snaps, opt_bytes, extra, rng_state,
                     save_time):
        os.makedirs(tmp)
        manifest = {"format": serialize.FORMAT, "step": step,
                    "save_unix_time": save_time, "extra": extra,
                    "arrays": {}}
        for ai, (name, shards) in enumerate(snaps):
            entry = {"shape": list(shards[0][1].shape),
                     "dtype": str(shards[0][1].dtype), "shards": []}
            for si, (_idx, arr) in enumerate(shards):
                fname = "a%05d_s%02d.npy" % (ai, si)
                meta = serialize.write_array(os.path.join(tmp, fname), arr)
                meta["file"] = fname
                meta["index"] = None
                entry["shards"].append(meta)
            manifest["arrays"][name] = entry
        manifest["optimizer"] = None
        if opt_bytes is not None:
            crc = serialize.write_bytes(os.path.join(tmp, "optimizer.bin"),
                                        opt_bytes)
            manifest["optimizer"] = {"file": "optimizer.bin",
                                     "size": len(opt_bytes), "crc32": crc}
        manifest["rng"] = None
        if rng_state is not None:
            serialize.dump_rng(os.path.join(tmp, "rng.npz"), rng_state)
            manifest["rng"] = {"file": "rng.npz"}
        serialize.write_json(os.path.join(tmp, _MANIFEST), manifest)

    def wait_until_finished(self):
        """Block until every async save committed; re-raise the first
        failure."""
        pending, self._pending = self._pending, []
        first = None
        for future, step in pending:
            exc = future.exception()
            if exc is not None and first is None:
                first = (step, exc)
        if first is not None:
            raise MXNetError("async checkpoint save (step %d) failed"
                             % first[0]) from first[1]

    def step_metadata(self, step=None):
        """The ``extra`` metadata of a committed entry (default: the
        latest), without loading its arrays; None when there is none."""
        self.wait_until_finished()
        if step is None:
            step = self.latest()
            if step is None:
                return None
        manifest_path = os.path.join(self._entry_dir(int(step)), _MANIFEST)
        if not os.path.exists(manifest_path):
            raise MXNetError("checkpoint step %d is not committed in %s"
                             % (int(step), self.directory))
        return dict(serialize.read_json(manifest_path).get("extra", {}))

    # ---------------------------------------------------------- restore
    def restore(self, step=None):
        """Load a committed entry as a :class:`Checkpoint`.

        With ``step=None`` (the resume path) restore walks back from the
        newest committed entry to the newest one that verifies: an entry
        whose manifest or arrays fail their checks is skipped with one
        warning, and only when none verifies does restore raise. An
        explicit ``step`` is an exact request and raises on corruption."""
        self.wait_until_finished()
        if step is not None:
            return self._restore_entry(int(step))
        candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            raise MXNetError("no committed checkpoint in %s"
                             % self.directory)
        failures = []
        for s in candidates:
            try:
                return self._restore_entry(s)
            except (MXNetError, KeyError, TypeError, ValueError) as exc:
                failures.append((s, exc))
                _TEL.counter("restore_fallbacks").add()
                logging.getLogger(__name__).warning(
                    "checkpoint step %d in %s failed verification (%s); "
                    "falling back to the previous committed entry",
                    s, self.directory, exc)
        raise MXNetError(
            "no checkpoint entry in %s passed verification (%d "
            "candidates); newest failure: step %d: %s"
            % (self.directory, len(failures), failures[0][0],
               failures[0][1]))

    def restore_before(self, predicate, verify=None):
        """Restore the newest committed entry that satisfies
        ``predicate(step, extra)`` over its manifest metadata, verifies,
        and passes ``verify(ckpt) -> None | reason``. Entries whose
        metadata or payload is unusable are skipped with a warning.
        Raises when none qualifies."""
        self.wait_until_finished()
        log = logging.getLogger(__name__)
        candidates = sorted(self.all_steps(), reverse=True)
        for s in candidates:
            try:
                extra = dict(serialize.read_json(os.path.join(
                    self._entry_dir(s), _MANIFEST)).get("extra", {}))
                if not predicate(s, extra):
                    continue
                ckpt = self._restore_entry(s)
                reason = verify(ckpt) if verify is not None else None
            except (MXNetError, OSError, KeyError, TypeError,
                    ValueError) as exc:
                reason = str(exc)
            if not reason:
                return ckpt
            _TEL.counter("restore_fallbacks").add()
            log.warning("checkpoint step %d in %s is unusable (%s); "
                        "falling back to the previous committed entry",
                        s, self.directory, reason)
        raise MXNetError(
            "no checkpoint entry in %s both satisfies the predicate and "
            "passes verification (%d candidates)"
            % (self.directory, len(candidates)))

    def discard_after(self, step):
        """Delete committed entries newer than ``step``; returns their
        steps."""
        self.wait_until_finished()
        step = int(step)
        dropped = [s for s in self.all_steps() if s > step]
        for s in dropped:
            shutil.rmtree(self._entry_dir(s), ignore_errors=True)
        if dropped:
            logging.getLogger(__name__).warning(
                "discarded %d checkpoint entries after step %d (%s)",
                len(dropped), step, dropped)
            _TEL.counter("discarded_entries").add(len(dropped))
        return dropped

    def _restore_entry(self, step):
        """Load and verify one committed entry; any corruption raises
        :class:`MXNetError` naming the failing file."""
        t0 = time.perf_counter()
        entry = self._entry_dir(step)
        manifest_path = os.path.join(entry, _MANIFEST)
        if not os.path.exists(manifest_path):
            raise MXNetError("checkpoint step %d is not committed in %s"
                             % (step, self.directory))
        try:
            manifest = serialize.read_json(manifest_path)
        except (ValueError, OSError) as exc:
            raise MXNetError("checkpoint manifest %s is unreadable "
                             "(corrupt or truncated): %s"
                             % (manifest_path, exc)) from exc
        if manifest.get("format") != serialize.FORMAT:
            raise MXNetError("unknown checkpoint format %r in %s"
                             % (manifest.get("format"), entry))
        params = {}
        for name, meta in manifest["arrays"].items():
            shards = []
            for smeta in meta["shards"]:
                path = os.path.join(entry, smeta["file"])
                try:
                    arr = serialize.read_array(path, smeta)
                except (OSError, ValueError) as exc:
                    raise MXNetError("checkpoint shard %s is unreadable "
                                     "(corrupt or truncated): %s"
                                     % (path, exc)) from exc
                idx = smeta["index"]
                shards.append((None if idx is None else
                               tuple((a, b) for a, b in idx), arr))
            params[name] = serialize.assemble(meta["shape"], meta["dtype"],
                                              shards)
        opt_bytes = None
        if manifest.get("optimizer"):
            with open(os.path.join(entry, manifest["optimizer"]["file"]),
                      "rb") as f:
                opt_bytes = f.read()
            if (zlib.crc32(opt_bytes) & 0xFFFFFFFF) != \
                    manifest["optimizer"]["crc32"]:
                raise MXNetError("optimizer state in step %d failed its "
                                 "crc32 check" % step)
        rng = None
        if manifest.get("rng"):
            rng = serialize.load_rng(
                os.path.join(entry, manifest["rng"]["file"]))
        _TEL.counter("restores").add()
        _TEL.counter("restore_ms").add((time.perf_counter() - t0) * 1e3)
        _TEL.counter("bytes_read").add(
            sum(p.nbytes for p in params.values())
            + (len(opt_bytes) if opt_bytes else 0))
        return Checkpoint(step=step, params=params,
                          optimizer_state=opt_bytes,
                          extra=manifest.get("extra", {}), rng=rng)

    # --------------------------------------------------------------- gc
    def _retained(self, steps):
        if not steps:
            return set()
        if self.keep is None and self.keep_every is None:
            return set(steps)
        kept = {steps[-1]}                       # latest is untouchable
        if self.keep is not None:
            kept.update(steps[-self.keep:])
        if self.keep_every is not None:
            kept.update(s for s in steps if s % self.keep_every == 0)
        return kept

    def _gc(self):
        """Apply the retention policy (after every commit)."""
        steps = self.all_steps()
        kept = self._retained(steps)
        for s in steps:
            if s not in kept:
                shutil.rmtree(self._entry_dir(s), ignore_errors=True)
