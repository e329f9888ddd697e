"""Predictor — online inference over a trained Module, one bound module
per batch-size bucket (the port's counterpart of
``mxnet_tpu/serving/predictor.py``).

``Module.predict`` loops over a whole ``DataIter``: fine for offline
eval, no good for online traffic, where requests come in every size.
The Predictor serves them at a few fixed shapes (the ``DynamicBatcher``
coalesces concurrent requests into full launches):

* it binds one inference Module per **batch-size bucket** (powers of
  two from 2 up to ``max_batch_size`` by default), all bound with
  ``shared_module=`` to the top bucket's module, so every bucket
  computes from ONE set of parameter and aux tensors on the device;
* a request of ``n`` rows is zero-padded up to the smallest bucket
  ``>= n`` and the outputs sliced back to ``n``, so steady-state traffic
  only ever runs the buckets' shapes. ``warmup()`` runs every bucket
  once before traffic: that first forward is where cuDNN picks its
  algorithms for the bucket's shapes and the caching allocator grows,
  and the ``compiles`` counter in ``stats()`` counts exactly those
  first forwards ("zero compiles after warmup"). An eval forward is
  row-independent, so the served rows equal, bit for bit, the same rows
  through a Module bound at the bucket's batch and run with
  ``predict``;
* requests larger than the top bucket are chunked across launches.

Parameters are copied from the source module at construction, so a
later training step on the source never changes served rows; rebuild
the Predictor to pick up new weights. A launch copies the padded rows
to the card and reads the outputs back; that readback is the launch's
only synchronisation with the device.

Precision: the buckets serve under the source module's mode with its
training-only fields stripped (remat, optimizer-state dtype, loss scale),
so a module trained in ``bf16`` serves in bfloat16 and one trained in
``bf16_opt`` or ``combined`` serves float32 forwards; the input cast
(``act_cast``) and the narrow-math GEMMs (``narrow_math``) stay, and the
mode name is kept. ``int8_serve`` takes its static activation scales from
a :class:`~mxnet_tpu_torch.precision.quant.CalibrationTable`
(``calibration=``), whose digest the buckets' policy describes
(``calibration_digest``). A module loaded from a checkpoint entry
recorded under another mode than the one it runs is refused, and so is
one whose parameters no longer match the entry's recorded params digest.

Persistent executable cache (``warmup(cache_dir=)`` or
``MXNET_COMPILE_CACHE_DIR``; :mod:`mxnet_tpu_torch.serving.cache`): each
bucket's eval forward is traced once with ``torch.export`` (parameters
and aux states as inputs) and kept on disk, keyed by (params digest,
precision mode, bucket, input signature, backend); a second replica
loads the programs and traces nothing. With a cache directory every
bucket serves through its exported program, whose rows are bit for bit
the executor's.
"""
from __future__ import annotations

import logging
import os
import threading
import time

import numpy as onp
import torch

from .. import telemetry
from ..base import MXNetError
from ..checkpoint import pack_params, params_digest
from ..context import Context
from ..io import DataBatch
from ..module import Module
from ..module.base_module import pad_batch_rows
from .stats import ServingStats

__all__ = ["Predictor"]

class Predictor:
    """Bind a trained/loaded :class:`Module` for online inference.

    Parameters
    ----------
    module : Module
        Source of symbol + parameters. May be a live (bound) training
        module or an unbound ``Module.load`` result; its parameters are
        copied — later training steps do not leak into serving.
    data_shapes : list of (name, shape), optional
        Input descriptors; the batch dimension is replaced per bucket.
        Defaults to the source module's bound ``data_shapes``.
    buckets : list of int, optional
        Explicit batch-size buckets, each at least 2. Default: powers of
        two from 2 up to ``max_batch_size``.
    max_batch_size : int
        Top bucket for the default power-of-two ladder (ignored when
        ``buckets`` is given). Larger requests are chunked.
    context : Context or list of Context, optional
        The serving device; defaults to the source module's.
    calibration : CalibrationTable, optional
        Static per-site activation ranges (``precision.quant``) for a
        ``narrow_math`` policy: required by ``int8_serve`` (its int8
        activation scales come from a calibration pass).
    """

    def __init__(self, module, data_shapes=None, buckets=None,
                 max_batch_size=32, context=None, logger=None,
                 latency_window=2048, calibration=None):
        if not isinstance(module, Module):
            raise MXNetError(
                "Predictor needs a plain Module (got %s); for wrapper "
                "modules serve the underlying Module"
                % type(module).__name__)
        self.logger = logger or logging.getLogger("mxnet_tpu_torch.serving")
        self._stats = ServingStats(latency_window=latency_window)
        self._lock = threading.RLock()

        # -- source introspection --------------------------------------
        symbol = module.symbol
        if module.binded and module.params_initialized:
            arg_params, aux_params = module.get_params()
        elif module.params_initialized and module._arg_params is not None:
            arg_params = module._arg_params
            aux_params = module._aux_params or {}
        else:
            raise MXNetError(
                "Predictor needs initialized parameters: bind+init the "
                "module, or load it from params files first")
        # the precision gate: a checkpoint trained under one mode served
        # by a module bound under another would return other numbers,
        # not an error; live modules carry no recorded mode
        saved_mode = getattr(module, "_ckpt_precision_mode", None)
        if saved_mode is not None and saved_mode != module.precision_mode:
            raise MXNetError(
                "refusing to serve: checkpoint was trained under precision "
                "mode %r but the module to bind runs %r; load with the "
                "matching precision= (or drop the override so the "
                "recorded mode is adopted)"
                % (saved_mode, module.precision_mode))
        if data_shapes is None:
            if not module.binded:
                raise MXNetError(
                    "data_shapes is required when the source module is "
                    "not bound (e.g. a Module.load result)")
            data_shapes = module.data_shapes
        self._params_digest = params_digest(
            symbol.tojson(), pack_params(arg_params, aux_params))
        # a manager-restored module carries its entry's digest: another
        # one means the parameters were swapped after the load, and a
        # cache entry keyed on either digest could serve a stale program
        recorded = getattr(module, "_ckpt_params_digest", None)
        if recorded is not None and recorded != self._params_digest:
            raise MXNetError(
                "refusing to serve: the module's parameters no longer "
                "match the checkpoint manifest's recorded params digest "
                "(%s... != %s...); the params were replaced after load; "
                "rebuild the module from its checkpoint"
                % (self._params_digest[:12], recorded[:12]))
        self._data_descs = [(name, tuple(shape))
                            for name, shape in data_shapes]
        if context is None:
            contexts = list(module._context)
        elif isinstance(context, Context):
            contexts = [context]
        else:
            contexts = list(context)

        # -- bucket ladder ---------------------------------------------
        # one device: the data-parallel factor is the context count
        dp = len(contexts)
        if buckets is None:
            # the ladder starts at 2 (not 1): a 1-row batch takes a
            # matrix-vector path with another accumulation order, and
            # padding one zero row is free
            b, buckets = max(2, int(dp)), []
            while b <= max_batch_size:
                buckets.append(b)
                b *= 2
            if not buckets:
                raise MXNetError(
                    "max_batch_size=%d is smaller than the data-parallel "
                    "factor %d — no bucket fits" % (max_batch_size, dp))
        else:
            buckets = sorted({int(b) for b in buckets})
            if not buckets:
                raise MXNetError("buckets must not be empty")
            bad = [b for b in buckets if b <= 0 or b % dp]
            if bad:
                raise MXNetError(
                    "buckets %r must be positive multiples of the "
                    "data-parallel factor %d (the context "
                    "count) so every bucket shards evenly" % (bad, dp))
            if buckets[0] == 1:
                raise MXNetError(
                    "a 1-row bucket breaks the bitwise-parity contract "
                    "(a batch-1 product takes a matrix-vector path that "
                    "accumulates in another order); use a minimum bucket "
                    "of 2 — padding the one extra row is free")
        self._buckets = buckets

        # -- one inference module per bucket, ONE set of param tensors -
        def _shapes_at(b):
            return [(name, (b,) + shape[1:])
                    for name, shape in self._data_descs]

        # serve under the source policy's eval-visible fields only: the
        # forward keeps the compute dtype, the input cast (act_cast) and
        # the narrow-math GEMMs, and the training-only levers (remat,
        # optimizer-state dtype, loss scale) are stripped; the mode name
        # stays
        src_pol = module._precision
        serve_pol = None
        if src_pol is not None:
            from ..precision import PrecisionPolicy
            narrow = src_pol.narrow_math
            table = calibration if calibration is not None \
                else src_pol.calibration
            if narrow == "int8" and table is None:
                raise MXNetError(
                    "precision mode %r needs a CalibrationTable (static "
                    "int8 activation scales): run "
                    "precision.quant.calibrate(...) and pass the table "
                    "via Predictor(calibration=...)" % src_pol.name)
            serve_pol = PrecisionPolicy(
                name=src_pol.name, compute_dtype=src_pol.compute_dtype,
                act_cast=src_pol.act_cast,
                weight_quant=src_pol.weight_quant, narrow_math=narrow,
                calibration=table, experimental=src_pol.experimental)
        elif calibration is not None:
            raise MXNetError(
                "Predictor(calibration=...) only applies to a module bound "
                "under a narrow_math precision mode (e.g. 'int8_serve')")
        self._calibration = calibration if serve_pol is None \
            else serve_pol.calibration
        # what a trace freezes into a bucket's program besides its shapes
        # (serving.cache keys it): the policy's eval fields
        self._policy_sig = "policy=%s" % (
            "none,cdt=%s" % module._compute_dtype if serve_pol is None else
            "%s,cdt=%s,act_cast=%s,narrow=%s,wq=%s" % (
                serve_pol.name, serve_pol.compute_dtype, serve_pol.act_cast,
                serve_pol.narrow_math, serve_pol.weight_quant))

        def _make():
            return Module(symbol, data_names=module._data_names,
                          label_names=module._label_names,
                          logger=self.logger, context=contexts,
                          compute_dtype=module._compute_dtype,
                          precision=serve_pol,
                          _allow_fused=module._allow_fused)

        base = _make()
        base.bind(data_shapes=_shapes_at(buckets[-1]), for_training=False)
        base.set_params(arg_params, aux_params)
        self._modules = {buckets[-1]: base}
        for b in buckets[:-1]:
            m = _make()
            m.bind(data_shapes=_shapes_at(b), for_training=False,
                   shared_module=base)
            self._modules[b] = m
        self._base = base
        self._launched = set()    # buckets whose first forward has run
        self._programs = {}       # bucket -> exported program (cache)

    # ------------------------------------------------------------------
    @staticmethod
    def load(source, epoch=None, data_shapes=None, data_names=("data",),
             label_names=("softmax_label",), context=None, precision=None,
             **kwargs):
        """Predictor straight from a checkpoint: ``source`` is a legacy
        prefix (``prefix-symbol.json`` + ``prefix-%04d.params`` of either
        package, ``epoch`` required), a ``CheckpointManager``, or a
        checkpoint directory (``epoch`` then selects a committed step,
        default the latest). Routes through :meth:`Module.load`, so on
        the manager path the symbol comes from the manifest, the entry's
        recorded precision mode is adopted, and an explicit ``precision=``
        that differs from it is refused at construction. A legacy prefix
        records no mode, so a ``precision=`` other than ``"f32"`` raises
        there: load it with ``Module.load(prefix, epoch, precision=)`` and
        serve that module."""
        from ..checkpoint import CheckpointManager
        from ..checkpoint.manager import is_checkpoint_dir
        managed = isinstance(source, CheckpointManager) or (
            isinstance(source, str) and os.path.isdir(source) and
            (epoch is None or is_checkpoint_dir(source)))
        if not managed and precision not in (None, "f32"):
            raise MXNetError(
                "precision mode %r: a legacy prefix records no mode; load "
                "it with Module.load(prefix, epoch, precision=...) and "
                "serve that module" % (precision,))
        mkw = {"precision": precision} if managed and precision else {}
        mod = Module.load(source, epoch, data_names=list(data_names),
                          label_names=list(label_names), context=context,
                          **mkw)
        return Predictor(mod, data_shapes=data_shapes, context=context,
                         **kwargs)

    # ------------------------------------------------------------------
    @property
    def buckets(self):
        return list(self._buckets)

    @property
    def max_batch_size(self):
        return self._buckets[-1]

    @property
    def calibration(self):
        """The CalibrationTable the buckets serve with (None without)."""
        return self._calibration

    @property
    def output_names(self):
        return list(self._base.output_names)

    @property
    def data_names(self):
        return [name for name, _ in self._data_descs]

    @property
    def device(self):
        """The ``torch.device`` the buckets serve on (the gateway puts
        request rows there)."""
        return self._base._context[0].torch_device()

    def stats(self):
        """Snapshot of the serving counters: request outcomes, latency
        percentiles, batch-fill ratio, queue depth, compile count (the
        JAX package's keys)."""
        return self._stats.snapshot()

    # ------------------------------------------------------------------
    def _normalize(self, data):
        """Accept an array (numpy, NDArray or tensor) for single-input
        nets, a list/tuple in ``data_names`` order, or a name->array
        dict; return (name->float32 array dict, n_rows). Feature dims are
        validated against the bound shapes so a malformed request fails
        at submit time, not on the batcher thread. Host data becomes a
        numpy array; a tensor on the card stays there (it pads on the
        card) and serves the same rows as the same request from host
        memory."""
        names = self.data_names
        if isinstance(data, dict):
            arrays = dict(data)
        elif isinstance(data, (list, tuple)):
            arrays = dict(zip(names, data))
        else:
            if len(names) != 1:
                raise ValueError(
                    "this net has %d inputs %r; pass a dict or a list"
                    % (len(names), names))
            arrays = {names[0]: data}
        missing = [n for n in names if n not in arrays]
        if missing:
            raise ValueError("request is missing input(s) %r" % missing)
        out, rows = {}, None
        for name, shape in self._data_descs:
            v = arrays[name]
            if hasattr(v, "_read"):
                v = v._read()
            if isinstance(v, torch.Tensor):
                v = v.detach()
                v = v.float() if v.is_cuda else v.float().numpy()
            if not isinstance(v, torch.Tensor):
                v = onp.ascontiguousarray(v, dtype=onp.float32)
            if tuple(v.shape[1:]) != tuple(shape[1:]):
                raise ValueError(
                    "input %r has row shape %r, bound shape wants %r"
                    % (name, tuple(v.shape[1:]), tuple(shape[1:])))
            if rows is None:
                rows = v.shape[0]
            elif v.shape[0] != rows:
                raise ValueError(
                    "inputs disagree on row count: %d vs %d"
                    % (v.shape[0], rows))
            out[name] = v
        if not rows:
            raise ValueError("request has zero rows")
        return out, rows

    def bucket_for(self, n):
        """Smallest bucket that fits ``n`` rows (the top bucket for
        oversized requests — those are chunked)."""
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    # ------------------------------------------------------------------
    @property
    def params_digest(self):
        """Structural identity of (symbol, param shapes/dtypes): the
        JAX package's ``params_digest`` of the same inputs."""
        return self._params_digest

    def warmup_report(self):
        """Per-bucket outcome of the last :meth:`warmup`:
        ``{bucket: {"warmup_ms", "source"}}``; ``source`` is
        ``"deserialized"`` (the bucket's program loaded from the cache:
        no trace), ``"compiled"`` (traced with ``torch.export`` and
        committed for the next replica) or ``"eager"`` (no cache
        directory: the executor's first forward; the JAX package's
        ``"jit"``)."""
        return {b: dict(r) for b, r in
                getattr(self, "_warmup_report", {}).items()}

    def warmup(self, cache_dir=None):
        """Bring every bucket to its steady state BEFORE traffic;
        afterwards ``stats()['compiles']`` stays frozen. Returns the
        stats snapshot.

        Without a cache directory each bucket runs its first forward
        (zero rows, read back), and ``compiles`` equals the bucket count.
        ``cache_dir`` (default ``$MXNET_COMPILE_CACHE_DIR``; entries live
        in its ``aot/``) turns on the persistent executable cache
        (:mod:`mxnet_tpu_torch.serving.cache`): each bucket LOADS its
        exported program from a crc-verified entry keyed by (params
        digest, precision mode, bucket, input signature, backend) — no
        trace, no compile — or traces it with ``torch.export`` and
        commits the entry for the next replica (one compile). Either way
        the bucket then serves through that program and runs it once on
        zeros. Any key mismatch (drifted digest, other mode or backend,
        corrupt or ``.tmp-*`` entry) falls back LOUDLY to a fresh trace;
        a net the trace cannot capture raises ``MXNetError`` naming the
        node (ROADMAP A12).

        Each bucket's wall time, first run and readback included,
        publishes as a ``serving.<i>.b<bucket>.warmup_ms`` gauge (also
        ``stats()["warmup_ms"]``); hits and misses count into the serving
        scope and ``compile.cache_hits``/``cache_misses``; traces and
        first runs count into ``compile.warmup_compiles``, never the
        training ``compile.retraces`` stream."""
        from . import cache as _cache
        aot = _cache.aot_dir(cache_dir)
        store = None
        if aot is not None:
            bad = _cache.untraceable_node(self._base._exec_group.symbol)
            if bad is not None:
                raise MXNetError(
                    "warmup(cache_dir=): node %r (%s) cannot be traced "
                    "into a cached program: %s (ROADMAP A12); warm up "
                    "without a cache directory" % bad)
            if not getattr(self._base._exec_group, "fused", False):
                raise MXNetError(
                    "warmup(cache_dir=) traces the fused route's eval "
                    "forward; this module runs the classic per-executor "
                    "route (_allow_fused=False / MXNET_MODULE_FUSED=0); "
                    "warm up without a cache directory")
            store = _cache.ExecutableCache(aot)
        else:
            self._programs.clear()      # the executor serves again
        watch = telemetry.compile_watch()
        for m in self._modules.values():
            watch.attach(m)
        report = {}
        with self._lock, watch.warmup_scope():
            for b in self._buckets:
                t0 = time.perf_counter()
                source = self._warm_bucket(b, store, watch) \
                    if store is not None else None
                zeros = {name: onp.zeros((b,) + shape[1:], onp.float32)
                         for name, shape in self._data_descs}
                self._run_bucket(b, zeros, b, warmup=True)
                if b in self._programs:
                    # the first run checked the inputs against the traced
                    # shapes; traffic builds them by the same rule
                    self._programs[b].validate_inputs = False
                ms = (time.perf_counter() - t0) * 1000.0
                self._stats.note_warmup_bucket(b, ms, source)
                report[b] = {"warmup_ms": round(ms, 3),
                             "source": source or "eager"}
        self._warmup_report = report
        return self.stats()

    def _bucket_cache_key(self, grp, bucket):
        """The executable-cache key of ``bucket``'s program."""
        from . import cache as _cache
        backend = _cache.backend_signature(grp.contexts[0].torch_device())
        input_sig = "%s;%s" % (_cache.input_signature(self._data_descs),
                               self._policy_sig)
        if self._calibration is not None:
            # two calibrations of one net have other static scales, which
            # the trace makes constants of the program: the table's digest
            # keeps their entries apart
            input_sig += ";calib=%s" % self._calibration.digest()
        return _cache.cache_key(self._params_digest,
                                grp.precision_mode_name(), bucket, input_sig,
                                backend)

    def _program_args(self, grp, inputs):
        """The exported program's positional tensors: the (shared)
        parameters in ``param_names`` order, the aux states, then the
        group's inputs (``inputs`` by name, the bound arrays for the
        rest, e.g. labels)."""
        ex = grp.execs[0]
        return tuple(ex.arg_dict[n]._read() for n in grp.param_names) + \
            tuple(a._read() for a in ex.aux_arrays) + \
            tuple(inputs[n] if n in inputs else ex.arg_dict[n]._read()
                  for n in grp._input_names)

    def _trace_bucket(self, grp, bucket):
        """Trace ``bucket``'s eval forward (``grp._forward_only``, the
        executor's own forward) into an exported program."""
        from . import cache as _cache
        pnames, inames = list(grp.param_names), list(grp._input_names)
        n_p, n_aux = len(pnames), len(grp.execs[0].aux_arrays)
        last = [None]

        def tap(name, _value):
            last[0] = name

        def forward(*flat):
            outs, _ = grp._forward_only(
                dict(zip(pnames, flat[:n_p])), list(flat[n_p:n_p + n_aux]),
                dict(zip(inames, flat[n_p + n_aux:])), False, tap=tap)
            return outs

        def where():
            ops = [n.name for n in grp.execs[0]._symbol._topo()
                   if n.op is not None]
            if last[0] is None:
                return "node %r" % ops[0] if ops else ""
            done = last[0].rsplit("_output", 1)[0]
            i = ops.index(done) + 1 if done in ops else len(ops)
            return "node %r" % ops[i] if i < len(ops) else \
                "the outputs"

        zeros = {name: torch.zeros((bucket,) + tuple(shape[1:]),
                                   device=grp.contexts[0].torch_device())
                 for name, shape in self._data_descs}
        return _cache.export_program(
            forward, self._program_args(grp, zeros),
            "the serving bucket %d's eval forward" % bucket, where)

    def _warm_bucket(self, bucket, store, watch):
        """Load-or-trace one bucket's program through the executable
        cache and install it: ``"deserialized"`` (loaded) or
        ``"compiled"`` (traced now, entry committed)."""
        from . import cache as _cache
        grp = self._modules[bucket]._exec_group
        key = self._bucket_cache_key(grp, bucket)
        program, source = None, "compiled"
        try:
            program = _cache.load_program(store.load(key))
            source = "deserialized"
        except _cache.CacheMiss as e:
            log = self.logger.info if e.reason == "absent" \
                else self.logger.warning
            log("serving bucket %d: executable cache %s: tracing afresh "
                "(%s)", bucket, e.reason, e.detail or store.path_for(key))
        except Exception as e:  # noqa: BLE001 - any load failure
            self.logger.warning(
                "serving bucket %d: cached program failed to load (%s): "
                "tracing afresh", bucket, e)
        if program is None:
            ep = self._trace_bucket(grp, bucket)
            self._stats.note_compile()
            watch.note_program("serving.b%d.fwd_eval" % bucket,
                               {n: (bucket,) + tuple(s[1:])
                                for n, s in self._data_descs})
            store.store(key, _cache.program_bytes(ep))
            program = _cache.program_module(ep)
        if source == "deserialized":
            watch.note_cache_hit()
        else:
            watch.note_cache_miss()
        self._programs[bucket] = program
        # the program's first run is part of warmup, not a compile
        self._launched.add(bucket)
        return source

    def release(self):
        """Drop this Predictor's ``serving.<i>`` registry scope (see
        :meth:`ServingStats.release`) — call when discarding a
        Predictor in a long-lived multi-tenant process."""
        self._stats.release()

    def predict(self, data):
        """Serve one request synchronously (no batching): pad to the
        bucket, launch, slice. Returns a single numpy array for
        single-output nets, else a list in ``output_names`` order.
        Thread-safe; for concurrent callers prefer a
        :class:`DynamicBatcher`, which coalesces them into fewer,
        fuller launches."""
        tracing = telemetry.enabled()
        arrays, rows = self._normalize(data)
        t0 = time.perf_counter()
        self._stats.note_request()
        timing = {} if tracing else None
        outs = self._predict_rows(arrays, rows, timing=timing)
        t1 = time.perf_counter()
        self._stats.note_completed((t1 - t0) * 1000.0)
        if tracing:
            # direct path: no queue, no coalescing — the trace is pad +
            # device + the residual dispatch/slice overhead
            self._stats.note_trace(
                self._stats.new_request_id(), rows,
                self.bucket_for(rows), {
                    "pad_ms": timing.get("pad_ms", 0.0),
                    "device_ms": timing.get("device_ms", 0.0),
                    "resolve_ms": max(
                        (t1 - t0) * 1000.0 - timing.get("pad_ms", 0.0)
                        - timing.get("device_ms", 0.0), 0.0)})
        return outs[0] if len(outs) == 1 else outs

    def _predict_rows(self, arrays, rows, timing=None):
        """Serve ``rows`` normalized rows; always returns the list of
        per-output numpy arrays. The batcher calls this directly (it
        does its own request accounting). ``timing`` (a dict) receives
        accumulated ``pad_ms`` / ``device_ms`` clocks for the request
        trace — chunked oversized requests accumulate across launches."""
        from .. import faults as _faults
        if _faults.armed():
            # device-slowdown seam (kind=delay): a straggling or
            # throttled device; the latency lands in the device_ms phase
            # and the SLO burn windows, the rows unchanged
            _faults.check("serving.device", rows=rows)
        parts = []
        with self._lock:
            start = 0
            while start < rows:
                take = min(rows - start, self._buckets[-1])
                chunk = {k: v[start:start + take]
                         for k, v in arrays.items()} if (start or
                                                         take < rows) \
                    else arrays
                parts.append(self._run_bucket(self.bucket_for(take),
                                              chunk, take,
                                              timing=timing))
                start += take
        if len(parts) == 1:
            return parts[0]
        return [onp.concatenate([p[i] for p in parts])
                for i in range(len(parts[0]))]

    def _run_bucket(self, bucket, arrays, rows, warmup=False,
                    timing=None):
        """One device launch at ``bucket``: zero-pad the request rows
        up to the bucket's bound shape (``pad_batch_rows``), run the
        bucket's module, and read back only the real rows."""
        mod = self._modules[bucket]
        t_pad = time.perf_counter() if timing is not None else 0.0
        batch = DataBatch(
            data=[pad_batch_rows(arrays[name], bucket)
                  for name, _ in self._data_descs],
            label=None, pad=bucket - rows)
        if timing is not None:
            t0 = time.perf_counter()
            timing["pad_ms"] = timing.get("pad_ms", 0.0) \
                + (t0 - t_pad) * 1000.0
        program = self._programs.get(bucket)
        with telemetry.span("serving.launch", bucket=bucket, rows=rows):
            if program is None:
                mod.forward(batch, is_train=False)
                outs = [o[:rows].asnumpy() for o in mod.get_outputs()]
            else:
                outs = self._run_program(mod._exec_group, program, batch,
                                         rows)
        if timing is not None:
            timing["device_ms"] = timing.get("device_ms", 0.0) \
                + (time.perf_counter() - t0) * 1000.0
        if bucket not in self._launched:
            self._launched.add(bucket)
            self._stats.note_compile()
        self._stats.note_batch(bucket, rows, warmup=warmup)
        return outs

    def _run_program(self, grp, program, batch, rows):
        """One launch through a bucket's exported program: the padded
        rows go to the device as the group's staging does, the program
        reads the shared parameter tensors, and only the real rows come
        back."""
        dev = grp.contexts[0].torch_device()
        inputs = {}
        for (name, _), v in zip(self._data_descs, batch.data):
            if hasattr(v, "_read"):
                v = v._read()
            inputs[name] = v.to(dev) if isinstance(v, torch.Tensor) \
                else torch.from_numpy(onp.ascontiguousarray(v)).to(dev)
        with torch.no_grad():
            outs = program(*self._program_args(grp, inputs))
        return [o[:rows].cpu().numpy() for o in outs]
