"""BaseModule (PyTorch counterpart of ``mxnet_tpu/module/base_module.py``)
— the canonical train, score and predict loops.

``fit`` is the JAX package's loop: bind, init_params, init_optimizer,
then per batch forward_backward, update, update_metric and the batch-end
callbacks; at each epoch's end it logs the training metric, syncs the
parameters (get_params + set_params), calls the epoch-end callbacks and
scores ``eval_data``. On the fused route the training metric rides the
device tally (``_install_device_metric``: no per-batch readback) and
``batch_group=K`` trains K batches per grouped step. ``resume_from=``
restarts an interrupted run from a checkpoint entry (parameters,
optimizer states, RNG state; a step-granular entry re-enters its epoch
past the batches it trained), ``monitor=`` taps the op outputs of every
``interval``-th batch, and ``prefetch_to_device=N`` trains through a
``data.DeviceLoader``. Each epoch pins the iterator's epoch coordinate
(``set_epoch``), and ``fit`` adopts the iterator's
``device_augment_spec``. On top, as in the JAX package: the training
guardian (``guardian=``, rollback-and-skip), the ``module.step`` fault
seam, and with telemetry enabled the step timeline, the compile watch,
the live roofline, the regression watchdog and the flight recorder's
dump on failure.
"""
from __future__ import annotations

import logging
import os
import time
from collections import namedtuple

import numpy as onp
import torch

from .. import context as ctx_mod
from .. import faults as _faults
from .. import metric as metric_mod
from .. import ndarray as nd
from ..initializer import Uniform

__all__ = ["BaseModule", "BatchEndParam", "pad_batch_rows",
           "stack_group_inputs"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def pad_batch_rows(arr, target_rows):
    """Zero-pad ``arr`` (NDArray, numpy array or tensor) along axis 0
    up to ``target_rows`` and return the raw padded array — the ONE
    pad rule every fixed-shape launch shares: the serving bucketer
    (``serving.Predictor``) pads a request up to its batch bucket, and
    ``Module.forward`` pads an eval batch shorter than the bound shape.
    Host arrays pad on the host; a tensor pads on its own device, so a
    tensor on the card is never read back to pad it."""
    vals = arr._read() if hasattr(arr, "_read") else arr
    n = vals.shape[0]
    if n >= target_rows:
        return vals
    if isinstance(vals, onp.ndarray):
        fill = onp.zeros((target_rows - n,) + vals.shape[1:], vals.dtype)
        return onp.concatenate([vals, fill])
    fill = vals.new_zeros((target_rows - n,) + tuple(vals.shape[1:]))
    return torch.cat([vals, fill])


def stack_group_inputs(batches, data_names, label_names):
    """K batches -> {input name: stacked (K, batch, ...) block}: every data
    input, and a label only when every batch of the group has it. The
    one pairing rule of the grouped train step and grouped predict."""
    stacked = {}
    for i, name in enumerate(data_names):
        stacked[name] = _stack_batch_arrays([b.data[i] for b in batches])
    if label_names and batches[0].label:
        for i, name in enumerate(label_names):
            if i < len(batches[0].label) and \
                    all(b.label[i] is not None for b in batches):
                stacked[name] = _stack_batch_arrays(
                    [b.label[i] for b in batches])
    return stacked


def _stack_batch_arrays(arrs):
    """K per-batch arrays -> one (K, batch, ...) block: host arrays stack
    into one contiguous numpy block (one copy to the card later), tensors
    on the card stack there (never read back)."""
    vals = [a._read() if hasattr(a, "_read") else a for a in arrs]
    if all(isinstance(v, onp.ndarray) for v in vals):
        return onp.stack(vals)
    if any(isinstance(v, torch.Tensor) and v.device.type != "cpu"
           for v in vals):
        dev = next(v.device for v in vals if isinstance(v, torch.Tensor)
                   and v.device.type != "cpu")
        return torch.stack([torch.as_tensor(v).to(dev) for v in vals])
    return onp.stack([onp.asarray(v) for v in vals])


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, list) else [obj]


def _poison_batch_seam(batch, module, epoch, nbatch):
    """The ``module.step`` numeric seam (armed plans only): a fired
    ``grad_nonfinite``/``loss_spike`` rule scales the step's first
    FLOATING data input by the injected factor (NaN / the spike value) —
    the deterministic spelling of a poisoned batch the guardian must
    detect and roll past. The context carries the data coordinate
    (``epoch``/``nbatch``) and the upcoming 0-based optimizer step
    (``step``). A batch on the card scales there; integer wire batches
    (the u8 device-augment input) pass through untouched."""
    factor = _faults.poison(
        "module.step", epoch=epoch, nbatch=nbatch,
        step=int(getattr(getattr(module, "_optimizer", None),
                         "num_update", -1)))
    if factor is None:
        return batch
    from ..io import DataBatch
    data = list(batch.data)
    for i, d in enumerate(data):
        vals = d._read() if hasattr(d, "_read") else d
        if isinstance(vals, torch.Tensor):
            if vals.is_floating_point():
                data[i] = nd.NDArray(vals * factor)
                break
        elif onp.issubdtype(onp.asarray(vals).dtype, onp.floating):
            vals = onp.asarray(vals)
            data[i] = nd.NDArray(torch.from_numpy(
                vals * vals.dtype.type(factor)))
            break
    return DataBatch(data=data, label=batch.label, pad=batch.pad,
                     index=getattr(batch, "index", None))


class BaseModule(object):
    """Binding, parameter and optimizer state of a module, and the loops
    over data iterators."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._resume_skip = None    # (epoch, batches) of a mid-epoch resume

    def forward_backward(self, data_batch):
        """One training step's forward and backward."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def _eval_batches(self, eval_data, num_batch, reset):
        """Up to ``num_batch`` (index, batch) pairs of ``eval_data``."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("call bind and init_params first")
        if reset:
            eval_data.reset()
        for index, batch in enumerate(eval_data):
            if index == num_batch:
                return
            yield index, batch

    def _fire(self, callbacks, epoch, nbatch, eval_metric, caller_locals):
        if not callbacks:
            return
        event = BatchEndParam(epoch=epoch, nbatch=nbatch,
                              eval_metric=eval_metric, locals=caller_locals)
        for callback in _as_list(callbacks):
            callback(event)

    def _unpadded_outputs(self, batch, copy=False):
        """The outputs without the rows the iterator padded the batch
        with, nor those ``forward`` added to reach the bound shape."""
        pad = (batch.pad or 0) + getattr(self, "_eval_pad_extra", 0)
        keep = slice(None) if not pad else slice(0, -pad)
        outs = [out[keep] for out in self.get_outputs()]
        return [o.copy() for o in outs] if copy else outs

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate on a data iterator; returns the metric's (name, value)
        pairs. As in the JAX package, a padded last batch is scored whole,
        padded rows included."""
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        seen = 0
        for index, batch in self._eval_batches(eval_data, num_batch, reset):
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            self._fire(batch_end_callback, epoch, index, eval_metric,
                       locals())
            seen = index + 1
        if score_end_callback:
            self._fire(score_end_callback, epoch, seen, eval_metric,
                       locals())
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield (outputs without padded rows, index, batch) per batch."""
        for index, batch in self._eval_batches(eval_data, num_batch, reset):
            self.forward(batch, is_train=False)
            yield (self._unpadded_outputs(batch), index, batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, batch_group=None):
        """Forward over an iterator, collecting the outputs without padded
        rows: merged along the batch axis, or one list per batch.

        ``batch_group=K`` (fused route) stages K batches with one copy per
        input and runs their forwards in one call
        (``MeshExecutorGroup.score_stacked``); the outputs equal the
        per-batch loop's. On the classic route it warns and runs per
        batch."""
        if batch_group and batch_group > 1:
            if getattr(self._exec_group, "fused", False):
                if not (self.binded and self.params_initialized):
                    raise RuntimeError("call bind and init_params first")
                if reset:
                    eval_data.reset()
                return self._merge_outputs(
                    self._predict_grouped(eval_data, num_batch,
                                          batch_group),
                    merge_batches, always_output_list)
            self.logger.warning(
                "predict(batch_group=%d) needs the fused route; scoring "
                "per batch", batch_group)
        collected = []
        for _index, batch in self._eval_batches(eval_data, num_batch, reset):
            self.forward(batch, is_train=False)
            collected.append(self._unpadded_outputs(batch, copy=True))
        return self._merge_outputs(collected, merge_batches,
                                   always_output_list)

    @staticmethod
    def _merge_outputs(collected, merge_batches, always_output_list):
        if not collected or not merge_batches:
            return collected
        num_outputs = len(collected[0])
        if any(len(out) != num_outputs for out in collected):
            raise ValueError("Cannot merge batches, as num of outputs is not "
                             "the same in mini-batches")
        merged = [nd.concatenate([out[i] for out in collected])
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def _predict_grouped(self, eval_data, num_batch, batch_group):
        """K batches per grouped eval call; a batch whose shape or inputs
        differ from the open group's (the ragged tail) flushes it first.
        Labels the iterator provides are staged, as per batch."""
        group = self._exec_group
        data_names = [d[0] for d in group.data_shapes]
        label_names = group._label_names
        collected, chunk, pads = [], [], []
        chunk_names = None

        def flush():
            if not chunk:
                return
            stacked = {name: _stack_batch_arrays([b[i] for b in chunk])
                       for i, name in enumerate(chunk_names)}
            outs = group.score_stacked(stacked)
            for k, pad in enumerate(pads):
                collected.append([
                    nd.NDArray(o[k][:o.shape[1] - pad].clone(),
                               ctx=group.contexts[0]) for o in outs])
            del chunk[:]
            del pads[:]

        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            arrs = list(batch.data)
            names = list(data_names)
            if label_names and batch.label:
                for name, lb in zip(label_names, batch.label):
                    if lb is not None:
                        arrs.append(lb)
                        names.append(name)
            if chunk and (names != chunk_names or
                          tuple(arrs[0].shape) != tuple(chunk[0][0].shape)):
                flush()
            if tuple(arrs[0].shape)[:1] != (group.batch_size,):
                # a batch of another size takes the per-batch path
                self.forward(batch, is_train=False)
                collected.append(self._unpadded_outputs(batch, copy=True))
                continue
            chunk_names = names
            chunk.append(arrs)
            pads.append(batch.pad or 0)
            if len(chunk) == batch_group:
                flush()
        flush()
        return collected

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, resume_from=None, batch_group=None,
            prefetch_to_device=None, guardian=None):
        """Train on a data iterator for epochs ``begin_epoch`` up to
        ``num_epoch``.

        ``resume_from`` (a ``CheckpointManager``, its directory, or a
        restored ``Checkpoint``) restores the latest committed entry's
        parameters, optimizer states and RNG state after init and
        continues at the epoch after it; a manager with no entry starts
        fresh. ``monitor`` (a ``Monitor``) is installed and ticked around
        every batch.

        ``batch_group=K`` (fused route) trains K batches per grouped step
        (``MeshExecutorGroup.step_update_grouped``): K iterator batches
        stack into one host block per input, staged with one copy, and
        run as K whole steps in one call; parameters, optimizer state, lr
        schedule and metric equal per-batch training bit for bit.
        ``batch_end_callback`` fires once per group with ``nbatch`` the
        index of the group's last batch (``Speedometer`` counts the
        stride), and the epoch tail forms a smaller last group. It needs
        an optimizer with a pure apply, a metric with a device statistic
        and no monitor; otherwise fit warns and trains per batch.
        ``prefetch_to_device=N`` (``True`` means depth 2) wraps
        ``train_data`` in a ``data.DeviceLoader``: a background stager
        keeps a ring of N batches already on the card (pinned copies on a
        side stream), so host decode, the copy and the step overlap;
        composed with ``batch_group=K`` it stages whole K-blocks. The
        trained parameters equal an unprefetched run's bit for bit, the
        epoch log reports the epoch's host-wait, and the caller's
        iterator stays usable after ``fit``. A train iterator with a
        ``device_augment_spec`` (``data.DeviceAugmentIter``,
        ``CachedDataset``, ``ImageRecordIter(device_augment="defer")``)
        has it adopted before the bind.

        ``guardian=`` (a ``guardian.Guardian``, a checkpoint directory
        or ``CheckpointManager``, or ``MXNET_GUARDIAN=1`` +
        ``MXNET_GUARDIAN_DIR``) arms the training guardian: the fused
        step threads a numeric-health word on the card (no readback on
        the step path), polled at each epoch boundary; a non-finite
        loss, gradient or parameter, a loss spike or an SDC probe
        mismatch rolls back to the newest verifiable entry before the
        poisoned batch and replays the deterministic stream without it,
        within the guardian's ``max_rollbacks``. None (the default) runs
        the step it always ran."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        aug_spec = getattr(train_data, "device_augment_spec", None)
        if aug_spec and not self.binded and \
                getattr(self, "_device_augment", None) == {}:
            self._device_augment = dict(aug_spec)
        # a sharded iterator reports the global batch; each rank binds
        # its own rows (the rank's block, the reference's per-worker
        # batch) and the step's all-reduce makes the global batch
        self.bind(data_shapes=getattr(train_data, "local_provide_data",
                                      None) or train_data.provide_data,
                  label_shapes=getattr(train_data, "local_provide_label",
                                       None) or train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        # never inherit a previous fit's mid-epoch skip marker
        self._resume_skip = None
        if resume_from is not None:
            begin_epoch = self._resume_from(resume_from, begin_epoch)
        from .. import guardian as guardian_mod
        guardian = guardian_mod.resolve(guardian)
        if guardian is not None and not guardian.arm(self, begin_epoch):
            guardian = None     # cannot carry the sentinel; unguarded
        if validation_metric is None:
            validation_metric = eval_metric
        validation_metric = metric_mod.create(validation_metric)
        eval_metric = metric_mod.create(eval_metric)
        # the fused route tallies the training metric on the device
        self._install_device_metric(eval_metric)
        group_k = int(batch_group) if batch_group else 0
        if group_k > 1 and (monitor is not None or
                            not self._fit_grouped_ready(eval_metric)):
            self.logger.warning(
                "fit(batch_group=%d) needs the fused route with an "
                "optimizer that has a pure apply and a metric with a "
                "device statistic (and no monitor); training per batch",
                group_k)
            group_k = 0

        loader = None
        if prefetch_to_device:
            # created after the bind: the loader stages onto the bound
            # group's device and through its stage_stacked
            from ..data import DeviceLoader
            depth = 2 if prefetch_to_device is True \
                else int(prefetch_to_device)
            loader = DeviceLoader(
                train_data, module=self, depth=depth,
                batch_group=group_k if group_k > 1 else None)
            train_data = loader
        try:
            self._fit_epochs(train_data, eval_data, eval_metric,
                             validation_metric, begin_epoch, num_epoch,
                             group_k, monitor, batch_end_callback,
                             epoch_end_callback, eval_end_callback,
                             eval_batch_end_callback, guardian)
        finally:
            if loader is not None:
                loader.close()
            if guardian is not None:
                guardian.disarm()
        # dist_async holds each key's last reduction in flight: apply it
        # before fit returns (the store's barrier drains it)
        kv = getattr(self, "_kvstore", None)
        if kv is not None and kv.type == "dist_async":
            kv.barrier()

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, begin_epoch, num_epoch, group_k,
                    monitor, batch_end_callback, epoch_end_callback,
                    eval_end_callback, eval_batch_end_callback,
                    guardian=None):
        """The epoch loop of ``fit``, bracketed by its telemetry.

        With telemetry enabled every step writes one ``StepTimeline``
        record (host-wait, step, metric + callback and checkpoint
        clocks, the new-program flag) and one ``"step"`` JSONL line, a
        ``CompileWatch`` attaches to the executor group with the warmup
        boundary after the FIRST healthy epoch of this fit, the live
        roofline and the regression watchdog start at that boundary,
        and epochs are bracketed in trace spans. All clocks are the
        host's: nothing is read back from the card and no RNG is
        touched, so the trained parameters are those of a telemetry-off
        run bit for bit. The device-feed loader's ``PipelineStats`` is
        published (``telemetry.set_active_pipeline``) for the whole fit,
        enabled or not. An exception escaping the loop commits the
        flight recorder's postmortem first, when it is armed."""
        from .. import telemetry
        pipe_stats = getattr(train_data, "pipeline_stats", None)
        wait_seen = pipe_stats.snapshot()["host_wait_ms"] \
            if pipe_stats is not None else 0.0
        tl = watch = None
        if telemetry.enabled():
            tl = telemetry.timeline()
            watch = telemetry.compile_watch()
            watch.attach(self)
        telemetry.set_active_pipeline(pipe_stats)
        try:
            self._fit_epochs_inner(
                train_data, eval_data, eval_metric, validation_metric,
                begin_epoch, num_epoch, group_k, monitor,
                batch_end_callback, epoch_end_callback, eval_end_callback,
                eval_batch_end_callback, pipe_stats, wait_seen, tl, watch,
                guardian)
        except BaseException as exc:
            recorder = telemetry.flight_recorder()
            if recorder.armed:
                try:
                    recorder.dump("fit: %s: %s" % (type(exc).__name__,
                                                   exc))
                except Exception:  # noqa: BLE001 - never mask the fault
                    self.logger.exception("flight-recorder dump failed")
            raise
        finally:
            telemetry.set_active_pipeline(None)
            if watch is not None:
                # a later fit's first epoch may legitimately run new
                # programs
                watch.reset_warmup()

    def _fit_epochs_inner(self, train_data, eval_data, eval_metric,
                          validation_metric, begin_epoch, num_epoch,
                          group_k, monitor, batch_end_callback,
                          epoch_end_callback, eval_end_callback,
                          eval_batch_end_callback, pipe_stats, wait_seen,
                          tl, watch, guardian=None):
        from .. import telemetry
        roof = {}   # the live roofline's basis and gauges, at warmup end
        wd = None   # the regression watchdog, armed at the same boundary
        # a while loop, not a range: the guardian's rollback re-enters an
        # EARLIER epoch; "warmed" marks the first healthy epoch's end
        warmed = False
        epoch = begin_epoch
        while epoch < num_epoch:
            tic = time.time()
            eval_metric.reset()
            if hasattr(train_data, "set_epoch"):
                # pin the iterator's epoch coordinate to the true epoch: a
                # resumed run replays the stream the uninterrupted one saw
                train_data.set_epoch(epoch)
            skip = 0
            if self._resume_skip and self._resume_skip[0] == epoch:
                # a step-granular entry: its first `skip` batches of this
                # epoch already trained; pull and discard them
                skip = self._resume_skip[1]
                self._resume_skip = None
            if guardian is not None:
                guardian.begin_epoch(self, epoch)
            with telemetry.span("fit.epoch", epoch=epoch):
                if group_k > 1:
                    mid_verdict = self._fit_epoch_grouped(
                        train_data, epoch, group_k, eval_metric,
                        batch_end_callback, tl, watch, skip, roof, guardian)
                else:
                    mid_verdict = self._fit_epoch_batches(
                        train_data, epoch, eval_metric, monitor,
                        batch_end_callback, tl, watch, skip, roof, guardian)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            cost = time.time() - tic
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, cost)
            if pipe_stats is not None:
                # the epoch's slice of the cumulative host-wait clock
                snap = pipe_stats.snapshot()
                wait_ms = snap["host_wait_ms"] - wait_seen
                wait_seen = snap["host_wait_ms"]
                self.logger.info(
                    "Epoch[%d] Host-wait=%.1fms (%.1f%% of epoch, ring "
                    "high-water %d/%d)", epoch, wait_ms,
                    100.0 * wait_ms / max(cost * 1000.0, 1e-9),
                    snap["ring_high_water"], snap["ring_depth"])

            if guardian is not None:
                # the off-path judgment, BEFORE the epoch-end callbacks: a
                # poisoned epoch neither checkpoints nor evaluates; the
                # rollback re-enters a (possibly earlier) epoch with the
                # convicted batch excluded from the replayed stream
                verdict = mid_verdict if mid_verdict is not None \
                    else guardian.poll(self, epoch)
                if verdict is not None:
                    epoch = guardian.rollback(self, verdict)
                    train_data.reset()
                    continue

            arg_params, aux_params = self.get_params()
            self.set_params(arg_params, aux_params)
            if epoch_end_callback is not None:
                t_cb = time.perf_counter()
                with telemetry.span("fit.epoch_end_callback", epoch=epoch):
                    for callback in _as_list(epoch_end_callback):
                        callback(epoch, self.symbol, arg_params, aux_params)
                if tl is not None:
                    # checkpoint staging dominates this slot: attributed
                    # to the step it delayed, and to the sink as its own
                    # event (the epoch's step lines already streamed)
                    cb_ms = (time.perf_counter() - t_cb) * 1000.0
                    tl.note_checkpoint(cb_ms)
                    telemetry.log_event(
                        "checkpoint", {"epoch": epoch,
                                       "checkpoint_ms": round(cb_ms, 3)})

            if eval_data:
                with telemetry.span("fit.eval", epoch=epoch):
                    res = self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
            if tl is not None:
                wd = self._epoch_telemetry(epoch, warmed, watch, roof, wd)
            warmed = True
            epoch += 1

    def _epoch_telemetry(self, epoch, warmed, watch, roof, wd):
        """The telemetry of one healthy epoch's end (host arithmetic and
        one readback of the loss-scale triple, never on the step path):
        at the first, the warmup boundary — the compile watch's steady
        state starts, the live roofline resolves its basis and the
        regression watchdog arms (``MXNET_TELEMETRY_WATCHDOG=0`` opts
        out; ``MXNET_TELEMETRY_BASELINE`` pins its baseline); at later
        ones the watchdog polls. Diagnostics never stop the fit. Returns
        the armed watchdog or None."""
        from .. import telemetry
        if not warmed:
            watch.mark_warmup_done()
            self._resolve_roofline(roof)
            if os.environ.get("MXNET_TELEMETRY_WATCHDOG", "1") != "0":
                try:
                    wd = telemetry.health_watchdog().arm(
                        baseline=os.environ.get(
                            "MXNET_TELEMETRY_BASELINE") or None)
                except Exception:  # noqa: BLE001 - diagnostics only
                    self.logger.exception(
                        "health watchdog failed to arm; continuing "
                        "unwatched")
                    wd = None
        elif wd is not None:
            try:
                wd.poll()
            except Exception:  # noqa: BLE001 - diagnostics only
                self.logger.exception("health watchdog poll failed")
        grp = getattr(self, "_exec_group", None)
        skips = grp.scale_skips() if hasattr(grp, "scale_skips") else None
        if skips is not None:
            # a loss-scaler skip storm, for the watchdog's absolute judge
            telemetry.registry().gauge("precision.scale_skips").set(skips)
        telemetry.flush_metrics("epoch %d" % epoch)
        return wd

    @staticmethod
    def _skip_batches(data_iter, skip):
        """Pull and discard ``skip`` batches (a step-granular resume);
        returns the last discarded ``nbatch`` (-1 for none)."""
        nbatch = -1
        for _ in range(skip):
            try:
                next(data_iter)
            except StopIteration:
                break
            nbatch += 1
        return nbatch

    def _fit_epoch_batches(self, train_data, epoch, eval_metric, monitor,
                           batch_end_callback, tl, watch, skip, roof,
                           guardian):
        """One epoch, one step a batch. Returns a guardian verdict taken
        at a window boundary inside the epoch, or None."""
        from .. import telemetry
        data_iter = iter(train_data)
        nbatch = self._skip_batches(data_iter, skip)
        while True:
            t0 = time.perf_counter() if tl is not None else 0.0
            try:
                data_batch = next(data_iter)
            except StopIteration:
                return None
            nbatch += 1
            if guardian is not None and guardian.should_skip(epoch, nbatch):
                # a convicted coordinate: pulled and DISCARDED, so the
                # stream position advances and the batch never trains
                guardian.note_skipped(epoch, nbatch)
                continue
            if _faults.armed():
                data_batch = _poison_batch_seam(data_batch, self, epoch,
                                                nbatch)
            t1 = time.perf_counter() if tl is not None else 0.0
            n_new = watch.count if watch is not None else 0
            if monitor is not None:
                monitor.tic()
            self.forward_backward(data_batch)
            self.update()
            if guardian is not None:
                guardian.note_step(epoch, nbatch)
            t2 = time.perf_counter() if tl is not None else 0.0
            self.update_metric(eval_metric, data_batch.label)
            if monitor is not None:
                monitor.toc_print()
            try:
                self._fire(batch_end_callback, epoch, nbatch, eval_metric,
                           locals())
            finally:
                # written even when a callback raises: the FAILING step
                # is the flight-recorder postmortem's last record
                if tl is not None:
                    rec = tl.record(
                        epoch, nbatch, host_wait_ms=(t1 - t0) * 1000.0,
                        step_ms=(t2 - t1) * 1000.0,
                        metric_cb_ms=(time.perf_counter() - t2) * 1000.0,
                        recompile=watch.count > n_new)
                    self._roofline_note(rec, roof)
                    telemetry.log_event("step", rec)
            if guardian is not None:
                # a full ring since the last bracket is judged NOW,
                # before a spike scrolls out of it
                verdict = guardian.maybe_poll_window(self, epoch)
                if verdict is not None:
                    return verdict

    def _fit_epoch_grouped(self, train_data, epoch, group_k, eval_metric,
                           batch_end_callback, tl=None, watch=None, skip=0,
                           roof=None, guardian=None):
        """One epoch of K batches per grouped step. A batch whose data or
        label shapes differ from the open group's flushes it first; the
        epoch tail forms its own smaller group, and so does a group a
        convicted batch left one short. With telemetry each GROUP writes
        one step record. Returns a guardian verdict taken at a group
        boundary, or None."""
        from .. import telemetry
        group, members = [], []     # the batches and their nbatch
        wait_s = [0.0]              # host-wait over the open group

        def flush(last_nbatch, caller_locals):
            t1 = time.perf_counter() if tl is not None else 0.0
            n_new = watch.count if watch is not None else 0
            if guardian is not None:
                # ordinal -> nbatch bookkeeping: the grouped step counts
                # each of its K steps
                for nb in members:
                    guardian.note_step(epoch, nb)
            if self._grouped_step(group):
                t2 = time.perf_counter() if tl is not None else 0.0
                # the group's statistics are already in the device
                # tally; this consumes the step's flag
                self.update_metric(eval_metric, group[-1].label)
            else:
                for b in group:
                    self.forward_backward(b)
                    self.update()
                    self.update_metric(eval_metric, b.label)
                t2 = time.perf_counter() if tl is not None else 0.0
            try:
                self._fire(batch_end_callback, epoch, last_nbatch,
                           eval_metric, caller_locals)
            finally:
                if tl is not None:
                    rec = tl.record(
                        epoch, last_nbatch,
                        host_wait_ms=wait_s[0] * 1000.0,
                        step_ms=(t2 - t1) * 1000.0,
                        metric_cb_ms=(time.perf_counter() - t2) * 1000.0,
                        batch_group=len(group),
                        recompile=watch.count > n_new)
                    self._roofline_note(rec, roof)
                    telemetry.log_event("step", rec)
            wait_s[0] = 0.0
            del group[:]
            del members[:]

        def signature(b):
            sig = [tuple(d.shape) for d in b.data]
            sig.extend(None if lb is None else tuple(lb.shape)
                       for lb in (b.label or []))
            return sig

        data_iter = iter(train_data)
        nbatch = self._skip_batches(data_iter, skip)
        open_sig = None
        while True:
            t0 = time.perf_counter() if tl is not None else 0.0
            try:
                data_batch = next(data_iter)
            except StopIteration:
                break
            nbatch += 1
            if guardian is not None and guardian.should_skip(epoch, nbatch):
                guardian.note_skipped(epoch, nbatch)
                continue
            if _faults.armed():
                data_batch = _poison_batch_seam(data_batch, self, epoch,
                                                nbatch)
            if tl is not None:
                wait_s[0] += time.perf_counter() - t0
            sig = signature(data_batch)
            if group and sig != open_sig:
                flush(nbatch - 1, locals())
            if not group:
                open_sig = sig
            group.append(data_batch)
            members.append(nbatch)
            if len(group) == group_k:
                flush(nbatch, locals())
                if guardian is not None:
                    verdict = guardian.maybe_poll_window(self, epoch)
                    if verdict is not None:
                        return verdict
        if group:
            flush(nbatch, locals())
        return None

    def _resolve_roofline(self, roof):
        """Fill ``roof`` with the live roofline's basis (the executor
        group's counted step FLOPs and bytes and the card's peaks,
        ``MeshExecutorGroup.roofline_basis``) and the ``train.*`` gauges
        the per-step notes publish. Once, at the warmup boundary; no-op
        for groups without the introspection surface."""
        from .. import telemetry
        basis_fn = getattr(getattr(self, "_exec_group", None),
                           "roofline_basis", None)
        if basis_fn is None or roof.get("basis"):
            return
        try:
            basis = basis_fn()
        except Exception:  # noqa: BLE001 - diagnostics, never fit control
            basis = None
        if not basis:
            return
        scope = telemetry.registry().scope("train")
        roof["basis"] = basis
        roof["gauges"] = {name: scope.gauge(name) for name in (
            "mfu", "achieved_hbm_gbps", "achieved_tflops", "hbm_util",
            "bound_by")}

    @staticmethod
    def _roofline_note(rec, roof):
        """Fold the live roofline into one step record and the
        ``train.*`` gauges: the basis' per-step FLOPs and bytes (times
        the record's group size) over the record's wall clock, the JAX
        package's arithmetic. ``bound_by`` publishes as its numeric code
        (``telemetry.BOUND_BY_CODES``); the record carries the string.
        Host arithmetic only."""
        if not roof or not roof.get("basis"):
            return
        from ..telemetry.introspect import roofline
        basis = roof["basis"]
        k = max(int(rec.get("batch_group", 1)), 1)
        r = roofline(basis["flops_per_step"] * k,
                     basis["bytes_per_step"] * k,
                     max(rec["total_ms"], 1e-6) / 1000.0,
                     basis["peak_tflops"], basis["peak_hbm_gbps"],
                     host_wait_fraction=rec["host_wait_ms"]
                     / max(rec["total_ms"], 1e-9))
        rec["mfu"] = round(r["mfu"], 6)
        rec["achieved_tflops"] = round(r["achieved_tflops"], 4)
        rec["achieved_hbm_gbps"] = round(r["achieved_hbm_gbps"], 3)
        rec["bound_by"] = r["bound_by"]
        gauges = roof["gauges"]
        gauges["mfu"].set(rec["mfu"])
        gauges["achieved_hbm_gbps"].set(rec["achieved_hbm_gbps"])
        gauges["achieved_tflops"].set(rec["achieved_tflops"])
        gauges["hbm_util"].set(round(r["hbm_util"], 4))
        gauges["bound_by"].set(r["bound_by_code"])

    def _fit_grouped_ready(self, eval_metric):
        """Whether ``fit(batch_group=K)`` can run grouped steps (the
        fused Module says)."""
        return False

    def _install_device_metric(self, eval_metric):
        """Put the training metric on the device tally (the fused Module
        does; a no-op elsewhere)."""

    def _resume_from(self, resume_from, begin_epoch):
        """Restore training state from a checkpoint entry and return the
        epoch to continue at."""
        from .. import random as random_mod
        from ..checkpoint import CheckpointManager, split_params
        if isinstance(resume_from, str):
            resume_from = CheckpointManager(resume_from)
        if isinstance(resume_from, CheckpointManager):
            if resume_from.latest() is None:
                self.logger.info("resume_from: no committed checkpoint in "
                                 "%s; starting fresh", resume_from.directory)
                return begin_epoch
            ckpt = resume_from.restore()
        else:
            ckpt = resume_from
        cpu = ctx_mod.cpu()
        arg_np, aux_np = split_params(ckpt.params)
        self.set_params(
            {k: nd.array(v, ctx=cpu, dtype=v.dtype) for k, v in arg_np.items()},
            {k: nd.array(v, ctx=cpu, dtype=v.dtype) for k, v in aux_np.items()})
        if ckpt.optimizer_state is not None:
            self.load_optimizer_states(ckpt.optimizer_state)
        if ckpt.rng is not None:
            random_mod.set_state(ckpt.rng)
        epoch = int(ckpt.extra.get("epoch", ckpt.step))
        nbatch = ckpt.extra.get("nbatch")
        if nbatch is not None:
            # a step-granular entry (``save_checkpoint(extra={"epoch": e,
            # "nbatch": b})``): re-enter its epoch past the batches it
            # trained; fit pins the iterator's epoch, so the stream
            # replays and the trajectory is the uninterrupted one
            self._resume_skip = (epoch, int(nbatch) + 1)
            self.logger.info(
                "resumed from checkpoint step %d (continuing at epoch %d, "
                "skipping %d trained batch(es))", ckpt.step, epoch,
                int(nbatch) + 1)
            return epoch
        self.logger.info("resumed from checkpoint step %d (continuing at "
                         "epoch %d)", ckpt.step, epoch + 1)
        return epoch + 1

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        """Copy the given parameters in (the initializer is not used)."""
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        """Write the parameters as a legacy flat ``.params`` file."""
        from ..checkpoint import save_params_file
        arg_params, aux_params = self.get_params()
        save_params_file(fname, arg_params, aux_params)

    def load_params(self, fname):
        """Set the parameters from a legacy flat ``.params`` file."""
        from ..checkpoint import load_params_file
        arg_params, aux_params = load_params_file(fname, ctx=ctx_mod.cpu())
        self.set_params(arg_params, aux_params)

    @property
    def symbol(self):
        return self._symbol

    # -- the abstract interface: every concrete module defines these (the
    # JAX package's and MXNet 0.9.5's BaseModule raise the same way) -----
    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()
