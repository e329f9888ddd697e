"""BaseModule (PyTorch counterpart of ``mxnet_tpu/module/base_module.py``)
— the canonical train, score and predict loops.

``fit`` is the JAX package's classic loop: bind, init_params,
init_optimizer, then per batch forward_backward, update, update_metric
and the batch-end callbacks; at each epoch's end it logs the training
metric, syncs the parameters (get_params + set_params), calls the
epoch-end callbacks and scores ``eval_data``. ``resume_from=`` restarts
an interrupted run from a checkpoint entry (parameters, optimizer
states, RNG state), and ``monitor=`` taps the op outputs of every
``interval``-th batch. What else the JAX ``fit`` layers on top
(telemetry, the training guardian, ``batch_group``, device prefetch, the
device-side metric tally, step-granular resume) comes with later slices:
those arguments are accepted at None and refused otherwise.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

import numpy as onp
import torch

from .. import context as ctx_mod
from .. import metric as metric_mod
from .. import ndarray as nd
from ..base import MXNetError
from ..initializer import Uniform

__all__ = ["BaseModule", "BatchEndParam", "pad_batch_rows"]

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


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, list) else [obj]


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
                reset=True, always_output_list=False):
        """Forward over an iterator, collecting the outputs without padded
        rows: merged along the batch axis, or one list per batch."""
        collected = []
        for _index, batch in self._eval_batches(eval_data, num_batch, reset):
            self.forward(batch, is_train=False)
            collected.append(self._unpadded_outputs(batch, copy=True))
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
        every batch. ``batch_group``, ``prefetch_to_device`` and
        ``guardian`` come with later slices of the port and must be
        None."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        for name, value, where in (
                ("batch_group", batch_group, "the grouped-step slice"),
                ("prefetch_to_device", prefetch_to_device,
                 "the device-feed slice (mxnet_tpu/data)"),
                ("guardian", guardian,
                 "the guardian slice (mxnet_tpu/guardian)")):
            if value is not None:
                raise MXNetError("fit(%s=%r) comes with %s of the port"
                                 % (name, value, where))
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if resume_from is not None:
            begin_epoch = self._resume_from(resume_from, begin_epoch)
        if validation_metric is None:
            validation_metric = eval_metric
        validation_metric = metric_mod.create(validation_metric)
        eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                self._fire(batch_end_callback, epoch, nbatch, eval_metric,
                           locals())
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)

            arg_params, aux_params = self.get_params()
            self.set_params(arg_params, aux_params)
            for callback in _as_list(epoch_end_callback):
                callback(epoch, self.symbol, arg_params, aux_params)

            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

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
        if ckpt.extra.get("nbatch") is not None:
            raise MXNetError(
                "checkpoint step %d is step-granular (nbatch=%s, written by "
                "ElasticTrainer); resuming inside an epoch comes with the "
                "dist slice of the port" % (ckpt.step, ckpt.extra["nbatch"]))
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
