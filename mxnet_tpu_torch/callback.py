"""Training callbacks (PyTorch counterpart of ``mxnet_tpu/callback.py``).

- epoch callbacks ``f(epoch, symbol, arg_params, aux_params)``, called by
  ``Module.fit`` after each epoch (checkpointing);
- batch callbacks ``f(BatchEndParam)``, called after every batch
  (throughput and metric logging).

The card runs asynchronously: a callback that looks only at
``param.nbatch`` measures how fast the host enqueues work. Reading
``param.eval_metric`` reads the batch's outputs back, which waits for the
card, so ``Speedometer`` with a metric attached measures the card. When
``fit`` trains through a ``data.DeviceLoader`` (``prefetch_to_device=``),
each ``Speedometer`` line also carries the window's host-wait share.
"""
from __future__ import annotations

import logging
import math
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix=None, period=1,
                      save_optimizer_states=False, manager=None,
                      async_save=True):
    """Epoch callback: save ``mod`` every ``period`` epochs as
    ``prefix-%04d.params`` (+ ``.states``), and/or, with ``manager=`` (a
    ``CheckpointManager``), as a step entry numbered by the 0-based epoch
    just completed — what ``fit(resume_from=manager)`` continues after.
    Raises ``ValueError`` with neither a prefix nor a manager."""
    if prefix is None and manager is None:
        raise ValueError("module_checkpoint needs a prefix or a manager")
    period = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        epoch = iter_no + 1
        if epoch % period == 0:
            if manager is not None:
                mod.save_checkpoint(prefix, iter_no, save_optimizer_states,
                                    manager=manager, async_save=async_save)
            if prefix is not None:
                mod.save_checkpoint(prefix, epoch, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch callback: save the passed symbol and params every ``period``
    epochs (the FeedForward-era twin of :func:`module_checkpoint`)."""
    from .model import save_checkpoint
    period = max(1, int(period))

    def _callback(iter_no, sym, arg, aux):
        epoch = iter_no + 1
        if epoch % period == 0:
            save_checkpoint(prefix, epoch, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch callback: log the training metric every ``period`` batches,
    optionally resetting it afterwards."""

    def _callback(param):
        metric = param.eval_metric
        if metric is None or param.nbatch % period != 0:
            return
        for name, value in metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            metric.reset()

    return _callback


class Speedometer(object):
    """Batch callback: log samples/sec (and the training metric, if one is
    attached, which it then resets) every ``frequent`` batches. The window
    restarts at every epoch boundary (``nbatch`` not increasing). When fit
    trains through a device-feed loader (``telemetry.active_pipeline()``),
    each line also gives the window's host-wait share: the part of its
    wall time the loop spent blocked on the input path."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._tic = None
        self._last_count = 0
        self._seen = 0
        self._wait_seen = None

    @staticmethod
    def _host_wait_ms():
        from . import telemetry
        stats = telemetry.active_pipeline()
        return None if stats is None else stats.snapshot()["host_wait_ms"]

    def __call__(self, param):
        count = param.nbatch
        if count <= self._last_count:
            self._tic = None    # new epoch: restart the timing window
            self._seen = 0
        delta = count - self._last_count
        self._last_count = count
        if self._tic is None:
            self._tic = time.time()
            self._seen = 0
            self._wait_seen = self._host_wait_ms()
            return
        self._seen += delta
        if self._seen < self.frequent:
            return
        elapsed = time.time() - self._tic
        speed = self._seen * self.batch_size / elapsed
        wait_txt = ""
        wait_now = self._host_wait_ms()
        if wait_now is not None and self._wait_seen is not None:
            wait_txt = "\thost-wait=%.1f%%" % (
                100.0 * (wait_now - self._wait_seen)
                / max(elapsed * 1000.0, 1e-9))
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            metric.reset()
            for name, value in pairs:
                logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                             "\tTrain-%s=%f%s", param.epoch, count, speed,
                             name, value, wait_txt)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, count, speed, wait_txt)
        self._tic = time.time()
        self._seen = 0
        self._wait_seen = self._host_wait_ms()


class ProgressBar(object):
    """Batch callback: a text progress bar over ``total`` batches."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        done = int(round(self.bar_len * param.nbatch / float(self.total)))
        pct = math.ceil(100.0 * param.nbatch / float(self.total))
        logging.info("[%s] %s%%\r",
                     "=" * done + "-" * (self.bar_len - done), pct)


class LogValidationMetricsCallback(object):
    """Eval-end callback: log every validation metric of the epoch."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
