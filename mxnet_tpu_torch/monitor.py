"""Monitor — inspect every op's outputs (and weights/aux) during training
(PyTorch counterpart of ``mxnet_tpu/monitor.py``).

``install`` registers ``stat_helper`` as an executor's monitor callback;
while a monitored batch is active the executor hands every op output to
it (``executor.py`` taps), and ``stat_func`` reduces each to a small
NDArray. ``tic``/``toc`` gate the taps to every ``interval``-th batch.
"""
from __future__ import annotations

import logging
import re

from . import ndarray as nd

__all__ = ["Monitor"]


def _rms_stat(x):
    """Default statistic: |x|'s root-mean-square (the reference's
    norm/sqrt(size) "asum" default)."""
    return nd.norm(x) / (x.size ** 0.5)


class Monitor(object):
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.stat_func = stat_func or _rms_stat
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def stat_helper(self, name, array):
        """Per-op-output callback fed by the executor's taps."""
        if self.activated and self.re_prog.match(name):
            self.queue.append((self.step, name, self.stat_func(array)))

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def _tap_state_dicts(self):
        """End-of-batch taps of the arguments and aux states."""
        for exe in self.exes:
            for source in (exe.arg_dict, exe.aux_dict):
                for name, array in source.items():
                    if self.re_prog.match(name):
                        self.queue.append(
                            (self.step, name, self.stat_func(array)))

    @staticmethod
    def _render(stat):
        values = stat if isinstance(stat, list) else [stat]
        parts = []
        for v in values:
            if not isinstance(v, nd.NDArray):
                raise TypeError("stat_func must return NDArray(s)")
            parts.append(str(v.asscalar() if v.shape == (1,)
                             else v.asnumpy()))
        return "\t".join(parts) + "\t"

    def toc(self):
        """End a monitored batch: (step, name, rendered stat) of every
        tap, or [] when the batch was not monitored."""
        if not self.activated:
            return []
        self.activated = False
        self._tap_state_dicts()
        if self.sort:
            self.queue.sort(key=lambda entry: entry[1])
        drained = [(step, name, self._render(stat))
                   for step, name, stat in self.queue]
        self.queue = []
        return drained

    def toc_print(self):
        for step, name, rendered in self.toc():
            logging.info("Batch: {:7d} {:30s} {:s}".format(
                step, name, rendered))
