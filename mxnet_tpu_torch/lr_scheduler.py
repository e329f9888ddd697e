"""Learning-rate schedulers (PyTorch counterpart of
``mxnet_tpu/lr_scheduler.py``).

A scheduler is a callable ``num_update -> lr`` that the optimizer
consults on every update (``optimizer.py _get_lr``); it runs on the host.
Stepwise decay state advances incrementally, so a call is O(1) per
update. The JAX package's Poly/Cosine/Warmup schedules are not ported.
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler(object):
    """Base class: ``scheduler(num_update) -> learning rate``."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError("subclasses implement __call__")


class FactorScheduler(LRScheduler):
    """Geometric decay: multiply by ``factor`` every ``step`` updates,
    clamped below at ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step must be >= 1 update")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info(
                    "Update[%d]: lr clamped at %0.5e; no further decay",
                    num_update, self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """Decay by ``factor`` at each boundary in the increasing list
    ``step``."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of updates")
        for i, s in enumerate(step):
            if s < 1:
                raise ValueError("schedule boundaries must be >= 1")
            if i and s <= step[i - 1]:
                raise ValueError("schedule boundaries must increase")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind < len(self.step) and \
                num_update > self.step[self.cur_step_ind]:
            self.count = self.step[self.cur_step_ind]
            self.cur_step_ind += 1
            self.base_lr *= self.factor
            logging.info("Update[%d]: Change learning rate to %0.5e",
                         num_update, self.base_lr)
        return self.base_lr
