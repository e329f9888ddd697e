"""Learning-rate schedulers (PyTorch counterpart of
``mxnet_tpu/lr_scheduler.py``).

A scheduler is a callable ``num_update -> lr`` that the optimizer
consults on every update (``optimizer.py _get_lr``); it runs on the host.
Stepwise decay state advances incrementally, so a call is O(1) per
update. ``PolyScheduler``, ``CosineScheduler`` and ``WarmupScheduler``
are the JAX package's continuous schedules.
"""
from __future__ import annotations

import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "WarmupScheduler"]


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


class PolyScheduler(LRScheduler):
    """Polynomial decay to ``final_lr`` over ``max_update`` updates:
    lr = final + (base - final) * (1 - t/T)^power."""

    def __init__(self, max_update, base_lr=0.01, power=2.0, final_lr=0.0):
        super().__init__(base_lr)
        if max_update < 1:
            raise ValueError("max_update must be >= 1")
        self.max_update = max_update
        self.power = power
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update >= self.max_update:
            return self.final_lr
        frac = 1.0 - float(num_update) / self.max_update
        return self.final_lr + (self.base_lr - self.final_lr) * \
            frac ** self.power


class CosineScheduler(LRScheduler):
    """Cosine decay to ``final_lr`` over ``max_update`` updates."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0):
        super().__init__(base_lr)
        if max_update < 1:
            raise ValueError("max_update must be >= 1")
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update >= self.max_update:
            return self.final_lr
        cos = (1.0 + math.cos(math.pi * num_update / self.max_update)) / 2
        return self.final_lr + (self.base_lr - self.final_lr) * cos


class WarmupScheduler(LRScheduler):
    """Linear warmup from ``start_lr`` over ``warmup_steps`` updates,
    then ``base_scheduler``, whose clock starts at 0 after the warmup.
    ``base_lr`` is the wrapped scheduler's (the optimizer sets it)."""

    def __init__(self, base_scheduler, warmup_steps, start_lr=0.0):
        if warmup_steps < 1:
            raise ValueError("warmup_steps must be >= 1")
        self.base_scheduler = base_scheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr

    @property
    def base_lr(self):
        return self.base_scheduler.base_lr

    @base_lr.setter
    def base_lr(self, value):
        self.base_scheduler.base_lr = value

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            frac = float(num_update) / self.warmup_steps
            return self.start_lr + \
                (self.base_scheduler.base_lr - self.start_lr) * frac
        return self.base_scheduler(num_update - self.warmup_steps)
