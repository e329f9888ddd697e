"""BaseModule (PyTorch counterpart of ``mxnet_tpu/module/base_module.py``)
— the state flags and ``forward_backward``; ``fit``/``score``/``predict``
come with a later slice of the port."""
from __future__ import annotations

import logging

__all__ = ["BaseModule"]


class BaseModule(object):
    """Binding, parameter and optimizer state of a module."""

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

    @property
    def symbol(self):
        return self._symbol
