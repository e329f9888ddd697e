"""PythonModule and PythonLossModule (PyTorch counterpart of
``mxnet_tpu/module/python_module.py``).

A ``PythonModule`` is a module without parameters whose computation is
the subclass's own Python code; ``PythonLossModule`` is the loss brick
whose forward passes the scores through and whose backward applies
``grad_func(scores, labels)``. Both slot into a ``SequentialModule``
beside real Modules.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Subclass and implement ``forward``/``backward`` (and
    ``_compute_output_shapes``) in Python; there are no parameters."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names) if data_names is not None \
            else data_names
        self._label_names = list(label_names) if label_names is not None \
            else label_names
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        self.params_initialized = True

    def update(self):
        """Nothing to update (a subclass with state overrides this)."""

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def update_metric(self, eval_metric, labels):
        # only a brick bound with labels feeds the metric
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if grad_req != "write":
            raise ValueError("PythonModule only supports grad_req='write'")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """The (name, shape) list of the outputs at the bound shapes."""
        raise NotImplementedError()

    def install_monitor(self, mon):
        """A Python brick has no operators to tap."""


class PythonLossModule(PythonModule):
    """A loss layer in Python: forward is the identity on the scores,
    backward applies ``grad_func(scores, labels)``."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        if len(data_names) != 1 or len(label_names) != 1:
            raise ValueError(
                "PythonLossModule takes exactly one data and one label")
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        train = self.for_training if is_train is None else is_train
        if train and data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise ValueError("a loss module takes no out_grads")
        if not self.for_training:
            raise ValueError("backward() on a module bound with "
                             "for_training=False")
        if self._grad_func is None:
            raise NotImplementedError(
                "PythonLossModule needs grad_func (symbolic losses belong "
                "in a Module)")
        grad = self._grad_func(self._scores, self._labels)
        self._scores_grad = grad if isinstance(grad, nd.NDArray) else \
            nd.array(grad, ctx=self._scores.context)

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
