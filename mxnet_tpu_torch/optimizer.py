"""Optimizers (PyTorch counterpart of ``mxnet_tpu/optimizer.py``).

Same registry + Updater contract as the JAX package, for SGD with
momentum, weight decay and gradient rescaling. SGD calls the update ops
of ``ops/optimizer_ops.py`` with ``out=`` set to the weight and its
momentum, so each update lands in place.
"""
from __future__ import annotations

from .ndarray import zeros, sgd_update, sgd_mom_update

__all__ = ["Optimizer", "SGD", "Updater", "get_updater", "create",
           "register"]


class Optimizer(object):
    """Base optimizer with lr/wd multipliers and the name registry."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, sym=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        """Create optimizer state (momentum etc.) for a parameter."""

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_lr_mult(self, args_lr_mult):
        """Per-parameter lr multipliers, from ``__lr_mult__`` symbol attrs
        and then ``args_lr_mult``."""
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Defaults: no decay except on ``*_weight`` and ``*_gamma``."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _get_lr(self, index):
        lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum via the sgd(_mom)_update ops."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        kwargs = {"rescale_grad": self.rescale_grad, "lr": lr, "wd": wd}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        if state is not None:
            sgd_mom_update(weight, grad, state, out=[weight, state],
                           momentum=self.momentum, **kwargs)
        else:
            sgd_update(weight, grad, out=weight, **kwargs)


class Updater(object):
    """Per-index optimizer state holder (the reference's get_updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
