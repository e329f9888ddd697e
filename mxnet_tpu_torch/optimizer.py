"""Optimizers (PyTorch counterpart of ``mxnet_tpu/optimizer.py``).

Same registry + Updater contract as the JAX package, for SGD with
momentum, weight decay and gradient rescaling. SGD calls the update ops
of ``ops/optimizer_ops.py`` with ``out=`` set to the weight and its
momentum, so each update lands in place. A learning-rate scheduler reads
``num_update``, the largest per-parameter update count so far. A training
step updates every parameter through ``Updater.update_multi``, which, in
the JAX package's order, counts the step's updates first and then reads
each parameter's lr, so every parameter of step k sees ``num_update`` k.

``Updater.get_states``/``set_states`` carry the optimizer state and its
update clock in the JAX package's v2 envelope, with numpy leaves: a
restored state goes back onto its weight's device at the first update.
"""
from __future__ import annotations

import io
import pickle

import numpy

from .base import MXNetError
from .ndarray import NDArray, array, zeros, sgd_update, sgd_mom_update

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
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        """Create optimizer state (momentum etc.) for a parameter."""

    def update(self, index, weight, grad, state):
        """Update one parameter: read its lr and wd, count the update,
        apply it."""
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        self._apply(weight, grad, state, lr, wd)

    def _apply(self, weight, grad, state, lr, wd):
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

    def _update_count(self, index):
        """Count one update of parameter ``index``; ``num_update`` is the
        largest count of any parameter."""
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
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

    def _apply(self, weight, grad, state, lr, wd):
        kwargs = {"rescale_grad": self.rescale_grad, "lr": lr, "wd": wd}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        if state is not None:
            sgd_mom_update(weight, grad, state, out=[weight, state],
                           momentum=self.momentum, **kwargs)
        else:
            sgd_update(weight, grad, out=weight, **kwargs)


def _map_leaves(state, fn):
    """``state`` (None, a leaf, or a tuple/list tree) with ``fn`` applied
    to every leaf."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_map_leaves(s, fn) for s in state)
    return fn(state)


def _host_leaf(leaf):
    return leaf.asnumpy() if isinstance(leaf, NDArray) else \
        numpy.asarray(leaf)


class _StateUnpickler(pickle.Unpickler):
    """Unpickles only what ``get_states`` writes: builtins and numpy. A
    payload of the JAX package (leaves that are its NDArrays or JAX
    arrays) is refused with the name of the package that wrote it."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top in ("numpy", "builtins"):
            return super().find_class(module, name)
        if top in ("mxnet_tpu", "jax", "jaxlib", "ml_dtypes"):
            raise MXNetError(
                "optimizer-state payload was written by the JAX package "
                "(mxnet_tpu): its leaves are %s.%s; the port reads the "
                "payloads it writes (numpy leaves) and no others"
                % (module, name))
        raise MXNetError("optimizer-state payload holds %s.%s, which the "
                         "port does not read" % (module, name))


class Updater(object):
    """Per-index optimizer state holder (the reference's get_updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self._on_host = set()   # restored indices whose leaves are numpy

    def _state(self, index, weight):
        """The state of ``index``, created on first use; restored numpy
        leaves move onto ``weight``'s device here."""
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
            return self.states[index]
        st = self.states[index]
        if index in self._on_host:
            self._on_host.discard(index)
            st = _map_leaves(st, lambda leaf: array(
                leaf, ctx=weight.context, dtype=leaf.dtype))
            self.states[index] = st
        return st

    def __call__(self, index, grad, weight):
        self.optimizer.update(index, weight, grad, self._state(index, weight))

    def update_multi(self, triples):
        """Update every (index, grad, weight) of one step: count them all,
        then apply each with the lr it reads now (the JAX package's
        ``Updater.update_multi`` order)."""
        opt = self.optimizer
        for index, _, weight in triples:
            self._state(index, weight)
            opt._update_count(index)
        for index, grad, weight in triples:
            opt._apply(weight, grad, self.states[index], opt._get_lr(index),
                       opt._get_wd(index))

    @staticmethod
    def _leaf_dtypes(state):
        """Nested per-leaf dtype names of one state tree."""
        return _map_leaves(state, lambda leaf: numpy.dtype(
            _host_leaf(leaf).dtype).name)

    def get_states(self):
        """The states and the update clock as bytes: the JAX package's
        v2 envelope (``num_update``, ``index_update_count``,
        ``state_dtype``, ``state_dtypes``) with numpy leaves."""
        opt = self.optimizer
        states = {k: _map_leaves(st, _host_leaf)
                  for k, st in self.states.items()}
        return pickle.dumps({
            "__fmt__": 2,
            "states": states,
            "num_update": int(opt.num_update),
            "index_update_count": dict(opt._index_update_count),
            "state_dtype": None,
            "state_dtypes": {k: self._leaf_dtypes(st)
                             for k, st in states.items()},
        })

    def set_states(self, states):
        """Restore :meth:`get_states` bytes, update clock included, so a
        resumed run's lr schedule continues where the saved run stopped.
        Payloads the port did not write raise :class:`MXNetError`."""
        payload = _StateUnpickler(io.BytesIO(states)).load()
        if not (isinstance(payload, dict) and payload.get("__fmt__") == 2):
            raise MXNetError("optimizer-state payload is not the v2 "
                             "envelope that Updater.get_states writes")
        if payload.get("state_dtype") not in (None, "float32"):
            raise MXNetError(
                "optimizer-state payload was saved with state_dtype=%s; "
                "reduced-precision optimizer state comes with the "
                "precision slice of the port" % payload["state_dtype"])
        if payload.get("state_dtypes") != {
                k: self._leaf_dtypes(st)
                for k, st in payload["states"].items()}:
            raise MXNetError(
                "optimizer-state payload is internally inconsistent: the "
                "per-leaf dtype record does not match the state leaves "
                "(payload corrupted or hand-edited)")
        self.states = dict(payload["states"])
        self._on_host = set(self.states)
        opt = self.optimizer
        opt.num_update = int(payload["num_update"])
        opt._index_update_count = dict(payload["index_update_count"])


def get_updater(optimizer):
    return Updater(optimizer)
