"""Checkpoint files, the kvstore helpers of the update loop and the legacy
``FeedForward`` API (PyTorch counterpart of ``mxnet_tpu/model.py``).

``prefix-symbol.json`` + ``prefix-%04d.params`` use the JAX package's
formats, so either package reads the other's. ``FeedForward`` is a shim
over ``Module``, as in the JAX package: ``fit``, ``predict``, ``score``,
``save``, ``load`` and ``create``.
"""
from __future__ import annotations

import os

import numpy as onp

from .checkpoint import load_params_file, save_params_file
from . import context as ctx_mod
from . import kvstore as kvs
from . import symbol as sym_mod

__all__ = ["FeedForward", "BatchEndParam", "save_checkpoint",
           "load_checkpoint"]


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) for ``Module.init_optimizer``: no
    store for ``None`` or a local kind on one device; a ``KVStore``
    instance updates on the store. ``MXNET_UPDATE_ON_KVSTORE`` overrides
    the choice when there is a store."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                # large arrays favour updating where they are
                max_size = max(onp.prod(param.shape)
                               for param in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    env_override = os.environ.get("MXNET_UPDATE_ON_KVSTORE")
    if env_override is not None and kv is not None:
        update_on_kvstore = env_override == "1"
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Initialise one key per parameter and, when updating on the store,
    pull it into the bound arrays. The store keeps its copy on the bound
    arrays' device (the values of ``arg_params``, which ``set_params``
    put there), so its updates run where the weights live."""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, param_on_devs[0])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Push every gradient and pull the updated weight back."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list is None or grad_list[0] is None:
            continue
        kvstore.push(index, grad_list, priority=-index)
        kvstore.pull(index, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, kvstore=None):
    """Update every parameter that has a gradient, as one step of
    ``updater`` (one device: the key is the parameter's index); with a
    ``kvstore``, the gradients are aggregated through it first."""
    triples = []
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list is None or grad_list[0] is None:
            continue
        if kvstore:
            kvstore.push(index, grad_list, priority=-index)
            kvstore.pull(index, grad_list, priority=-index)
        triples.append((index, grad_list[0], arg_list[0]))
    updater.update_multi(triples)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write prefix-symbol.json and prefix-%04d.params (``arg:``/``aux:``
    prefixed names, atomic write)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_params_file("%s-%04d.params" % (prefix, epoch), arg_params,
                     aux_params)


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) of a checkpoint, arrays on ctx."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params_file(
        "%s-%04d.params" % (prefix, epoch), ctx=ctx)
    return symbol, arg_params, aux_params


class FeedForward(object):
    """The legacy training API, as a shim over ``Module`` (one device:
    ``ctx`` is a Context or a list of one)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform
        self.symbol = symbol
        if ctx is None:
            ctx = [ctx_mod.current_context()]
        elif isinstance(ctx, ctx_mod.Context):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._module = None

    def _make_module(self, data_names, label_names):
        from .module import Module
        self._module = Module(self.symbol, data_names=data_names,
                              label_names=label_names, context=self.ctx)
        return self._module

    def _as_iter(self, X, y, shuffle=False, label_name="softmax_label"):
        from .io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                           shuffle=shuffle, label_name=label_name)

    def _bound_for_inference(self, eval_iter, label_names, label_shapes):
        if self._module is None or not self._module.binded:
            mod = self._make_module([x[0] for x in eval_iter.provide_data],
                                    label_names)
            mod.bind(data_shapes=eval_iter.provide_data,
                     label_shapes=label_shapes, for_training=False)
            mod.init_params(arg_params=self.arg_params,
                            aux_params=self.aux_params)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train ``num_epoch`` epochs on ``X`` (an iterator, or arrays with
        labels ``y``) through a Module."""
        train_data = self._as_iter(X, y, shuffle=True)
        mod = self._make_module([x[0] for x in train_data.provide_data],
                                [x[0] for x in train_data.provide_label])
        if isinstance(eval_data, tuple):
            eval_data = self._as_iter(eval_data[0], eval_data[1])
        mod.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback,
                kvstore=kvstore, optimizer=self.optimizer,
                optimizer_params=dict(self.kwargs),
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                allow_missing=True, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch, monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs on ``X`` as numpy arrays (a list for several)."""
        eval_iter = self._as_iter(X, None)
        # the loss heads' label variables are arguments but not
        # parameters: declared as labels, an unlabeled bind skips them
        label_names = [n for n in self.symbol.list_arguments()
                       if n.endswith("_label")]
        mod = self._bound_for_inference(eval_iter, label_names, None)
        out = mod.predict(eval_iter, num_batch=num_batch, reset=reset)
        if isinstance(out, list):
            return [o.asnumpy() for o in out]
        return out.asnumpy()

    def score(self, X, y=None, eval_metric="acc", num_batch=None, reset=True):
        """The value of ``eval_metric`` on ``X``."""
        eval_iter = self._as_iter(X, y)
        mod = self._bound_for_inference(
            eval_iter, [x[0] for x in eval_iter.provide_label],
            eval_iter.provide_label)
        res = mod.score(eval_iter, eval_metric, num_batch=num_batch,
                        reset=reset)
        return res[0][1]

    def save(self, prefix, epoch=None):
        """Write the model as a legacy checkpoint at ``epoch``
        (``num_epoch`` by default)."""
        if epoch is None:
            epoch = self.num_epoch
        if epoch is None:
            raise ValueError("save needs an epoch")
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward over a legacy checkpoint."""
        symbol, arg_params, aux_params = load_checkpoint(
            prefix, epoch, ctx=ctx_mod.cpu())
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Train a new model from scratch."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model


# the fit loop's batch-end record, defined with the module code (imported
# last: module/module.py imports this file's helpers)
from .module.base_module import BatchEndParam  # noqa: E402
