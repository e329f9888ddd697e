"""Module — symbol + context + params + optimizer (PyTorch counterpart of
``mxnet_tpu/module/module.py``) on one device, through the classic
``DataParallelExecutorGroup`` route: bind (with ``shared_module=`` for
inference), init_params, init_optimizer, forward, backward, update,
update_metric, get_params, and checkpoints in the JAX package's file
format (``save_checkpoint``, ``Module.load``). ``fit``, ``score`` and
``predict`` come from ``BaseModule``. The fused one-program step and
multi-device binding come with later slices of the port.
"""
from __future__ import annotations

import logging

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..initializer import Uniform, InitDesc
from ..model import _update_params, load_checkpoint, save_checkpoint
from .base_module import BaseModule, pad_batch_rows
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """Trainable module over a Symbol, bound to one device context (the
    default context, ``gpu(0)``, unless ``context`` says otherwise)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        if len(context) != 1:
            raise MXNetError("this slice of the port binds one device; got "
                             "%d contexts" % len(context))
        context[0].torch_device()   # a gpu context without CUDA raises here
        self._context = context
        self._symbol = symbol
        data_names = list(data_names or [])
        label_names = list(label_names or [])
        self._data_names = data_names
        self._label_names = label_names
        input_names = data_names + label_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._exec_group = None
        self._eval_pad_extra = 0

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        """The bound (name, shape) pairs of the data inputs."""
        if not self.binded:
            raise MXNetError("call bind first")
        return list(self._exec_group.data_shapes)

    @staticmethod
    def load(prefix, epoch, **kwargs):
        """A Module over the checkpoint ``prefix-symbol.json`` +
        ``prefix-%04d.params`` (either package's); the parameters are set
        when it is bound. ``kwargs`` go to ``Module``."""
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=ctx_mod.cpu())
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write ``prefix-symbol.json`` and ``prefix-%04d.params``."""
        if save_optimizer_states:
            raise MXNetError("saving optimizer states comes with a later "
                             "slice of the port")
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        self.logger.info('Saved checkpoint to "%s-%04d.params"', prefix,
                         epoch)

    def get_params(self):
        """(arg_params, aux_params) as CPU NDArrays, synced from the
        device after updates."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params first")
        if self._params_dirty:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return self._arg_params, self._aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Allocate and initialize parameters: values in ``arg_params``/
        ``aux_params`` are copied, the rest come from ``initializer``."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")
        cpu = ctx_mod.cpu()
        if self._arg_params is None:
            self._arg_params = {
                name: nd.zeros(arr[0].shape, ctx=cpu, dtype=arr[0].dtype)
                for name, arr in zip(self._param_names,
                                     self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: nd.zeros(arr[0].shape, ctx=cpu, dtype=arr[0].dtype)
                for name, arr in zip(self._aux_names,
                                     self._exec_group.aux_arrays)}

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                if cache[name] is not arr:
                    cache[name].copyto(arr)
            elif cache is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            elif initializer is not None:
                initializer(name, arr)

        attrs = self._symbol.attr_dict()
        for name, arr in sorted(self._arg_params.items()):
            _impl(InitDesc(name, attrs.get(name)), arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(InitDesc(name, attrs.get(name)), arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor group for the given input shapes.

        ``shared_module`` (a bound, initialized Module over the same
        parameters; inference binds only): this module computes from
        the shared module's parameter and aux tensors themselves, the
        same storage, so one ``set_params`` on either reaches both."""
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad:
            raise MXNetError("inputs_need_grad comes with a later slice of "
                             "the port")
        shared_group = None
        if shared_module is not None:
            if for_training:
                raise MXNetError("shared_module binds for inference only "
                                 "(for_training=False) in this slice of "
                                 "the port")
            if not (isinstance(shared_module, Module) and
                    shared_module.binded and
                    shared_module.params_initialized):
                raise MXNetError("shared_module must be a bound Module "
                                 "with initialized parameters")
            shared_group = shared_module._exec_group
        self.for_training = for_training
        self.binded = True
        data_shapes = [(x[0], tuple(x[1])) for x in data_shapes]
        label_shapes = [(x[0], tuple(x[1])) for x in label_shapes] \
            if label_shapes else None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, data_shapes, label_shapes,
            self._param_names, for_training, self._fixed_param_names,
            grad_req, shared_group)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self._params_dirty = False
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer; ``rescale_grad`` defaults to 1/batch."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params first")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring")
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad",
                                        1.0 / self._exec_group.batch_size)
            optimizer = opt.create(
                optimizer, sym=self.symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params first")
        self._eval_pad_extra = 0
        train = self.for_training if is_train is None else bool(is_train)
        if not train:
            data_batch = self._pad_eval_tail(data_batch)
        self._exec_group.forward(data_batch, is_train)

    def _pad_eval_tail(self, batch):
        """An eval batch with fewer rows than the bound batch runs
        zero-padded to the bound shape (``pad_batch_rows``, the rule the
        serving buckets use). Rows are independent in an eval forward;
        the extra rows are dropped again by ``_unpadded_outputs`` and
        ``update_metric`` through ``_eval_pad_extra``."""
        from ..io import DataBatch
        target = self._exec_group.batch_size
        rows = batch.data[0].shape[0] if batch.data else 0
        if rows == 0 or rows >= target:
            return batch
        data = [pad_batch_rows(d, target) for d in batch.data]
        label = None
        if batch.label:
            label = [None if lb is None else pad_batch_rows(lb, target)
                     for lb in batch.label]
        self._eval_pad_extra = target - rows
        return DataBatch(data=data, label=label, pad=batch.pad,
                         index=batch.index)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params first")
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to every parameter with a gradient."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        self._params_dirty = True
        _update_params(self._exec_group.param_arrays,
                       self._exec_group.grad_arrays, self._updater)

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        """Add this batch's outputs against ``labels`` to ``eval_metric``
        (one readback of the outputs); after a tail-padded eval forward,
        only the real rows count."""
        extra = self._eval_pad_extra
        if extra:
            keep = self._exec_group.batch_size - extra
            outs = [o[0:keep] for o in self.get_outputs()]
            labels = [lb if lb is None or lb.shape[0] <= keep
                      else lb[0:keep] for lb in (labels or [])]
            eval_metric.update(labels, outs)
            return
        self._exec_group.update_metric(eval_metric, labels)
