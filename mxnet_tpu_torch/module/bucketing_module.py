"""BucketingModule (PyTorch counterpart of
``mxnet_tpu/module/bucketing_module.py``): variable-length training with
one symbol per bucket key over one parameter set.

Every bucket is a classic-route ``Module(_allow_fused=False)``. The
default bucket is bound first (the master); each other bucket binds on
its first batch with ``shared_module=`` the master, so its executor
computes from the master's parameter tensors, and from its gradient
tensors where the shapes agree, the same storage. The other buckets
``borrow_optimizer`` from the master: one optimizer state and one update
clock for all of them. ``switch_bucket`` picks the bucket a batch's
``bucket_key`` names.
"""
from __future__ import annotations

import logging

from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """A dispatcher over per-bucket :class:`Module` instances: the work
    runs in the current bucket's module; this class routes the calls."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._mod_kwargs = dict(logger=logger, context=context,
                                work_load_list=work_load_list,
                                fixed_param_names=fixed_param_names)
        self._reset_bind()
        self._params_dirty = False
        self._monitor = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _active(self, trained=False, optimized=False):
        """The current bucket's module, after the state checks."""
        assert self.binded, "call bind first"
        if trained:
            assert self.params_initialized, "call init_params first"
        if optimized:
            assert self.optimizer_initialized, "call init_optimizer first"
        return self._curr_module

    def _make_bucket(self, bucket_key, data_shapes, label_shapes,
                     for_training, inputs_need_grad, grad_req="write",
                     shared_module=None):
        """Generate and bind the Module of one bucket key."""
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(symbol, data_names, label_names, _allow_fused=False,
                     **self._mod_kwargs)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                 force_rebind=False, shared_module=shared_module,
                 grad_req=grad_req)
        if self._monitor is not None:
            mod.install_monitor(self._monitor)
        self._buckets[bucket_key] = mod
        return mod

    # -- introspection --------------------------------------------------
    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        return self._active().data_shapes

    @property
    def label_shapes(self):
        return self._active().label_shapes

    @property
    def output_shapes(self):
        return self._active().output_shapes

    @property
    def symbol(self):
        return self._active().symbol

    @property
    def buckets(self):
        """{bucket key: its bound Module}."""
        return dict(self._buckets)

    # -- parameters -----------------------------------------------------
    def get_params(self):
        mod = self._active(trained=True)
        mod._params_dirty = self._params_dirty
        self._params_dirty = False
        return mod.get_params()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        self._active().init_params(initializer=initializer,
                                   arg_params=arg_params,
                                   aux_params=aux_params,
                                   allow_missing=allow_missing,
                                   force_init=force_init)
        self._params_dirty = False
        self.params_initialized = True

    # -- binding --------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._curr_module = self._make_bucket(
            self._default_bucket_key, data_shapes, label_shapes,
            for_training, inputs_need_grad, grad_req=grad_req)
        self._curr_bucket_key = self._default_bucket_key

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it on first
        use over the master's parameters."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            master = self._buckets[self._default_bucket_key]
            self._make_bucket(bucket_key, data_shapes, label_shapes,
                              master.for_training, master.inputs_need_grad,
                              shared_module=master)
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    # -- optimizer ------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        mod = self._active(trained=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        mod.init_optimizer(kvstore, optimizer, optimizer_params,
                           force_init=force_init)
        for other in self._buckets.values():
            if other is not mod:
                other.borrow_optimizer(mod)
        self.optimizer_initialized = True

    # -- compute --------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._active(trained=True)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)
        self._eval_pad_extra = getattr(self._curr_module,
                                       "_eval_pad_extra", 0)

    def backward(self, out_grads=None):
        self._active(trained=True).backward(out_grads=out_grads)

    def update(self):
        self._params_dirty = True
        self._active(trained=True, optimized=True).update()

    def get_outputs(self, merge_multi_context=True):
        return self._active(trained=True).get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        mod = self._active(trained=True)
        assert self.inputs_need_grad
        return mod.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._active(trained=True).update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)
