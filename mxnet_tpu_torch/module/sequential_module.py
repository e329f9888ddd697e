"""SequentialModule — modules run one after another (PyTorch counterpart
of ``mxnet_tpu/module/sequential_module.py``).

Each stage's outputs are the next stage's data; the gradients flow back
through ``get_input_grads``. ``add(module, take_labels=True)`` routes the
chain's labels to a stage, and ``auto_wiring=True`` renames the previous
stage's outputs to the stage's data names. Every stage after the first
binds with ``inputs_need_grad`` (its input gradients feed the stage
before it), so it takes the classic route; the first stage may stay on
the fused route, where ``backward(out_grads=)`` reuses the graph of the
forward whose outputs the next stage read. A stage's outputs have the
next stage's bound shapes, so no batch re-binds a stage. An eval tail
that the first stage padded to the bound batch carries its pad marker
down the chain, so the metric and ``predict`` drop the padded rows.
"""
from __future__ import annotations

import copy
import logging

from ..initializer import Uniform
from .base_module import BaseModule, pad_batch_rows

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"
    _META_KEYS = frozenset((META_TAKE_LABELS, META_AUTO_WIRING))

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._eval_pad_extra = 0

    def add(self, module, **kwargs):
        """Append ``module`` with the meta keywords ``take_labels`` and
        ``auto_wiring``; returns self. It undoes bind and init."""
        unknown = set(kwargs) - self._META_KEYS
        if unknown:
            raise ValueError("unknown meta keys %s (known: %s)"
                             % (sorted(unknown), sorted(self._META_KEYS)))
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # ------------------------------------------------------- introspection
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        self._need_bind()
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        self._need_bind()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._need_bind()
        return self._modules[-1].output_shapes

    def _need_bind(self):
        if not self.binded:
            raise RuntimeError("call bind first")

    def _need_params(self):
        if not (self.binded and self.params_initialized):
            raise RuntimeError("call bind and init_params first")

    # ------------------------------------------------------------- params
    def get_params(self):
        self._need_params()
        args, auxs = {}, {}
        for m in self._modules:
            a, x = m.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        self._need_bind()
        for m in self._modules:
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params, allow_missing=allow_missing,
                          force_init=force_init)
        self._reject_duplicate_params()
        self.params_initialized = True

    def _reject_duplicate_params(self):
        """Stages must not share parameter names: ``get_params`` merges
        their dicts, so one stage's weights would hide another's."""
        owner = {}
        for i, m in enumerate(self._modules):
            a, x = m.get_params()
            for name in list(a) + list(x):
                if name in owner:
                    raise ValueError(
                        "duplicated parameter %r: stage %d (%s) and stage "
                        "%d (%s)" % (name, owner[name],
                                     type(self._modules[owner[name]])
                                     .__name__, i, type(m).__name__))
                owner[name] = i

    # --------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise ValueError("inputs_need_grad needs for_training")
        if shared_module is not None:
            raise ValueError("SequentialModule does not share modules")
        if not self._modules:
            raise ValueError("cannot bind an empty SequentialModule")
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes

        stage_data = data_shapes
        labels_used = False
        for i, (m, meta) in enumerate(zip(self._modules, self._metas)):
            takes_labels = meta.get(self.META_TAKE_LABELS, False)
            labels_used = labels_used or takes_labels
            if meta.get(self.META_AUTO_WIRING, False):
                names = m.data_names
                if len(names) != len(stage_data):
                    raise ValueError(
                        "auto_wiring: stage %d has %d data names for %d "
                        "inputs" % (i, len(names), len(stage_data)))
                stage_data = [(n, shape) for n, (_, shape)
                              in zip(names, stage_data)]
            m.bind(data_shapes=stage_data,
                   label_shapes=label_shapes if takes_labels else None,
                   for_training=for_training,
                   inputs_need_grad=bool(
                       for_training and (inputs_need_grad or i > 0)),
                   force_rebind=force_rebind, shared_module=None,
                   grad_req=grad_req)
            stage_data = m.output_shapes
        if not labels_used:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._need_params()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring")
            return
        for m in self._modules:
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    # ---------------------------------------------------------- execution
    def forward(self, data_batch, is_train=None):
        self._need_params()
        batch = copy.copy(data_batch)
        last = len(self._modules) - 1
        for i, m in enumerate(self._modules):
            m.forward(batch, is_train=is_train)
            if i == last:
                break
            extra = getattr(m, "_eval_pad_extra", 0) if i == 0 else 0
            if extra and batch.label:
                # the later stages see the padded rows: so do the labels
                rows = batch.data[0].shape[0] + extra
                batch.label = [None if lb is None else
                               pad_batch_rows(lb, rows) for lb in batch.label]
            batch.data = m.get_outputs()
            names = [x[0] for x in m.output_shapes]
            if len(names) != len(batch.data):
                raise ValueError("stage %s: %d outputs vs %d output_shapes"
                                 % (type(m).__name__, len(batch.data),
                                    len(names)))
            batch.provide_data = [(n, d.shape) for n, d
                                  in zip(names, batch.data)]
        # an eval tail padded by the first stage reaches the others at the
        # full shape: hand them its marker, so the rows are dropped again
        extra = getattr(self._modules[0], "_eval_pad_extra", 0)
        self._eval_pad_extra = extra
        if extra:
            for m in self._modules[1:]:
                if hasattr(m, "_eval_pad_extra"):
                    m._eval_pad_extra = extra

    def backward(self, out_grads=None):
        self._need_params()
        for i in range(len(self._modules) - 1, -1, -1):
            self._modules[i].backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = self._modules[i].get_input_grads()

    def update(self):
        self._need_params()
        if not self.optimizer_initialized:
            raise RuntimeError("call init_optimizer first")
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        self._need_params()
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._need_params()
        if not self.inputs_need_grad:
            raise RuntimeError("bind with inputs_need_grad=True first")
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._need_params()
        for m, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS, False):
                m.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._need_bind()
        for m in self._modules:
            m.install_monitor(mon)
