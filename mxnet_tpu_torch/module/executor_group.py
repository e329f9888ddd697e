"""DataParallelExecutorGroup (PyTorch counterpart of
``mxnet_tpu/module/executor_group.py``), on one device.

Binds one Executor over the symbol with BatchNorm→ReLU pairs fused
(``executor.fuse_bn_relu``), so training runs through the BatchNorm(+ReLU)
kernels with the mask recomputed in the backward. The arg/aux lists and
the output names do not change under the fusion. A group bound with a
``shared_group`` takes that group's parameter and aux arrays as its own
(the same tensors), and its gradient tensors where the shapes agree, so
groups bound at several batch sizes or sequence lengths (the buckets of
a ``BucketingModule``) hold one copy of the parameters. ``reshape``
binds again at new input shapes through ``Executor.reshape``:
parameters, aux states and their gradients stay the same tensors.
Splitting a batch over several devices of one process comes with the
model-parallel half of the port (ROADMAP A8b); across processes,
``Module.bind`` sets the data-parallel world (``_dp``: the group holds
the rank's row block, sums the gradients over the ranks after the
backward, and runs BatchNorm over the global batch).
"""
from __future__ import annotations

from .. import ndarray as nd
from ..base import MXNetError
from ..executor import fuse_bn_relu

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup(object):
    # the data-parallel world (a dist.DistRuntime of two or more ranks,
    # set by Module.bind) and whether the group sums its gradients over
    # it (False when a dist_async kvstore reduces them instead)
    _dp = None
    _reduce_grads = False

    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, fixed_param_names=None,
                 grad_req="write", shared_group=None,
                 inputs_need_grad=False):
        if len(contexts) != 1:
            raise MXNetError("one process binds one device; several "
                             "contexts in one process come with the "
                             "model-parallel half of the port (ROADMAP "
                             "A8b)")
        symbol = fuse_bn_relu(symbol)
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = fixed_param_names or []
        self._monitor = None
        if not for_training:
            grad_req = "null"
        data_names = [x[0] for x in data_shapes]

        if isinstance(grad_req, str):
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = "null" if k in self.fixed_param_names \
                        else grad_req
                elif k in data_names and inputs_need_grad:
                    self.grad_req[k] = grad_req
                else:
                    self.grad_req[k] = "null"
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {k: "null" for k in self.arg_names}
            self.grad_req.update(grad_req)
        else:
            raise ValueError("invalid grad_req")
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def bind_exec(self, data_shapes, label_shapes, shared_group=None):
        """Allocate arguments, gradients and aux states (parameters and
        aux taken from ``shared_group`` when given); bind."""
        ctx = self.contexts[0]
        input_shapes = dict(data_shapes)
        if label_shapes is not None:
            input_shapes.update(dict(label_shapes))
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        shared_args, shared_aux, shared_grads = {}, {}, {}
        if shared_group is not None:
            shared_ex = shared_group.execs[0]
            shared_args = {n: shared_ex.arg_dict[n] for n in self.param_names}
            shared_aux = shared_ex.aux_dict
            shared_grads = {n: g for n, g in shared_ex.grad_dict.items()
                            if n in self.param_names}

        def alloc(name, shape, shared):
            arr = shared.get(name)
            if arr is None:
                return nd.zeros(shape, ctx=ctx)
            if arr.shape != tuple(shape):
                raise MXNetError("shared %s has shape %s, this bind needs %s"
                                 % (name, arr.shape, tuple(shape)))
            return arr

        args, grads = [], {}
        for name, shape in zip(self.arg_names, arg_shapes):
            args.append(alloc(name, shape, shared_args))
            if self.grad_req[name] != "null":
                g = shared_grads.get(name)
                grads[name] = g if g is not None and \
                    g.shape == tuple(shape) else nd.zeros(shape, ctx=ctx)
        aux = [alloc(name, shape, shared_aux)
               for name, shape in zip(self.aux_names, aux_shapes)]
        self._wire(self.symbol.bind(ctx, args, args_grad=grads,
                                    grad_req=self.grad_req, aux_states=aux),
                   data_shapes, label_shapes)

    def reshape(self, data_shapes, label_shapes):
        """Bind again at new input shapes. Every array whose shape does
        not change (parameters, aux states, their gradients) is the same
        tensor afterwards; inputs that shrink become views of the old
        input arrays, inputs that grow are allocated."""
        input_shapes = dict(data_shapes)
        if label_shapes is not None:
            input_shapes.update(dict(label_shapes))
        old = self.execs[0]
        ex = old.reshape(partial_shaping=True, allow_up_sizing=True,
                         **input_shapes)
        if self._monitor is not None:
            self._monitor.exes.remove(old)
            self._monitor.install(ex)
        self._wire(ex, data_shapes, label_shapes)

    def _wire(self, ex, data_shapes, label_shapes):
        self.batch_size = data_shapes[0][1][0]
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.execs = [ex]
        self.param_arrays = [[ex.arg_dict[n]] for n in self.param_names]
        self.grad_arrays = [[ex.grad_dict[n]]
                            if self.grad_req.get(n, "null") != "null"
                            else None for n in self.param_names]
        self.aux_arrays = [[ex.aux_dict[n]] for n in self.aux_names]
        self.data_arrays = [[ex.arg_dict[n]] for n, _ in data_shapes]
        self.label_arrays = [[ex.arg_dict[n]] for n, _ in label_shapes] \
            if label_shapes else None

    def set_params(self, arg_params, aux_params):
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters back into the given dicts."""
        for name, block in zip(self.param_names, self.param_arrays):
            block[0].copyto(arg_params[name])
        for name, block in zip(self.aux_names, self.aux_arrays):
            block[0].copyto(aux_params[name])

    def _dp_scope(self):
        """The cross-rank BatchNorm scope of a training pass."""
        from ..ops.nn import cross_rank_bn
        return cross_rank_bn(self._dp)

    def _reduce_grad_arrays(self):
        """Sum the gradient arrays over the ranks in place."""
        if self._reduce_grads:
            self._dp.allreduce_tensors_(
                [g._read() for g in self.execs[0].grad_arrays
                 if g is not None])

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        for src, dst in zip(data_batch.data, self.data_arrays):
            dst[0][:] = src
        if self.label_arrays is not None and data_batch.label:
            for src, dst in zip(data_batch.label, self.label_arrays):
                dst[0][:] = src
        if is_train and self._dp is not None:
            with self._dp_scope():
                self.execs[0].forward(is_train=is_train)
            return
        self.execs[0].forward(is_train=is_train)

    def install_monitor(self, mon):
        self._monitor = mon
        for ex in self.execs:
            mon.install(ex)

    def get_input_grads(self, merge_multi_context=True):
        grads = [self.execs[0].grad_dict[name] for name, _ in
                 self.data_shapes]
        return grads if merge_multi_context else [[g] for g in grads]

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True")
        if self._dp is None:
            self.execs[0].backward(out_grads=out_grads)
            return
        with self._dp_scope():
            self.execs[0].backward(out_grads=out_grads)
        self._reduce_grad_arrays()

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.execs[0].outputs)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]
