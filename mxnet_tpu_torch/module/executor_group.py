"""DataParallelExecutorGroup (PyTorch counterpart of
``mxnet_tpu/module/executor_group.py``), on one device.

Binds one Executor over the symbol with BatchNorm→ReLU pairs fused
(``executor.fuse_bn_relu``), so training runs through the BatchNorm(+ReLU)
kernels with the mask recomputed in the backward. The arg/aux lists and
the output names do not change under the fusion. Splitting a batch over
several devices comes with a later slice of the port.
"""
from __future__ import annotations

from .. import ndarray as nd
from ..base import MXNetError
from ..executor import fuse_bn_relu

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup(object):
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, fixed_param_names=None,
                 grad_req="write"):
        if len(contexts) != 1:
            raise MXNetError("this slice of the port binds one device")
        symbol = fuse_bn_relu(symbol)
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.for_training = for_training
        self.fixed_param_names = fixed_param_names or []
        if not for_training:
            grad_req = "null"

        if isinstance(grad_req, str):
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = "null" if k in self.fixed_param_names \
                        else grad_req
                else:
                    self.grad_req[k] = "null"
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {k: "null" for k in self.arg_names}
            self.grad_req.update(grad_req)
        else:
            raise ValueError("invalid grad_req")
        self.bind_exec(data_shapes, label_shapes)

    def bind_exec(self, data_shapes, label_shapes):
        """Allocate arguments, gradients and aux states; bind."""
        self.batch_size = data_shapes[0][1][0]
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        ctx = self.contexts[0]
        input_shapes = dict(data_shapes)
        if label_shapes is not None:
            input_shapes.update(dict(label_shapes))
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        args, grads = [], {}
        for name, shape in zip(self.arg_names, arg_shapes):
            args.append(nd.zeros(shape, ctx=ctx))
            if self.grad_req[name] != "null":
                grads[name] = nd.zeros(shape, ctx=ctx)
        aux = [nd.zeros(s, ctx=ctx) for s in aux_shapes]
        ex = self.symbol.bind(ctx, args, args_grad=grads,
                              grad_req=self.grad_req, aux_states=aux)
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

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        for src, dst in zip(data_batch.data, self.data_arrays):
            dst[0][:] = src
        if self.label_arrays is not None and data_batch.label:
            for src, dst in zip(data_batch.label, self.label_arrays):
                dst[0][:] = src
        self.execs[0].forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True")
        self.execs[0].backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]
