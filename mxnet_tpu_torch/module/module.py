"""Module — symbol + context + params + optimizer (PyTorch counterpart of
``mxnet_tpu/module/module.py``) on one device: bind (with
``shared_module=``), reshape, init_params, init_optimizer,
forward, backward, update, update_metric, get_params, monitors, and
checkpoints in the JAX package's formats: legacy prefix files and
``CheckpointManager`` entries (``save_checkpoint``, ``Module.load``,
optimizer states). ``fit``, ``score`` and ``predict`` come from
``BaseModule``. A batch whose shapes differ from the bound ones re-binds
through ``reshape`` on the same parameters.

Two routes, as in the JAX package. By default a bind takes the fused
route (``MeshExecutorGroup``): a training step is one function —
forward, backward, optimizer, metric tally — run by ``update()``, with
the precision modes (``precision=``, ``compute_dtype=``, ``remat=``),
``fit(batch_group=K)`` and the device-side metric tally.
``_allow_fused=False``, ``MXNET_MODULE_FUSED=0``, ``inputs_need_grad``,
a ``grad_req`` other than ``"write"`` or a monitor take the classic
per-executor route (``DataParallelExecutorGroup``); a precision mode
other than f32, or ``device_augment``, refuses to bind there.
``device_augment={name: data.DeviceAugment}`` (usually adopted by ``fit``
from the train iterator's ``device_augment_spec``) stages uint8 wire
batches and runs the augment on the device at staging.

Data parallelism runs one process per device: under a live ``dist``
runtime of R ranks each rank binds its row block, rank 0's parameters
are broadcast at ``init_params``, the step sums the gradients over the
ranks, BatchNorm reduces over the global batch, and checkpoint entries
carry ``dp_width`` (rank 0 writes them). Several devices in one process,
mesh axes, parameter sharding and pipeline microbatches come with the
model-parallel half of the port (ROADMAP A8b).
"""
from __future__ import annotations

import logging
import os

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..initializer import Uniform, InitDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from .base_module import BaseModule, pad_batch_rows, stack_group_inputs
from .executor_group import DataParallelExecutorGroup
from .mesh_executor_group import MeshExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """Trainable module over a Symbol, bound to one device context (the
    default context, ``gpu(0)``, unless ``context`` says otherwise)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 compute_dtype=None, remat=None, mesh_axes=None,
                 param_sharding=None, pipeline_microbatches=None,
                 device_augment=None, precision=None, _allow_fused=True):
        super().__init__(logger=logger)
        for name, value in (("mesh_axes", mesh_axes),
                            ("param_sharding", param_sharding),
                            ("pipeline_microbatches", pipeline_microbatches)):
            if value:
                raise MXNetError(
                    "Module(%s=...) comes with the model-parallel half of "
                    "the port (ROADMAP A8b); data parallelism runs one "
                    "process per device (mxnet_tpu_torch.dist)" % name)
        # the precision mode: a name or PrecisionPolicy (None consults
        # MXNET_PRECISION_MODE); it folds into compute_dtype and remat,
        # explicit keywords winning, and also sets the optimizer-state
        # dtype, the loss scale and the recorded mode name
        from .. import precision as precision_mod
        from ..precision.policy import canon_dtype, canon_remat
        self._precision = precision_mod.resolve(precision)
        if self._precision is not None:
            if compute_dtype is None:
                compute_dtype = self._precision.compute_dtype
            if remat is None:
                remat = self._precision.remat
        self._compute_dtype = canon_dtype(compute_dtype, "compute_dtype")
        if remat is None and os.environ.get(
                "MXNET_BACKWARD_DO_MIRROR", "0") == "1":
            # the reference's activation-recompute switch
            remat = "full"
        if remat is not None and not callable(remat):
            try:
                remat = canon_remat(remat)
            except MXNetError:
                raise ValueError(
                    "remat must be None, 'full', 'dots'/'dots_saveable', "
                    "'bn_stats'/'offload_bn_stats' or a checkpoint-policy "
                    "callable (got %r)" % (remat,))
        self._remat = remat
        # {data input name: data.DeviceAugment}; fit() adopts the train
        # iterator's device_augment_spec when this is empty
        self._device_augment = dict(device_augment or {})
        self._allow_fused = _allow_fused
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        if len(context) != 1:
            raise MXNetError(
                "one process binds one device; got %d contexts (several "
                "devices in one process come with the model-parallel half "
                "of the port, ROADMAP A8b; data parallelism runs one "
                "process per device, mxnet_tpu_torch.dist)" % len(context))
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
        self._kvstore = None
        self._update_on_kvstore = False
        # the store update() routes gradients through: None without one,
        # and for a synchronous dist store, whose sum the group's step
        # makes itself (over the dp world of the bind)
        self._grad_kvstore = None
        self._dp_reduce = True      # False: a dist_async store reduces
        self._preload_opt_states = None
        self._exec_group = None
        self._eval_pad_extra = 0
        self._shared_from_fused = False
        self.inputs_need_grad = False
        if work_load_list is not None and len(work_load_list) != 1:
            raise MXNetError("work_load_list must have one entry per "
                             "context")

    @property
    def precision_mode(self):
        """The recorded precision-mode name ('f32' without a policy): the
        spelling checkpoint manifests carry and serving compares."""
        from ..precision.policy import mode_name
        return mode_name(self._precision)

    @property
    def _opt_state_dtype(self):
        return None if self._precision is None \
            else self._precision.opt_state_dtype

    @property
    def _fused(self):
        return getattr(self._exec_group, "fused", False)

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        """The bound (name, shape) pairs of the data inputs."""
        self._need_bind()
        return list(self._exec_group.data_shapes)

    @property
    def label_shapes(self):
        """The bound (name, shape) pairs of the labels, or None."""
        self._need_bind()
        shapes = self._exec_group.label_shapes
        return None if shapes is None else list(shapes)

    @property
    def output_shapes(self):
        """(name, shape) of each output at the bound shapes."""
        self._need_bind()
        return list(zip(self.output_names,
                        [o.shape for o in self._exec_group.get_outputs()]))

    def _need_bind(self):
        if not self.binded:
            raise MXNetError("call bind first")

    # ----------------------------------------------------------- persistence
    @staticmethod
    def load(prefix, epoch=None, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint of either package; the parameters
        are set when it is bound, the optimizer states (with
        ``load_optimizer_states``) when its optimizer is created.

        ``prefix`` is a legacy file prefix (``prefix-symbol.json`` +
        ``prefix-%04d.params``, ``epoch`` required), or a
        ``CheckpointManager`` or its directory: then ``epoch`` selects a
        committed step (default: the latest) and the symbol comes from
        the entry. A prefix that also names a directory without
        committed entries stays a prefix. ``kwargs`` go to ``Module``."""
        from ..checkpoint import CheckpointManager
        from ..checkpoint.manager import is_checkpoint_dir
        if isinstance(prefix, CheckpointManager) or (
                isinstance(prefix, str) and os.path.isdir(prefix) and
                (epoch is None or is_checkpoint_dir(prefix))):
            return Module._load_from_manager(prefix, epoch,
                                             load_optimizer_states, **kwargs)
        if epoch is None:
            raise MXNetError("epoch is required when loading from a legacy "
                             "prefix")
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=ctx_mod.cpu())
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    @staticmethod
    def _load_from_manager(manager, step=None, load_optimizer_states=False,
                           **kwargs):
        """A Module over a ``CheckpointManager`` entry, which carries its
        symbol JSON in the manifest's ``extra``."""
        from .. import symbol as sym_mod
        from ..checkpoint import CheckpointManager, split_params
        if not isinstance(manager, CheckpointManager):
            manager = CheckpointManager(manager)
        ckpt = manager.restore(step)
        sym_json = ckpt.extra.get("symbol")
        if sym_json is None:
            raise MXNetError(
                "checkpoint step %d in %s carries no symbol — it was not "
                "saved by Module.save_checkpoint(manager=...)"
                % (ckpt.step, manager.directory))
        saved_mode = str(ckpt.extra.get("precision_mode", "f32"))
        if "precision" not in kwargs and saved_mode != "f32":
            # adopt the recorded mode, so the module (and its optimizer
            # state dtype) continues in the numerics family the entry was
            # trained in; an explicit precision= wins
            kwargs["precision"] = Module._policy_from_manifest(
                saved_mode, ckpt.extra.get("precision"))
        arg_np, aux_np = split_params(ckpt.params)
        mod = Module(symbol=sym_mod.load_json(sym_json), **kwargs)
        mod._ckpt_precision_mode = saved_mode
        mod._ckpt_params_digest = ckpt.extra.get("params_digest")
        if mod.precision_mode != saved_mode:
            logging.warning(
                "checkpoint step %d was saved under precision mode %r but "
                "the restored module runs %r; serving it will be refused",
                ckpt.step, saved_mode, mod.precision_mode)
        cpu = ctx_mod.cpu()
        mod._arg_params = {k: nd.array(v, ctx=cpu, dtype=v.dtype)
                           for k, v in arg_np.items()}
        mod._aux_params = {k: nd.array(v, ctx=cpu, dtype=v.dtype)
                           for k, v in aux_np.items()}
        mod.params_initialized = True
        if load_optimizer_states:
            if ckpt.optimizer_state is None:
                raise MXNetError(
                    "checkpoint step %d in %s has no optimizer state "
                    "(save with save_optimizer_states=True)"
                    % (ckpt.step, manager.directory))
            mod._preload_opt_states = ckpt.optimizer_state
        return mod

    @staticmethod
    def _policy_from_manifest(mode, desc):
        """The PrecisionPolicy a manifest recorded (mode name and
        ``describe()`` fields). A registered mode whose fields still
        match is returned as is; otherwise the recorded fields win. A
        custom remat callable cannot ride a manifest."""
        from .. import precision as precision_mod
        desc = dict(desc or {})
        pol = precision_mod.MODES.get(mode)
        if pol is not None:
            if not desc or pol.describe() == desc:
                return pol
            logging.warning(
                "checkpoint precision mode %r no longer matches the "
                "registered mode's fields; restoring the policy the "
                "checkpoint recorded (%r)", mode, desc)
        if desc.get("remat") == "custom":
            raise MXNetError(
                "checkpoint was saved under an ad-hoc precision policy "
                "with a custom remat callable (%r); pass the policy with "
                "precision= when loading" % mode)

        def _field(key):
            v = desc.get(key)
            return None if v in (None, "float32", "none") else v

        return precision_mod.PrecisionPolicy(
            name=mode, compute_dtype=_field("compute_dtype"),
            opt_state_dtype=_field("opt_state_dtype"),
            remat=_field("remat"), act_cast=desc.get("act_cast"),
            weight_quant=desc.get("weight_quant"),
            narrow_math=desc.get("narrow_math"),
            loss_scale=desc.get("loss_scale"),
            loss_scale_window=desc.get("loss_scale_window"),
            experimental=bool(desc.get("experimental", False)))

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        manager=None, async_save=True, extra=None):
        """Save symbol, parameters and, with ``save_optimizer_states``,
        the optimizer states.

        Without ``manager``: ``prefix-symbol.json``,
        ``prefix-%04d.params`` and ``prefix-%04d.states``. With
        ``manager=`` (a ``CheckpointManager``): one step entry numbered
        ``epoch``, async by default, carrying the symbol, the epoch, the
        RNG state and ``params_digest`` in its manifest, so that
        ``fit(resume_from=manager)`` restores everything; ``prefix`` is
        then ignored and may be None. ``extra`` merges into the
        manifest's metadata."""
        if manager is not None:
            return self._save_to_manager(manager, epoch,
                                         save_optimizer_states, async_save,
                                         extra)
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        self.logger.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            self.logger.info('Saved optimizer state to "%s"', state_name)

    def _save_to_manager(self, manager, step, save_optimizer_states,
                         async_save, extra=None):
        from ..checkpoint import pack_params, params_digest
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params first")
        grp = self._exec_group
        # the bound tensors themselves: the manager copies each to the
        # host before save() returns, one copy from the card
        arrays = pack_params(
            {n: a[0] for n, a in zip(self._param_names, grp.param_arrays)},
            {n: a[0] for n, a in zip(self._aux_names, grp.aux_arrays)})
        opt_state = None
        if save_optimizer_states:
            if not self.optimizer_initialized:
                raise MXNetError("call init_optimizer first")
            opt_state = self._states_updater().get_states()
        sym_json = self._symbol.tojson()
        merged = {"epoch": int(step), "symbol": sym_json,
                  "precision_mode": self.precision_mode,
                  "params_digest": params_digest(sym_json, arrays)}
        if self._precision is not None:
            merged["precision"] = self._precision.describe()
        rt = getattr(grp, "_dp", None)
        if rt is not None:
            # the width it was trained at; a resume may run at another
            merged["dp_width"] = rt.size
        if extra:
            merged.update(extra)
        if rt is not None and rt.rank != 0:
            # the ranks hold the same state: rank 0 commits the entry
            return step
        manager.save(step, arrays, optimizer_state=opt_state, extra=merged,
                     async_save=async_save)
        self.logger.info('Staged checkpoint step %d into "%s"%s', step,
                         manager.directory,
                         " (async)" if async_save else "")
        return step

    def _states_updater(self):
        """The updater that holds the optimizer states: the kvstore's
        when the update runs on it, else the module's."""
        return self._kvstore._updater if self._update_on_kvstore \
            else self._updater

    def save_optimizer_states(self, fname):
        """Write the optimizer states (``Updater.get_states``) to
        ``fname``."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        from ..checkpoint.serialize import atomic_write_bytes
        atomic_write_bytes(fname, self._states_updater().get_states())

    def load_optimizer_states(self, fname):
        """Restore optimizer states from a ``.states`` file or from the
        raw bytes of a checkpoint entry."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        if isinstance(fname, (bytes, bytearray)):
            self._states_updater().set_states(bytes(fname))
            return
        with open(fname, "rb") as fin:
            self._states_updater().set_states(fin.read())

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
        grp = self._exec_group
        if grp._dp is not None:
            # every rank starts from rank 0's values (the kvstore init of
            # MXNet's dist training): one broadcast per dtype
            grp._dp.broadcast_tensors_(
                [a[0]._read() for a in grp.param_arrays] +
                [a[0]._read() for a in grp.aux_arrays])
            self._params_dirty = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor group for the given input shapes: the fused
        ``MeshExecutorGroup`` when the bind is eligible
        (:meth:`_fused_eligible`), else the classic group.

        ``shared_module`` (a bound, initialized Module over the same
        parameters): this module computes from the shared module's
        parameter and aux tensors themselves, the same storage, so one
        ``set_params`` on either reaches both. A training bind shares on
        the classic route only (``BucketingModule``'s buckets), where the
        gradient tensors are shared too where their shapes agree, and it
        borrows the shared module's optimizer once it has one; the fused
        route binds shared modules for inference."""
        if force_rebind:
            if self.binded and self.params_initialized:
                # the bound arrays hold the trained values: the new group
                # starts from them, whichever route it takes
                self.get_params()
            self.binded = False
            self._exec_group = None
            self._eval_pad_extra = 0
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if for_training and self._precision is not None and \
                self._precision.serving_only():
            # quantized weight storage and native narrow GEMMs have no
            # gradient story: they exist for inference only
            raise ValueError(
                "precision=%r is a serving-only mode (weight_quant/"
                "narrow_math); bind with for_training=False or train "
                "under a training mode and quantize post-training"
                % self._precision.name)
        shared_group = None
        if shared_module is not None:
            if not (isinstance(shared_module, Module) and
                    shared_module.binded and
                    shared_module.params_initialized):
                raise MXNetError("shared_module must be a bound Module "
                                 "with initialized parameters")
            shared_group = shared_module._exec_group
        data_shapes, label_shapes = _shape_pairs(data_shapes, label_shapes)
        shared_fused = getattr(shared_group, "fused", False)
        fused = self._fused_eligible(shared_group, inputs_need_grad,
                                     grad_req)
        if fused and shared_module is not None and for_training:
            raise MXNetError("shared_module binds for training on the "
                             "classic route only (_allow_fused=False); the "
                             "fused route shares for inference "
                             "(for_training=False)")
        if not fused:
            if self._precision is not None and \
                    not self._precision.is_default():
                # the modes live in the fused step; a silent classic
                # fallback would train float32 under the mode's name
                raise ValueError(
                    "precision=%r requires the fused mesh path, but this "
                    "bind is not fused-eligible (check MXNET_MODULE_FUSED, "
                    "_allow_fused, inputs_need_grad, grad_req='write')"
                    % self._precision.name)
            if self._device_augment:
                # the u8 wire layout and its staging augment exist on the
                # fused route only; a silent classic fallback would hand
                # the symbol uint8 NHWC blocks
                raise ValueError(
                    "device_augment requires the fused route, but this "
                    "bind is not fused-eligible (check MXNET_MODULE_FUSED, "
                    "_allow_fused, inputs_need_grad, grad_req='write')")
            if shared_fused:
                raise ValueError(
                    "shared_module uses the fused MeshExecutorGroup but "
                    "this bind is not fused-eligible; bind the shared "
                    "module with MXNET_MODULE_FUSED=0 to share classic "
                    "executors")
            if self._compute_dtype is not None or self._remat is not None:
                self.logger.warning(
                    "compute_dtype=%s / remat=%r apply on the fused route "
                    "only; this bind takes the classic route and runs "
                    "float32 without remat", self._compute_dtype,
                    self._remat)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._shared_from_fused = shared_fused
        if fused:
            self._exec_group = MeshExecutorGroup(
                self._symbol, self._context, data_shapes, label_shapes,
                self._param_names, for_training, self._fixed_param_names,
                grad_req, shared_group, compute_dtype=self._compute_dtype,
                remat=self._remat if for_training else None,
                precision=self._precision,
                device_augment=self._device_augment)
            # a re-bind keeps the step of an optimizer already attached
            self._exec_group._step_enabled = self.optimizer_initialized
        else:
            self._exec_group = DataParallelExecutorGroup(
                self._symbol, self._context, data_shapes, label_shapes,
                self._param_names, for_training, self._fixed_param_names,
                grad_req, shared_group, inputs_need_grad)
        self._attach_dp(self._exec_group)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self._params_dirty = False
            if for_training and shared_module.optimizer_initialized:
                self.borrow_optimizer(shared_module)
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _attach_dp(self, grp):
        """Give a new group the data-parallel world: the live runtime of
        two or more ranks (``dist.runtime.dp_runtime``), whose ranks each
        train their row block of one global batch."""
        from ..dist.runtime import dp_runtime
        grp._dp = dp_runtime()
        grp._reduce_grads = grp._dp is not None and self._dp_reduce

    @property
    def dp_world(self):
        """The number of ranks this module's step spans (1 alone)."""
        grp = self._exec_group
        rt = getattr(grp, "_dp", None)
        return rt.size if rt is not None else 1

    def _fused_eligible(self, shared_group, inputs_need_grad, grad_req):
        """Whether a bind takes the fused route: allowed
        (``_allow_fused``, ``MXNET_MODULE_FUSED`` not ``0``), a fused or
        no shared group, no input gradients, ``grad_req="write"``."""
        if not self._allow_fused or \
                os.environ.get("MXNET_MODULE_FUSED", "1") == "0":
            return False
        if shared_group is not None and \
                not getattr(shared_group, "fused", False):
            return False
        return not inputs_need_grad and grad_req == "write"

    def _fallback_to_classic(self, reason):
        """Swap the fused group for the classic one, keeping the
        parameters (and the optimizer state, whose keys are the same on
        one device)."""
        if getattr(self._exec_group, "_shared_out", False) or \
                self._shared_from_fused:
            raise MXNetError(
                "cannot leave the fused route (%s) while parameters are "
                "shared with another module; bind all modules with "
                "MXNET_MODULE_FUSED=0 instead" % reason)
        if self._precision is not None and not self._precision.is_default():
            raise MXNetError("cannot leave the fused route (%s): "
                             "precision=%r has no classic-route "
                             "equivalent" % (reason, self._precision.name))
        if self._device_augment:
            raise MXNetError("cannot leave the fused route (%s): "
                             "device_augment has no classic-route "
                             "equivalent" % reason)
        grp = self._exec_group
        grp._flush()
        grp.disable_device_metric()
        if self.params_initialized:
            self.get_params()
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, grp.data_shapes, grp.label_shapes,
            self._param_names, self.for_training, self._fixed_param_names,
            "write", None, False)
        self._attach_dp(self._exec_group)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        self.logger.info("%s: training continues on the classic route",
                         reason)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the kvstore and the optimizer; ``rescale_grad`` defaults
        to 1/batch, and a precision mode's optimizer-state dtype becomes
        its ``state_dtype``.

        ``kvstore``: ``None`` or a local kind's name means no store on one
        device (``model._create_kvstore``); a ``KVStore`` instance gets
        the optimizer and every ``update()`` pushes the gradients to it
        and pulls the weights back (update on the kvstore). Without a
        store, on the fused route, it turns on the one-function step
        that ``update()`` runs.

        Data parallelism (a bind over a world of R ranks, or a dist
        store): ``dist_sync``, ``dist_device_sync`` and ``dist`` keep the
        one-function step, which sums the gradients over the ranks (one
        all-reduce) before the optimizer, every rank applying the same
        update; ``rescale_grad`` defaults to 1/(R × batch), the global
        batch, as the JAX package's ``psum`` step has it. ``dist_async``
        updates on its store (each push applied one step late) from the
        rank's own gradients, with ``rescale_grad`` 1/batch (the
        reference scales ``_sync`` kinds only)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params first")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring")
            return
        from ..kvstore import SYNC_DIST
        kvstore, update_on_kvstore = _create_kvstore(kvstore, 1,
                                                     self._arg_params)
        grp = self._exec_group
        sync_dist = kvstore is not None and kvstore.type in SYNC_DIST
        if sync_dist:
            update_on_kvstore = False   # the step sums; every rank updates
        self._dp_reduce = not (kvstore is not None
                               and kvstore.type == "dist_async")
        grp._reduce_grads = grp._dp is not None and self._dp_reduce
        batch = grp.batch_size
        if self._dp_reduce:
            batch *= self.dp_world
        want = self._opt_state_dtype
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", 1.0 / batch)
            if want is not None:
                optimizer_params.setdefault("state_dtype", want)
            optimizer = opt.create(
                optimizer, sym=self.symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        else:
            have = getattr(optimizer, "state_dtype", None)
            if want is not None and have is None:
                optimizer.state_dtype = want
            elif want is not None and have != want:
                raise MXNetError(
                    "optimizer instance carries state_dtype=%r but the "
                    "module's precision mode %r wants %r; drop one of the "
                    "two settings" % (have, self.precision_mode, want))
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._grad_kvstore = None if sync_dist else kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if self._grad_kvstore:
            _initialize_kvstore(kvstore, grp.param_arrays,
                                self._arg_params, self._param_names,
                                update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._fused:
            grp._step_enabled = self._grad_kvstore is None
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Train with ``shared_module``'s optimizer and updater (one
        optimizer state for modules over the same parameters)."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("shared_module has no optimizer")
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self._kvstore = shared_module._kvstore
        self._grad_kvstore = shared_module._grad_kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self.optimizer_initialized = True
        if self._fused:
            self._exec_group._step_enabled = self._grad_kvstore is None

    def reshape(self, data_shapes, label_shapes=None):
        """Bind again at new input shapes on the same parameters: every
        parameter and aux tensor keeps its storage."""
        self._need_bind()
        data_shapes, label_shapes = _shape_pairs(data_shapes, label_shapes)
        self._exec_group.reshape(data_shapes, label_shapes)

    def forward(self, data_batch, is_train=None):
        """Run the forward on ``data_batch``. An eval batch that is only
        short runs padded to the bound shape; any other batch whose
        shapes differ from the bound ones re-binds through ``reshape``
        first."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params first")
        self._eval_pad_extra = 0
        train = self.for_training if is_train is None else bool(is_train)
        if not train:
            data_batch = self._pad_eval_tail(data_batch)
        else:
            data_batch = self._rank_block(data_batch)
        self._reshape_to(data_batch)
        self._exec_group.forward(data_batch, is_train)

    def _rank_block(self, batch):
        """A training batch of R times the bound rows under a data-parallel
        world of R ranks is a replicated global batch: this rank trains
        its row block of it (``dist.sharded_iter.rank_batch``). Any other
        batch is the rank's own."""
        grp = self._exec_group
        rt = getattr(grp, "_dp", None)
        if rt is None or batch.data[0].shape[0] != grp.batch_size * rt.size:
            return batch
        from ..dist.sharded_iter import rank_batch
        return rank_batch(batch, rt.rank, rt.size)

    def _reshape_to(self, batch):
        """Re-bind at ``batch``'s shapes when they differ from the bound
        ones. Labels take the batch's shapes, or, when it has none, the
        bound ones with the new batch size."""
        grp = self._exec_group
        if getattr(grp, "_device_augment", None):
            # wire batches: compare what the bound arrays hold, and re-bind
            # the wire entries at the batch's size
            new = grp.model_view_shapes(batch)
            if new == [tuple(s) for _, s in grp._bind_data_shapes]:
                return
            rows = new[0][0]
            data_shapes = [(name, (rows,) + tuple(shape[1:]))
                           for name, shape in grp.data_shapes]
        else:
            new = [tuple(d.shape) for d in batch.data]
            if new == [tuple(s) for _, s in grp.data_shapes]:
                return
            data_shapes = [(name, shape) for (name, _), shape
                           in zip(grp.data_shapes, new)]
        label_shapes = grp.label_shapes
        if label_shapes and batch.label:
            label_shapes = [(name, tuple(lb.shape)) for (name, _), lb
                            in zip(label_shapes, batch.label)]
        elif label_shapes:
            label_shapes = [(name, (new[0][0],) + tuple(shape[1:]))
                            for name, shape in label_shapes]
        self.reshape(data_shapes, label_shapes)

    def _pad_eval_tail(self, batch):
        """An eval batch with fewer rows than the bound batch, and the
        bound trailing dimensions, runs zero-padded to the bound shape
        (``pad_batch_rows``, the rule the serving buckets use). Rows are
        independent in an eval forward; the extra rows are dropped again
        by ``_unpadded_outputs`` and ``update_metric`` through
        ``_eval_pad_extra``. A batch whose other dimensions differ is a
        true reshape and is returned as it is."""
        from ..io import DataBatch
        target = self._exec_group.batch_size
        rows = batch.data[0].shape[0] if batch.data else 0
        if rows == 0 or rows >= target:
            return batch
        for (_name, shape), arr in zip(self._exec_group.data_shapes,
                                       batch.data):
            if tuple(arr.shape[1:]) != tuple(shape[1:]):
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
        """Apply the optimizer to every parameter with a gradient: on the
        kvstore (push the gradients, pull the weights) when it updates
        there; else on the fused route the deferred step runs as one
        function (``MeshExecutorGroup.step_update``); otherwise, or when
        the gradients were read first, the classic update."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        self._params_dirty = True
        grp = self._exec_group
        if self._update_on_kvstore:
            _update_params_on_kvstore(grp.param_arrays, grp.grad_arrays,
                                      self._kvstore)
            return
        if self._fused and self._grad_kvstore is None and \
                grp.step_update(self._updater):
            return
        _update_params(grp.param_arrays, grp.grad_arrays, self._updater,
                       kvstore=self._grad_kvstore)

    def grouped_train_engaged(self):
        """Whether a grouped (``fit(batch_group=K)``) step has run on
        this module."""
        return self._grouped_steps > 0

    _grouped_steps = 0

    def _fit_grouped_ready(self, eval_metric):
        """``fit(batch_group=K)`` runs the whole group on the device: it
        needs the fused step (fused group, an optimizer with a pure
        apply) and the metric on the device tally, since a group has no
        per-batch outputs to update a host metric from."""
        grp = self._exec_group
        if not (self._fused and grp._step_enabled):
            return False
        if self._updater is None or \
                self._updater.fused_apply_or_none() is None:
            return False
        return grp._metric_live is eval_metric

    def _grouped_step(self, batches):
        """Stack K iterator batches into one (K, batch, ...) block per
        input and run them as one grouped step
        (``MeshExecutorGroup.step_update_grouped``)."""
        if not self._fused:
            return False
        grp = self._exec_group
        self._eval_pad_extra = 0
        stacked = self._staged_group_block(batches)
        if stacked is None:
            stacked = stack_group_inputs(batches,
                                         [d[0] for d in grp.data_shapes],
                                         grp._label_names)
        if not grp.step_update_grouped(self._updater, stacked):
            return False
        self._params_dirty = True
        self._grouped_steps += 1
        return True

    @staticmethod
    def _staged_group_block(batches):
        """When the batches are, in order, the views of ONE block a
        ``DeviceLoader`` staged for exactly this group, that block's
        staged input dict (the grouped step consumes it as it is); else
        None (the generic stacking path)."""
        block = getattr(batches[0], "_staged_block", None)
        if block is None or \
                getattr(batches[0], "_staged_size", -1) != len(batches):
            return None
        for j, b in enumerate(batches):
            if getattr(b, "_staged_block", None) is not block or \
                    getattr(b, "_staged_index", -1) != j:
                return None
        return block

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate; on the fused route with a metric that has a device
        statistic, the tally rides the device (one forward per batch, one
        readback). Per-batch callbacks need the running host value, so
        they keep the host loop, as ``MXNET_DEVICE_METRIC=0`` does."""
        from .. import metric as metric_mod
        if batch_end_callback is None and self._fused and \
                os.environ.get("MXNET_DEVICE_METRIC", "1") != "0":
            if not (self.binded and self.params_initialized):
                raise MXNetError("call bind and init_params first")
            eval_metric = metric_mod.create(eval_metric)
            if reset:
                eval_data.reset()
            result = self._exec_group.score_device(eval_data, eval_metric,
                                                   num_batch)
            if result is not None:
                pairs, seen = result
                self._fire(score_end_callback, epoch, seen, eval_metric,
                           locals())
                return pairs
            reset = False   # already rewound; the device path declined
        return super().score(eval_data, eval_metric, num_batch=num_batch,
                             batch_end_callback=batch_end_callback,
                             score_end_callback=score_end_callback,
                             reset=reset, epoch=epoch)

    def _install_device_metric(self, eval_metric):
        """Put ``fit``'s training metric on the device tally (fused route;
        ``MXNET_DEVICE_METRIC=0`` keeps the host metric)."""
        if not self._fused:
            return
        if os.environ.get("MXNET_DEVICE_METRIC", "1") == "0":
            self._exec_group.disable_device_metric()
            return
        self._exec_group.enable_device_metric(eval_metric)

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        """The gradients of the data inputs (bind with
        ``inputs_need_grad=True``, which takes the classic route)."""
        if not (self.binded and self.params_initialized and
                self.inputs_need_grad):
            raise MXNetError("bind with inputs_need_grad=True first")
        return self._exec_group.get_input_grads(merge_multi_context)

    def install_monitor(self, mon):
        """Tap every op output of this module's executor into ``mon``. The
        fused step has no per-op boundaries to tap, so a fused module
        moves to the classic route first, keeping its parameters and
        optimizer state (the JAX package does the same)."""
        self._need_bind()
        if self._fused:
            self._fallback_to_classic("install_monitor needs per-op taps")
        self._exec_group.install_monitor(mon)

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


def _shape_pairs(data_shapes, label_shapes):
    """(name, shape tuple) pairs of data and labels (labels: or None)."""
    data = [(x[0], tuple(x[1])) for x in data_shapes]
    label = [(x[0], tuple(x[1])) for x in label_shapes] \
        if label_shapes else None
    return data, label
