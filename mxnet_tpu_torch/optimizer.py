"""Optimizers (PyTorch counterpart of ``mxnet_tpu/optimizer.py``).

Same registry + Updater contract as the JAX package, for SGD with
momentum, weight decay and gradient rescaling, Adam and RMSProp, and
MXNet 0.9.5's ``DCASGD``, ``NAG``, ``SGLD``, ``ccSGD``, ``AdaGrad``,
``AdaDelta``, ``Ftrl`` and ``Test``. As in the JAX package, only SGD (and
its alias ``ccSGD``), Adam and RMSProp have a pure ``_fused_apply``; the
others update one parameter at a time with NDArray arithmetic, on the
classic update route (``NAG`` overrides ``SGD.update``, so it takes that
route too). ``SGLD`` draws its noise from the port's key path
(``random.next_key``, one key an update).
``update`` (one parameter) calls the update ops of
``ops/optimizer_ops.py`` with ``out=`` set to the weight and its state,
so each update lands in place. A step
(``Updater.update_multi`` on the classic route, the fused route's step
in ``module/mesh_executor_group.py``) calls the optimizer's pure
per-parameter ``_fused_apply`` through ``Updater.fused_apply_or_none``;
it computes the ops' operations in their order, so every path agrees
bit for bit. A learning-rate scheduler reads
``num_update``, the largest per-parameter update count so far. A training
step updates every parameter through ``Updater.update_multi``, which, in
the JAX package's order, counts the step's updates first and then reads
each parameter's lr, so every parameter of step k sees ``num_update`` k.

``Optimizer(state_dtype="bfloat16")`` (set by a precision mode) stores
the state in bfloat16; only the fused route takes it, through
``precision.wrap_fused_apply`` (float32 update math, the state rounded
back on the way out); the classic route refuses it.

``Updater.get_states``/``set_states`` carry the optimizer state and its
update clock in the JAX package's v2 envelope, with numpy leaves (a
bfloat16 leaf as its uint16 words, tagged ``bfloat16`` in the per-leaf
dtype record, which ``set_states`` verifies): a restored state goes back
onto its weight's device at the first update.
"""
from __future__ import annotations

import io
import math
import pickle

import numpy
import torch

from .base import MXNetError
from . import random as _random
from .ndarray import (NDArray, array, zeros, sgd_update, sgd_mom_update,
                      adam_update, rmsprop_update, rmspropalex_update,
                      clip, square, sqrt)

__all__ = ["Optimizer", "SGD", "Adam", "RMSProp", "DCASGD", "NAG", "SGLD",
           "ccSGD", "AdaGrad", "AdaDelta", "Ftrl", "Test", "Updater",
           "get_updater", "create", "register"]


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
                 sym=None, begin_num_update=0, state_dtype=None):
        # storage dtype of the state leaves: None follows the weight;
        # "bfloat16" (a precision mode) narrows it, fused route only
        if state_dtype is not None:
            from .precision.policy import canon_dtype
            state_dtype = canon_dtype(state_dtype, "state_dtype")
        self.state_dtype = state_dtype
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

    def _state_zeros_dtype(self, weight):
        """The dtype state zeros are allocated with: the weight's, or the
        narrowed ``state_dtype``."""
        from .precision.policy import state_np_dtype
        return state_np_dtype(self.state_dtype, weight.dtype)

    def update(self, index, weight, grad, state):
        """Update one parameter: read its lr and wd, count the update,
        apply it."""
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        self._apply(weight, grad, state, lr, wd)

    def _apply(self, weight, grad, state, lr, wd):
        raise NotImplementedError()

    def set_lr_scale(self, args_lrscale):
        """Deprecated in MXNet 0.9.5 as in the JAX package: raises
        ``DeprecationWarning``; use :meth:`set_lr_mult`."""
        raise DeprecationWarning

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
        return zeros(weight.shape, weight.context,
                     dtype=self._state_zeros_dtype(weight))

    def _fused_apply(self, xp, p, g, s, lr, wd):
        """Pure one-parameter step of the fused route (``xp`` is torch);
        the operations and their order are ``sgd_mom_update``'s, so it
        matches the classic update bit for bit."""
        g = g * self.rescale_grad
        if self.clip_gradient:
            g = xp.clamp(g, -self.clip_gradient, self.clip_gradient)
        g = g + wd * p
        if self.momentum == 0.0:
            return p - lr * g, s
        new_s = self.momentum * s - lr * g
        return p + new_s, new_s

    def _apply(self, weight, grad, state, lr, wd):
        kwargs = {"rescale_grad": self.rescale_grad, "lr": lr, "wd": wd}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        if state is not None:
            sgd_mom_update(weight, grad, state, out=[weight, state],
                           momentum=self.momentum, **kwargs)
        else:
            sgd_update(weight, grad, out=weight, **kwargs)


@register
class Adam(Optimizer):
    """Adam through the ``adam_update`` op, with the per-step bias
    correction folded into the learning rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        dtype = self._state_zeros_dtype(weight)
        return (zeros(weight.shape, weight.context, dtype=dtype),
                zeros(weight.shape, weight.context, dtype=dtype))

    def _fused_lr(self, index):
        """The bias-corrected lr of ``index`` at its current update count
        (read after the count, as a step reads it)."""
        t = self._index_update_count[index]
        return self._get_lr(index) * math.sqrt(1.0 - self.beta2 ** t) / \
            (1.0 - self.beta1 ** t)

    def _fused_apply(self, xp, p, g, s, lr, wd):
        mean, var = s
        g = g * self.rescale_grad
        if self.clip_gradient:
            g = xp.clamp(g, -self.clip_gradient, self.clip_gradient)
        g = g + wd * p
        new_mean = self.beta1 * mean + (1 - self.beta1) * g
        new_var = self.beta2 * var + (1 - self.beta2) * xp.square(g)
        new_p = p - lr * new_mean / (xp.sqrt(new_var) + self.epsilon)
        return new_p, (new_mean, new_var)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        self._apply(weight, grad, state, lr, wd)

    def _apply(self, weight, grad, state, lr, wd):
        mean, var = state
        kwargs = {"rescale_grad": self.rescale_grad, "lr": lr, "wd": wd,
                  "beta1": self.beta1, "beta2": self.beta2,
                  "epsilon": self.epsilon}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        adam_update(weight, grad, mean, var, out=[weight, mean, var],
                    **kwargs)


@register
class RMSProp(Optimizer):
    """RMSProp through ``rmsprop_update`` (Tieleman, ``centered=False``:
    state (n,)) or ``rmspropalex_update`` (Graves, ``centered=True``:
    state (n, g, delta))."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        dtype = self._state_zeros_dtype(weight)
        n = 3 if self.centered else 1
        return tuple(zeros(weight.shape, weight.context, dtype=dtype)
                     for _ in range(n))

    def _fused_apply(self, xp, p, g, s, lr, wd):
        """The ops' operations in their order, so it matches the classic
        update bit for bit."""
        g = g * self.rescale_grad
        if self.clip_gradient:
            g = xp.clamp(g, -self.clip_gradient, self.clip_gradient)
        g = g + wd * p
        g1 = self.gamma1
        new_n = (1 - g1) * xp.square(g) + g1 * s[0]
        if not self.centered:
            new_p, new_s = p - lr * g / xp.sqrt(new_n + self.epsilon), \
                (new_n,)
        else:
            new_g = (1 - g1) * g + g1 * s[1]
            new_d = self.gamma2 * s[2] - lr * g / xp.sqrt(
                new_n - xp.square(new_g) + self.epsilon)
            new_p, new_s = p + new_d, (new_n, new_g, new_d)
        if self.clip_weights:
            new_p = xp.clamp(new_p, -self.clip_weights, self.clip_weights)
        return new_p, new_s

    def _apply(self, weight, grad, state, lr, wd):
        kwargs = {"rescale_grad": self.rescale_grad, "lr": lr, "wd": wd,
                  "gamma1": self.gamma1, "epsilon": self.epsilon}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        if self.clip_weights:
            kwargs["clip_weights"] = self.clip_weights
        if not self.centered:
            (n,) = state
            rmsprop_update(weight, grad, n, out=[weight, n], **kwargs)
        else:
            n, g, delta = state
            rmspropalex_update(weight, grad, n, g, delta,
                               out=[weight, n, g, delta],
                               gamma2=self.gamma2, **kwargs)


def _clipped(opt, grad):
    """``grad * rescale_grad``, clipped to ``clip_gradient`` when set."""
    grad = grad * opt.rescale_grad
    if opt.clip_gradient is not None:
        grad = clip(grad, a_min=-opt.clip_gradient, a_max=opt.clip_gradient)
    return grad


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the state is the momentum (or
    None) and the weight of the previous update."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (zeros(weight.shape, weight.context, dtype=weight.dtype),
                weight.copy())

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = _clipped(self, grad)
        mom, previous_weight = state
        comp = grad + wd * weight + \
            self.lamda * grad * grad * (weight - previous_weight)
        if mom is not None:
            mom *= self.momentum
            mom += -lr * comp
            delta = mom
        else:
            delta = -lr * comp
        weight.copyto(previous_weight)
        weight += delta


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = _clipped(self, grad)
        if state is not None:
            mom = state
            mom *= self.momentum
            grad += wd * weight
            mom += grad
            grad += self.momentum * mom
            weight += -lr * grad
        else:
            weight += -lr * (grad + wd * weight)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: a half step of SGD plus
    Gaussian noise of variance lr, drawn from ``random.next_key``."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = _clipped(self, grad)
        noise = _random.key_normal(_random.next_key(), weight.shape,
                                   weight._read().device)
        weight += -lr / 2 * (grad + wd * weight) + NDArray(
            noise.to(weight._read().dtype) * math.sqrt(lr),
            ctx=weight.context)


@register
class ccSGD(SGD):
    """Kept for compatibility: an alias of SGD (its fused step too)."""


@register
class AdaGrad(Optimizer):
    """AdaGrad: the state is the running sum of squared gradients."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = _clipped(self, grad)
        history = state
        history += square(grad)
        weight += -lr * (grad / sqrt(history + self.float_stable_eps)
                         + wd * weight)


@register
class AdaDelta(Optimizer):
    """AdaDelta: running averages of squared gradients and updates."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        grad = _clipped(self, grad)
        acc_g, acc_delta = state
        acc_g *= self.rho
        acc_g += (1.0 - self.rho) * grad * grad
        current_delta = sqrt(acc_delta + self.epsilon) / \
            sqrt(acc_g + self.epsilon) * grad
        acc_delta *= self.rho
        acc_delta += (1.0 - self.rho) * current_delta * current_delta
        weight -= current_delta + wd * weight


@register
class Ftrl(Optimizer):
    """FTRL-proximal; the closed-form weight is computed on the host, as
    in the JAX package."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(**kwargs)
        self.lamda1 = lamda1
        self.beta = beta
        self.lr = learning_rate

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        lr = self._get_lr(index)
        grad = _clipped(self, grad)
        dn, n = state
        dn += grad - (sqrt(n + grad * grad) - sqrt(n)) * weight / lr
        n += grad * grad
        dn_np = dn.asnumpy()
        n_np = n.asnumpy()
        w = -(dn_np - numpy.sign(dn_np) * self.lamda1) / \
            ((self.beta + numpy.sqrt(n_np)) / lr + wd)
        w *= (numpy.abs(dn_np) > self.lamda1)
        weight[:] = w


@register
class Test(Optimizer):
    """Test optimizer: ``w += -lr * rescale_grad * grad``."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad * (-self.lr)


def _map_leaves(state, fn):
    """``state`` (None, a leaf, or a tuple/list tree) with ``fn`` applied
    to every leaf."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_map_leaves(s, fn) for s in state)
    return fn(state)


def _host_leaf(leaf):
    """A state leaf as a host numpy array: a bfloat16 tensor as its
    uint16 words (numpy has no bfloat16)."""
    if isinstance(leaf, NDArray):
        t = leaf._read().detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(numpy.uint16)
        return t.cpu().numpy().copy()
    return numpy.asarray(leaf)


def _leaf_dtype_name(leaf):
    """The dtype name a state leaf records: ``bfloat16`` for a bfloat16
    tensor or a restored leaf of its words, else numpy's name."""
    if isinstance(leaf, NDArray):
        t = leaf._read()
        if t.dtype == torch.bfloat16:
            return "bfloat16"
        return numpy.dtype(leaf.dtype).name
    if isinstance(leaf, _Bf16Words):
        return "bfloat16"
    return numpy.dtype(numpy.asarray(leaf).dtype).name


class _Bf16Words(object):
    """A restored bfloat16 state leaf held on the host as its uint16
    words until its first update moves it onto the weight's device."""

    __slots__ = ("words",)

    def __init__(self, words):
        self.words = words

    def to_tensor(self, device):
        return torch.from_numpy(self.words.view(numpy.int16).copy()) \
            .view(torch.bfloat16).to(device)


def _device_leaf(leaf, weight):
    """A restored host leaf as an NDArray on ``weight``'s device."""
    if isinstance(leaf, _Bf16Words):
        return NDArray(leaf.to_tensor(weight._read().device),
                       ctx=weight.context)
    return array(leaf, ctx=weight.context, dtype=leaf.dtype)


class _StateUnpickler(pickle.Unpickler):
    """Unpickles only what ``get_states`` writes: builtins and numpy. A
    payload of the JAX package (leaves that are its NDArrays, JAX arrays
    or ml_dtypes bfloat16 arrays) is refused with the name of the package
    that wrote it."""

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
            st = _map_leaves(st, lambda leaf: _device_leaf(leaf, weight))
            self.states[index] = st
        return st

    def _refuse_narrowed(self):
        """The classic per-parameter update computes at the storage dtype;
        a narrowed ``state_dtype`` needs the fused route's float32 math."""
        if getattr(self.optimizer, "state_dtype", None) is not None:
            raise MXNetError(
                "optimizer state_dtype=%r requires the fused one-program "
                "update path (Module on the fused MeshExecutorGroup with "
                "a pure _fused_apply optimizer); the classic per-param "
                "update would compute in the storage dtype"
                % self.optimizer.state_dtype)

    def __call__(self, index, grad, weight):
        self._refuse_narrowed()
        self.optimizer.update(index, weight, grad, self._state(index, weight))

    def update_multi(self, triples):
        """Update every (index, grad, weight) of one step: count them all,
        then apply each with the lr it reads now (the JAX package's
        ``Updater.update_multi`` order; Adam's bias-corrected lr at the
        new count), through the optimizer's ``_fused_apply`` (the same
        operations as its update op, so bit for bit the same result).
        An optimizer without a pure apply runs its own ``update`` one
        parameter at a time, as the JAX package's does."""
        opt = self.optimizer
        fa = self.fused_apply_or_none()
        if fa is None:
            for index, grad, weight in triples:
                self(index, grad, weight)
            return
        get_lr = getattr(opt, "_fused_lr", opt._get_lr)
        for index, _, weight in triples:
            self._state(index, weight)
            opt._update_count(index)
        for index, grad, weight in triples:
            lr, wd = get_lr(index), opt._get_wd(index)
            p, st = fa(torch, weight._read(), grad._read(),
                       self.read_state_tree(index, weight), lr, wd)
            weight._write(p)
            self.write_state_tree(index, st)

    def fused_apply_or_none(self):
        """The optimizer's pure per-parameter apply, or None when the
        per-parameter ``update`` must run: no ``_fused_apply``, or a
        subclass overrode ``update`` below the class that defines
        ``_fused_apply`` (its numerics would differ). A narrowed
        ``state_dtype`` rides as ``precision.wrap_fused_apply``."""
        opt = self.optimizer
        fa = getattr(opt, "_fused_apply", None)
        if fa is None:
            return None

        def _defining(name):
            for c in type(opt).__mro__:
                if name in c.__dict__:
                    return c
            return None

        cf, cu = _defining("_fused_apply"), _defining("update")
        if cf is None or cu is None or not issubclass(cf, cu):
            return None
        if getattr(opt, "state_dtype", None) is not None:
            from .precision.policy import wrap_fused_apply
            return wrap_fused_apply(fa, opt.state_dtype)
        return fa

    def read_state_tree(self, index, weight):
        """The state of ``index`` as a tree of tensors on ``weight``'s
        device (None leaves pass through), created on first use."""
        return _map_leaves(self._state(index, weight), lambda s: s._read())

    def write_state_tree(self, index, new):
        """Write a tree of tensors into the state of ``index`` in place."""
        def tree_write(state, val):
            if state is None:
                return
            if isinstance(state, (tuple, list)):
                for s, n in zip(state, val):
                    tree_write(s, n)
                return
            state._write(val)

        tree_write(self.states[index], new)

    @staticmethod
    def _leaf_dtypes(state):
        """Nested per-leaf dtype names of one state tree."""
        return _map_leaves(state, _leaf_dtype_name)

    def get_states(self):
        """The states and the update clock as bytes: the JAX package's
        v2 envelope (``num_update``, ``index_update_count``,
        ``state_dtype``, ``state_dtypes``) with numpy leaves; a bfloat16
        leaf travels as its uint16 words, recorded as ``bfloat16``."""
        opt = self.optimizer
        dtypes = {k: self._leaf_dtypes(st) for k, st in self.states.items()}
        states = {k: _map_leaves(st, lambda leaf: leaf.words
                                 if isinstance(leaf, _Bf16Words)
                                 else _host_leaf(leaf))
                  for k, st in self.states.items()}
        return pickle.dumps({
            "__fmt__": 2,
            "states": states,
            "num_update": int(opt.num_update),
            "index_update_count": dict(opt._index_update_count),
            "state_dtype": opt.state_dtype,
            "state_dtypes": dtypes,
        })

    @staticmethod
    def _payload_state_dtype(payload):
        """The storage dtype a payload was saved under: recorded in v2
        envelopes, inferred from the leaves of a legacy bare dict."""
        if "state_dtype" in payload:
            return payload["state_dtype"] or "float32"
        for st in payload.get("states", {}).values():
            for name in _flat(_map_leaves(st, _leaf_dtype_name)):
                if name != "float32":
                    return name
        return "float32"

    def _check_state_dtype(self, payload):
        """Refuse a storage-dtype mismatch: float32 states into a bf16
        mode or the reverse would flip the state dtype on the next write
        and break the within-mode bitwise contract."""
        want = self.optimizer.state_dtype or "float32"
        got = self._payload_state_dtype(payload)
        if got != want:
            raise MXNetError(
                "optimizer-state payload was saved with state_dtype=%s but "
                "this Updater runs state_dtype=%s; restore with a module "
                "built under the matching precision mode "
                "(Module(precision=...))" % (got, want))

    def set_states(self, states):
        """Restore :meth:`get_states` bytes, update clock included, so a
        resumed run's lr schedule continues where the saved run stopped.
        A legacy payload (a bare dict of float32 numpy leaves) loads with
        the clock at ``begin_num_update``. Payloads the port did not
        write, payloads of another state dtype, and payloads whose
        per-leaf dtype record disagrees with their leaves raise
        :class:`MXNetError`."""
        payload = _StateUnpickler(io.BytesIO(states)).load()
        opt = self.optimizer
        if isinstance(payload, dict) and payload.get("__fmt__") == 2:
            self._check_state_dtype(payload)
            record = payload.get("state_dtypes")
            leaves = payload["states"]
            if not (isinstance(record, dict)
                    and sorted(record) == sorted(leaves)
                    and all(_record_matches(st, record[k])
                            for k, st in leaves.items())):
                raise MXNetError(
                    "optimizer-state payload is internally inconsistent: "
                    "the per-leaf dtype record does not match the state "
                    "leaves (payload corrupted or hand-edited)")
            self.states = {k: _map_leaves_with(st, record[k], _host_state)
                           for k, st in leaves.items()}
            opt.num_update = int(payload["num_update"])
            opt._index_update_count = dict(payload["index_update_count"])
        elif isinstance(payload, dict) and all(
                isinstance(k, int) for k in payload):
            self._check_state_dtype({"states": payload})
            self.states = dict(payload)
        else:
            raise MXNetError("optimizer-state payload is not the v2 "
                             "envelope that Updater.get_states writes")
        self._on_host = set(self.states)


def _flat(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _record_matches(state, record):
    """Whether a payload state tree has the structure and leaf dtypes its
    record names (a ``bfloat16`` record: uint16 words)."""
    if state is None or record is None:
        return state is None and record is None
    if isinstance(state, (tuple, list)):
        return isinstance(record, (tuple, list)) and \
            len(state) == len(record) and \
            all(_record_matches(s, r) for s, r in zip(state, record))
    name = numpy.dtype(numpy.asarray(state).dtype).name
    return name == ("uint16" if record == "bfloat16" else record)


def _host_state(leaf, name):
    return _Bf16Words(leaf) if name == "bfloat16" else leaf


def _map_leaves_with(state, record, fn):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_map_leaves_with(s, r, fn)
                           for s, r in zip(state, record))
    return fn(state, record)


def get_updater(optimizer):
    return Updater(optimizer)
