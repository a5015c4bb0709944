"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``).

The ``Optimizer`` base (per-parameter lr/wd multipliers, gradient
clipping, learning-rate schedulers, update counts), every registered
optimizer under the reference's registry names, the ``Updater`` that
holds per-parameter state, and the ``create`` registry.  State lives in
the port's NDArrays.  Classes whose update is an op of
``ops/optimizer_ops.py`` run it through ``invoke``; FTML, LAMB, Nadam,
Adamax and SGLD compute in the class body, as the reference's do (LAMB
clips the trust ratio, not the op's bounds), with SGLD's noise from the
device's ``torch.Generator``.

One deliberate difference: ``_get_lr``/``_get_wd`` look a parameter up in
``param_dict`` by its index first, as MXNet 1.x does.  ``gluon.Trainer``
keys ``param_dict`` by index, so a Parameter's ``lr_mult``/``wd_mult``
reach its update; the reference looks up by name there and ignores them.
A row-sparse gradient (``nd.sparse.RowSparseNDArray``) goes through
``update_row_sparse``: SGD's lazy update changes only the rows it holds,
every other optimizer densifies it and runs its dense update.

States files: ``Updater.get_states`` pickles the states as numpy arrays
(and the optimizer with ``dump_optimizer=True``) in the reference's
format, naming the reference's classes (``mxnet_tpu.optimizer.optimizer.
LAMB``, ``mxnet_tpu.lr_scheduler.PolyScheduler``) with the same attribute
names, so the reference's ``Trainer.load_states`` reads the port's file;
``set_states`` reads either package's file through an unpickler that maps
those classes to the port's own and refuses any other global of
``mxnet_tpu`` or ``jax``, so a load never imports them.
"""
from __future__ import annotations

import io
import math
import pickle

import numpy as _np
import torch

from .. import lr_scheduler as _lr_scheduler
from .. import random as _rnd
from ..base import MXNetError, Registry
from ..ndarray.ndarray import NDArray, invoke
from ..ndarray.serialization import host_copies

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "FTML", "Signum", "SignSGD", "LAMB", "Nadam",
           "Adamax", "SGLD", "Test", "Updater", "get_updater", "create",
           "register"]

_REG = Registry("optimizer")


def register(cls):
    _REG.register(cls)
    return cls


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return _REG.create(name, **kwargs)


class Optimizer:
    """Base optimizer.  ``lr_scheduler`` (its ``base_lr`` set to
    ``learning_rate``) gives the learning rate at each update count;
    ``param_dict`` ({index: Parameter}) and ``set_lr_mult`` /
    ``set_wd_mult`` ({index or name: multiplier}) scale it per parameter;
    ``clip_gradient`` clips the rescaled gradient to +-clip."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=0, **extra):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}

    # -- state --------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def update_row_sparse(self, index, weight, grad, state):
        """A row-sparse gradient's update.  Here: densify it and run the
        dense update (the reference's fallback for an op without a sparse
        kernel); SGD overrides it with the lazy update."""
        self.update(index, weight, NDArray._wrap(grad._data), state)

    # -- lr / wd ------------------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined; cannot set learning rate")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr, table):
        name = self.idx2name.get(index,
                                 index if isinstance(index, str) else None)
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if name in self.param_dict:
            return getattr(self.param_dict[name], attr)
        if index in table:
            return table[index]
        if name is not None and name in table:
            return table[name]
        return 1.0

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("param_dict", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.param_dict = {}


def _zeros_like(w):
    return invoke("zeros_like", [w], {})


def _clip(v):
    return -1.0 if v is None else float(v)


def _class_grad(opt, grad, weight=None, wd=0.0):
    """The class-body optimizers' gradient: rescaled, clipped when
    ``clip_gradient`` is truthy (the reference tests it so, not by
    _clip), plus ``wd * weight`` when ``weight`` is given."""
    g = grad._data * opt.rescale_grad
    if opt.clip_gradient:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    if weight is not None:
        g = g + wd * weight._data
    return g


def _op_kw(opt, index):
    return dict(lr=opt._get_lr(index), wd=opt._get_wd(index),
                rescale_grad=opt.rescale_grad,
                clip_gradient=_clip(opt.clip_gradient))


@register
class SGD(Optimizer):
    """SGD with momentum: mom = momentum * mom - lr * (clip(rescale * g)
    + wd * w); w += mom (sgd_mom_update; sgd_update without momentum)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _op_kw(self, index)
        if state is None:
            weight._set(invoke("sgd_update", [weight, grad], kw))
        else:
            new_w, new_mom = invoke("sgd_mom_update", [weight, grad, state],
                                    dict(momentum=self.momentum, **kw))
            weight._set(new_w)
            state._set(new_mom)

    def update_row_sparse(self, index, weight, grad, state):
        """The lazy update (``lazy_update=True``): only the rows the
        gradient holds change, each by the dense rule with its own weight
        decay and momentum row (reference: sgd_update's FComputeEx)."""
        if not self.lazy_update:
            return super().update_row_sparse(index, weight, grad, state)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        idx = grad._rs_indices.long()
        w = weight._data
        with torch.no_grad():
            g = grad._rs_values.to(w.dtype) * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            g = g + wd * w[idx]
            if state is None:
                w.index_add_(0, idx, -lr * g)
            else:
                m = state._data
                rows = self.momentum * m[idx] - lr * g
                m[idx] = rows
                w.index_add_(0, idx, rows)


@register
class NAG(Optimizer):
    """Nesterov momentum (nag_mom_update; sgd_update without momentum)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _op_kw(self, index)
        if state is None:
            weight._set(invoke("sgd_update", [weight, grad], kw))
        else:
            new_w, new_mom = invoke("nag_mom_update", [weight, grad, state],
                                    dict(momentum=self.momentum, **kw))
            weight._set(new_w)
            state._set(new_mom)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the step's lr."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _op_kw(self, index)
        t = self._index_update_count[index]
        kw["lr"] = kw["lr"] * math.sqrt(1.0 - self.beta2 ** t) / \
            (1.0 - self.beta1 ** t)
        mean, var = state
        new_w, new_m, new_v = invoke(
            "adam_update", [weight, grad, mean, var],
            dict(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                 **kw))
        weight._set(new_w)
        mean._set(new_m)
        var._set(new_v)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        new_w, new_h = invoke("adagrad_update", [weight, grad, state],
                              dict(epsilon=self.float_stable_eps,
                                   **_op_kw(self, index)))
        weight._set(new_w)
        state._set(new_h)


@register
class AdaDelta(Optimizer):
    """AdaDelta: no learning rate (the multipliers of lr do nothing)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        acc_g, acc_d = state
        new_w, new_g, new_d = invoke(
            "adadelta_update", [weight, grad, acc_g, acc_d],
            dict(rho=self.rho, epsilon=self.epsilon, wd=self._get_wd(index),
                 rescale_grad=self.rescale_grad,
                 clip_gradient=_clip(self.clip_gradient)))
        weight._set(new_w)
        acc_g._set(new_g)
        acc_d._set(new_d)


@register
class RMSProp(Optimizer):
    """Tieleman & Hinton's RMSProp (rmsprop_update, with ``clip_weights``)
    or, ``centered``, Graves' (rmspropalex_update)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(_zeros_like(weight) for _ in range(n))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(gamma1=self.gamma1, epsilon=self.epsilon,
                  **_op_kw(self, index))
        if not self.centered:
            (n,) = state
            new_w, new_n = invoke(
                "rmsprop_update", [weight, grad, n],
                dict(clip_weights=_clip(self.clip_weights), **kw))
            weight._set(new_w)
            n._set(new_n)
        else:
            n, g, delta = state
            new_w, new_n, new_g = invoke(
                "rmspropalex_update", [weight, grad, n, g, delta],
                dict(gamma2=self.gamma2, **kw))
            weight._set(new_w)
            n._set(new_n)
            g._set(new_g)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        new_w, new_z, new_n = invoke(
            "ftrl_update", [weight, grad, z, n],
            dict(lamda1=self.lamda1, beta=self.beta, **_op_kw(self, index)))
        weight._set(new_w)
        z._set(new_z)
        n._set(new_n)


@register
class FTML(Optimizer):
    """Follow the Moving Leader, computed in the class body as the
    reference does (state d, v, z)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        d, v, z = state
        g = _class_grad(self, grad, weight, wd)
        w = weight._data
        new_v = self.beta2 * v._data + (1 - self.beta2) * torch.square(g)
        d_t = (1 - self.beta1 ** t) / lr * (
            torch.sqrt(new_v / (1 - self.beta2 ** t)) + self.epsilon)
        sigma = d_t - self.beta1 * d._data
        new_z = self.beta1 * z._data + (1 - self.beta1) * g - sigma * w
        weight._set(-new_z / d_t)
        d._set(d_t)
        v._set(new_v)
        z._set(new_z)


@register
class SignSGD(Optimizer):
    def update(self, index, weight, grad, state):
        self._update_count(index)
        weight._set(invoke("signsgd_update", [weight, grad],
                           _op_kw(self, index)))


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        new_w, new_m = invoke("signum_update", [weight, grad, state],
                              dict(momentum=self.momentum, wd_lh=self.wd_lh,
                                   **_op_kw(self, index)))
        weight._set(new_w)
        state._set(new_m)


def lamb_trust_ratio(r1, r2):
    """LAMB's trust ratio ||w|| / ||update||, 1 where either norm is 0."""
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))


@register
class LAMB(Optimizer):
    """LAMB (You et al. 2019), computed in the class body as the
    reference does: the Adam direction (bias-corrected unless
    ``bias_correction=False``) plus wd * w, scaled by the trust ratio
    ||w|| / ||direction||, which ``lower_bound`` / ``upper_bound`` clip
    when set.  The ratio stays on the device: no host read per
    parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        mean, var = state
        g = _class_grad(self, grad)
        w = weight._data
        new_mean = self.beta1 * mean._data + (1 - self.beta1) * g
        new_var = self.beta2 * var._data + (1 - self.beta2) * torch.square(g)
        m_hat, v_hat = new_mean, new_var
        if self.bias_correction:
            m_hat = new_mean / (1 - self.beta1 ** t)
            v_hat = new_var / (1 - self.beta2 ** t)
        upd = m_hat / (torch.sqrt(v_hat) + self.epsilon) + wd * w
        ratio = lamb_trust_ratio(torch.sqrt(torch.sum(torch.square(w))),
                                 torch.sqrt(torch.sum(torch.square(upd))))
        if self.lower_bound:
            ratio = torch.clamp(ratio, min=self.lower_bound)
        if self.upper_bound:
            ratio = torch.clamp(ratio, max=self.upper_bound)
        weight._set(w - lr * ratio * upd)
        mean._set(new_mean)
        var._set(new_var)


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum, its momentum schedule
    ``m_schedule`` one float on the optimizer, advanced at every
    parameter's update (MXNet's own behaviour)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        g = _class_grad(self, grad, weight, wd)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        mean, var = state
        new_m = self.beta1 * mean._data + (1 - self.beta1) * g
        new_v = self.beta2 * var._data + (1 - self.beta2) * torch.square(g)
        g_prime = g / (1 - self.m_schedule)
        m_prime = new_m / (1 - m_schedule_next)
        v_prime = new_v / (1 - self.beta2 ** t)
        m_bar = (1 - momentum_t) * g_prime + momentum_t_1 * m_prime
        weight._set(weight._data - lr * m_bar / (torch.sqrt(v_prime)
                                                 + self.epsilon))
        mean._set(new_m)
        var._set(new_v)


@register
class Adamax(Optimizer):
    """Adam under the infinity norm (class body, as the reference)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = lr / (1 - self.beta1 ** t)
        g = _class_grad(self, grad, weight, wd)
        mean, u = state
        new_m = self.beta1 * mean._data + (1 - self.beta1) * g
        new_u = torch.maximum(self.beta2 * u._data, torch.abs(g))
        weight._set(weight._data - lr_t * new_m / (new_u + 1e-8))
        mean._set(new_m)
        u._set(new_u)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: w -= lr / 2 * g, plus
    N(0, lr) noise drawn from the device's generator."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _class_grad(self, grad, weight, wd)
        w = weight._data
        noise = torch.randn(w.shape, device=w.device,
                            generator=_rnd.generator(w.device)).to(w.dtype)
        weight._set(w - lr / 2 * g + math.sqrt(lr) * noise)


@register
class Test(Optimizer):
    """Trivial optimizer used by tests (the reference has the same)."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        weight._set(weight - self.lr * grad * self.rescale_grad)


# the reference's modules of the classes a states file names
_REF_MODULES = {"mxnet_tpu.optimizer.optimizer": "optimizer",
                "mxnet_tpu.lr_scheduler": "lr_scheduler"}
_PORT_MODULES = {__name__: "optimizer", _lr_scheduler.__name__: "lr_scheduler"}
_REF_BY_KIND = {kind: mod for mod, kind in _REF_MODULES.items()}


def _port_class(kind, name):
    """The port's optimizer or scheduler class ``name``, or None."""
    cls = globals().get(name) if kind == "optimizer" else \
        getattr(_lr_scheduler, name, None)
    base = Optimizer if kind == "optimizer" else _lr_scheduler.LRScheduler
    return cls if isinstance(cls, type) and issubclass(cls, base) else None


class _RefPickler(pickle._Pickler):
    """Pickles the port's optimizer and scheduler classes under the
    reference's module paths.  The Python pickler, whose ``save_global``
    can be overridden: the C one imports each class's module to check
    it, which would import the reference."""

    def save_global(self, obj, name=None):
        kind = _PORT_MODULES.get(getattr(obj, "__module__", None))
        if kind is None or _port_class(kind, obj.__qualname__) is not obj:
            return super().save_global(obj, name)
        self.save(_REF_BY_KIND[kind])
        self.save(obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _ref_dumps(obj):
    buf = io.BytesIO()
    _RefPickler(buf, protocol=4).dump(obj)
    return buf.getvalue()


def _jax_array_to_numpy(fun, args, arr_state, aval_state):
    """A pickled JAX array (``jax._src.array._reconstruct_array``'s
    arguments) rebuilt as the numpy array it wraps."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class _StatesUnpickler(pickle.Unpickler):
    """Reads a states file of either package without importing the
    reference or JAX: their optimizer and scheduler classes map to the
    port's, a JAX array to numpy, and any other ``mxnet_tpu`` or ``jax``
    global raises MXNetError."""

    def find_class(self, module, name):
        kind = _REF_MODULES.get(module) or _PORT_MODULES.get(module)
        if kind is not None:
            cls = _port_class(kind, name)
            if cls is None:
                raise MXNetError(f"states file names {module}.{name}, which "
                                 f"the port does not have")
            return cls
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _jax_array_to_numpy
        if module.split(".")[0] in ("mxnet_tpu", "mxnet_tpu_torch", "jax",
                                    "jaxlib"):
            raise MXNetError(f"states file names {module}.{name}; the port "
                             f"reads only the optimizer and scheduler "
                             f"classes and numpy arrays")
        return super().find_class(module, name)


def _numpy_states(states):
    """{index: state} with every NDArray as a numpy array (bfloat16 as
    float32, as ``asnumpy`` gives it), all read back in one pass."""
    tensors = []

    def collect(v):
        if isinstance(v, NDArray):
            tensors.append(v._data)
        elif isinstance(v, (tuple, list)):
            for s in v:
                collect(s)

    for v in states.values():
        collect(v)
    # pickled at once by the caller, so host tensors need no copy
    host = iter(host_copies(tensors, clone_host=False))

    def build(v):
        if isinstance(v, NDArray):
            t = next(host)
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if isinstance(v, (tuple, list)):
            return tuple(build(s) for s in v)
        return v

    return {k: build(v) for k, v in states.items()}


def _state_arrays(v, device):
    """A state (numpy arrays or NDArrays, in tuples) as NDArrays on
    ``device``."""
    if isinstance(v, NDArray):
        return NDArray._wrap(v._data.to(device))
    if isinstance(v, _np.ndarray):
        return NDArray._wrap(torch.from_numpy(_np.array(v)).to(device))
    if isinstance(v, (tuple, list)):
        return tuple(_state_arrays(s, device) for s in v)
    return v


class Updater:
    """Applies an optimizer to (index, grad, weight), creating each
    parameter's state at its first update.  States read by
    :meth:`set_states` move to their weight's device at its next
    update (``states_synced``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = _state_arrays(self.states[index],
                                               weight._data.device)
            self.states_synced[index] = True
        if getattr(grad, "stype", "default") == "row_sparse":
            self.optimizer.update_row_sparse(index, weight, grad,
                                             self.states[index])
        else:
            self.optimizer.update_multi_precision(index, weight, grad,
                                                  self.states[index])

    def get_states(self, dump_optimizer=False):
        """The pickled states (numpy arrays), with the optimizer when
        ``dump_optimizer``: the reference's format, which its
        ``Updater.set_states`` reads."""
        states = _numpy_states(self.states)
        return _ref_dumps((states, self.optimizer) if dump_optimizer
                          else states)

    def set_states(self, states):
        """Read :meth:`get_states` bytes of either package.  A file with
        the optimizer replaces ``self.optimizer``; the arrays stay on the
        host until their parameter's next update."""
        data = _StatesUnpickler(io.BytesIO(states)).load()
        if isinstance(data, tuple) and len(data) == 2 and \
                isinstance(data[1], Optimizer):
            states, self.optimizer = data
        else:
            states = data
        self.states = {k: _state_arrays(v, torch.device("cpu"))
                       for k, v in states.items()}
        self.states_synced = {k: False for k in self.states}


def get_updater(optimizer):
    return Updater(optimizer)
