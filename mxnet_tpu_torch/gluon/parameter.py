"""Gluon Parameter / ParameterDict (counterpart of
``mxnet_tpu/gluon/parameter.py``).

A Parameter holds one ``torch.nn.Parameter`` on one device (multi-device
copies are not ported), created when its shape is known: at
``initialize()``, or at the first forward for a deferred shape.  Its
``data()`` is an NDArray over that tensor, marked as an autograd variable
per ``grad_req``; the gradient buffer is allocated with the first
gradient.  Every Block that holds the
Parameter as an attribute registers the torch tensor in its
``_parameters`` under that attribute name, so ``parameters()`` and
``.to()`` work on a Gluon net as on any ``nn.Module``.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict

import numpy as _np
import torch

from .. import initializer as init_mod
from ..base import MXNetError, torch_dtype
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "load_reference_params"]


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its deferred shape inference completed."""


class _TraceState(threading.local):
    def __init__(self):
        self.ctx = None     # the active functionalize _TraceContext, or None


_TRACE = _TraceState()


class _TraceContext:
    """Active while ``parallel.functionalize`` runs a net on given tensors:
    ``data()`` answers from ``param_map`` (and notes the Parameter in
    ``read``) and running-state writes collect in ``state_updates`` instead
    of touching the Parameters."""

    def __init__(self, param_map):
        self.param_map = param_map          # Parameter -> NDArray
        self.state_updates = []             # [(Parameter, tensor)]
        self.read = set()                   # Parameters data() answered


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype=_np.float32,
                 init=None, allow_deferred_init=False, differentiable=True):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._nd = None          # NDArray over the torch.nn.Parameter
        self._deferred_init = ()
        # [(weak reference to a Block, attribute name)]: weak, so that a
        # net nothing else holds is freed at once, not at the next cyclic
        # garbage collection (a full-width net holds tens of GB on the card)
        self._owners = []

    # -- shape with deferred (0/None) dims ---------------------------------
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape) if new_shape is not None else None
            return
        if new_shape is None:
            return
        if len(self._shape) != len(new_shape) or any(
                s not in (0, n) for s, n in zip(self._shape, new_shape)):
            raise MXNetError(f"Parameter {self.name}: incompatible shape "
                             f"{new_shape} vs {self._shape}")
        self._shape = tuple(new_shape)

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req}")
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._nd is not None:
            self._init_grad()

    # -- initialization ----------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Place and fill the data on ``ctx`` (default: the current
        context, the first CUDA card), or defer that to the first forward
        while the shape is unknown."""
        default_init = default_init or init_mod.Uniform()
        if self._nd is not None and not force_reinit:
            return
        if ctx is None:
            ctx = current_context()
        if isinstance(ctx, (list, tuple)):
            if len(ctx) != 1:
                raise MXNetError(f"Parameter {self.name}: one device per "
                                 f"parameter (got {list(ctx)})")
            ctx = ctx[0]
        device = ctx.device if isinstance(ctx, Context) else \
            torch.device(ctx)
        if not self._shape_known():
            if self._allow_deferred_init:
                self._deferred_init = (init, device, default_init)
                return
            raise MXNetError(
                f"cannot initialize Parameter {self.name} because it has "
                f"invalid shape {self._shape} (set allow_deferred_init or "
                f"give a full shape)")
        self._finish_deferred_init(init, device, default_init)

    def _finish_deferred_init(self, initializer=None, device=None,
                              default_init=None):
        if self._deferred_init:
            initializer, device, default_init = self._deferred_init
            self._deferred_init = ()
        if not self._shape_known():
            raise DeferredInitializationError(
                f"Parameter {self.name} has unknown shape {self._shape}")
        data = NDArray._wrap(torch.zeros(self._shape, device=device,
                                         dtype=torch_dtype(self.dtype)))
        actual = initializer or self.init or default_init
        if isinstance(actual, str):
            actual = init_mod.create(actual)
        actual(self.name, data)
        self._init_impl(data._data)

    def _init_impl(self, tensor):
        self._bind(torch.nn.Parameter(tensor, requires_grad=False))

    def _bind(self, var):
        """Make ``var`` this parameter's tensor, in every owning Block."""
        self._nd = NDArray._wrap(var)
        self._init_grad()
        for ref, attr in self._owners:
            block = ref()
            if block is not None:
                block._parameters[attr] = var

    def _attach(self, block, attr):
        self._owners.append((weakref.ref(block), attr))
        if self._nd is not None:
            block._parameters[attr] = self._nd._data

    def _init_grad(self):
        var = self._nd._data
        var.requires_grad_(self._grad_req != "null")
        if self._grad_req == "null":
            self._nd._grad = None
            self._nd._grad_req = "null"
        else:
            # the buffer comes with the first gradient (autograd.backward)
            # or the first grad() call: a net that is only served, or only
            # trained through TrainStep, holds no second copy of its weights
            self._nd._mark_variable(None, self._grad_req)

    # -- access -------------------------------------------------------------
    def _check_initialized(self):
        if self._nd is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has not been initialized yet "
                    f"(deferred init pending first forward)")
            raise MXNetError(f"Parameter {self.name} has not been "
                             f"initialized. Call .initialize() first")

    def data(self, ctx=None):
        tc = _TRACE.ctx
        if tc is not None and self in tc.param_map:
            tc.read.add(self)
            return tc.param_map[self]
        self._check_initialized()
        return self._nd

    def grad(self, ctx=None):
        self._check_initialized()
        if self._grad_req == "null":
            raise MXNetError(f"Parameter {self.name} has grad_req='null'")
        if self._nd._grad is None:
            self._nd._grad = NDArray._wrap(torch.zeros_like(self._nd._data))
        return self._nd._grad

    def zero_grad(self):
        if self._nd is not None:
            self._nd.zero_grad()

    def set_data(self, data):
        """Copy ``data`` (NDArray, tensor or array-like) into the parameter
        in place, finishing a pending deferred init first."""
        self.shape = data.shape
        if self._nd is None:
            if not self._deferred_init:
                raise MXNetError(f"Parameter {self.name} not initialized")
            self._finish_deferred_init()
        if isinstance(data, NDArray):
            data = data._data
        self._nd._set(torch.as_tensor(data))

    def _sync_device(self):
        """After ``Module._apply`` (``.to()``, ``.float()``...): rebind to
        the owner's tensor if torch replaced it, and move the gradient
        buffer beside the data."""
        if self._nd is None:
            return
        block, attr = next((ref(), attr) for ref, attr in self._owners
                           if ref() is not None)
        var = block._parameters.get(attr)
        if var is not None and var is not self._nd._data:
            self._bind(var)
        elif self._nd._grad is not None and (
                self._nd._grad._data.device != var.device
                or self._nd._grad._data.dtype != var.dtype):
            self._init_grad()

    def __repr__(self):
        return f"Parameter {self.name} (shape={self._shape}, " \
            f"dtype={self.dtype})"


class ParameterDict:
    """Prefix-scoped dict of Parameters (reference: gluon.ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def get(self, name, **kwargs):
        """Get-or-create ``prefix + name`` (shared dict first)."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None and self._shared is not None and \
                name in self._shared:
            param = self._params[name] = self._shared[name]
        if param is None:
            param = self._params[name] = Parameter(name, **kwargs)
        else:
            for k, v in kwargs.items():
                if k == "shape":
                    param.shape = v
                elif k == "init" and v is not None and param.init is None:
                    param.init = v
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        default = init or init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, default, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def __repr__(self):
        s = "\n".join(repr(v) for v in self.values())
        return f"ParameterDict(prefix={self._prefix!r})\n{s}"


def _strip_counter(name):
    """A parameter name without the block counters: ``conv2d12_weight`` ->
    ``conv2d_weight``, ``stage3_batchnorm7_running_var`` ->
    ``stage_batchnorm_running_var``."""
    return "_".join(part.rstrip("0123456789") for part in name.split("_"))


def load_reference_params(net, ref_params):
    """Load the reference net's weights into ``net``.

    ``ref_params`` is ``{name: p.data().asnumpy()}`` over the reference
    net's ``collect_params()``, in that order, running stats included.
    Names carry process-global block counters, so the two nets' names
    need not agree; parameters are matched by position in
    ``collect_params()`` order instead, and at every position the name
    with its counters stripped and the shape must agree, else nothing is
    loaded and MXNetError names the first mismatch.  Deferred shapes of
    ``net`` are fixed from the reference's."""
    own = list(net.collect_params().items())
    ref = list(ref_params.items())
    if len(own) != len(ref):
        raise MXNetError(f"reference has {len(ref)} parameters, the net "
                         f"{len(own)}")
    for (name, p), (rname, value) in zip(own, ref):
        shape = tuple(_np.shape(value))
        same_shape = p.shape is not None and len(p.shape) == len(shape) \
            and all(s in (0, n) for s, n in zip(p.shape, shape))
        if _strip_counter(name) != _strip_counter(rname) or not same_shape:
            raise MXNetError(f"parameter mismatch: net {name} {p.shape} "
                             f"vs reference {rname} {shape}")
    for (_, p), (_, value) in zip(own, ref):
        p.set_data(torch.from_numpy(_np.array(value, dtype=_np.float32)))
