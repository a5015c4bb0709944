"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``):
``Initializer`` with the reference's name-suffix dispatch and its
per-variable override (``InitDesc.attrs["__init__"]``), ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu``, ``Bilinear``, ``LSTMBias`` and ``Mixed`` (by name pattern).
Draws come from the device's generator in :mod:`mxnet_tpu_torch.random`
(torch's Philox, not jax's threefry, nor numpy's generator that the
reference's Orthogonal draws from, so the numbers differ from the
reference's while the distributions agree)."""
from __future__ import annotations

import json
import math
import re

import numpy as _np
import torch

from . import random as _rnd
from .base import Registry

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "register", "create"]

_REG = Registry("initializer")


def register(cls):
    _REG.register(cls)
    return cls


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _REG.create(name, **kwargs)


def _create_from_dumps(s):
    """Rebuild an initializer from ``Initializer.dumps()`` JSON or a bare
    name."""
    try:
        payload = json.loads(s)
    except (TypeError, ValueError):
        return create(str(s))
    if isinstance(payload, list) and payload:
        return create(payload[0], **(payload[1] if len(payload) > 1 else {}))
    return create(str(payload))


class InitDesc(str):
    """A parameter's name with its attributes (reference:
    mxnet.initializer.InitDesc); ``attrs["__init__"]`` overrides the
    initializer for this parameter."""

    def __new__(cls, name, attrs=None, global_init=None):
        s = super().__new__(cls, name)
        s.attrs = attrs or {}
        s.global_init = global_init
        return s


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        """Fill ``arr`` by the parameter name's suffix: weights by this
        initializer, biases and betas 0, gammas 1, running means 0 and
        running variances 1, anything else by ``_init_default``.  An
        initializer in ``desc.attrs["__init__"]`` (an Initializer or its
        ``dumps()``) fills the array instead, by its ``_init_weight``."""
        override = getattr(desc, "attrs", None)
        override = override.get("__init__") if override else None
        if override is not None and override is not self:
            init = override if isinstance(override, Initializer) else \
                _create_from_dumps(override)
            init._init_weight(str(desc), arr)
            return
        name = str(desc).lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            self._init_zero(desc, arr)
        elif name.endswith("gamma"):
            self._init_one(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)

    def init_weight(self, name, arr):
        self._init_weight(name, arr)

    def _init_zero(self, name, arr):
        arr[:] = 0.0

    def _init_one(self, name, arr):
        arr[:] = 1.0

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        self._init_weight(name, arr)

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])


def _rand_uniform(arr, scale):
    t = arr._data
    return torch.empty(t.shape, device=t.device).uniform_(
        -scale, scale, generator=_rnd.generator(t.device)).to(t.dtype)


def _rand_normal(arr, sigma):
    t = arr._data
    return torch.randn(t.shape, device=t.device,
                       generator=_rnd.generator(t.device)).to(t.dtype) * sigma


class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 0.0


class One(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 1.0


_REG.register(Zero, aliases=("zeros",))
_REG.register(One, aliases=("ones",))


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale); the Gluon default (scale 0.07)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr._set(_rand_uniform(arr, self.scale))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr._set(_rand_normal(arr, self.sigma))


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal matrix over the weight flattened to
    (shape[0], rest): the U or V factor of a normal matrix's SVD (the
    reference draws normal whatever ``rand_type`` says; so does this)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale

    def _init_weight(self, name, arr):
        t = arr._data
        shape = tuple(t.shape)
        flat = (shape[0], int(_np.prod(shape[1:])) if len(shape) > 1 else 1)
        a = torch.randn(flat, device=t.device, dtype=torch.float64,
                        generator=_rnd.generator(t.device))
        u, _, vt = torch.linalg.svd(a, full_matrices=False)
        q = u if tuple(u.shape) == flat else vt
        arr[:] = (self.scale * q.reshape(shape)).to(t.dtype)


def _fan(shape):
    hw = int(_np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[1] * hw if len(shape) > 1 else shape[0]
    fan_out = shape[0] * hw
    return fan_in, fan_out


@register
class Xavier(Initializer):
    """Scale sqrt(magnitude / fan) with fan the average, fan-in or fan-out
    of the weight, from a uniform or gaussian draw (reference:
    mxnet.initializer.Xavier)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        fan_in, fan_out = _fan(arr.shape)
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in}.get(
            self.factor_type, fan_out)
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        if self.rnd_type == "uniform":
            arr._set(_rand_uniform(arr, scale))
        else:
            arr._set(_rand_normal(arr, scale))


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__(rnd_type="gaussian", factor_type=factor_type,
                         magnitude=2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes (for a
    Deconvolution weight), the same in every (out, in) slice."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = _np.arange(shape[3]) / f - c
        y = _np.arange(shape[2]) / f - c
        kernel = (1 - _np.abs(y))[:, None] * (1 - _np.abs(x))[None, :]
        weight = _np.broadcast_to(kernel, shape).astype("float32")
        arr[:] = torch.from_numpy(_np.ascontiguousarray(weight))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (the second of the four
    gates, i f c o) at ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        n = arr.shape[0] // 4
        arr[:] = 0.0
        arr[n:2 * n] = self.forget_bias


class Mixed:
    """Initialize each parameter by the first initializer whose pattern
    (a regular expression, ``re.match``) matches its name."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise ValueError(f"parameter {name} did not match any pattern")
