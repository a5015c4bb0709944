"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``):
``Initializer`` with the reference's name-suffix dispatch, ``Zero``,
``One``, ``Constant``, ``Uniform``, ``Normal``, ``Xavier`` and
``MSRAPrelu``.  Draws come from the device's generator in
:mod:`mxnet_tpu_torch.random` (torch's Philox, not jax's threefry, so the
numbers differ from the reference's while the distributions agree)."""
from __future__ import annotations

import math

import numpy as _np
import torch

from . import random as _rnd
from .base import Registry

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "MSRAPrelu", "register", "create"]

_REG = Registry("initializer")


def register(cls):
    _REG.register(cls)
    return cls


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _REG.create(name, **kwargs)


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr):
        """Fill ``arr`` by the parameter ``name``'s suffix: weights by this
        initializer, biases and betas 0, gammas 1, running means 0 and
        running variances 1."""
        desc, name = name, str(name).lower()
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
            self._init_weight(desc, arr)

    def _init_zero(self, name, arr):
        arr[:] = 0.0

    def _init_one(self, name, arr):
        arr[:] = 1.0

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


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
