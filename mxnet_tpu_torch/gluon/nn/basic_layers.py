"""Gluon basic layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): Sequential, HybridSequential,
Dense, BatchNorm and Flatten."""
from __future__ import annotations

import numpy as _np

from ... import autograd
from ..block import Block, HybridBlock
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "BatchNorm", "Flatten"]


class _SequentialMixin:
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        layers = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            net.add(*layers[key])
            return net
        return layers[key]

    def __len__(self):
        return len(self._children)


class Sequential(_SequentialMixin, Block):
    """Stack of Blocks executed in order."""

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_SequentialMixin, HybridBlock):
    def hybrid_forward(self, F, x, *args):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer over the FullyConnected op, weight
    (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self.weight = self.params.get("weight", shape=(units, in_units),
                                      init=weight_initializer, dtype=dtype,
                                      allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get("bias", shape=(units,),
                                        init=bias_initializer, dtype=dtype,
                                        allow_deferred_init=True)
        else:
            self.bias = None
        self.act = Activation(activation, prefix=activation + "_") \
            if activation else None

    def infer_shape(self, x, *args):
        in_units = int(_np.prod(x.shape[1:])) if self._flatten else \
            x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, num_hidden=self._units,
                                   no_bias=True, flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   no_bias=False, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out


class BatchNorm(HybridBlock):
    """Batch normalization with running stats.  The moving mean/var come
    back from the BatchNorm op and are written into their Parameters (or
    collected as state under ``functionalize``)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=(in_channels,),
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=(in_channels,),
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = autograd.is_training() and not self._use_global_stats
        out, new_mean, new_var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training:
            self._update_running_state(self.running_mean, new_mean)
            self._update_running_state(self.running_var, new_var)
        return out


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)

    def __repr__(self):
        return "Flatten"
