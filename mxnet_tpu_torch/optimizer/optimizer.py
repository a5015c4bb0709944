"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``):
``Optimizer``, ``SGD`` (with momentum), ``Adam``,
the ``Updater`` that holds per-parameter state, and the ``create``
registry.  Dense updates run through the update ops of
``ops/optimizer_ops.py``."""
from __future__ import annotations

import math

from ..base import Registry
from ..ndarray.ndarray import invoke

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
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
    """Base optimizer: one learning rate and weight decay for every
    parameter, gradient rescaling, update counts.  Per-parameter lr/wd
    multipliers, gradient clipping, learning rate schedulers and
    multi-precision updates are not ported."""

    def __init__(self, rescale_grad=1.0, wd=0.0, learning_rate=0.01):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.num_update = 0
        self._index_update_count = {}

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_learning_rate(self, lr):
        self.lr = lr

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)


def _zeros_like(w):
    return invoke("zeros_like", [w], {})


@register
class SGD(Optimizer):
    """SGD with momentum: mom = momentum * mom - lr * (rescale * g + wd * w);
    w += mom (the sgd_mom_update op; sgd_update without momentum)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self.lr, wd=self.wd, rescale_grad=self.rescale_grad)
        if state is None:
            weight._set(invoke("sgd_update", [weight, grad], kw))
        else:
            new_w, new_mom = invoke("sgd_mom_update", [weight, grad, state],
                                    dict(momentum=self.momentum, **kw))
            weight._set(new_w)
            state._set(new_mom)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the step's lr."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr_t = self.lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        new_w, new_m, new_v = invoke(
            "adam_update", [weight, grad, mean, var],
            dict(lr=lr_t, beta1=self.beta1, beta2=self.beta2,
                 epsilon=self.epsilon, wd=self.wd,
                 rescale_grad=self.rescale_grad))
        weight._set(new_w)
        mean._set(new_m)
        var._set(new_v)


class Updater:
    """Applies an optimizer to (index, grad, weight), creating each
    parameter's state at its first update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
