"""Gluon Trainer on one device (counterpart of
``mxnet_tpu/gluon/trainer.py``): ``step(batch_size)`` rescales the
gradients by 1 / batch_size and applies the optimizer to every parameter
with a gradient.  Gradient reduction across devices (the KVStore) is not
ported; with one device there is nothing to reduce."""
from __future__ import annotations

from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict/dict/list")
        if kvstore not in (None, "device", "local"):
            raise MXNetError(f"kvstore {kvstore!r}: only one device is "
                             f"supported (no KVStore)")
        self._params = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p}")
            self._params.append(p)
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             **(optimizer_params or {}))
        self._updater = opt_mod.get_updater(self._optimizer)
        self._scale = self._optimizer.rescale_grad

    @property
    def learning_rate(self):
        return self._optimizer.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every parameter from its gradient, scaled by
        1 / batch_size (reference: Trainer.step)."""
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum gradients across devices: the identity on one device."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._nd is None:
                continue
            self._updater(i, param.grad(), param.data())
