"""Gluon Trainer on one device (counterpart of
``mxnet_tpu/gluon/trainer.py``): ``step(batch_size)`` rescales the
gradients by 1 / batch_size and applies the optimizer to every parameter
with a gradient.  The optimizer gets the parameters as ``param_dict``
({index: Parameter}), so each Parameter's ``lr_mult`` and ``wd_mult``
reach its update.  ``save_states``/``load_states`` write and read the
optimizer and its states in the reference's format (either package reads
the other's file).  With ``MXNET_GUARD_CHECKSUM=1`` each step stamps the
digest of its gradients into the flight recorder (``guard``'s quarantine
evidence).  Gradient reduction across devices (the KVStore) and ZeRO's
sharded states are not ported; with one device there is nothing to
reduce."""
from __future__ import annotations

import torch

from .. import guard as _guard
from .. import optimizer as opt_mod
from .. import telemetry as _telemetry
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_STEPS_TOTAL = _telemetry.counter(
    "mxnet_trainer_steps_total", "Trainer.step calls (telemetry=True)")


class Trainer:
    """``telemetry=True`` attributes each ``step()`` to the telemetry step
    timeline, as the reference's Trainer does: gradient sync as the
    ``collectives`` phase, the parameter update as ``optimizer`` (see
    :mod:`mxnet_tpu_torch.telemetry`).  Off by default."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", telemetry=False):
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
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **(optimizer_params or {}))
        self._updater = opt_mod.get_updater(self._optimizer)
        self._scale = self._optimizer.rescale_grad
        self._telemetry = bool(telemetry)

    @property
    def step_count(self):
        """Optimizer updates applied so far (``optimizer.num_update``)."""
        return self._optimizer.num_update

    @property
    def learning_rate(self):
        """The learning rate of the next update: the scheduler's at the
        update count, if the optimizer has one."""
        opt = self._optimizer
        return opt.lr if opt.lr_scheduler is None else \
            opt.lr_scheduler(opt.num_update)

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        """Raises MXNetError if the optimizer has a scheduler."""
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every parameter from its gradient, scaled by
        1 / batch_size (reference: Trainer.step)."""
        if self._telemetry:
            _STEPS_TOTAL.inc()
        with _telemetry.maybe_phase(self._telemetry, "collectives"):
            self.allreduce_grads()
        if _guard.checksum_enabled():
            self._stamp_checksum()
        with _telemetry.maybe_phase(self._telemetry, "optimizer"):
            self.update(batch_size, ignore_stale_grad)

    # the reference's header of a states file holding ZeRO-1 sharded
    # optimizer state (its parallel/zero.py)
    _ZERO_MAGIC = b"MXTRZRO1"

    def _states_blob(self):
        """The bytes ``save_states`` writes: the updater's states and the
        optimizer, pickled (an async checkpoint takes them on the step
        loop's thread and writes them on another)."""
        return self._updater.get_states(dump_optimizer=True)

    def save_states(self, fname):
        """Write the optimizer and its states to ``fname``."""
        with open(fname, "wb") as f:
            f.write(self._states_blob())

    def load_states(self, fname):
        """Read a ``save_states`` file of either package: the optimizer
        (its update counts and scheduler included) replaces this
        Trainer's, with ``param_dict`` rebuilt over its parameters."""
        with open(fname, "rb") as f:
            data = f.read()
        if data.startswith(self._ZERO_MAGIC):
            raise MXNetError(f"{fname} holds ZeRO-1 sharded optimizer "
                             f"state (MXNET_ZERO); reading it waits for the "
                             f"port of parallel/zero.py")
        self._updater.set_states(data)
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))

    def allreduce_grads(self):
        """Sum gradients across devices: the identity on one device."""

    def _stamp_checksum(self):
        """Quarantine evidence (``MXNET_GUARD_CHECKSUM=1``): the digest of
        the reduced gradients, one flat bucket, stamped into the flight
        recorder.  Reduced gradients are bit-identical on every rank, so
        digests that differ across the merged black boxes name a
        corrupted rank."""
        grads = [p.grad()._data.reshape(-1) for p in self._params
                 if p.grad_req != "null" and p._nd is not None]
        if grads:
            _guard.stamp_bucket_checksum("__grad_bucket0",
                                         torch.cat(grads),
                                         step=self.step_count)

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._nd is None:
                continue
            self._updater(i, param.grad(), param.data())
