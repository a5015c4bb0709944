"""BucketingModule: one Module a bucket key, the parameters shared
(counterpart of ``mxnet_tpu/module/bucketing_module.py``).  Each bucket
(typically a padded sequence length) binds its own executor over the
default bucket's parameter arrays (``simple_bind``'s ``shared_exec``), so
an update through any bucket updates them all."""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key is required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._bind_args = {}

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self._bind_args = dict(inputs_need_grad=inputs_need_grad,
                               grad_req=grad_req)
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training=for_training,
                 inputs_need_grad=inputs_need_grad, grad_req=grad_req)
        self._buckets = {self._default_bucket_key: mod}
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        if not self.binded:
            raise MXNetError("call bind before switch_bucket")
        if bucket_key not in self._buckets:
            default_mod = self._buckets[self._default_bucket_key]
            mod = self._gen_module(bucket_key)
            mod.bind(data_shapes, label_shapes, for_training=self.for_training,
                     shared_module=default_mod, **self._bind_args)
            self._buckets[bucket_key] = mod
            if self.params_initialized:
                mod.params_initialized = True
            if self.optimizer_initialized:
                # one optimizer and updater: its state follows the shared
                # parameters
                mod._optimizer = default_mod._optimizer
                mod._updater = default_mod._updater
                mod.optimizer_initialized = True
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        for mod in self._buckets.values():
            mod.set_params(arg_params, aux_params,
                           allow_missing=allow_missing,
                           allow_extra=allow_extra)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        base = self._buckets[self._default_bucket_key]
        base.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params,
                            force_init=force_init)
        for mod in self._buckets.values():
            mod._updater = base._updater
            mod._optimizer = base._optimizer
            mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            bucket_key = self._default_bucket_key
        provide = getattr(data_batch, "provide_data", None) or [
            (name, tuple(arr.shape)) for name, arr in
            zip(self._curr_module.data_names, data_batch.data)]
        label_shapes = getattr(data_batch, "provide_label", None)
        self.switch_bucket(bucket_key, provide, label_shapes)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        # the parameter arrays are shared across buckets: updating through
        # the current bucket updates them all
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)
