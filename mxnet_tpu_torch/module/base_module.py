"""BaseModule: the training-loop surface (counterpart of
``mxnet_tpu/module/base_module.py``): ``fit``/``score``/``predict``/
``iter_predict`` over the subclass's bind/init_params/forward/backward/
update."""
from __future__ import annotations

import logging

from .. import metric as _metric
from ..base import MXNetError

__all__ = ["BaseModule"]


def _as_metric(m):
    if isinstance(m, _metric.EvalMetric):
        return m
    return _metric.create(m)


class BaseModule:
    """Abstract module.  Subclasses implement bind/init_params/
    init_optimizer/forward/backward/update/get_outputs/update_metric."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False

    # -- high-level train/eval loops ---------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        if num_epoch is None:
            raise MXNetError("num_epoch is required for fit")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params,
                            force_init=force_init)

        eval_metric = _as_metric(eval_metric)
        validation_metric = (_as_metric(validation_metric)
                             if validation_metric is not None else eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            for data_batch in train_data:
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    params = _BatchEndParam(epoch=epoch, nbatch=nbatch,
                                            eval_metric=eval_metric,
                                            locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(params)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        if reset:
            eval_data.reset()
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(_BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric, locals=locals()))
        if score_end_callback is not None:
            for cb in _as_list(score_end_callback):
                cb(_BatchEndParam(epoch=epoch, nbatch=0,
                                  eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        from ..ndarray import concatenate

        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = getattr(eval_batch, "pad", 0) or 0
            outs = [o[0:o.shape[0] - pad] for o in self.get_outputs()]
            output_list.append(outs)
        if not output_list:
            return []
        if merge_batches:
            num_outputs = len(output_list[0])
            merged = [concatenate([o[i] for o in output_list])
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            yield self.get_outputs(), nbatch, eval_batch

    def install_monitor(self, mon):
        """Subclasses that run an executor install ``mon`` on it."""

    # -- abstract ----------------------------------------------------------
    def bind(self, *a, **kw):
        raise NotImplementedError

    def init_params(self, *a, **kw):
        raise NotImplementedError

    def init_optimizer(self, *a, **kw):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError


class _BatchEndParam:
    __slots__ = ("epoch", "nbatch", "eval_metric", "locals")

    def __init__(self, epoch, nbatch, eval_metric, locals):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return x
    return [x]
