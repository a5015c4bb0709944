"""Module: symbolic training over one bound Executor (counterpart of
``mxnet_tpu/module/module.py``).

The reference binds one executor too.  Here it runs on one device a
process: a ``context`` list of more than one device raises (several
contexts in one process come with the second multi-GPU slice, ROADMAP.md
A6) instead of quietly running on the first device.  ``kvstore`` takes
every store of ``mx.kv``: a distributed one (with a process group)
updates the weights on the store, as MXNet 1.x's ``update_on_kvstore``
does (gradients pushed and summed over the processes, weights pulled
back); a local one, with one context, leaves the update to the Module's
updater.
"""
from __future__ import annotations

import logging

import numpy as _np
import torch

from ..base import MXNetError
from .base_module import BaseModule

__all__ = ["Module", "save_checkpoint", "load_checkpoint"]


def _one_device(context):
    if isinstance(context, (list, tuple)):
        if len(context) != 1:
            raise MXNetError(
                f"Module over {len(context)} devices: several contexts in "
                f"one process come with the second multi-GPU slice "
                f"(ROADMAP.md A6); bind one context a process and train "
                f"across processes with a distributed kvstore")
        context = context[0]
    return context


def _create_kvstore(kvstore):
    """(store, update_on_kvstore): a store of ``mx.kv`` (None for
    None), updating the weights itself when it is distributed and a
    process group exists."""
    from .. import kvstore as kvs

    if kvstore is None:
        return None, False
    kv = kvstore if isinstance(kvstore, kvs.KVStore) else kvs.create(kvstore)
    return kv, isinstance(kv, kvs.DistTPUSyncKVStore) and kv._distributed()


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        from ..context import current_context

        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._context = _one_device(context or current_context())
        self._fixed_param_names = list(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        self._param_names = [n for n in arg_names
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._preloaded_params = None
        self._pending_opt_states = None
        self._monitor = None

    # -- properties --------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return [(n, o.shape) for n, o in
                zip(self.output_names, self._exec.outputs)]

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self._data_shapes = [_as_desc(d) for d in data_shapes]
        self._label_shapes = ([_as_desc(lab) for lab in label_shapes]
                              if label_shapes else [])
        shapes = {name: shape for name, shape in
                  self._data_shapes + self._label_shapes}
        # the inputs' dtypes (DataDesc.dtype) type every array, as the
        # reference's infer_type propagates them
        types = {d.name: str(_np.dtype(d.dtype)) for d in
                 list(data_shapes) + list(label_shapes or [])
                 if getattr(d, "dtype", None) is not None}
        req = {}
        for n in self._symbol.list_arguments():
            if n in self._data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names or n in self._fixed_param_names:
                req[n] = "null"
            else:
                req[n] = grad_req if for_training else "null"
        shared_exec = shared_module._exec if shared_module is not None else None
        self._exec = self._symbol.simple_bind(
            self._context, grad_req=req, shared_exec=shared_exec,
            type_dict=types or None, **shapes)
        if self._monitor is not None:
            self._monitor.install(self._exec)
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True
        if self._preloaded_params is not None:
            arg, aux = self._preloaded_params
            self.set_params(arg, aux, allow_missing=False)
            self._preloaded_params = None

    # -- params ------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        from .. import initializer as _init
        from ..ndarray import NDArray

        def copy_in(arr, src):
            arr._set(src._data if isinstance(src, NDArray) else
                     torch.as_tensor(_np.asarray(src, dtype="float32")))

        initializer = initializer or _init.Uniform(0.01)
        var_attrs = self._symbol.attr_dict()
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                copy_in(arr, arg_params[name])
            elif arg_params is not None and not allow_missing:
                raise MXNetError(f"parameter {name!r} missing from arg_params "
                                 "(pass allow_missing=True to initialize it)")
            else:
                initializer(_init.InitDesc(name, var_attrs.get(name)), arr)
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            if aux_params is not None and name in aux_params:
                copy_in(arr, aux_params[name])
            else:
                initializer(_init.InitDesc(name), arr)
        self.params_initialized = True

    def get_params(self):
        if not self.binded:
            raise MXNetError("module not bound")
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not self.binded:
            self._preloaded_params = (arg_params, aux_params)
            self.params_initialized = True
            return
        self._exec.copy_params_from(arg_params, aux_params,
                                    allow_extra_params=allow_extra)
        self.params_initialized = True

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        from .. import optimizer as _opt

        if isinstance(optimizer, str):
            optimizer = _opt.create(optimizer, **dict(optimizer_params))
        self._optimizer = optimizer
        self._updater = _opt.get_updater(optimizer)
        self._kvstore, self._update_on_kvstore = _create_kvstore(kvstore)
        if self._update_on_kvstore:
            for i, name in enumerate(self._param_names):
                self._kvstore.init(i, self._exec.arg_dict[name])
            self._kvstore.set_optimizer(optimizer)
        self.optimizer_initialized = True
        if self._pending_opt_states is not None:
            self.load_optimizer_states(self._pending_opt_states)
            self._pending_opt_states = None

    # -- forward/backward/update -------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        feeds = {}
        for name, arr in zip(self._data_names, data_batch.data):
            feeds[name] = arr
        if self._label_names and data_batch.label:
            for name, arr in zip(self._label_names, data_batch.label):
                feeds[name] = arr
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads=out_grads)

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer before update")
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            if self._update_on_kvstore:
                self._kvstore.push(i, grad)
                self._kvstore.pull(i, self._exec.arg_dict[name])
            else:
                self._updater(i, grad, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        """Tap every node's output and the arguments with ``mon``
        (``monitor.Monitor``) from the next forward on."""
        self._monitor = mon
        if self._exec is not None:
            mon.install(self._exec)

    # -- checkpointing -------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("call init_optimizer before load_optimizer_states")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over ``prefix-symbol.json`` whose parameters, from
        ``prefix-{epoch:04d}.params``, are set at ``bind``."""
        sym, arg, aux = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded_params = (arg, aux)
        mod.params_initialized = True
        if load_optimizer_states:
            mod._pending_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod


def _as_desc(d):
    # a DataDesc or a (name, shape) pair
    if hasattr(d, "name"):
        return (d.name, tuple(d.shape))
    name, shape = d
    return (name, tuple(shape))


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """``prefix-symbol.json`` and ``prefix-{epoch:04d}.params`` with
    ``arg:``/``aux:``-tagged arrays (reference: mx.model.save_checkpoint)."""
    from ..ndarray import serialization

    symbol.save(f"{prefix}-symbol.json")
    data = {f"arg:{k}": v for k, v in arg_params.items()}
    data.update({f"aux:{k}": v for k, v in aux_params.items()})
    serialization.save(f"{prefix}-{epoch:04d}.params", data)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) of a checkpoint, the arrays on the
    CPU (``bind``/``set_params`` copy them to the module's device)."""
    from .. import symbol as _sym
    from ..context import cpu
    from ..ndarray import serialization

    sym = _sym.load(f"{prefix}-symbol.json")
    loaded = serialization.load(f"{prefix}-{epoch:04d}.params", ctx=cpu())
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return sym, arg_params, aux_params
