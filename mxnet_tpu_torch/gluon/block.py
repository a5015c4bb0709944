"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

A Block is a ``torch.nn.Module``: child Blocks are its submodules, and each
Parameter it holds as an attribute is registered in its ``_parameters``
once the data exists, so ``parameters()``, ``state_dict()`` and ``.to()``
work as on any module.  Names follow the reference: each Block gets a
prefix from a per-class counter (process-global outside a
``name_scope()``, per parent inside one), and its Parameters are named
``prefix + attribute``.

``hybridize()`` is accepted and changes nothing: the forward runs eagerly
either way, so a hybridized net computes exactly what the plain one does.
"""
from __future__ import annotations

import re
import threading
from contextlib import contextmanager

import torch

from .. import autograd as _ag
from .. import ndarray as _F
from ..base import MXNetError
from .parameter import (_TRACE, DeferredInitializationError, Parameter,
                        ParameterDict)

__all__ = ["Block", "HybridBlock"]


class _BlockScope(threading.local):
    def __init__(self):
        self.counters = {}
        self.scope_stack = []   # active name_scope() (prefix, counters)

    def next_name(self, hint):
        if self.scope_stack:
            prefix, counters = self.scope_stack[-1]
        else:
            prefix, counters = "", self.counters
        n = counters.get(hint, 0)
        counters[hint] = n + 1
        return f"{prefix}{hint}{n}_"


_NAME_SCOPE = _BlockScope()


class Block(torch.nn.Module):
    """Base container (reference: gluon.Block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        if prefix is not None:
            # an explicit prefix is relative to the enclosing name_scope
            scope = _NAME_SCOPE.scope_stack[-1][0] if \
                _NAME_SCOPE.scope_stack else ""
            self._prefix = scope + prefix
        else:
            self._prefix = _NAME_SCOPE.next_name(self._alias())
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") else \
            self._prefix

    @property
    def params(self):
        return self._params

    @property
    def _children(self):
        return {k: v for k, v in self._modules.items() if v is not None}

    @contextmanager
    def name_scope(self):
        """Names of blocks created inside are prefixed with this block's
        prefix, numbered per block instance."""
        if not hasattr(self, "_scope_counters"):
            self._scope_counters = {}
        _NAME_SCOPE.scope_stack.append((self._prefix, self._scope_counters))
        try:
            yield
        finally:
            _NAME_SCOPE.scope_stack.pop()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            value._attach(self, name)
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)
        return block

    def collect_params(self, select=None):
        """All Parameters of self and its descendants, in creation order
        (reference semantics)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self._params.items()
                        if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """{structural name: Parameter}: attribute paths such as
        ``model.layers.0.self_attn.q_proj.weight``, which do not depend on
        the global name counters (reference: the same method)."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, the first CUDA card)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        """Cast every parameter of self and its descendants to ``dtype``
        (reference: Block.cast; HybridBlock needs no override, as the
        port keeps no staged graph to drop)."""
        for child in self._children.values():
            child.cast(dtype)
        for _, p in self._params.items():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        """Accepted for compatibility: the forward stays eager, so the net
        computes exactly what it did (a staged graph is not ported)."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        for p in self._reg_params.values():
            p._sync_device()
        return out

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Block with ``hybrid_forward(F, x, *args, **params)``: F is the
    ``nd`` namespace and the registered parameters come as keywords."""

    def infer_shape(self, *args):
        """Resolve deferred parameter shapes from the input shapes;
        parametric layers override this."""
        raise MXNetError(
            f"{type(self).__name__} has deferred-init parameters but does "
            f"not implement infer_shape; give explicit in_units/in_channels")

    def _resolve_params(self, *args):
        kwargs = {}
        for name, p in self._reg_params.items():
            try:
                kwargs[name] = p.data()
            except DeferredInitializationError:
                self.infer_shape(*args)
                p._finish_deferred_init()
                kwargs[name] = p.data()
        return kwargs

    def _update_running_state(self, param, new_value_nd):
        """Write a non-differentiable state update (BatchNorm moving
        stats): collected under ``functionalize``, else written in place."""
        tc = _TRACE.ctx
        if tc is not None:
            tc.state_updates.append((param, new_value_nd._data))
        else:
            with _ag.pause():
                param.data()._set(new_value_nd)

    def forward(self, x, *args):
        return self.hybrid_forward(_F, x, *args,
                                   **self._resolve_params(x, *args))

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
