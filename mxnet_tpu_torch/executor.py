"""Executor: a symbol bound to argument, gradient and aux arrays
(counterpart of ``mxnet_tpu/executor.py``).

``forward`` interprets the graph with the op table's torch functions
(``symbol.evaluate``) on the bound arrays' device; a training forward
records it for torch autograd, and ``backward`` differentiates that
recording with respect to every argument whose ``grad_req`` is not
"null", writing ("write") or adding ("add") into the gradient arrays.  A
training forward writes BatchNorm's moving statistics into the aux arrays,
as the reference's forward+backward does.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["Executor"]


class Executor:
    """A symbol bound to argument/aux/grad buffers."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        from .context import current_context

        self._symbol = symbol
        self._ctx = ctx or current_context()
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        if isinstance(args, (list, tuple)):
            if len(args) != len(arg_names):
                raise MXNetError(
                    f"bind: {len(arg_names)} arguments expected, got {len(args)}")
            args = dict(zip(arg_names, args))
        elif args is None:
            args = {}
        missing = [n for n in arg_names if n not in args]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")
        self.arg_dict = OrderedDict((n, args[n]) for n in arg_names)

        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        elif aux_states is None:
            aux_states = {}
        missing = [n for n in aux_names if n not in aux_states]
        if missing:
            raise MXNetError(f"bind: missing auxiliary states {missing}")
        self.aux_dict = OrderedDict((n, aux_states[n]) for n in aux_names)

        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        self.grad_dict = OrderedDict(
            (n, (args_grad or {}).get(n)) for n in arg_names)

        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(arg_names, grad_req))
        else:
            self.grad_req = {n: grad_req.get(n, "null") for n in arg_names}

        self._arg_names = arg_names
        self._aux_names = aux_names
        self.outputs = []
        self._recorded = None     # (output tensors, {name: leaf}) to differentiate
        self._monitor = None

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` on every node's output in each
        forward (``monitor.Monitor``)."""
        self._monitor = callback

    def _tap(self):
        cb = self._monitor
        if cb is None:
            return None
        return lambda name, t: cb(name, NDArray._wrap(t.detach()))

    def _device(self):
        first = next(iter(self.arg_dict.values()), None)
        return first._data.device if first is not None else self._ctx.device

    def _feed(self, leaves=None):
        feed = {n: a._data for n, a in self.arg_dict.items()}
        if leaves:
            feed.update(leaves)
        feed.update((n, a._data) for n, a in self.aux_dict.items())
        return feed

    # -- public API --------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        from .symbol.symbol import evaluate

        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"unknown argument {k!r}")
            dst = self.arg_dict[k]
            src = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
            dst._set(src.to(device=dst._data.device, dtype=dst._data.dtype))

        heads = self._symbol._heads
        device = self._device()
        if not is_train:
            self._recorded = None
            with torch.no_grad():
                outs, _ = evaluate(heads, self._feed(), device=device,
                                   monitor=self._tap())
            self.outputs = [NDArray._wrap(o) for o in outs]
            return self.outputs
        leaves = {n: self.arg_dict[n]._data.detach().requires_grad_(True)
                  for n in self._arg_names
                  if self.grad_req.get(n, "null") != "null"
                  and self.arg_dict[n]._data.is_floating_point()}
        with torch.enable_grad():
            outs, state = evaluate(heads, self._feed(leaves), training=True,
                                   collect_state=True, device=device,
                                   monitor=self._tap())
        with torch.no_grad():
            for name, val in state.items():
                if name in self.aux_dict:
                    self.aux_dict[name]._set(val)
        self._recorded = (outs, leaves)
        self.outputs = [NDArray._wrap(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        if self._recorded is None:
            raise MXNetError("backward called before forward(is_train=True)")
        outs, leaves = self._recorded
        self._recorded = None
        if not leaves:
            return
        if out_grads is None:
            ogs = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            ogs = [(g._data if isinstance(g, NDArray) else
                    torch.as_tensor(g)).to(device=o.device, dtype=o.dtype)
                   for g, o in zip(out_grads, outs)]
        pairs = [(o, g) for o, g in zip(outs, ogs) if o.requires_grad]
        names = list(leaves)
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [leaves[n] for n in names],
            [g for _, g in pairs], allow_unused=True) if pairs else \
            [None] * len(names)
        with torch.no_grad():
            for n, g in zip(names, grads):
                if g is None:
                    g = torch.zeros_like(leaves[n])
                buf = self.grad_dict.get(n)
                if buf is None:
                    buf = NDArray._wrap(torch.zeros_like(self.arg_dict[n]._data))
                    self.grad_dict[n] = buf
                if self.grad_req[n] == "add":
                    buf._data.add_(g.to(buf._data.dtype))
                else:
                    buf._data.copy_(g)

    # -- conveniences (reference executor surface) -------------------------
    @property
    def arg_arrays(self):
        return list(self.arg_dict.values())

    @property
    def grad_arrays(self):
        return [self.grad_dict[n] for n in self._arg_names]

    @property
    def aux_arrays(self):
        return list(self.aux_dict.values())

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, arr in (arg_params or {}).items():
            if name in self.arg_dict:
                self.arg_dict[name]._set(arr._data)
            elif not allow_extra_params:
                raise MXNetError(f"unknown parameter {name!r}")
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name]._set(arr._data)
            elif not allow_extra_params:
                raise MXNetError(f"unknown aux state {name!r}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        from .ndarray import zeros

        shapes = {n: a.shape for n, a in self.arg_dict.items()}
        shapes.update(kwargs)
        args = {n: zeros(s, ctx=self._ctx) for n, s in shapes.items()}
        for n, a in self.arg_dict.items():
            if args[n].shape == a.shape:
                args[n]._set(a)
        grads = None
        if any(r != "null" for r in self.grad_req.values()):
            grads = {n: zeros(s, ctx=self._ctx) for n, s in shapes.items()}
        return Executor(self._symbol, self._ctx, args=args, args_grad=grads,
                        grad_req=self.grad_req, aux_states=dict(self.aux_dict))

    @property
    def output_dict(self):
        return OrderedDict(zip(self._symbol.list_outputs(), self.outputs))
