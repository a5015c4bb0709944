"""Imperative autograd over torch autograd (counterpart of
``mxnet_tpu/autograd.py``): the ``record`` / ``pause`` / ``train_mode`` /
``predict_mode`` scopes, ``is_recording`` / ``is_training``,
``backward``, the functional ``grad`` (with ``create_graph=True`` for
higher-order gradients) and the user-defined ``Function``.

``record()`` is where torch builds its graph: ``ndarray.invoke`` runs an
op with torch's grad mode on only while recording, so work outside a
record scope costs no graph.  A marked variable (``attach_grad``, or a
Gluon Parameter) is a leaf tensor that requires grad, with an MXNet
gradient buffer beside it (a Parameter's is made with its first
gradient).  ``backward`` runs torch's backward from the
heads, then moves each reached variable's ``.grad`` into its buffer by
its ``grad_req``: ``write`` overwrites (contributions within one backward
sum), ``add`` accumulates, ``null`` drops.  Variables the heads do not
reach keep their buffers, as in the reference.

``grad`` returns the gradients without touching any buffer; with
``create_graph=True`` they are themselves recorded, so a further
``backward`` differentiates through them (torch's double backward, where
the reference replays its tape as a function).  A ``Function`` is a
``torch.autograd.Function`` whose forward and backward are the user's,
over NDArrays.
"""
from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()

# id(NDArray) -> NDArray of every live marked variable; backward scans it
# for the leaves torch gave a .grad
_VARIABLES = weakref.WeakValueDictionary()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(flag):
    prev = _STATE.recording
    _STATE.recording = bool(flag)
    return prev


def set_training(flag):
    prev = _STATE.training
    _STATE.training = bool(flag)
    return prev


@contextmanager
def _scope(recording=None, training=None):
    prev_r, prev_t = _STATE.recording, _STATE.training
    if recording is not None:
        _STATE.recording = recording
    if training is not None:
        _STATE.training = training
    try:
        yield
    finally:
        _STATE.recording, _STATE.training = prev_r, prev_t


def record(train_mode=True):
    """``with autograd.record():`` -- record for backward (and train mode)."""
    return _scope(recording=True, training=train_mode)


def pause(train_mode=False):
    return _scope(recording=False, training=train_mode)


def train_mode():
    return _scope(training=True)


def predict_mode():
    return _scope(training=False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to NDArrays (reference:
    MXAutogradMarkVariables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var._mark_variable(g, req)


def _register_variable(nd):
    _VARIABLES[id(nd)] = nd


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Backward from ``heads`` (NDArrays computed under ``record()``) into
    the gradient buffers of the marked variables they reach.  A head's
    default gradient is ones of its shape.  ``train_mode`` is the
    reference's signature; torch's backward runs no forward code, so it
    has no effect here."""
    tensors, grads = _heads(heads, head_grads)
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)
    _move_grads()


def _heads(heads, head_grads):
    """(head tensors, their gradients): ones where none is given."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    tensors, grads = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            raise MXNetError(
                "cannot differentiate a head that was not computed under "
                "autograd.record() from marked variables")
        tensors.append(t)
        grads.append(torch.ones_like(t) if hg is None else
                     torch.as_tensor(getattr(hg, "_data", hg),
                                     dtype=t.dtype, device=t.device))
    return tensors, grads


def _move_grads():
    """Move each marked variable's ``.grad`` into its buffer by its
    ``grad_req``."""
    with torch.no_grad():
        for var in list(_VARIABLES.values()):
            g = var._data.grad
            if g is None:
                continue
            var._data.grad = None
            buf = var._grad
            if var._grad_req == "null":
                continue
            if buf is None:          # a Parameter's buffer, made on demand
                var._grad = type(var)._wrap(g)
            elif var._grad_req == "add":
                buf._data.add_(g)
            else:
                buf._data.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (NDArrays
    on the tape), as a list of NDArrays, without touching any gradient
    buffer (reference: mx.autograd.grad).  A variable the heads do not
    reach gets zeros.  ``retain_graph`` defaults to ``create_graph``.
    With ``create_graph=True`` the gradients are recorded, so a further
    ``backward`` or ``grad`` differentiates through them."""
    from .ndarray.ndarray import NDArray

    if not isinstance(variables, (list, tuple)):
        variables = [variables]
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError(
                f"variable of shape {v.shape} is not on the tape (call "
                f".attach_grad() inside or before the record scope)")
    tensors, grads = _heads(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    with torch.set_grad_enabled(create_graph):
        res = torch.autograd.grad(tensors, [v._data for v in variables],
                                  grads, retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    return [NDArray._wrap(torch.zeros_like(v._data) if g is None else g)
            for v, g in zip(variables, res)]


class _FunctionNode(torch.autograd.Function):
    """The torch node of a :class:`Function` call: the user's forward and
    backward over NDArrays, outside any recording."""

    @staticmethod
    def forward(ctx, func, *vals):
        from .ndarray.ndarray import NDArray

        with pause():
            out = func.forward(*(NDArray._wrap(v) for v in vals))
        ctx.func = func
        func._multi = isinstance(out, (tuple, list))
        ctx.in_meta = [(v.dtype, v.is_floating_point()) for v in vals]
        outs = list(out) if func._multi else [out]
        # an output that is an input as it came needs its own tensor
        return tuple(o._data.clone() if any(o._data is v for v in vals)
                     else o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray

        func = ctx.func
        with pause():
            gin = func.backward(*(NDArray._wrap(g) for g in grads))
        gin = list(gin) if isinstance(gin, (tuple, list)) else [gin]
        if len(gin) != len(ctx.in_meta):
            raise MXNetError(
                f"{type(func).__name__}.backward returned {len(gin)} "
                f"gradients for {len(ctx.in_meta)} inputs")
        out = []
        for g, (dtype, floating) in zip(gin, ctx.in_meta):
            if g is None or not floating:
                out.append(None)
            else:
                g = getattr(g, "_data", g)
                out.append(torch.as_tensor(g).to(dtype))
        return (None,) + tuple(out)


class Function:
    """A differentiable function with a hand-written gradient (reference:
    mx.autograd.Function): subclass it, write ``forward(*inputs)`` and
    ``backward(*output_grads)`` over NDArrays (``backward`` returns one
    gradient an input, None for none), keep residuals with
    ``save_for_backward`` (``saved_tensors``) or as attributes, and call
    the instance.  Both run outside recording; under ``record()`` the call
    is one node of the tape, a ``torch.autograd.Function``."""

    def __init__(self):
        self._saved = ()

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensors(self):
        return self._saved

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray, array

        nd_in = [x if isinstance(x, NDArray) else array(x) for x in inputs]
        vals = [a._data for a in nd_in]
        with torch.set_grad_enabled(is_recording()):
            res = _FunctionNode.apply(self, *vals)
        outs = [NDArray._wrap(t) for t in res]
        return tuple(outs) if self._multi else outs[0]
