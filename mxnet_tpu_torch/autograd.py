"""Imperative autograd over torch autograd (counterpart of
``mxnet_tpu/autograd.py``): the ``record`` / ``pause`` / ``train_mode`` /
``predict_mode`` scopes, ``is_recording`` / ``is_training`` and
``backward``.

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
"""
from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward"]


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
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)
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
