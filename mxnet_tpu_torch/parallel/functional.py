"""Functionalize a Gluon block (counterpart of
``mxnet_tpu/parallel/functional.py``): ``apply_fn(params, *inputs)`` runs
the net with the parameter values taken from a name -> tensor dict instead
of the net's own Parameters, so a caller can differentiate the forward
with respect to tensors it owns (``TrainStep``)."""
from __future__ import annotations

from collections import OrderedDict

import torch

from .. import autograd as _ag
from ..gluon.parameter import (_TRACE, DeferredInitializationError,
                               _TraceContext)
from ..ndarray.ndarray import NDArray

__all__ = ["functionalize"]


def functionalize(net, train_mode=False, with_state=False):
    """Return ``(apply_fn, params)`` for an initialized Gluon block.

    ``params`` is an OrderedDict name -> tensor of the current values,
    sorted by name.  ``apply_fn(params_dict, *inputs)`` runs the forward
    in train (``train_mode``) or predict mode on those tensors; it records
    for torch autograd iff grad mode is on where it is called.

    ``with_state=False``: running-state updates (BatchNorm moving stats)
    are dropped.  ``with_state=True``: ``apply_fn`` returns
    ``(outputs, state)``, state mapping each state parameter's name to
    its new value.  The net's own Parameters are never written.
    ``apply_fn(..., read=names)`` adds to the set ``names`` the name of
    every parameter the forward read (a block that is never called reads
    none of its parameters).
    """
    plist = sorted(net.collect_params().items())
    try:
        params = OrderedDict((name, p.data()._data) for name, p in plist)
    except DeferredInitializationError as e:
        raise DeferredInitializationError(
            f"{e} -- run one forward (net(x)) before functionalize() so "
            f"deferred shapes are resolved") from e
    name_of = {id(p): name for name, p in plist}

    def apply_fn(params_dict, *inputs, read=None):
        tc = _TraceContext({p: NDArray._wrap(params_dict[name])
                            for name, p in plist})
        prev = _TRACE.ctx
        _TRACE.ctx = tc
        try:
            with _ag._scope(recording=torch.is_grad_enabled(),
                            training=train_mode):
                out = net.forward(*(NDArray._wrap(t) for t in inputs))
        finally:
            _TRACE.ctx = prev
        if read is not None:
            read.update(name_of[id(p)] for p in tc.read)
        if isinstance(out, NDArray):
            out = out._data
        elif isinstance(out, (list, tuple)):
            out = tuple(o._data if isinstance(o, NDArray) else o
                        for o in out)
        if not with_state:
            return out
        return out, OrderedDict((name_of[id(p)], v)
                                for p, v in tc.state_updates)

    return apply_fn, params
