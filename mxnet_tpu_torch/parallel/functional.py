"""Functionalize a Gluon block (counterpart of
``mxnet_tpu/parallel/functional.py``): ``apply_fn(params, *inputs)`` runs
the net with the parameter values taken from a name -> tensor dict instead
of the net's own Parameters, so a caller can differentiate the forward
with respect to tensors it owns (``TrainStep``).  ``rematerialize`` runs a
piece of such a forward under activation checkpointing."""
from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager

import torch
from torch.utils.checkpoint import checkpoint

from .. import autograd as _ag
from .. import random as _random
from .._tree import flatten, unflatten
from ..gluon.parameter import (_TRACE, DeferredInitializationError,
                               _TraceContext)
from ..ndarray.ndarray import _AMP, NDArray

__all__ = ["functionalize", "functionalize_part", "rematerialize"]


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
    none of its parameters).  Inputs and outputs may be nested lists and
    tuples of tensors (a recurrent net's states).
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
                leaves, spec = flatten(inputs)
                out = net.forward(*unflatten(spec, leaves, NDArray._wrap))
        finally:
            _TRACE.ctx = prev
        if read is not None:
            read.update(name_of[id(p)] for p in tc.read)
        leaves, spec = flatten(out)
        out = unflatten(spec, leaves)
        if not with_state:
            return out
        return out, OrderedDict((name_of[id(p)], v)
                                for p, v in tc.state_updates)

    return apply_fn, params


def functionalize_part(net, fn, names, train_mode=False):
    """``apply(params_dict, *inputs)`` running ``fn(*inputs)`` (NDArrays
    in and out, calling ``net``'s blocks) with the parameters named in
    ``names`` answered from ``params_dict``, as :func:`functionalize`
    answers them all: a piece of a net's forward (a pipeline's embedding
    or head) over a subset of its parameters."""
    names = set(names)
    plist = [(name, p) for name, p in sorted(net.collect_params().items())
             if name in names]

    def apply(params_dict, *inputs):
        tc = _TraceContext({p: NDArray._wrap(params_dict[name])
                            for name, p in plist})
        prev = _TRACE.ctx
        _TRACE.ctx = tc
        try:
            with _ag._scope(recording=torch.is_grad_enabled(),
                            training=train_mode):
                leaves, spec = flatten(inputs)
                out = fn(*unflatten(spec, leaves, NDArray._wrap))
        finally:
            _TRACE.ctx = prev
        leaves, spec = flatten(out)
        return unflatten(spec, leaves)

    return apply


def _scopes():
    """The scopes a forward runs in: the functionalize trace (which tensors
    the Parameters answer with), the AMP cast policy, and the autograd
    recording / training state."""
    return (_TRACE.ctx, dict(_AMP), _ag.is_recording(), _ag.is_training())


@contextmanager
def _reenter(scopes):
    """Run inside ``scopes`` (from :func:`_scopes`), restoring the current
    ones on exit."""
    tc, amp, recording, training = scopes
    prev_tc, prev_amp = _TRACE.ctx, dict(_AMP)
    _TRACE.ctx = tc
    _AMP.update(amp)
    try:
        with _ag._scope(recording=recording, training=training):
            yield
    finally:
        _TRACE.ctx = prev_tc
        _AMP.update(prev_amp)


def rematerialize(fn, *args):
    """``fn(*args)`` (tensors in, tensors out) with its activations
    recomputed in the backward instead of stored:
    ``torch.utils.checkpoint`` without reentry, so the parameters ``fn``
    closes over get their gradients through the original graph.

    The recomputation runs while the backward runs, outside every scope the
    forward ran in, so it re-enters them: the functionalize trace (without
    it the Parameters would answer with the net's own tensors instead of
    the step's, and the gradients would be silently wrong), the AMP policy
    (else it would recompute in fp32), the autograd state (else the ops
    would record nothing), and the state of the port's generator on the
    inputs' devices, which it leaves as it found it (Dropout draws the
    forward's masks again)."""
    scopes = _scopes()
    gens = [_random.generator(d) for d in
            {a.device for a in args if isinstance(a, torch.Tensor)}]
    rng = [g.get_state() for g in gens]
    calls = []

    def body(*a):
        recompute = bool(calls)
        calls.append(None)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, rng):
            g.set_state(s)
        try:
            with _reenter(scopes):
                return fn(*a)
        finally:
            if recompute:
                for g, s in zip(gens, now):
                    g.set_state(s)

    return checkpoint(body, *args, use_reentrant=False)
