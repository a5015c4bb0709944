"""``mx.nd.contrib``: the control-flow operators ``foreach``,
``while_loop`` and ``cond``, and every ``_contrib_*`` op of the table
under its short name (counterpart of ``mxnet_tpu/ndarray/contrib.py``).

Each control-flow call is one :func:`~.ndarray.apply_fn` computation: the
loop runs in Python over device tensors and reads nothing back to the
host, so it records for autograd like any op and can be captured in a
CUDA graph.  ``while_loop`` keeps the reference's fixed shapes: it runs
``max_iterations`` steps, a step after the condition first fails leaves
the loop variables as they were and emits zeros, so every output has
``max_iterations`` rows.  ``cond`` runs the branch the predicate picks
(the predicate is read on the host); inside a CUDA-graph capture, where
the host may not read, it runs both and selects on the device.
"""
from __future__ import annotations

import sys as _sys

import torch

from ..base import MXNetError
from ..ops.registry import OP_TABLE
from . import _make_op_func
from .ndarray import NDArray, apply_fn

__all__ = ["foreach", "while_loop", "cond"]


def _unwrap_list(x):
    if isinstance(x, NDArray):
        return [x], True
    return list(x), False


def _wrap(vals):
    return [NDArray._wrap(v) for v in vals]


def foreach(body, data, init_states):
    """Run ``body(data_t, states) -> (out_t, new_states)`` over axis 0 of
    ``data``; returns the stacked outputs and the final states (reference:
    mx.nd.contrib.foreach)."""
    data_list, data_single = _unwrap_list(data)
    states_list, states_single = _unwrap_list(init_states)
    n_data = len(data_list)
    meta = {}

    def pure(*vals):
        xs, states = vals[:n_data], list(vals[n_data:])
        steps = []
        for t in range(xs[0].shape[0]):
            x_nd = _wrap([x[t] for x in xs])
            s_nd = _wrap(states)
            out, new_states = body(x_nd[0] if data_single else x_nd,
                                   s_nd[0] if states_single else s_nd)
            out_list, meta["out_single"] = _unwrap_list(out)
            steps.append([o._data for o in out_list])
            states = [s._data for s in _unwrap_list(new_states)[0]]
        meta["n_out"] = len(steps[0])
        outs = [torch.stack(col) for col in zip(*steps)]
        return tuple(outs) + tuple(states)

    res = apply_fn(pure, data_list + states_list, name="foreach")
    res = res if isinstance(res, list) else [res]
    outs, states = res[:meta["n_out"]], res[meta["n_out"]:]
    return (outs[0] if meta["out_single"] else outs,
            states[0] if states_single else states)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Run ``func(*loop_vars) -> (outputs, new loop_vars)`` while
    ``cond(*loop_vars)`` holds, at most ``max_iterations`` times (reference:
    mx.nd.contrib.while_loop).  The outputs are stacked to
    ``max_iterations`` rows, zeros after the loop ended."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations (fixed shapes)")
    vars_list, single = _unwrap_list(loop_vars)
    meta = {}

    def pure(*vals):
        states = list(vals)
        active = torch.ones((), dtype=torch.bool, device=states[0].device)
        steps = []
        for _ in range(int(max_iterations)):
            s_nd = _wrap(states)
            pred = cond(*s_nd)
            active = active & pred._data.reshape(()).to(torch.bool)
            outs, new_states = func(*s_nd)
            out_list, meta["out_single"] = _unwrap_list(outs)
            new_list = _unwrap_list(new_states)[0]
            states = [torch.where(active, n._data, o)
                      for n, o in zip(new_list, states)]
            steps.append([torch.where(active, o._data,
                                      torch.zeros_like(o._data))
                          for o in out_list])
        meta["n_out"] = len(steps[0])
        outs = [torch.stack(col) for col in zip(*steps)]
        return tuple(outs) + tuple(states)

    res = apply_fn(pure, vars_list, name="while_loop")
    res = res if isinstance(res, list) else [res]
    outs, states = res[:meta["n_out"]], res[meta["n_out"]:]
    return (outs[0] if meta["out_single"] else outs,
            states[0] if single else states)


def cond(pred, then_func, else_func, inputs=None):
    """``then_func(*inputs)`` where ``pred(*inputs)`` holds, else
    ``else_func(*inputs)`` (reference: mx.nd.contrib.cond); both branches
    give outputs of the same shapes."""
    inputs_list = _unwrap_list(inputs)[0] if inputs is not None else []
    meta = {}

    def branch(fn, vals):
        out_list, meta["out_single"] = _unwrap_list(fn(*_wrap(vals)))
        return [o._data for o in out_list]

    def pure(*vals):
        p = pred(*_wrap(vals))._data.reshape(()).to(torch.bool)
        if not (p.is_cuda and torch.cuda.is_current_stream_capturing()):
            return tuple(branch(then_func if bool(p) else else_func, vals))
        return tuple(torch.where(p, a, b) for a, b in
                     zip(branch(then_func, vals), branch(else_func, vals)))

    res = apply_fn(pure, inputs_list, name="cond")
    res = res if isinstance(res, list) else [res]
    return res[0] if meta["out_single"] else res


_mod = _sys.modules[__name__]
for _name, _od in OP_TABLE.items():
    if _name.startswith("_contrib_"):
        _short = _name[len("_contrib_"):]
        if not hasattr(_mod, _short):
            setattr(_mod, _short, _make_op_func(_name, _od))
