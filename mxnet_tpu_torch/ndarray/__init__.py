"""The ``mx.nd`` namespace: one function per op of the table, generated at
import (counterpart of ``mxnet_tpu/ndarray/__init__.py``), plus
``array`` / ``zeros`` / ``ones`` with MXNet's positional signatures."""
from __future__ import annotations

import inspect as _inspect
import sys as _sys

import numpy as _np
import torch as _torch

from .. import ops as _ops  # noqa: F401  (populates the table)
from ..ops.registry import OP_TABLE, list_ops
from .ndarray import NDArray, array, invoke, waitall

__all__ = ["NDArray", "array", "invoke", "waitall", "zeros", "ones",
           "list_ops"]


def _make_op_func(opname, od):
    """Positional array inputs map to the op's tensor parameters;
    positional scalars/tuples bind, in order, to its defaulted attribute
    parameters, as the reference's generated signatures do."""
    attr_names = [p.name for p in
                  _inspect.signature(od.fn).parameters.values()
                  if p.default is not _inspect.Parameter.empty]

    def fn(*args, out=None, ctx=None, name=None, **attrs):
        nd_args, extra = [], []
        for a in args:
            if isinstance(a, NDArray):
                nd_args.append(a)
            elif isinstance(a, (_np.ndarray, _torch.Tensor)):
                nd_args.append(array(a, ctx=ctx))
            else:
                extra.append(a)
        ai = 0
        for v in extra:
            while ai < len(attr_names) and attr_names[ai] in attrs:
                ai += 1
            if ai >= len(attr_names):
                raise TypeError(f"{opname}: too many positional arguments")
            attrs[attr_names[ai]] = v
            ai += 1
        return invoke(opname, nd_args, attrs, out=out, ctx=ctx)

    fn.__name__ = fn.__qualname__ = opname
    fn.__doc__ = od.fn.__doc__ or f"Operator {opname} (see " \
        f"mxnet_tpu_torch.ops)"
    return fn


_mod = _sys.modules[__name__]
for _name in list(OP_TABLE):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_op_func(_name, OP_TABLE[_name]))


def _shape_t(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", **kw):
    return invoke("zeros", [], {"shape": _shape_t(shape), "dtype": dtype},
                  ctx=ctx)


def ones(shape, ctx=None, dtype="float32", **kw):
    return invoke("ones", [], {"shape": _shape_t(shape), "dtype": dtype},
                  ctx=ctx)
