"""The ``mx.nd`` namespace: one function per op of the table, generated at
import (counterpart of ``mxnet_tpu/ndarray/__init__.py``), the helpers
with MXNet's positional signatures (``array``, ``zeros``, ``ones``,
``full``, ``empty``, ``arange``, ``eye``, ``concat``, ``stack``,
``add_n``, the ``*_like`` ops, the scalar-tolerant ``maximum`` /
``minimum`` / ``power`` and the storage-dispatching ``dot``),
``cast_storage`` / ``sparse_retain``, ``save`` / ``load`` (the ``.params``
container), and the ``linalg``, ``contrib``, ``image``, ``random`` and
``sparse`` namespaces."""
from __future__ import annotations

import inspect as _inspect
import sys as _sys

import numpy as _np
import torch as _torch

from .. import ops as _ops  # noqa: F401  (populates the table)
from ..base import MXNetError
from ..ops.registry import OP_TABLE, list_ops
from . import dispatch_cache as _dispatch_cache
from .ndarray import NDArray, array, invoke, waitall

__all__ = ["NDArray", "array", "invoke", "waitall", "zeros", "ones", "full",
           "empty", "arange", "eye", "concat", "concatenate", "stack", "add_n",
           "zeros_like", "ones_like", "maximum", "minimum", "power", "dot",
           "list_ops", "save", "load", "linalg", "contrib", "image",
           "random", "sparse", "RowSparseNDArray", "CSRNDArray",
           "cast_storage", "sparse_retain", "dispatch_stats",
           "reset_dispatch_stats", "set_eager_jit"]


def dispatch_stats(reset=False):
    """``invoke``'s dispatch counters under the reference's keys: calls in
    all and per op (``ndarray/dispatch_cache.py``; the port dispatches
    eagerly, so every call counts as a bypass and nothing as a hit)."""
    out = _dispatch_cache.stats()
    if reset:
        _dispatch_cache.reset_stats()
    return out


def reset_dispatch_stats():
    _dispatch_cache.reset_stats()


def set_eager_jit(flag):
    """The reference's switch of its eager jit cache.  The port has none:
    ``False`` returns False, ``True`` raises."""
    return _dispatch_cache.set_enabled(flag)


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


# -- helpers with MXNet's positional signatures ----------------------------
def _shape_t(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _arrays(arrays):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        return list(arrays[0])
    return list(arrays)


def zeros(shape, ctx=None, dtype="float32", **kw):
    return invoke("zeros", [], {"shape": _shape_t(shape), "dtype": dtype},
                  ctx=ctx)


def ones(shape, ctx=None, dtype="float32", **kw):
    return invoke("ones", [], {"shape": _shape_t(shape), "dtype": dtype},
                  ctx=ctx)


def full(shape, val, ctx=None, dtype="float32", **kw):
    return invoke("full", [], {"shape": _shape_t(shape), "val": val,
                               "dtype": dtype}, ctx=ctx)


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    return invoke("arange", [], {"start": start, "stop": stop, "step": step,
                                 "repeat": repeat, "dtype": dtype}, ctx=ctx)


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    return invoke("eye", [], {"N": N, "M": M, "k": k, "dtype": dtype},
                  ctx=ctx)


def concat(*arrays, dim=1, **kw):
    return invoke("concat", _arrays(arrays), {"dim": dim})


def concatenate(arrays, axis=0, always_copy=True):
    """Join a list of arrays along ``axis`` (reference:
    mx.nd.concatenate; the result is a new array either way)."""
    return invoke("concat", list(arrays), {"dim": axis})


def stack(*arrays, axis=0, **kw):
    return invoke("stack", _arrays(arrays), {"axis": axis})


def add_n(*arrays, **kw):
    return invoke("add_n", _arrays(arrays), {})


def zeros_like(a, **kw):
    return invoke("zeros_like", [a], {})


def ones_like(a, **kw):
    return invoke("ones_like", [a], {})


_dense_dot = dot   # generated from the op table above


def dot(lhs, rhs, transpose_a=False, transpose_b=False, out=None, **kw):
    """The product of the op table; a CSR ``lhs`` with a dense ``rhs``
    takes the sparse product (``sparse.dot_csr_dense``: a gather and an
    index_add over the nonzeros), as the reference's dot FComputeEx does.
    Other sparse operands are materialized."""
    from . import sparse

    if isinstance(lhs, sparse.CSRNDArray) and \
            not isinstance(rhs, sparse._SparseBase):
        res = sparse.dot(lhs, rhs, transpose_a=transpose_a,
                         transpose_b=transpose_b)
        if out is not None:
            out._set(res._data.to(out._data.dtype))
            return out
        return res
    return _dense_dot(lhs, rhs, transpose_a=transpose_a,
                      transpose_b=transpose_b, out=out, **kw)


def cast_storage(arr, stype):
    """``arr`` in storage ``stype`` (reference: the cast_storage op)."""
    return arr.tostype(stype)


def sparse_retain(arr, row_ids):
    """The rows of a row_sparse ``arr`` listed in ``row_ids``."""
    from . import sparse

    return sparse.retain(arr, row_ids)


def _scalar_tolerant(opname, scalar_op):
    """``opname`` with a Python scalar on either side: the scalar rides as
    the attribute of ``scalar_op`` in the array's dtype family (an int for
    an integer array), so it promotes nothing; two scalars give a
    one-element float32 array."""
    base_fn = getattr(_mod, opname)

    def fn(lhs, rhs, *args, out=None, ctx=None, **kw):
        lhs_s = isinstance(lhs, (int, float))
        rhs_s = isinstance(rhs, (int, float))
        if lhs_s and rhs_s:
            res = array(getattr(_np, opname)(
                _np.float32(lhs), _np.float32(rhs)).reshape(()), ctx=ctx)
            if out is not None:
                out._set(res._data.to(out._data.dtype))
                return out
            return res

        def coerce(scalar, arr):
            if _np.issubdtype(_np.dtype(arr.dtype), _np.integer):
                return int(scalar)
            return float(scalar)

        if rhs_s:
            return invoke(scalar_op, [lhs], {"scalar": coerce(rhs, lhs)},
                          out=out, ctx=ctx)
        if lhs_s:
            return invoke(scalar_op, [rhs], {"scalar": coerce(lhs, rhs),
                                             "reverse": True},
                          out=out, ctx=ctx)
        return base_fn(lhs, rhs, *args, out=out, ctx=ctx, **kw)

    fn.__name__ = opname
    fn.__doc__ = base_fn.__doc__
    return fn


for _n in ("maximum", "minimum", "power"):
    setattr(_mod, _n, _scalar_tolerant(_n, f"broadcast_{_n}_scalar"))


def save(fname, data):
    """Save a dict, list or single NDArray to ``fname`` in the ``.params``
    container (see :mod:`.serialization`)."""
    from .serialization import save as _save

    return _save(fname, data)


def load(fname, ctx=None):
    """Load a ``.params`` file onto ``ctx`` (default: the current context,
    the first CUDA card)."""
    from .serialization import load as _load

    return _load(fname, ctx=ctx)

from . import contrib, image, linalg, random, sparse  # noqa: E402,F401
from .sparse import CSRNDArray, RowSparseNDArray  # noqa: E402,F401
