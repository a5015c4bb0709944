"""Sparse NDArrays: row_sparse and csr storage, ``mx.nd.sparse``
(counterpart of ``mxnet_tpu/ndarray/sparse.py``; MXNet's
``python/mxnet/ndarray/sparse.py``).

A sparse array holds its compact parts as torch tensors on one device:
``RowSparseNDArray`` the stored rows' indices (int32) and values,
``CSRNDArray`` the nonzeros, their column indices and the row pointer
(int32).  Every dense op accepts a sparse input by materializing it (the
reference's storage fallback: ``_data`` is the dense tensor), while the
sparse-aware paths read the parts: ``dot`` of a CSR and a dense operand
(a gather and an ``index_add`` over the nonzeros, never the dense CSR
matrix; its gradient reaches the dense operand through torch autograd),
``retain``, ``add_rowsparse`` and the lazy row-sparse optimizer updates.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, dtype_name
from ..context import Context, current_context
from .ndarray import NDArray, apply_fn, array as _dense_array

__all__ = ["RowSparseNDArray", "CSRNDArray", "row_sparse_array", "csr_matrix",
           "zeros", "array", "add_rowsparse", "dot_csr_dense", "dot",
           "cast_storage", "retain"]


def _device(ctx, like=None):
    """``ctx``'s device; else the device of ``like`` (an NDArray or a
    tensor); else the current context's."""
    if ctx is not None:
        return ctx.device
    if isinstance(like, NDArray):
        return like._data.device
    if isinstance(like, torch.Tensor):
        return like.device
    return current_context().device


def _tensor(x, device, dtype=None):
    """``x`` (NDArray, tensor, numpy or list) as a tensor on ``device``."""
    if isinstance(x, NDArray):
        x = x._data.detach()
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(_np.array(x))
        if dtype is None and x.dtype == torch.float64:
            x = x.to(torch.float32)
    return x.to(device=device, dtype=dtype or x.dtype)


class _SparseBase(NDArray):
    """Dense materialization through ``_data`` (so every dense op takes a
    sparse input), compact parts for the sparse-aware consumers."""

    __slots__ = ()

    def _dense(self):
        raise NotImplementedError

    @property
    def _data(self):
        return self._dense()

    @_data.setter
    def _data(self, value):
        raise MXNetError(f"{type(self).__name__} is immutable; convert with "
                         f"tostype('default') first")

    def _set(self, value):
        raise MXNetError(f"{type(self).__name__} is immutable; convert with "
                         f"tostype('default') first")

    @property
    def context(self):
        return Context.from_device(self._device)

    ctx = context

    @property
    def size(self):
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def ndim(self):
        return len(self.shape)

    def tostype(self, stype):
        if stype == "default":
            return NDArray._wrap(self._dense())
        if stype == self.stype:
            return self
        if stype == "row_sparse":
            return RowSparseNDArray.from_dense(self._dense())
        if stype == "csr":
            return CSRNDArray.from_dense(self._dense())
        raise MXNetError(f"unknown stype {stype!r}")

    def copy(self):
        return self.tostype(self.stype)

    def as_in_context(self, ctx):
        return self if ctx == self.context else self.copyto(ctx)

    def attach_grad(self, grad_req="write", stype=None):
        raise MXNetError(f"{type(self).__name__} cannot be a variable: "
                         f"the gradient of a sparse operand is not taken "
                         f"(convert with tostype('default'))")


class RowSparseNDArray(_SparseBase):
    """(indices (K,), values (K, *cols)) standing for shape (N, *cols);
    rows not listed are zero."""

    __slots__ = ("_rs_indices", "_rs_values", "_rs_shape")

    @classmethod
    def create(cls, indices, values, shape, ctx=None):
        self = object.__new__(cls)
        device = _device(ctx, values)
        self._rs_indices = _tensor(indices, device, torch.int32)
        self._rs_values = _tensor(values, device)
        self._rs_shape = tuple(int(d) for d in shape)
        self._grad = None
        self._grad_req = "null"
        return self

    @classmethod
    def from_dense(cls, dense, ctx=None):
        t = _tensor(dense, _device(ctx, dense))
        nz = (t != 0).reshape(t.shape[0], -1).any(dim=1) if t.dim() > 1 \
            else t != 0
        idx = torch.nonzero(nz).reshape(-1)
        return cls.create(idx, t[idx], t.shape)

    @property
    def _device(self):
        return self._rs_values.device

    def _dense(self):
        dense = torch.zeros(self._rs_shape, dtype=self._rs_values.dtype,
                            device=self._device)
        if self._rs_values.shape[0]:
            dense[self._rs_indices.long()] = self._rs_values
        return dense

    @property
    def shape(self):
        return self._rs_shape

    @property
    def dtype(self):
        return dtype_name(self._rs_values.dtype)

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self):
        return NDArray._wrap(self._rs_indices)

    @property
    def data(self):
        return NDArray._wrap(self._rs_values)

    def __repr__(self):
        return (f"<RowSparseNDArray {self._rs_shape} "
                f"({self._rs_values.shape[0]} rows stored)>")

    def copyto(self, other):
        if isinstance(other, Context):
            return RowSparseNDArray.create(self._rs_indices, self._rs_values,
                                           self._rs_shape, other)
        other._set(NDArray._wrap(self._dense()))
        return other

    def retain(self, row_ids):
        """Only the stored rows listed in ``row_ids`` (reference: the
        sparse_retain op)."""
        rid = _tensor(row_ids, self._device, torch.int32)
        keep = torch.isin(self._rs_indices, rid)
        return RowSparseNDArray.create(self._rs_indices[keep],
                                       self._rs_values[keep], self._rs_shape,
                                       self.context)


class CSRNDArray(_SparseBase):
    """Compressed sparse row matrix: (data, indices, indptr) + 2-D shape."""

    __slots__ = ("_csr_data", "_csr_indices", "_csr_indptr", "_csr_shape")

    @classmethod
    def create(cls, data, indices, indptr, shape, ctx=None):
        self = object.__new__(cls)
        device = _device(ctx, data)
        self._csr_data = _tensor(data, device)
        self._csr_indices = _tensor(indices, device, torch.int32)
        self._csr_indptr = _tensor(indptr, device, torch.int32)
        self._csr_shape = tuple(int(d) for d in shape)
        self._grad = None
        self._grad_req = "null"
        return self

    @classmethod
    def from_dense(cls, dense, ctx=None):
        d = dense.asnumpy() if isinstance(dense, NDArray) else \
            dense.detach().cpu().numpy() if isinstance(dense, torch.Tensor) \
            else _np.asarray(dense)
        ctx = Context.from_device(_device(ctx, dense))
        if d.ndim != 2:
            raise MXNetError("csr storage requires a 2-D array")
        rows, cols = _np.nonzero(d)
        indptr = _np.zeros(d.shape[0] + 1, dtype=_np.int64)
        _np.add.at(indptr, rows + 1, 1)
        return cls.create(d[rows, cols], cols, _np.cumsum(indptr), d.shape,
                          ctx)

    @property
    def _device(self):
        return self._csr_data.device

    def _rows(self):
        """The row of each stored value (int64)."""
        n = self._csr_shape[0]
        counts = (self._csr_indptr[1:] - self._csr_indptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(n, device=self._device), counts,
            output_size=self._csr_data.shape[0])

    def _dense(self):
        dense = torch.zeros(self._csr_shape, dtype=self._csr_data.dtype,
                            device=self._device)
        if self._csr_data.shape[0]:
            dense[self._rows(), self._csr_indices.long()] = self._csr_data
        return dense

    @property
    def shape(self):
        return self._csr_shape

    @property
    def dtype(self):
        return dtype_name(self._csr_data.dtype)

    @property
    def stype(self):
        return "csr"

    @property
    def data(self):
        return NDArray._wrap(self._csr_data)

    @property
    def indices(self):
        return NDArray._wrap(self._csr_indices)

    @property
    def indptr(self):
        return NDArray._wrap(self._csr_indptr)

    def __repr__(self):
        return (f"<CSRNDArray {self._csr_shape} "
                f"({self._csr_data.shape[0]} stored)>")

    def copyto(self, other):
        if isinstance(other, Context):
            return CSRNDArray.create(self._csr_data, self._csr_indices,
                                     self._csr_indptr, self._csr_shape, other)
        other._set(NDArray._wrap(self._dense()))
        return other


# --------------------------------------------------------------------------
# constructors (reference: mx.nd.sparse.*)
# --------------------------------------------------------------------------
def row_sparse_array(arg, shape=None, ctx=None, dtype=None):
    """From ``(values, indices)`` and ``shape``, or from a dense array."""
    if isinstance(arg, tuple) and len(arg) == 2:
        values, indices = arg
        if shape is None:
            raise MXNetError("shape required for (data, indices) input")
        return RowSparseNDArray.create(indices, values, shape, ctx)
    if isinstance(arg, RowSparseNDArray):
        return arg
    dense = arg.asnumpy() if isinstance(arg, NDArray) else _np.asarray(arg)
    if dtype is not None:
        dense = dense.astype(dtype)
    return RowSparseNDArray.from_dense(dense, ctx)


def csr_matrix(arg, shape=None, ctx=None, dtype=None):
    """From ``(data, indices, indptr)`` and ``shape``, or from a dense
    2-D array."""
    if isinstance(arg, tuple) and len(arg) == 3:
        data, indices, indptr = arg
        if shape is None:
            raise MXNetError("shape required for (data, indices, indptr)")
        return CSRNDArray.create(data, indices, indptr, shape, ctx)
    if isinstance(arg, CSRNDArray):
        return arg
    dense = arg.asnumpy() if isinstance(arg, NDArray) else _np.asarray(arg)
    if dtype is not None:
        dense = dense.astype(dtype)
    return CSRNDArray.from_dense(dense, ctx)


def zeros(stype, shape, ctx=None, dtype="float32"):
    if stype == "row_sparse":
        return RowSparseNDArray.create(
            _np.zeros((0,), dtype=_np.int64),
            _np.zeros((0,) + tuple(shape[1:]), dtype=dtype), shape, ctx)
    if stype == "csr":
        return CSRNDArray.create(
            _np.zeros((0,), dtype=dtype), _np.zeros((0,), dtype=_np.int64),
            _np.zeros(shape[0] + 1, dtype=_np.int64), shape, ctx)
    from . import zeros as _dzeros

    return _dzeros(shape, ctx=ctx, dtype=dtype)


def array(source, ctx=None, dtype=None):
    if isinstance(source, (RowSparseNDArray, CSRNDArray)):
        return source
    return _dense_array(source, ctx=ctx, dtype=dtype)


# --------------------------------------------------------------------------
# sparse-aware helpers (reference: the FComputeEx kernels)
# --------------------------------------------------------------------------
def add_rowsparse(a, b):
    """row_sparse + row_sparse, kept row_sparse (reference: elemwise_add's
    rsp + rsp): the union of the stored rows, in sorted order."""
    union, inv = torch.unique(torch.cat([a._rs_indices, b._rs_indices]),
                              sorted=True, return_inverse=True)
    vals = torch.zeros((union.shape[0],) + tuple(a._rs_values.shape[1:]),
                       dtype=a._rs_values.dtype, device=a._device)
    vals.index_add_(0, inv, torch.cat([a._rs_values,
                                       b._rs_values.to(a._device)]))
    return RowSparseNDArray.create(union, vals, a.shape, a.context)


def _spmm(data, cols, indptr, n_rows, n_cols, dn, transpose_a=False):
    """CSR (``data``, ``cols``, ``indptr``; n_rows x n_cols) times the dense
    ``dn`` (or its transpose product when ``transpose_a``): each nonzero
    gathers its dense row and an ``index_add`` sums them into the output
    rows, so the CSR matrix is never made dense.  A 1-D ``dn`` gives a
    vector."""
    vec = dn.dim() == 1
    dn2 = dn[:, None] if vec else dn
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n_rows, device=dn.device),
                                   counts, output_size=data.shape[0])
    cols = cols.long()
    if not transpose_a:
        # out[r] += data * dense[col]
        contrib = data[:, None].to(dn.dtype) * dn2[cols]
        out = torch.zeros((n_rows, dn2.shape[1]), dtype=contrib.dtype,
                          device=dn.device).index_add(0, rows, contrib)
    else:
        # out[col] += data * dense[row]
        contrib = data[:, None].to(dn.dtype) * dn2[rows]
        out = torch.zeros((n_cols, dn2.shape[1]), dtype=contrib.dtype,
                          device=dn.device).index_add(0, cols, contrib)
    return out[:, 0] if vec else out


def dot_csr_dense(csr, dense, transpose_a=False):
    """csr x dense (reference: src/operator/tensor/dot.cc's csr paths).
    Recorded under ``autograd.record()``: the gradient reaches the dense
    operand (csr^T x the output's gradient); the csr values are data and
    take none, as in the reference."""
    if not isinstance(dense, NDArray):
        dense = _dense_array(dense, ctx=csr.context)
    want = csr._csr_shape[0] if transpose_a else csr._csr_shape[1]
    if dense.shape[0] != want:
        raise MXNetError(
            f"dot: csr shape {csr._csr_shape} (transpose_a={transpose_a}) "
            f"incompatible with rhs shape {tuple(dense.shape)}")
    n_rows, n_cols = csr._csr_shape

    def fn(dn):
        return _spmm(csr._csr_data, csr._csr_indices, csr._csr_indptr,
                     n_rows, n_cols, dn, transpose_a)

    return apply_fn(fn, [dense], name="dot_csr_dense")


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Storage-dispatching dot (reference: mx.nd.sparse.dot): a CSR lhs
    with a dense rhs takes :func:`dot_csr_dense`; anything else the dense
    op, sparse operands materialized."""
    if isinstance(lhs, CSRNDArray) and not isinstance(rhs, _SparseBase):
        if transpose_b:
            raise MXNetError("transpose_b unsupported for csr dot")
        return dot_csr_dense(lhs, rhs, transpose_a=transpose_a)
    from .ndarray import invoke

    return invoke("dot", [lhs, rhs], {"transpose_a": transpose_a,
                                      "transpose_b": transpose_b})


def cast_storage(arr, stype):
    """Reference: src/operator/tensor/cast_storage.cc."""
    return arr.tostype(stype)


def retain(arr, row_ids):
    """Reference: the sparse_retain op."""
    if not isinstance(arr, RowSparseNDArray):
        raise MXNetError("retain requires a RowSparseNDArray")
    return arr.retain(row_ids)
