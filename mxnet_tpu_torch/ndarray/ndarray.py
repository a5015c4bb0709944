"""NDArray: MXNet's mutable tensor as a handle over a ``torch.Tensor``
(counterpart of ``mxnet_tpu/ndarray/ndarray.py``).

Every operator call funnels through :func:`invoke`, which looks the op up
in the table, applies the mixed-precision cast policy (``contrib.amp``)
and runs it with torch autograd on exactly while ``autograd.record()`` is
active.  Writes (``a[:] = x``, ``a += 1``, an optimizer's ``_set``) copy
into the handle's tensor in place, so every alias sees them.
"""
from __future__ import annotations

import functools
import threading
import time

import numpy as _np
import torch

from .. import autograd as _ag
from ..base import MXNetError, dtype_name, numeric_types, torch_dtype
from ..context import Context, current_context
from ..ops.registry import get_op
from . import dispatch_cache as _dispatch

__all__ = ["NDArray", "invoke", "apply_fn", "array", "waitall"]

# mixed-precision state, owned by contrib.amp: "wrap" is a callable
# (opdef, fn) -> fn installed by amp.init() (reference: the same dict in
# mxnet_tpu/ndarray/ndarray.py)
_AMP = {"on": False, "wrap": None, "target": None}
# per-op profiling state, owned by profiler.py ("record": callable(opname,
# t0, t1) installed while imperative ops are profiled)
_PROFILE = {"on": False, "record": None}
# symbolic export tracing (HybridBlock.export): while "on", a call with a
# SymbolTracer input adds a graph node instead of running (symbol.py)
_SYMTRACE = {"on": False}

class _CaptureState(threading.local):
    """``block``: the hybridized block whose forward this thread is
    capturing in a CUDA graph, or None; a host read there is refused with
    its name (HybridBlock.hybridize)."""
    block = None


_CAPTURE = _CaptureState()


def waitall():
    """Block until queued device work finishes (reference: mx.nd.waitall)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class NDArray:
    """n-dimensional array on a device, with imperative (mutable)
    semantics.  ``_data`` is the torch tensor; a marked variable also holds
    its gradient buffer ``_grad`` and ``_grad_req``."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    # higher than numpy's, so ndarray.__add__(np, NDArray) defers to us
    __array_priority__ = 1000.0

    def __init__(self):
        raise MXNetError("use mx.nd.array / mx.nd.zeros / ... to create "
                         "NDArrays")

    @classmethod
    def _wrap(cls, tensor):
        self = object.__new__(cls)
        self._data = tensor
        self._grad = None
        self._grad_req = "write"
        return self

    def _set(self, value):
        """Write ``value`` into this handle's tensor in place."""
        v = value._data if isinstance(value, NDArray) else value
        if tuple(v.shape) != self.shape:
            raise MXNetError(f"cannot assign shape {tuple(v.shape)} to "
                             f"NDArray of shape {self.shape}")
        with torch.no_grad():
            self._data.copy_(v)

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return dtype_name(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return Context.from_device(self._data.device)

    ctx = context

    @property
    def stype(self):
        """The storage type: "default" (dense); the sparse arrays of
        ``nd.sparse`` say "row_sparse" or "csr"."""
        return "default"

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return self.transpose()

    # -- sync / host transfer ---------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    def asnumpy(self):
        """A numpy copy (bfloat16 comes back as float32: numpy has no
        bfloat16).  A copy on the CPU too, where ``Tensor.numpy()`` would
        share the tensor's memory and see its later in-place updates."""
        if _CAPTURE.block is not None:
            raise MXNetError(
                f"hybridized block {_CAPTURE.block!r} reads an array "
                f"back to the host (asnumpy/asscalar) in its forward: a "
                f"CUDA graph cannot capture a host read")
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        elif not t.is_cuda:
            t = t.clone()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a gradient buffer and mark this array as a variable (a
        fresh leaf: recorded history behind it is cut, as in MXNet)."""
        grad = NDArray._wrap(torch.zeros_like(self._data))
        self._data = self._data.detach().requires_grad_(
            self._data.is_floating_point())
        self._mark_variable(grad, grad_req)

    def _mark_variable(self, grad_nd, grad_req="write"):
        self._grad = grad_nd
        self._grad_req = grad_req
        _ag._register_variable(self)

    def zero_grad(self):
        if self._grad is not None:
            with torch.no_grad():
                self._grad._data.zero_()

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], [out_grad], retain_graph=retain_graph,
                     train_mode=train_mode)

    def detach(self):
        return NDArray._wrap(self._data.detach())

    # -- copies / casts / movement ----------------------------------------
    def copy(self):
        return NDArray._wrap(self._data.detach().clone())

    def copyto(self, other):
        """Copy into another NDArray or onto a Context."""
        if isinstance(other, Context):
            return NDArray._wrap(self._data.detach().to(other.device,
                                                        copy=True))
        other._set(self)
        return other

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        """This array (the reference's ``mx.np`` bridge; the port has one
        array type)."""
        return self

    def astype(self, dtype, copy=True):
        return invoke("cast", [self], {"dtype": dtype})

    def tostype(self, stype):
        """This array in storage ``stype`` ("default", "row_sparse" or
        "csr"; reference: cast_storage)."""
        if stype == "default":
            return self
        from .sparse import CSRNDArray, RowSparseNDArray

        if stype == "row_sparse":
            return RowSparseNDArray.from_dense(self._data.detach())
        if stype == "csr":
            return CSRNDArray.from_dense(self._data.detach())
        raise MXNetError(f"unknown storage type {stype!r}")

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key):
        key = _sanitize_key(key)
        with torch.set_grad_enabled(_ag.is_recording()):
            return NDArray._wrap(self._data[key])

    def __setitem__(self, key, value):
        key = _sanitize_key(key)
        v = value._data if isinstance(value, NDArray) else value
        if not isinstance(v, (torch.Tensor,) + numeric_types):
            v = torch.as_tensor(_np.asarray(v), device=self._data.device)
        with torch.no_grad():
            self._data[key] = v

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # -- operators: all dispatch through the op table ----------------------
    def _binary(self, op, other, reverse=False):
        if isinstance(other, NDArray):
            return invoke(op, [other, self] if reverse else [self, other], {})
        if isinstance(other, numeric_types):
            return invoke(op + "_scalar", [self],
                          {"scalar": other.item()
                           if isinstance(other, _np.generic) else other,
                           "reverse": reverse})
        if isinstance(other, (_np.ndarray, list, tuple)):
            o = array(other, ctx=self.context)
            return invoke(op, [o, self] if reverse else [self, o], {})
        return NotImplemented

    def __add__(self, o):
        return self._binary("broadcast_add", o)

    def __radd__(self, o):
        return self._binary("broadcast_add", o, reverse=True)

    def __sub__(self, o):
        return self._binary("broadcast_sub", o)

    def __rsub__(self, o):
        return self._binary("broadcast_sub", o, reverse=True)

    def __mul__(self, o):
        return self._binary("broadcast_mul", o)

    def __rmul__(self, o):
        return self._binary("broadcast_mul", o, reverse=True)

    def __truediv__(self, o):
        return self._binary("broadcast_div", o)

    def __rtruediv__(self, o):
        return self._binary("broadcast_div", o, reverse=True)

    def __mod__(self, o):
        return self._binary("broadcast_mod", o)

    def __rmod__(self, o):
        return self._binary("broadcast_mod", o, reverse=True)

    def __pow__(self, o):
        return self._binary("broadcast_power", o)

    def __rpow__(self, o):
        return self._binary("broadcast_power", o, reverse=True)

    def __matmul__(self, o):
        from . import dot as _dot

        return _dot(self, o)

    def __neg__(self):
        return invoke("negative", [self], {})

    def __abs__(self):
        return invoke("abs", [self], {})

    def _inplace(self, op, o):
        r = self._binary(op, o)
        if _ag.is_recording():
            # a recorded in-place op rebinds the handle to the new node
            self._data = r._data.to(self._data.dtype)
        else:
            self._set(r)
        return self

    def __iadd__(self, o):
        return self._inplace("broadcast_add", o)

    def __isub__(self, o):
        return self._inplace("broadcast_sub", o)

    def __imul__(self, o):
        return self._inplace("broadcast_mul", o)

    def __itruediv__(self, o):
        return self._inplace("broadcast_div", o)

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary("broadcast_equal", o)

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary("broadcast_not_equal", o)

    def __gt__(self, o):
        return self._binary("broadcast_greater", o)

    def __ge__(self, o):
        return self._binary("broadcast_greater_equal", o)

    def __lt__(self, o):
        return self._binary("broadcast_lesser", o)

    def __le__(self, o):
        return self._binary("broadcast_lesser_equal", o)

    __hash__ = object.__hash__   # identity hash (mutable container)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # -- method surface ----------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return invoke("reshape", [self],
                      {"shape": _infer_reshape(self.shape, tuple(shape))})

    def transpose(self, axes=None):
        return invoke("transpose", [self], {"axes": axes})

    def flatten(self):
        return invoke("flatten", [self], {})

    def slice_axis(self, axis=0, begin=0, end=None):
        return invoke("slice_axis", [self],
                      {"axis": axis, "begin": begin, "end": end})

    def sum(self, axis=None, keepdims=False):
        return invoke("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return invoke("mean", [self], {"axis": axis, "keepdims": keepdims})

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def squeeze(self, axis=None):
        return invoke("squeeze", [self], {"axis": axis})

    def expand_dims(self, axis):
        return invoke("expand_dims", [self], {"axis": axis})

    def swapaxes(self, dim1, dim2):
        return invoke("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def broadcast_to(self, shape):
        return invoke("broadcast_to", [self], {"shape": shape})

    def broadcast_like(self, other):
        return invoke("broadcast_to", [self], {"shape": other.shape})

    def tile(self, reps):
        return invoke("tile", [self], {"reps": reps})

    def repeat(self, repeats, axis=None):
        return invoke("repeat", [self], {"repeats": repeats, "axis": axis})

    def pad(self, *a, **kw):
        return invoke("pad", [self], kw)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("split", [self], {"num_outputs": num_outputs,
                                        "axis": axis,
                                        "squeeze_axis": squeeze_axis})

    def clip(self, a_min=None, a_max=None):
        return invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def softmax(self, axis=-1):
        return invoke("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", [self], {"axis": axis})

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", [self], {"ord": ord, "axis": axis,
                                       "keepdims": keepdims})

    def argsort(self, axis=-1, is_ascend=True):
        return invoke("argsort", [self], {"axis": axis,
                                          "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return invoke("sort", [self], {"axis": axis, "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return invoke("topk", [self], {"axis": axis, "k": k,
                                       "ret_typ": ret_typ,
                                       "is_ascend": is_ascend})

    def dot(self, other, transpose_a=False, transpose_b=False):
        from . import dot as _dot

        return _dot(self, other, transpose_a=transpose_a,
                    transpose_b=transpose_b)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return invoke("one_hot", [self], {"depth": depth,
                                          "on_value": on_value,
                                          "off_value": off_value})

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", [self, indices], {"axis": axis, "mode": mode})


def _unary_method(op):
    def method(self):
        return invoke(op, [self], {})

    method.__name__ = op
    return method


def _reduce_method(op):
    def method(self, axis=None, keepdims=False):
        return invoke(op, [self], {"axis": axis, "keepdims": keepdims})

    method.__name__ = op
    return method


for _op in ("abs", "sign", "sqrt", "square", "exp", "log", "relu",
            "sigmoid", "tanh"):
    setattr(NDArray, _op, _unary_method(_op))
for _op in ("nansum", "max", "min", "prod", "argmax", "argmin"):
    setattr(NDArray, _op, _reduce_method(_op))


# --------------------------------------------------------------------------
# the imperative invoke path (reference: MXImperativeInvokeEx ->
# Imperative::Invoke)
# --------------------------------------------------------------------------
def invoke(opname, nd_args, attrs, out=None, ctx=None):
    """Run a registered op on NDArray inputs and wrap its outputs.

    Non-NDArray inputs become tensors on the device of the NDArray inputs
    (or ``ctx``); a creation op is handed ``device=`` (``ctx``, else the
    current context).  Optional inputs passed as None are dropped.  The op
    runs with torch autograd on iff ``autograd.is_recording()`` and the op
    is differentiable; under ``amp.init()`` its float inputs are cast by
    the policy inside the call, so gradients flow back to the original
    dtype through the cast.
    """
    od = get_op(opname)
    if _SYMTRACE["on"]:
        from ..symbol.symbol import SymbolTracer, trace_invoke

        if any(isinstance(a, SymbolTracer) for a in nd_args):
            return trace_invoke(opname, nd_args, attrs, out=out)
    nd_args = [a for a in nd_args if a is not None]
    device = ctx.device if isinstance(ctx, Context) else \
        (torch.device(ctx) if ctx is not None else None)
    if device is None:
        device = next((a._data.device for a in nd_args
                       if isinstance(a, NDArray)), None)
    vals = [a._data if isinstance(a, NDArray) else
            torch.as_tensor(_np.asarray(a), device=device) for a in nd_args]
    # None means "not given" except where it is a value (every axis, an
    # open clip bound), as in the reference
    attrs = {k: v for k, v in attrs.items()
             if v is not None or k in ("axis", "a_min", "a_max")}
    if od.creation:
        attrs["device"] = device if device is not None else \
            current_context().device
    fn = functools.partial(od.fn, **attrs)
    if _AMP["on"]:
        fn = _AMP["wrap"](od, fn)
    _dispatch.count(opname)
    # per-op timing (the reference's engine profiler op events): an honest
    # time of an asynchronous launch needs a sync, the trade the
    # reference's profiler makes.  Snapshot the recorder, so another
    # thread's profiler.stop() cannot null it mid-op; never inside a
    # CUDA-graph capture, where a sync is illegal
    prof_rec = _PROFILE["record"] if _PROFILE["on"] else None
    if prof_rec is not None:
        t0 = time.perf_counter()
    with torch.set_grad_enabled(_ag.is_recording() and od.differentiable):
        res = fn(*vals)
    multi = isinstance(res, (tuple, list))
    if prof_rec is not None and not _CAPTURE.block:
        first = res[0] if multi else res
        if isinstance(first, torch.Tensor) and first.is_cuda:
            torch.cuda.synchronize(first.device)
        prof_rec(opname, t0, time.perf_counter())
    outs = [NDArray._wrap(r) for r in (res if multi else [res])]
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, o in zip(targets, outs):
            t._set(o)
        return out
    return outs if multi else outs[0]


def apply_fn(fn, nd_args, name="custom_fn", ctx=None):
    """Run ``fn`` (torch tensors in, a tensor or a tuple of them out) over
    NDArray inputs as one computation on the autograd tape: torch records
    it while ``autograd.record()`` is on, as :func:`invoke` records an op,
    through its inputs and through any recorded tensor ``fn`` closes over
    (a loop body's parameters).  Non-NDArray inputs become tensors on the device of the NDArray
    inputs; the outputs are on ``ctx`` (default: the first NDArray input's
    context).  ``name`` is the reference's label for the tape node.  An
    arbitrary ``fn`` has no graph node: under export tracing it raises."""
    if _SYMTRACE["on"]:
        from ..symbol.symbol import SymbolTracer

        if any(isinstance(a, SymbolTracer) for a in nd_args):
            raise MXNetError(f"{name}: a function applied outside the op "
                             f"table cannot be exported to a Symbol")
    device = next((a._data.device for a in nd_args
                   if isinstance(a, NDArray)), None)
    if device is None:
        device = (ctx or current_context()).device
    vals = [a._data if isinstance(a, NDArray) else
            torch.as_tensor(_np.asarray(a), device=device) for a in nd_args]
    with torch.set_grad_enabled(_ag.is_recording()):
        res = fn(*vals)
    multi = isinstance(res, (tuple, list))
    outs = list(res) if multi else [res]
    if ctx is not None:
        outs = [o.to(ctx.device) for o in outs]
    nd_outs = [NDArray._wrap(o) for o in outs]
    return nd_outs if multi else nd_outs[0]


def _sanitize_key(key):
    def conv(k):
        return k._data if isinstance(k, NDArray) else k

    if isinstance(key, tuple):
        return tuple(conv(k) for k in key)
    return conv(key)


def _infer_reshape(cur_shape, shape):
    """MXNet reshape specials 0 (copy the dim) and -1 (infer)."""
    out = [cur_shape[i] if d == 0 else d for i, d in enumerate(shape)]
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        size = 1
        for d in cur_shape:
            size *= d
        out[out.index(-1)] = size // max(known, 1)
    return tuple(out)


def array(source_array, ctx=None, dtype=None):
    """Create an NDArray from any array-like on ``ctx`` (default: the
    current context, the first CUDA card).  Python lists and float64 numpy
    arrays become float32, int64 numpy arrays int32 (MXNet's dtype
    discipline); a 0-d source becomes shape (1,)."""
    device = (ctx or current_context()).device
    if isinstance(source_array, NDArray):
        t = source_array._data.detach()
    elif isinstance(source_array, torch.Tensor):
        t = source_array.detach()
    else:
        from_pylist = not hasattr(source_array, "dtype")
        v = _np.asarray(source_array)
        if dtype is None:
            if from_pylist or v.dtype == _np.float64:
                dtype = _np.float32
            elif v.dtype == _np.int64:
                dtype = _np.int32
        t = torch.from_numpy(_np.array(v.reshape(1) if v.ndim == 0 else v))
    if t.dim() == 0:
        t = t.reshape(1)
    t = t.to(device=device, dtype=torch_dtype(dtype) if dtype is not None
             else t.dtype, copy=True)
    return NDArray._wrap(t)
