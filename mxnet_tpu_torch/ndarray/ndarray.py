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

import numpy as _np
import torch

from .. import autograd as _ag
from ..base import MXNetError, dtype_name, numeric_types, torch_dtype
from ..context import Context, current_context
from ..ops.registry import get_op

__all__ = ["NDArray", "invoke", "array", "waitall"]

# mixed-precision state, owned by contrib.amp: "wrap" is a callable
# (opdef, fn) -> fn installed by amp.init() (reference: the same dict in
# mxnet_tpu/ndarray/ndarray.py)
_AMP = {"on": False, "wrap": None, "target": None}


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
        bfloat16)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

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

    def astype(self, dtype, copy=True):
        return invoke("cast", [self], {"dtype": dtype})

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

    def sum(self, axis=None, keepdims=False):
        return invoke("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return invoke("mean", [self], {"axis": axis, "keepdims": keepdims})


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
    nd_args = [a for a in nd_args if a is not None]
    device = ctx.device if isinstance(ctx, Context) else \
        (torch.device(ctx) if ctx is not None else None)
    if device is None:
        device = next((a._data.device for a in nd_args
                       if isinstance(a, NDArray)), None)
    vals = [a._data if isinstance(a, NDArray) else
            torch.as_tensor(_np.asarray(a), device=device) for a in nd_args]
    attrs = {k: v for k, v in attrs.items() if v is not None}
    if od.creation:
        attrs["device"] = device if device is not None else \
            current_context().device
    fn = functools.partial(od.fn, **attrs)
    if _AMP["on"]:
        fn = _AMP["wrap"](od, fn)
    with torch.set_grad_enabled(_ag.is_recording() and od.differentiable):
        res = fn(*vals)
    multi = isinstance(res, (tuple, list))
    outs = [NDArray._wrap(r) for r in (res if multi else [res])]
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, o in zip(targets, outs):
            t._set(o)
        return out
    return outs if multi else outs[0]


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
