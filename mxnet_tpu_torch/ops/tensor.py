"""Tensor operator family (counterpart of ``mxnet_tpu/ops/tensor.py``):
elementwise unary and binary math with broadcasting and scalar forms,
reductions, products, shape and index ops, creation and ordering, the
``linalg_*`` ops and the contrib odds and ends.

Each op is plain PyTorch (``torch.linalg`` for the factorisations); torch
autograd supplies the gradients.  Dtypes follow the reference, which runs
JAX with 64-bit types off: index outputs are float32 unless the op names a
dtype, integer results of the reference are int32, and comparisons and
logic give float32.  Ops whose output size depends on the data
(``where_index``, ``boolean_mask``) keep it on the input's device; the only
host sync is the size that ``nonzero`` implies.  Random draws (``shuffle``)
come from the device's generator in ``mxnet_tpu_torch.random``.
"""
from __future__ import annotations

import math
import operator

import numpy as _np
import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError, torch_dtype
from .registry import register

_I32 = torch.int32


def _axes(axis, ndim):
    """``axis`` (None, an int or a sequence) as a tuple of non-negative
    axes; None is every axis."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(a % ndim for a in axis)


def _inexact(x):
    """``x`` as a floating tensor (int and bool -> float32), as jnp
    promotes the inputs of its transcendental functions."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _wrap(idx, size):
    """Integer indices into an axis of ``size``, truncated toward zero as
    the reference's ``astype(int32)``, a negative one counted from the
    end."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + size, idx)


def _take_along(data, idx, dim):
    """jnp.take_along_axis: ``idx`` wrapped once, and an index still out
    of range gives the fill value (NaN for floats, the lowest value for
    integers) instead of an element (CUDA would assert on it)."""
    size = data.shape[dim]
    idx = _wrap(idx, size)
    out = torch.take_along_dim(data, idx.clamp(0, max(size - 1, 0)),
                               dim=dim)
    valid = (idx >= 0) & (idx < size)
    if data.is_floating_point():
        fill = math.nan
    elif data.dtype == torch.bool:
        fill = True
    else:
        fill = torch.iinfo(data.dtype).min
    return torch.where(valid, out, torch.full((), fill, dtype=data.dtype,
                                              device=data.device))


# ==========================================================================
# elementwise unary
# ==========================================================================
def _unary(name, f, differentiable=True, aliases=()):
    def fn(x):
        return f(x)

    fn.__name__ = name
    register(name, differentiable=differentiable, aliases=aliases)(fn)


def _cbrt(x):
    x = _inexact(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _gamma(x):
    """The signed Gamma function: exp(lgamma(x)) with the sign of Gamma,
    which is negative on (-1, 0), (-3, -2), ...  (The reference drops the
    sign for x < 0; see ROADMAP.md C8.)"""
    x = _inexact(x)
    neg = (x < 0) & (torch.remainder(torch.floor(x), 2) == 1)
    return torch.exp(torch.lgamma(x)) * torch.where(neg, -1.0, 1.0).to(x.dtype)


def _rint(x):
    return torch.round(_inexact(x))


_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("negative", lambda x: -x)
_unary("reciprocal", lambda x: 1.0 / x)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", lambda x: 1.0 / torch.sqrt(x))
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("expm1", torch.expm1)
_unary("log", torch.log)
_unary("log2", torch.log2)
_unary("log10", torch.log10)
_unary("log1p", torch.log1p)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", lambda x: torch.rad2deg(_inexact(x)))
_unary("radians", lambda x: torch.deg2rad(_inexact(x)))
_unary("floor", torch.floor, differentiable=False)
_unary("ceil", torch.ceil, differentiable=False)
# half to even, as jnp.round (MXNet 1.x rounds half away from zero)
_unary("round", torch.round, differentiable=False)
_unary("rint", _rint, differentiable=False)
_unary("trunc", torch.trunc, differentiable=False)
_unary("fix", torch.trunc, differentiable=False)
_unary("gamma", _gamma)
_unary("gammaln", lambda x: torch.lgamma(_inexact(x)))
_unary("erf", lambda x: torch.erf(_inexact(x)))
_unary("erfinv", lambda x: torch.erfinv(_inexact(x)))
_unary("relu", torch.relu)
_unary("sigmoid", lambda x: torch.sigmoid(_inexact(x)))
_unary("softsign", lambda x: x / (1 + torch.abs(x)))
_unary("logical_not", lambda x: (x == 0).to(x.dtype), differentiable=False)
# a copy, as MXNet's identity: writing into the output leaves x alone
_unary("identity", torch.clone, aliases=("_copy", "stop_gradient_off"))
_unary("zeros_like", torch.zeros_like, differentiable=False)
_unary("ones_like", torch.ones_like, differentiable=False)
_unary("isnan", torch.isnan, differentiable=False)
_unary("isinf", torch.isinf, differentiable=False)
_unary("isfinite", torch.isfinite, differentiable=False)
# the exact erf form, as the reference's nn.gelu(approximate=False)
_unary("gelu", F.gelu)


@register("stop_gradient", aliases=("BlockGrad", "block_grad"),
          differentiable=False)
def stop_gradient(x):
    return x.detach()


@register("clip")
def clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


@register("cast", aliases=("Cast", "amp_cast"))
def cast(x, dtype="float32"):
    return x.to(torch_dtype(dtype))


# --------------------------------------------------------------------------
# elementwise binary, broadcasting (elemwise_* and broadcast_* share one
# implementation, as torch broadcasts natively), and their scalar forms
# --------------------------------------------------------------------------
def _binary(name, f, differentiable=True, aliases=(), scalar=True):
    def fn(a, b):
        return f(a, b)

    fn.__name__ = name
    register(name, differentiable=differentiable, aliases=aliases)(fn)
    if not scalar:
        return

    def scalar_fn(a, scalar=0.0, reverse=False):
        return f(scalar, a) if reverse else f(a, scalar)

    scalar_fn.__name__ = name + "_scalar"
    register(name + "_scalar", differentiable=differentiable)(scalar_fn)


def _operands(a, b):
    """A Python scalar operand as a 0-d tensor on the other's device: torch
    promotes a 0-d tensor weakly, as jnp does a Python scalar."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    return a, b


def _cmp(f):
    return lambda a, b: f(a, b).to(torch.float32)


def _logic(f):
    def g(a, b):
        a, b = _operands(a, b)
        return f(a != 0, b != 0).to(torch.float32)

    return g


def _mod(a, b):
    """Python-style modulo (the sign of b), as jnp.mod; a scalar ``a`` is
    spelled out, as torch has no gradient for remainder(scalar, tensor)."""
    if isinstance(a, torch.Tensor):
        return torch.remainder(a, b)
    return a - torch.floor(a / b) * b


def _extremum(f):
    return lambda a, b: f(*_operands(a, b))


def _hypot(a, b):
    a, b = _operands(a, b)
    dt = torch.promote_types(_inexact(a).dtype, _inexact(b).dtype)
    return torch.hypot(a.to(dt), b.to(dt))


_binary("broadcast_add", lambda a, b: a + b,
        aliases=("elemwise_add", "add"))
_binary("broadcast_sub", lambda a, b: a - b,
        aliases=("elemwise_sub", "subtract"))
_binary("broadcast_mul", lambda a, b: a * b,
        aliases=("elemwise_mul", "multiply"))
_binary("broadcast_div", lambda a, b: a / b,
        aliases=("elemwise_div", "divide"))
_binary("broadcast_mod", _mod, aliases=("mod",))
_binary("broadcast_power", torch.pow, aliases=("power",))
_binary("broadcast_maximum", _extremum(torch.maximum), aliases=("maximum",))
_binary("broadcast_minimum", _extremum(torch.minimum), aliases=("minimum",))
_binary("broadcast_hypot", _hypot, scalar=False)
_binary("arctan2", lambda a, b: torch.atan2(_inexact(a), _inexact(b)),
        scalar=False)
_binary("broadcast_equal", _cmp(operator.eq), differentiable=False,
        aliases=("equal",))
_binary("broadcast_not_equal", _cmp(operator.ne), differentiable=False,
        aliases=("not_equal",))
_binary("broadcast_greater", _cmp(operator.gt), differentiable=False,
        aliases=("greater",))
_binary("broadcast_greater_equal", _cmp(operator.ge), differentiable=False,
        aliases=("greater_equal",))
_binary("broadcast_lesser", _cmp(operator.lt), differentiable=False,
        aliases=("lesser",))
_binary("broadcast_lesser_equal", _cmp(operator.le), differentiable=False,
        aliases=("lesser_equal",))
_binary("broadcast_logical_and", _logic(operator.and_), differentiable=False,
        aliases=("logical_and",), scalar=False)
_binary("broadcast_logical_or", _logic(operator.or_), differentiable=False,
        aliases=("logical_or",), scalar=False)
_binary("broadcast_logical_xor", _logic(operator.xor), differentiable=False,
        aliases=("logical_xor",), scalar=False)


@register("where")
def where(cond, x, y):
    return torch.where(cond != 0, x, y)


@register("maximum_n")
def maximum_n(*arrays):
    out = arrays[0]
    for a in arrays[1:]:
        out = torch.maximum(out, a)
    return out


@register("add_n", aliases=("ElementWiseSum", "sum_n"))
def add_n(*arrays):
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------
def _keep_int(x, r):
    """An integer reduction in the reference's dtype: int32 for bool,
    the input's otherwise (torch widens both to int64)."""
    if x.is_floating_point() or x.is_complex():
        return r
    return r.to(_I32 if x.dtype == torch.bool else x.dtype)


def _prod(x, dim, keepdim):
    for a in sorted(dim, reverse=True):
        x = torch.prod(x, dim=a, keepdim=True)
    return x if keepdim else x.squeeze(dim) if dim else x


def _nansum(x, dim, keepdim):
    if not x.is_floating_point():
        return torch.sum(x, dim=dim, keepdim=keepdim)
    return torch.nansum(x, dim=dim, keepdim=keepdim)


def _nanprod(x, dim, keepdim):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, dim, keepdim)


def _reduce(name, f, aliases=()):
    def fn(x, axis=None, keepdims=False, exclude=False):
        axes = _axes(axis, x.ndim)
        if exclude and axis is not None:
            axes = tuple(i for i in range(x.ndim) if i not in axes)
        if not axes:
            return x
        return _keep_int(x, f(x, dim=axes, keepdim=keepdims))

    fn.__name__ = name
    register(name, aliases=aliases)(fn)


_reduce("sum", torch.sum, aliases=("sum_axis",))
_reduce("nansum", _nansum)
_reduce("mean", lambda x, dim, keepdim: torch.mean(_inexact(x), dim=dim,
                                                   keepdim=keepdim))
_reduce("prod", _prod)
_reduce("nanprod", _nanprod)
_reduce("max", torch.amax, aliases=("max_axis",))
_reduce("min", torch.amin, aliases=("min_axis",))


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    axes = _axes(axis, x.ndim)
    if ord == 1:
        return torch.sum(torch.abs(x), dim=axes, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=keepdims))


def _arg(f, x, axis, keepdims):
    if axis is None:
        r = f(x.reshape(-1), dim=0)
        return r.reshape((1,) * x.ndim) if keepdims else r
    return f(x, dim=axis, keepdim=keepdims)


@register("argmax", differentiable=False)
def argmax(x, axis=None, keepdims=False):
    """Index of the first maximum, as float32 (the reference's dtype)."""
    return _arg(torch.argmax, x, axis, keepdims).to(torch.float32)


@register("argmin", differentiable=False)
def argmin(x, axis=None, keepdims=False):
    return _arg(torch.argmin, x, axis, keepdims).to(torch.float32)


@register("argmax_channel", differentiable=False)
def argmax_channel(x):
    return torch.argmax(x, dim=1).to(torch.float32)


@register("moments", nout=2)
def moments(x, axes=None, keepdims=False):
    """Mean and biased variance over ``axes``."""
    dims = _axes(axes, x.ndim)
    mean = torch.mean(x, dim=dims, keepdim=keepdims)
    var = torch.mean(torch.square(x - torch.mean(x, dim=dims, keepdim=True)),
                     dim=dims, keepdim=keepdims)
    return mean, var


# --------------------------------------------------------------------------
# products
# --------------------------------------------------------------------------
@register("dot")
def dot(a, b, transpose_a=False, transpose_b=False):
    """MXNet's dot: the last axis of ``a`` against the first of ``b``,
    after reversing all axes of an operand whose ``transpose_*`` is set."""
    if transpose_a:
        a = a.permute(*reversed(range(a.ndim)))
    if transpose_b:
        b = b.permute(*reversed(range(b.ndim)))
    if a.ndim > 1 or b.ndim > 1:
        return torch.tensordot(a, b, dims=1)
    return torch.dot(a, b)


@register("batch_dot")
def batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register("matmul")
def matmul(a, b):
    return torch.matmul(a, b)


# --------------------------------------------------------------------------
# shape
# --------------------------------------------------------------------------
@register("reshape", aliases=("Reshape",))
def reshape(x, shape=None, reverse=False):
    return x.reshape(shape)


@register("transpose")
def transpose(x, axes=None):
    return x.permute(*(axes or reversed(range(x.ndim))))


@register("flatten", aliases=("Flatten",))
def flatten(x):
    return x.reshape(x.shape[0], -1)


@register("expand_dims")
def expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(_axes(axis, x.ndim))


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(x, dim1=0, dim2=1):
    return x.transpose(dim1, dim2)


def _broadcast(x, shape):
    """``x`` broadcast to ``shape``, materialised: the output is an array
    of its own, which a later in-place write may fill."""
    return x.expand(tuple(shape)).contiguous()


@register("broadcast_to")
def broadcast_to(x, shape=None):
    # 0 keeps the input's size on that axis, as in MXNet
    return _broadcast(x, [s if s != 0 else x.shape[i]
                          for i, s in enumerate(shape)])


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(x, axis=None, size=None):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    sizes = size if isinstance(size, (tuple, list)) else (size,)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return _broadcast(x, tgt)


@register("broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return _broadcast(lhs, rhs.shape)
    tgt = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = rhs.shape[ra]
    return _broadcast(lhs, tgt)


@register("concat", aliases=("Concat",))
def concat(*arrays, dim=1):
    return torch.cat(arrays, dim=dim)


@register("stack")
def stack(*arrays, axis=0):
    return torch.stack(arrays, dim=axis)


@register("split", aliases=("SliceChannel", "slice_channel"),
          nout="dynamic")
def split(x, num_outputs=1, axis=1, squeeze_axis=False):
    n = x.shape[axis]
    if n % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {n} does not divide "
                         f"into {num_outputs} equal parts")
    parts = torch.split(x, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


def _slice_dim(x, axis, b, e, s):
    """``x[b:e:s]`` along ``axis``; a negative step (which torch's slicing
    refuses) runs over the flipped axis."""
    n = x.shape[axis]
    start, stop, step = slice(b, e, s).indices(n)
    lead = (slice(None),) * axis
    if step > 0:
        return x[lead + (slice(start, stop, step),)]
    return x.flip(axis)[lead + (slice(n - 1 - start, n - 1 - stop, -step),)]


# the reference's "crop" alias of slice is overwritten in its table by the
# image family's crop (image_crop), which is not ported yet
@register("slice")
def slice_op(x, begin=None, end=None, step=None):
    step = step or (None,) * len(begin)
    for axis, (b, e, s) in enumerate(zip(begin, end, step)):
        x = _slice_dim(x, axis, b, e, s)
    return x


@register("_slice_key")
def _slice_key(x, key=None):
    """Basic and advanced indexing, recorded (NDArray.__getitem__ under
    autograd)."""
    return x[key]


@register("_scatter_set_key")
def _scatter_set_key(x, v, key=None):
    """``x`` with ``x[key] = v`` written into a copy (NDArray.__setitem__
    under autograd): the gradient reaches the untouched part of ``x`` and
    ``v``.  Repeated advanced indices write in no fixed order on CUDA."""
    out = x.clone()
    out[key] = v.to(x.dtype)
    return out


@register("slice_axis")
def slice_axis(x, axis=0, begin=0, end=None):
    """``x[begin:end]`` along ``axis`` (a view)."""
    axis = axis % x.ndim
    end = x.shape[axis] if end is None else end
    return x.narrow(axis, begin, end - begin)


@register("slice_like")
def slice_like(x, like, axes=None):
    tgt = list(x.shape)
    for a in (axes if axes is not None else range(x.ndim)):
        tgt[a] = like.shape[a]
    return x[tuple(slice(0, t) for t in tgt)]


@register("tile")
def tile(x, reps=None):
    return torch.tile(x, tuple(reps))


@register("repeat")
def repeat(x, repeats=1, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("reverse", aliases=("flip",))
def reverse(x, axis=0):
    return torch.flip(x, _axes(axis, x.ndim))


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register("pad", aliases=("Pad",))
def pad(x, mode="constant", pad_width=None, constant_value=0.0):
    """MXNet's pad: ``pad_width`` is (before, after) for every axis, first
    axis first; edge and reflect pad the trailing (spatial) axes only."""
    if mode not in _PAD_MODES:
        raise MXNetError(f"unknown pad mode {mode}")
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(len(pad_width) // 2)]
    while pairs and pairs[0] == (0, 0):
        pairs.pop(0)
    flat = [p for pair in reversed(pairs) for p in pair]
    if mode == "constant":
        return F.pad(x, flat, value=constant_value)
    return F.pad(x, flat, mode=_PAD_MODES[mode])


@register("depth_to_space")
def depth_to_space(x, block_size=1):
    n, c, h, w = x.shape
    bs = block_size
    y = x.reshape(n, bs, bs, c // (bs * bs), h, w)
    return y.permute(0, 3, 4, 1, 5, 2).reshape(n, c // (bs * bs), h * bs,
                                               w * bs)


@register("space_to_depth")
def space_to_depth(x, block_size=1):
    n, c, h, w = x.shape
    bs = block_size
    y = x.reshape(n, c, h // bs, bs, w // bs, bs)
    return y.permute(0, 3, 5, 1, 2, 4).reshape(n, c * bs * bs, h // bs,
                                               w // bs)


@register("diag")
def diag(x, k=0):
    if x.ndim == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


# --------------------------------------------------------------------------
# indexing
# --------------------------------------------------------------------------
@register("take")
def take(a, indices, axis=0, mode="clip"):
    axis = axis % a.ndim
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("Embedding", aliases=("embedding",))
def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    """Rows of ``weight`` at ``data``, ids cast to integers and clipped
    into [0, input_dim - 1] as the reference does."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


@register("one_hot", differentiable=False)
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    """Rows of ``off_value`` with ``on_value`` at each index; an index out
    of [0, depth) gives a row of ``off_value``, as jax.nn.one_hot."""
    idx = indices.to(torch.int64).unsqueeze(-1)
    oh = (idx == torch.arange(depth, device=indices.device)).to(
        torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("gather_nd")
def gather_nd(data, indices):
    """``data`` at the coordinates of ``indices`` (M, ...) along its first
    M axes.  An index out of range reads the clamped element and passes no
    gradient back, as XLA's gather and its transpose do."""
    idx = [_wrap(i, data.shape[d]) for d, i in enumerate(indices)]
    valid = torch.ones(indices.shape[1:], dtype=torch.bool,
                       device=data.device)
    for d, i in enumerate(idx):
        valid &= (i >= 0) & (i < data.shape[d])
    out = data[tuple(i.clamp(0, data.shape[d] - 1)
                     for d, i in enumerate(idx))]
    valid = valid.reshape(valid.shape + (1,) * (out.ndim - valid.ndim))
    return torch.where(valid, out, out.detach())


@register("scatter_nd", differentiable=False)
def scatter_nd(data, indices, shape=None):
    """Zeros of ``shape`` with ``data`` written at ``indices`` (an index
    out of range writes nothing).  Repeated indices write in no fixed order
    on CUDA."""
    m, shape = indices.shape[0], tuple(shape)
    flat = torch.zeros((math.prod(shape[:m]) + 1,) + shape[m:],
                       dtype=data.dtype, device=data.device)
    lin = torch.zeros(indices.shape[1:], dtype=torch.int64,
                      device=data.device)
    valid = torch.ones_like(lin, dtype=torch.bool)
    for d in range(m):
        i = _wrap(indices[d], shape[d])
        valid &= (i >= 0) & (i < shape[d])
        lin = lin * shape[d] + i
    flat[torch.where(valid, lin, flat.shape[0] - 1)] = data
    return flat[:-1].reshape(shape)


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` gathered along ``axis`` at ``index`` (cast to an integer,
    clipped into range, as the reference does)."""
    axis = axis % data.ndim
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    picked = data.gather(axis, idx.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)


@register("where_index", differentiable=False)
def where_index(x):
    """(nnz, ndim) int32 coordinates of the non-zero elements, row-major,
    on ``x``'s device."""
    return torch.nonzero(x).to(_I32)


@register("boolean_mask", differentiable=False)
def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is non-zero,
    on ``data``'s device."""
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, axis, keep)


@register("sequence_mask", aliases=("SequenceMask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if sequence_length is None or not use_sequence_length:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    if axis == 0:
        mask = steps[:, None] < sequence_length[None, :]
    else:
        mask = steps[None, :] < sequence_length[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return data.masked_fill(~mask, value)


@register("sequence_last", aliases=("SequenceLast",))
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    idx = (sequence_length - 1).reshape((1, -1) + (1,) * (data.ndim - 2))
    return _take_along(data, idx, axis).squeeze(axis)


@register("sequence_reverse", aliases=("SequenceReverse",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sample's first ``sequence_length`` steps reversed along the
    time axis 0; the padding after them stays in place."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    steps = torch.arange(data.shape[axis], device=data.device)
    rev = sequence_length.to(torch.int64)[None, :] - 1 - steps[:, None]
    rev = torch.where(rev >= 0, rev, steps[:, None])
    rev = rev.reshape(rev.shape + (1,) * (data.ndim - 2))
    return _take_along(data, rev, 0)


# --------------------------------------------------------------------------
# creation
# --------------------------------------------------------------------------
@register("zeros", creation=True, differentiable=False)
def zeros(shape=None, dtype="float32", device=None):
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=device)


@register("ones", creation=True, differentiable=False)
def ones(shape=None, dtype="float32", device=None):
    return torch.ones(shape, dtype=torch_dtype(dtype), device=device)


@register("full", creation=True, differentiable=False)
def full(shape=None, val=0.0, dtype="float32", device=None):
    return torch.full(tuple(shape) if not isinstance(shape, int) else
                      (shape,), val, dtype=torch_dtype(dtype), device=device)


@register("arange", creation=True, differentiable=False)
def arange(start=0, stop=None, step=1.0, repeat=1, dtype="float32",
           device=None):
    """``start, start + step, ...`` below ``stop`` (one-argument form: from
    0 below ``start``), each value ``repeat`` times, on ``device`` (the
    frontend's context; a Gluon block passes its input's)."""
    if stop is None:
        start, stop = 0, start
    r = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                     device=device)
    return r.repeat_interleave(repeat) if repeat != 1 else r


def _linspace(start, stop, num, endpoint, dtype, device):
    """jnp.linspace's arithmetic, ``start * (1 - t) + stop * t`` for
    t = i / div with the endpoint appended exactly; ``start`` and ``stop``
    may be 0-d tensors (no host sync)."""
    out_dt = torch_dtype(dtype)
    comp = out_dt if out_dt.is_floating_point else torch.float32
    start = torch.as_tensor(start, dtype=comp, device=device)
    stop = torch.as_tensor(stop, dtype=comp, device=device)
    div = (num - 1) if endpoint else num
    if num > 1:
        t = torch.arange(div, dtype=comp, device=device) / div
        out = start * (1 - t) + stop * t
        if endpoint:
            out = torch.cat([out, stop.reshape(1)])
    else:
        out = start.reshape(1)[:num]
    if not out_dt.is_floating_point:
        out = torch.floor(out)
    return out.to(out_dt)


@register("linspace", creation=True, differentiable=False)
def linspace(start=0, stop=1, num=50, endpoint=True, dtype="float32",
             device=None):
    return _linspace(start, stop, num, endpoint, dtype, device)


@register("eye", creation=True, differentiable=False)
def eye(N=1, M=0, k=0, dtype="float32", device=None):
    n, m = int(N), int(M) if M else int(N)
    rows = torch.arange(n, device=device)[:, None]
    cols = torch.arange(m, device=device)[None, :]
    return (cols - rows == int(k)).to(torch_dtype(dtype))


# --------------------------------------------------------------------------
# ordering
# --------------------------------------------------------------------------
def _sorted(x, axis, is_ascend):
    """Stable ascending sort, flipped for descending: ties come out in the
    reference's order (jnp.sort / argsort, then flip)."""
    v, i = torch.sort(x, dim=axis, stable=True)
    if not is_ascend:
        v, i = torch.flip(v, (axis,)), torch.flip(i, (axis,))
    return v, i


@register("sort")
def sort(x, axis=-1, is_ascend=True):
    return _sorted(x, axis, is_ascend)[0]


@register("argsort", differentiable=False)
def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    return _sorted(x, axis, is_ascend)[1].to(torch_dtype(dtype))


@register("topk", differentiable=False, nout="dynamic")
def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, ties by
    the lower index first, as lax.top_k: a stable descending sort of ``x``
    (of ``-x`` for ascending), cut to ``k``."""
    axis = axis % x.ndim
    keyed = -x if is_ascend else x
    v, i = torch.sort(keyed, dim=axis, descending=True, stable=True)
    v, i = v.narrow(axis, 0, k), i.narrow(axis, 0, k)
    if is_ascend:
        v = -v
    if ret_typ == "indices":
        return i.to(torch_dtype(dtype))
    if ret_typ == "value":
        return v
    if ret_typ == "both":
        return v, i.to(torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(axis, i, 1)
    raise MXNetError(f"topk: unknown ret_typ {ret_typ!r}")


@register("shuffle", differentiable=False)
def shuffle(x):
    """A permutation of ``x`` along axis 0, drawn from the device's
    generator (so ``mx.random.seed`` fixes it)."""
    perm = torch.randperm(x.shape[0], device=x.device,
                          generator=_random.generator(x.device))
    return x[perm]


# --------------------------------------------------------------------------
# linalg (torch.linalg: cuSOLVER / cuBLAS on the card; a dtype the library
# lacks, such as bfloat16, raises rather than running elsewhere)
# --------------------------------------------------------------------------
def _t(a):
    return a.transpose(-1, -2)


@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_potrf")
def linalg_potrf(A):
    return torch.linalg.cholesky(A)


@register("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Solves op(A) X = alpha B (``rightside``: X op(A) = alpha B) for a
    triangular A."""
    a = A
    if transpose:
        a = _t(a)
        lower = not lower
    return torch.linalg.solve_triangular(a, alpha * B, upper=not lower,
                                         left=not rightside)


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0):
    at = _t(A)
    return alpha * (torch.matmul(at, A) if transpose else torch.matmul(A, at))


@register("linalg_det")
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_inverse")
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("linalg_svd", nout=3)
def linalg_svd(A):
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    return u, s, vt


# --------------------------------------------------------------------------
# the rest
# --------------------------------------------------------------------------
@register("histogram", differentiable=False, nout=2)
def histogram(x, bin_cnt=10, range=None):
    """Counts (float32) of ``x`` in ``bin_cnt`` equal bins over ``range``
    (default: the data's min and max, kept on the device) and the bin
    edges; jnp.histogram's binning: right-open bins, the last closed."""
    x = _inexact(x).reshape(-1)
    if range is not None:
        lo = torch.as_tensor(range[0], dtype=x.dtype, device=x.device)
        hi = torch.as_tensor(range[1], dtype=x.dtype, device=x.device)
    else:
        lo, hi = x.min(), x.max()
    flat = hi == lo
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    edges = _linspace(lo, hi, int(bin_cnt) + 1, True, x.dtype, x.device)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], edges.numel() - 1, idx)
    cnt = torch.zeros(edges.numel() + 1, dtype=torch.float32,
                      device=x.device)
    cnt.index_add_(0, idx, torch.ones_like(x, dtype=torch.float32))
    return cnt[1:-1], edges


_NUMPY = {torch.bool: _np.bool_, torch.uint8: _np.uint8, torch.int8: _np.int8,
          torch.int16: _np.int16, torch.int32: _np.int32,
          torch.int64: _np.int64, torch.float16: _np.float16,
          torch.float32: _np.float32, torch.float64: _np.float64}
_TORCH = {_np.dtype(v): k for k, v in _NUMPY.items()}
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


@register("amp_multicast", nout="dynamic")
def amp_multicast(*arrays, num_outputs=None):
    """Every input cast to the widest input dtype by numpy's promotion,
    bfloat16 counted as float32 (so bfloat16 alone comes back as float32);
    a 64-bit result that no input has is narrowed to 32 bits, as the
    reference (64-bit types off) computes it."""
    dts = [torch.float32 if a.dtype == torch.bfloat16 else a.dtype
           for a in arrays]
    widest = _TORCH[_np.result_type(*[_NUMPY[d] for d in dts])]
    if widest in _NARROW and widest not in dts:
        widest = _NARROW[widest]
    return tuple(a.to(widest) for a in arrays)


@register("hard_sigmoid")
def hard_sigmoid(x, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@register("log_sigmoid")
def log_sigmoid(x):
    return F.logsigmoid(x)


@register("unravel_index", differentiable=False)
def unravel_index(x, shape=None):
    """(len(shape), N) int32 coordinates of flat indices ``x``."""
    flat = x.to(torch.int64)
    coords = []
    for s in reversed(tuple(shape)):
        coords.append(torch.remainder(flat, s))
        flat = torch.div(flat, s, rounding_mode="floor")
    return torch.stack(coords[::-1], dim=0).to(_I32)


@register("ravel_multi_index", differentiable=False)
def ravel_multi_index(x, shape=None):
    strides = _np.concatenate([_np.cumprod(shape[::-1])[::-1][1:], [1]])
    s = torch.as_tensor(strides.astype(_np.int32), device=x.device)
    return torch.sum(x * s[:, None], dim=0).to(
        x.dtype if x.is_floating_point() else _I32)


@register("khatri_rao")
def khatri_rao(*mats):
    """Column-wise Kronecker product."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


@register("_contrib_index_copy", aliases=("index_copy",))
def index_copy(old, index, new):
    """``old`` with its rows at ``index`` replaced by ``new``'s (an index
    out of range writes nothing).  Repeated indices write in no fixed
    order on CUDA."""
    n = old.shape[0]
    rows = _wrap(index, n)
    rows = torch.where((rows >= 0) & (rows < n), rows, n)   # n: a spare row
    spare = torch.cat([old, old[:1]])
    return spare.index_copy(0, rows, new.to(old.dtype))[:-1]


@register("_contrib_index_array", aliases=("index_array",),
          differentiable=False)
def index_array(data, axes=None):
    """Each element's int32 N-d index (the reference's int64 becomes int32
    with 64-bit types off)."""
    shape = data.shape
    if axes is None:
        axes = tuple(range(len(shape)))
    elif isinstance(axes, int):
        axes = (axes,)
    grids = torch.meshgrid(*[torch.arange(s, device=data.device)
                             for s in shape], indexing="ij")
    return torch.stack([grids[a] for a in axes], dim=-1).to(_I32)


@register("batch_take")
def batch_take(a, indices):
    """``out[i] = a[i, indices[i]]``."""
    return _take_along(a, indices.reshape(-1, 1), 1)[:, 0]


@register("multi_sum_sq")
def multi_sum_sq(*arrays, num_arrays=None):
    """The float32 sum of squares of each input."""
    return torch.stack([torch.sum(torch.square(a.to(torch.float32)))
                        for a in arrays])


@register("masked_softmax")
def masked_softmax(data, mask=None, axis=-1, temperature=1.0,
                   normalize=True):
    """Softmax over ``axis`` of the elements where ``mask`` is non-zero
    (zero elsewhere; a row with none is all zeros)."""
    z = data / temperature
    if mask is not None:
        z = torch.where(mask != 0, z, -math.inf)
    z = z - torch.amax(torch.where(torch.isneginf(z), -1e30, z), dim=axis,
                       keepdim=True)
    e = torch.exp(z)
    if mask is not None:
        e = torch.where(mask != 0, e, 0.0)
    denom = torch.sum(e, dim=axis, keepdim=True)
    return e / torch.clamp(denom, min=1e-30)


@register("digamma")
def digamma(x):
    return torch.digamma(_inexact(x))
