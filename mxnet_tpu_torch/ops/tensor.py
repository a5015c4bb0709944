"""Tensor operators of the training path (counterpart of
``mxnet_tpu/ops/tensor.py``): elementwise arithmetic and comparisons with
broadcasting and scalar forms, the unary math of the NDArray dunders and
the losses, sum / mean, reshape / flatten / transpose, ``pick``, creation
and ``cast``.  Each is plain PyTorch; autograd supplies the gradients.
"""
from __future__ import annotations

import operator

import torch

from ..base import torch_dtype
from .registry import register


def _unary(name, f, differentiable=True, aliases=()):
    def fn(x):
        return f(x)

    fn.__name__ = name
    register(name, differentiable=differentiable, aliases=aliases)(fn)


_unary("negative", lambda x: -x)
_unary("abs", torch.abs)
_unary("square", torch.square)
_unary("zeros_like", torch.zeros_like, differentiable=False)


@register("cast", aliases=("Cast", "amp_cast"))
def cast(x, dtype="float32"):
    return x.to(torch_dtype(dtype))


# --------------------------------------------------------------------------
# elementwise binary, broadcasting (elemwise_* and broadcast_* share one
# implementation, as torch broadcasts natively), and their scalar forms
# --------------------------------------------------------------------------
def _binary(name, f, differentiable=True, aliases=()):
    def fn(a, b):
        return f(a, b)

    fn.__name__ = name
    register(name, differentiable=differentiable, aliases=aliases)(fn)

    def scalar_fn(a, scalar=0.0, reverse=False):
        return f(scalar, a) if reverse else f(a, scalar)

    scalar_fn.__name__ = name + "_scalar"
    register(name + "_scalar", differentiable=differentiable)(scalar_fn)


def _cmp(f):
    return lambda a, b: f(a, b).to(torch.float32)


def _mod(a, b):
    """Python-style modulo (the sign of b), as jnp.mod; a scalar ``a`` is
    spelled out, as torch has no gradient for remainder(scalar, tensor)."""
    if isinstance(a, torch.Tensor):
        return torch.remainder(a, b)
    return a - torch.floor(a / b) * b


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


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------
def _reduce(name, f):
    def fn(x, axis=None, keepdims=False, exclude=False):
        if axis is None:
            axes = tuple(range(x.ndim))
        else:
            axes = (axis,) if isinstance(axis, int) else tuple(axis)
            axes = tuple(a % x.ndim for a in axes)
            if exclude:
                axes = tuple(i for i in range(x.ndim) if i not in axes)
        if not axes:
            return x
        return f(x, dim=axes, keepdim=keepdims)

    fn.__name__ = name
    register(name, aliases=(name + "_axis",) if name == "sum" else ())(fn)


_reduce("sum", torch.sum)
_reduce("mean", torch.mean)


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


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` gathered along ``axis`` at ``index`` (cast to an integer,
    clipped into range, as the reference does)."""
    axis = axis % data.ndim
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    picked = data.gather(axis, idx.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)


# --------------------------------------------------------------------------
# creation
# --------------------------------------------------------------------------
@register("zeros", creation=True, differentiable=False)
def zeros(shape=None, dtype="float32", device=None):
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=device)


@register("ones", creation=True, differentiable=False)
def ones(shape=None, dtype="float32", device=None):
    return torch.ones(shape, dtype=torch_dtype(dtype), device=device)
