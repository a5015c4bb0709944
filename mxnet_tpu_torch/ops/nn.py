"""Neural-net operators of the training path (counterpart of
``mxnet_tpu/ops/nn.py``): FullyConnected, Convolution, Pooling, Activation,
softmax, log_softmax, BatchNorm, LayerNorm and Dropout.

None of these is a Pallas kernel in the reference (XLA lowers them), so
their counterparts are library calls: ``F.linear`` / ``F.conv2d`` through
cuBLAS and cuDNN, torch pooling, ``F.batch_norm`` and ``F.layer_norm``.

Channel-last layouts (``NHWC`` ...) keep the reference's tensors: the input
is (N, *spatial, C) and a convolution weight is MXNet's (O, *k, C/group).
``movedim`` turns both into the channels-last strided views of the logical
NCHW / OIHW tensors torch expects, with no copy, and cuDNN runs its NHWC
kernels on them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from .registry import register


def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    return t if len(t) == n else t + t[-1:] * (n - len(t))


def _channel_last(layout):
    return layout is not None and layout.endswith("C")


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(x, weight, *maybe_bias, num_hidden=None, no_bias=False,
                    flatten=True):
    """y = x W^T + b; weight (num_hidden, in_units), as the reference."""
    if flatten:
        x = x.reshape(x.shape[0], -1)
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    return F.linear(x, weight, bias)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=("convolution",))
def convolution(x, weight, *maybe_bias, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                layout=None, cudnn_tune=None, cudnn_off=None, workspace=None):
    nd = x.ndim - 2
    cl = _channel_last(layout)
    if cl:
        x, weight = x.movedim(-1, 1), weight.movedim(-1, 1)
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    y = _CONV[nd](x, weight, bias, _tup(stride, nd),
                  _tup(pad, nd) if pad is not None else 0, _tup(dilate, nd),
                  num_group)
    return y.movedim(1, -1) if cl else y


_POOL = {("max", 1): F.max_pool1d, ("max", 2): F.max_pool2d,
         ("max", 3): F.max_pool3d, ("avg", 1): F.avg_pool1d,
         ("avg", 2): F.avg_pool2d, ("avg", 3): F.avg_pool3d}


@register("Pooling", aliases=("pooling",))
def pooling(x, kernel=None, pool_type="max", stride=None, pad=None,
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, cudnn_off=None, layout=None):
    nd = x.ndim - 2
    cl = _channel_last(layout)
    if global_pool:
        axes = tuple(range(1, x.ndim - 1)) if cl else tuple(range(2, x.ndim))
        if pool_type == "max":
            return x.amax(dim=axes, keepdim=True)
        return x.mean(dim=axes, keepdim=True)
    if pooling_convention != "valid" or pool_type not in ("max", "avg"):
        raise MXNetError(f"Pooling: pool_type={pool_type!r} with "
                         f"pooling_convention={pooling_convention!r} is not "
                         f"ported (max/avg, 'valid' only)")
    if cl:
        x = x.movedim(-1, 1)
    k = _tup(kernel, nd)
    s = _tup(stride if stride is not None else 1, nd)
    p = _tup(pad or 0, nd)
    if pool_type == "max":
        y = _POOL["max", nd](x, k, s, p)
    else:
        y = _POOL["avg", nd](x, k, s, p, count_include_pad=count_include_pad)
    return y.movedim(1, -1) if cl else y


_ACT = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
        "softrelu": F.softplus, "softsign": F.softsign}


@register("Activation", aliases=("activation",))
def activation(x, act_type="relu"):
    if act_type not in _ACT:
        raise MXNetError(f"unknown act_type {act_type}")
    return _ACT[act_type](x)


@register("softmax")
def softmax(x, axis=-1, temperature=None):
    if temperature:
        x = x / temperature
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(x, axis=-1, temperature=None):
    if temperature:
        x = x / temperature
    return torch.log_softmax(x, dim=axis)


@register("BatchNorm", aliases=("batch_norm",), nout=3)
def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
               cudnn_off=None, output_mean_var=False, training=False):
    """Returns (out, new_moving_mean, new_moving_var), as the reference.

    Training mode normalises by the batch mean and the BIASED batch
    variance, and the moving stats follow the reference's convention:
    ``moving * momentum + batch * (1 - momentum)`` with the biased
    variance.  ``F.batch_norm``'s own running update is the opposite
    (``momentum`` weights the batch) and uses the unbiased variance, so it
    is handed zeroed scratch buffers with momentum 1, which leaves the
    batch mean and the unbiased variance in them (accumulated in fp32 for
    any activation dtype); the variance is rescaled by (n - 1) / n and the
    moving stats are updated here.  The normalisation itself runs in the
    library kernel: fp32 arithmetic, one rounding to the activation dtype.
    """
    axis = axis % x.ndim
    xc = x.movedim(axis, 1)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        n = x.numel() // x.shape[axis]
        acc = torch.promote_types(x.dtype, torch.float32)
        mean = torch.zeros(x.shape[axis], dtype=acc, device=x.device)
        var = torch.zeros(x.shape[axis], dtype=acc, device=x.device)
        out = F.batch_norm(xc, mean, var, g, beta, training=True,
                           momentum=1.0, eps=eps)
        var = var * ((n - 1) / n)
        new_mean = moving_mean * momentum + \
            mean.to(moving_mean.dtype) * (1 - momentum)
        new_var = moving_var * momentum + \
            var.to(moving_var.dtype) * (1 - momentum)
    else:
        out = F.batch_norm(xc, moving_mean, moving_var, g, beta,
                           training=False, eps=eps)
        new_mean, new_var = moving_mean, moving_var
    return out.movedim(1, axis), new_mean.detach(), new_var.detach()


@register("LayerNorm", aliases=("layer_norm",))
def layer_norm(x, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalise over ``axis`` by the mean and the BIASED variance, in fp32
    (fp64 for fp64 inputs) whatever the input dtype, then scale, shift and
    round once to the input dtype, as the reference does."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xm = x.movedim(axis, -1).to(acc)
    y = F.layer_norm(xm, (xm.shape[-1],), gamma.to(acc), beta.to(acc), eps)
    return y.to(x.dtype).movedim(-1, axis)


@register("Dropout", aliases=("dropout",))
def dropout(x, p=0.5, mode="training", axes=None, training=False,
            cudnn_off=None):
    """Inverted dropout: ``x * bernoulli(1 - p) / (1 - p)``, the mask
    broadcast over ``axes``; the identity in predict mode (unless
    ``mode="always"``) and at ``p = 0``.  The mask is drawn from the
    device's generator (``mxnet_tpu_torch.random``), so a seed fixes it."""
    if (not training and mode != "always") or p <= 0.0:
        return x
    shape = x.shape
    if axes:
        axes = [a % x.ndim for a in axes]
        shape = tuple(1 if i in axes else n for i, n in enumerate(x.shape))
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=torch.float32, device=x.device)
    mask.bernoulli_(keep, generator=_random.generator(x.device))
    return x * (mask / keep).to(x.dtype)
