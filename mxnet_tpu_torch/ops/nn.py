"""Neural-net operator family (counterpart of ``mxnet_tpu/ops/nn.py``):
FullyConnected, Convolution and Deconvolution, Pooling, UpSampling and
BilinearResize2D, Activation and LeakyReLU, the softmax family, the
normalisations (Batch, Layer, Group, Instance, L2, LRN), Dropout, the loss
layers (SoftmaxOutput, MakeLoss, the regression outputs, CTCLoss), the
fused RNN and the spatial transformer ops.

None of these is a Pallas kernel in the reference (XLA lowers them), so
their counterparts are plain PyTorch and library calls: ``F.linear`` /
``F.conv2d`` / ``F.conv_transpose2d`` through cuBLAS and cuDNN, torch
pooling and resizing, ``F.batch_norm``, ``F.layer_norm`` and
``F.ctc_loss``.  The loss layers pin their gradients with
``torch.autograd.Function``.

Channel-last layouts (``NHWC`` ...) keep the reference's tensors: the input
is (N, *spatial, C) and a convolution weight is MXNet's (O, *k, C/group).
``movedim`` turns both into the channels-last strided views of the logical
NCHW / OIHW tensors torch expects, with no copy, and cuDNN runs its NHWC
kernels on them.
"""
from __future__ import annotations

import threading

import math

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
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"Pooling: unknown pool_type {pool_type!r}")
    if cl:
        x = x.movedim(-1, 1)
    k = _tup(kernel, nd)
    s = _tup(stride if stride is not None else 1, nd)
    p = _tup(pad or 0, nd)
    if pooling_convention == "valid" and pool_type == "max":
        y = _POOL["max", nd](x, k, s, p)
    elif pooling_convention == "valid" and pool_type == "avg":
        y = _POOL["avg", nd](x, k, s, p, count_include_pad=count_include_pad)
    else:
        y = _padded_pooling(x, k, s, p, pool_type, pooling_convention,
                            count_include_pad)
    return y.movedim(1, -1) if cl else y


def _window_sum(x, k, s):
    """Sums over the pooling windows of channels-first ``x`` (no
    padding)."""
    if len(k) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + k, (1,) + s,
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
    return pool(x, k, s, divisor_override=1)


def _padded_pooling(x, k, s, p, pool_type, convention, count_include_pad):
    """Pooling over explicitly padded ``x``, as the reference's
    reduce_window: the "full" (ceil-mode) convention extends each axis's
    high-side padding until the windows cover it; max pads with -inf, the
    sums with 0; "avg" divides by the window size (``count_include_pad``,
    the extra padding counted too) or by the real elements in the window;
    "lp" is the window's L2 norm."""
    pads = [[pp, pp] for pp in p]
    if convention == "full":
        for i, pp in enumerate(pads):
            rem = (x.shape[2 + i] + 2 * p[i] - k[i]) % s[i]
            if rem:
                pp[1] += s[i] - rem
    flat = [v for pp in reversed(pads) for v in pp]
    if pool_type == "max":
        return _POOL["max", len(k)](F.pad(x, flat, value=float("-inf")),
                                    k, s)
    if pool_type == "lp":
        return torch.sqrt(_window_sum(F.pad(torch.abs(x) ** 2, flat), k, s))
    y = _window_sum(F.pad(x, flat), k, s)
    if pool_type == "sum":
        return y
    if count_include_pad:
        denom = 1.0
        for kk in k:
            denom *= kk
        return y / denom
    return y / _window_sum(F.pad(torch.ones_like(x), flat), k, s)


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
    reduce_stats = getattr(BATCH_STATS, "reduce", None)
    if training and not use_global_stats and reduce_stats is not None:
        return _batch_norm_global(x, g, beta, moving_mean, moving_var, eps,
                                  momentum, axis, reduce_stats,
                                  BATCH_STATS.world)
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


# Set by ``TrainStep(mesh=)`` around its forward and backward: ``reduce``
# sums a tensor over the data-parallel processes (differentiably) and
# ``world`` counts them, so training-mode BatchNorm normalises by the
# moments of the GLOBAL batch, as the reference's sharded jit does.
BATCH_STATS = threading.local()


def _batch_norm_global(x, g, beta, moving_mean, moving_var, eps, momentum,
                       axis, reduce_stats, world):
    """Training-mode BatchNorm over the global batch: the mean, then the
    biased variance about it, each one sum over the processes (the sums'
    gradients flow back to every process, as GSPMD's collectives do)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    axes = tuple(i for i in range(x.ndim) if i != axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    count = (x.numel() // x.shape[axis]) * world
    xf = x.to(acc)
    mean = reduce_stats(xf.sum(dim=axes)) / count
    d = xf - mean.reshape(shape)
    var = reduce_stats((d * d).sum(dim=axes)) / count
    scale = g.to(acc) * torch.rsqrt(var + eps)
    out = (d * scale.reshape(shape) + beta.to(acc).reshape(shape)).to(x.dtype)
    new_mean = moving_mean * momentum + \
        mean.detach().to(moving_mean.dtype) * (1 - momentum)
    new_var = moving_var * momentum + \
        var.detach().to(moving_var.dtype) * (1 - momentum)
    return out, new_mean.detach(), new_var.detach()


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


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution", aliases=("deconvolution",))
def deconvolution(x, weight, *maybe_bias, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=True, layout=None, target_shape=None,
                  workspace=None, cudnn_tune=None, cudnn_off=None):
    """Transposed convolution, the gradient of Convolution with respect to
    its input.  The weight is MXNet's (in, out/group, *k), channel-last
    (in, *k, out/group): torch's own layout, so cuDNN runs it directly.
    ``target_shape`` is not read, as in the reference."""
    nd = x.ndim - 2
    cl = _channel_last(layout)
    if cl:
        x, weight = x.movedim(-1, 1), weight.movedim(-1, 1)
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    y = _DECONV[nd](x, weight, bias, stride=_tup(stride, nd),
                    padding=_tup(pad, nd) if pad is not None else 0,
                    output_padding=_tup(adj, nd) if adj is not None else 0,
                    groups=num_group, dilation=_tup(dilate, nd))
    return y.movedim(1, -1) if cl else y


def _resize_bilinear(x, th, tw):
    """jax.image.resize's bilinear: half-pixel centres, and a triangle
    kernel widened by the scale where an axis shrinks (antialias)."""
    shrink = th < x.shape[2] or tw < x.shape[3]
    return F.interpolate(x, size=(th, tw), mode="bilinear",
                         align_corners=False, antialias=shrink)


@register("UpSampling", aliases=("upsampling",))
def upsampling(x, *weights, scale=2, sample_type="nearest", num_filter=0,
               multi_input_mode=None, num_args=1, workspace=None):
    """Nearest (each pixel repeated ``scale`` x ``scale`` times) or
    bilinear resize by ``scale``; extra inputs are not read, as in the
    reference."""
    if sample_type == "nearest":
        return F.interpolate(x, scale_factor=scale, mode="nearest")
    n, c, h, w = x.shape
    return _resize_bilinear(x, h * scale, w * scale)


@register("BilinearResize2D", aliases=("bilinear_resize2d",))
def bilinear_resize2d(x, height=None, width=None, scale_height=None,
                      scale_width=None, mode="size"):
    n, c, h, w = x.shape
    th = height if height else int(h * scale_height)
    tw = width if width else int(w * scale_width)
    return _resize_bilinear(x, th, tw)


@register("LeakyReLU", aliases=("leaky_relu",))
def leaky_relu(x, *maybe_gamma, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """leaky, prelu (learned ``gamma``, one per channel of axis 1), elu,
    selu, gelu and rrelu (its mean slope: the reference's deterministic
    form, in training too)."""
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        gamma = maybe_gamma[0]
        if x.ndim > 1 and gamma.ndim == 1:
            gamma = gamma.reshape((1, -1) + (1,) * (x.ndim - 2))
        return torch.where(x > 0, x, gamma * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * (torch.exp(x) - 1))
    if act_type == "selu":
        return F.selu(x)
    if act_type == "gelu":
        return F.gelu(x)
    if act_type == "rrelu":
        return torch.where(x > 0, x, (lower_bound + upper_bound) / 2 * x)
    raise MXNetError(f"unknown act_type {act_type}")


@register("softmin")
def softmin(x, axis=-1):
    return torch.softmax(-x, dim=axis)


@register("smooth_l1")
def smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       torch.abs(x) - 0.5 / s2)


def _normalize(x, dims, eps):
    mean = torch.mean(x, dim=dims, keepdim=True)
    var = torch.var(x, dim=dims, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


@register("GroupNorm", aliases=("group_norm",))
def group_norm(x, gamma, beta, num_groups=1, eps=1e-5,
               output_mean_var=False):
    """Normalise each group of channels of each sample by its mean and
    biased variance, then scale and shift per channel."""
    n, c = x.shape[:2]
    rest = x.shape[2:]
    xg = x.reshape((n, num_groups, c // num_groups) + rest)
    xh = _normalize(xg, tuple(range(2, xg.ndim)), eps).reshape(x.shape)
    shape = (1, c) + (1,) * len(rest)
    return xh * gamma.reshape(shape) + beta.reshape(shape)


@register("InstanceNorm", aliases=("instance_norm",))
def instance_norm(x, gamma, beta, eps=1e-3):
    xh = _normalize(x, tuple(range(2, x.ndim)), eps)
    shape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    return xh * gamma.reshape(shape) + beta.reshape(shape)


@register("L2Normalization", aliases=("l2_normalization",))
def l2_normalization(x, eps=1e-10, mode="instance"):
    if mode == "instance":
        dims = tuple(range(1, x.ndim))
    elif mode == "channel":
        dims = (1,)
    else:   # spatial
        dims = tuple(range(2, x.ndim))
    return x / torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=True)
                          + eps)


@register("LRN", aliases=("lrn",))
def lrn(x, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalisation across channels of NCHW:
    x / (knorm + alpha / nsize * sum of squares over nsize channels)^beta."""
    half = nsize // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = sq[:, 0:x.shape[1]]
    for i in range(1, nsize):
        acc = acc + sq[:, i:i + x.shape[1]]
    return x / torch.pow(knorm + alpha * acc / nsize, beta)


# --------------------------------------------------------------------------
# loss layers: the forward is the prediction; the backward ignores the
# incoming gradient and returns the loss's gradient, as MXNet's output
# layers do (torch.autograd.Function pins it)
# --------------------------------------------------------------------------
def _label_one_hot(label, n):
    """One-hot rows of ``label`` cast to integers; a label outside [0, n)
    (the ignore label) gives a row of zeros."""
    idx = label.to(torch.int64).unsqueeze(-1)
    return idx == torch.arange(n, device=label.device)


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization):
        p = torch.softmax(data, dim=-1)
        ctx.save_for_backward(p, label)
        ctx.cfg = (grad_scale, ignore_label, use_ignore, normalization)
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization = ctx.cfg
        grad = p - _label_one_hot(label, p.shape[-1]).to(p.dtype)
        if use_ignore:
            keep = label != ignore_label
            grad = grad * keep.to(p.dtype)[..., None]
        if normalization == "batch":
            grad = grad / p.shape[0]
        elif normalization == "valid" and use_ignore:
            grad = grad / torch.clamp(keep.sum(), min=1).to(p.dtype)
        return grad * grad_scale, None, None, None, None, None


@register("SoftmaxOutput", aliases=("softmax_output", "SoftmaxActivation"))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1,
                   use_ignore=False, multi_output=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    """Softmax over the last axis; its gradient is (p - onehot(label)) *
    grad_scale, with ``use_ignore`` zeroing the rows of ``ignore_label``
    and ``normalization`` "batch" (divide by the batch) or "valid" (by the
    rows not ignored, with ``use_ignore``)."""
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label,
                                use_ignore, normalization)


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grad_scale, normalization):
        ctx.cfg = (x.shape, x.dtype, grad_scale, normalization)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, grad_scale, normalization = ctx.cfg
        grad = torch.full(shape, grad_scale, dtype=dtype, device=g.device)
        if normalization == "batch":
            grad = grad / shape[0]
        return grad, None, None


@register("MakeLoss", aliases=("make_loss",))
def make_loss(x, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """The identity, whose gradient is ``grad_scale`` (over the batch with
    ``normalization="batch"``); ``valid_thresh`` is not read, as in the
    reference."""
    return _MakeLoss.apply(x, grad_scale, normalization)


class _RegressionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.cfg = (kind, grad_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        kind, grad_scale = ctx.cfg
        diff = out - label.reshape(out.shape)
        if kind == "linear":
            grad = diff * grad_scale / out.shape[0]
        elif kind == "mae":
            grad = torch.sign(diff) * grad_scale
        else:
            grad = diff * grad_scale
        return grad, None, None, None


@register("LinearRegressionOutput", aliases=("linear_regression_output",))
def linear_regression_output(data, label, grad_scale=1.0):
    """The identity; gradient (data - label) * grad_scale / batch."""
    return _RegressionOutput.apply(data, label, "linear", grad_scale)


@register("LogisticRegressionOutput",
          aliases=("logistic_regression_output",))
def logistic_regression_output(data, label, grad_scale=1.0):
    """sigmoid(data); gradient (sigmoid(data) - label) * grad_scale."""
    return _RegressionOutput.apply(data, label, "logistic", grad_scale)


@register("MAERegressionOutput", aliases=("mae_regression_output",))
def mae_regression_output(data, label, grad_scale=1.0):
    """The identity; gradient sign(data - label) * grad_scale."""
    return _RegressionOutput.apply(data, label, "mae", grad_scale)


@register("CTCLoss", aliases=("ctc_loss",))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Connectionist temporal classification loss per sequence.  ``data``
    is (T, batch, alphabet) logits, the blank is class 0; without
    ``label_lengths`` a label <= 0 is padding after the sequence.  As in
    the reference, ``blank_label`` is not read."""
    seq, batch, _ = data.shape
    labels = label.to(torch.int64)
    if use_data_lengths and data_lengths is not None:
        in_len = data_lengths.to(torch.int64)
    else:
        in_len = torch.full((batch,), seq, dtype=torch.int64,
                            device=data.device)
    if use_label_lengths and label_lengths is not None:
        tgt_len = label_lengths.to(torch.int64)
    else:
        tgt_len = (labels > 0).sum(dim=1)
    return F.ctc_loss(torch.log_softmax(data, dim=-1), labels.clamp(min=0),
                      in_len, tgt_len, blank=0, reduction="none")


# --------------------------------------------------------------------------
# the fused RNN: TNC data, the flat parameter vector of the reference's
# layout; each layer and direction is a step loop whose input product is
# taken out of the loop as one (T*N, ni) x (ni, G*nh) matmul
# --------------------------------------------------------------------------
_RNN_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


def _rnn_param_layout(mode, input_size, state_size, num_layers, ndir):
    """(kind, shape) in the flat layout: all weights layer-major (i2h then
    h2h per direction), then all biases; gate blocks in the order i, f, g,
    o (lstm) and r, z, n (gru)."""
    g = _RNN_GATES[mode]
    nh = state_size
    shapes = []
    for layer in range(num_layers):
        ni = input_size if layer == 0 else nh * ndir
        for _ in range(ndir):
            shapes.append(("i2h_weight", (g * nh, ni)))
            shapes.append(("h2h_weight", (g * nh, nh)))
    for layer in range(num_layers):
        for _ in range(ndir):
            shapes.append(("i2h_bias", (g * nh,)))
            shapes.append(("h2h_bias", (g * nh,)))
    return shapes


def rnn_param_size(mode, input_size, state_size, num_layers=1,
                   bidirectional=False):
    """Length of the flat parameter vector."""
    ndir = 2 if bidirectional else 1
    return sum(math.prod(s) for _, s in _rnn_param_layout(
        mode, input_size, state_size, num_layers, ndir))


def _rnn_cell(mode, i2h_t, h, c, wh, bh, clip):
    """One step: (new h, new c or None)."""
    if mode == "lstm":
        gates = i2h_t + F.linear(h, wh, bh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        # the cell state is clipped every step, as the reference does
        if clip[2]:
            c = torch.nan_to_num(c, nan=0.0)
        if clip[0] is not None or clip[1] is not None:
            c = torch.clamp(c, clip[0], clip[1])
        return torch.sigmoid(o) * torch.tanh(c), c
    if mode == "gru":
        ir, iz, in_ = i2h_t.chunk(3, dim=-1)
        hr, hz, hn = F.linear(h, wh, bh).chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * hn)
        return (1 - z) * n + z * h, None
    pre = i2h_t + F.linear(h, wh, bh)
    return (torch.relu(pre) if mode == "rnn_relu" else torch.tanh(pre)), None


def _rnn_direction(mode, xs, h, c, wi, wh, bi, bh, clip, seq_len):
    """xs (T, N, ni) -> (hs (T, N, nh), final h, final c or None).  With
    ``seq_len``, a step at t >= seq_len[n] neither advances sample n's
    state nor emits output (zeros)."""
    i2h = F.linear(xs, wi, bi)
    hs = []
    for t in range(xs.shape[0]):
        h_new, c_new = _rnn_cell(mode, i2h[t], h, c, wh, bh, clip)
        if seq_len is None:
            h, c = h_new, c_new
            hs.append(h_new)
            continue
        m = (t < seq_len).to(xs.dtype)[:, None]
        h = m * h_new + (1 - m) * h
        if c_new is not None:
            c = m * c_new + (1 - m) * c
        hs.append(h_new * m)
    return torch.stack(hs), h, (c if mode == "lstm" else None)


@register("RNN", aliases=("rnn",), nout="dynamic")
def fused_rnn(data, parameters, *maybe_states, state_size=None,
              num_layers=1, mode="lstm", bidirectional=False, p=0.0,
              state_outputs=False, training=False, projection_size=None,
              lstm_state_clip_min=None, lstm_state_clip_max=None,
              lstm_state_clip_nan=False, use_sequence_length=False):
    """MXNet's fused RNN: ``data`` (T, N, C), ``parameters`` the flat
    vector (``rnn_param_size``), then optional initial state (layers *
    directions, N, state_size), the LSTM's cell state, and with
    ``use_sequence_length`` a last input of lengths (N,), over whose valid
    prefix the reverse direction runs.  Returns the output (T, N,
    directions * state_size), and with ``state_outputs`` the final h (and
    c).  Dropout ``p`` applies between layers while ``training``, drawn
    from the device's generator."""
    if projection_size:
        raise MXNetError("RNN projection_size is not supported")
    from .tensor import sequence_reverse

    T, N, C = data.shape
    nh, nl = int(state_size), int(num_layers)
    ndir = 2 if bidirectional else 1
    pieces, off = [], 0
    for _, shp in _rnn_param_layout(mode, C, nh, nl, ndir):
        n = math.prod(shp)
        pieces.append(parameters[off:off + n].reshape(shp))
        off += n
    if off != parameters.shape[0]:
        raise MXNetError(
            f"RNN: parameter vector has {parameters.shape[0]} elements, "
            f"layout needs {off} (mode={mode}, input={C}, hidden={nh}, "
            f"layers={nl}, dirs={ndir})")
    n_w = 2 * nl * ndir
    weights, biases = pieces[:n_w], pieces[n_w:]
    states = list(maybe_states)
    seq_len = None
    if use_sequence_length:
        if not states:
            raise MXNetError("RNN use_sequence_length=True requires a "
                             "sequence_length input")
        seq_len = states.pop().to(torch.int32)
    zeros = torch.zeros((nl * ndir, N, nh), dtype=data.dtype,
                        device=data.device)
    h_all = states[0] if states else zeros
    c_all = states[1] if mode == "lstm" and len(states) > 1 else zeros
    clip = (lstm_state_clip_min, lstm_state_clip_max, lstm_state_clip_nan)

    def rev(x):
        if seq_len is None:
            return torch.flip(x, (0,))
        return sequence_reverse(x, seq_len, use_sequence_length=True)

    out, out_h, out_c = data, [], []
    for layer in range(nl):
        layer_outs = []
        for d in range(ndir):
            idx = layer * ndir + d
            hs, hf, cf = _rnn_direction(
                mode, out if d == 0 else rev(out), h_all[idx], c_all[idx],
                weights[2 * idx], weights[2 * idx + 1], biases[2 * idx],
                biases[2 * idx + 1], clip, seq_len)
            layer_outs.append(hs if d == 0 else rev(hs))
            out_h.append(hf)
            if cf is not None:
                out_c.append(cf)
        out = layer_outs[0] if ndir == 1 else torch.cat(layer_outs, dim=-1)
        if p > 0 and training and layer < nl - 1:
            keep = 1.0 - p
            mask = torch.empty(out.shape, dtype=torch.float32,
                               device=out.device)
            mask.bernoulli_(keep, generator=_random.generator(out.device))
            out = out * (mask / keep).to(out.dtype)
    if not state_outputs:
        return out
    outs = (out, torch.stack(out_h))
    if mode == "lstm":
        outs = outs + (torch.stack(out_c),)
    return outs


# --------------------------------------------------------------------------
# the spatial transformer family: the sampling grid is elementwise, the
# sampling a gather and a lerp, zero outside the input
# --------------------------------------------------------------------------
@register("GridGenerator", aliases=("grid_generator",))
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: ``data`` (N, 6) -> the sampling grid (N, 2, H, W) in
    [-1, 1], x then y; warp: a flow field (N, 2, H, W) -> the normalised
    grid."""
    from .tensor import _linspace

    if transform_type == "affine":
        h, w = int(target_shape[0]), int(target_shape[1])
        theta = data.reshape(-1, 2, 3)
        ys = _linspace(-1.0, 1.0, h, True, data.dtype, data.device)
        xs = _linspace(-1.0, 1.0, w, True, data.dtype, data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
        return torch.matmul(theta, base).reshape(-1, 2, h, w)
    if transform_type == "warp":
        n, _, h, w = data.shape
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=data.dtype, device=data.device),
            torch.arange(w, dtype=data.dtype, device=data.device),
            indexing="ij")
        x = (data[:, 0] + gx) * (2.0 / max(w - 1, 1)) - 1.0
        y = (data[:, 1] + gy) * (2.0 / max(h - 1, 1)) - 1.0
        return torch.stack([x, y], dim=1)
    raise MXNetError(f"unknown transform_type {transform_type}")


def _bilinear_sample(data, grid):
    """data (N, C, H, W), grid (N, 2, h, w) in [-1, 1] (x = -1 the first
    column's centre, 1 the last's) -> (N, C, h, w); a corner outside the
    input contributes zero."""
    n, c, H, W = data.shape
    x = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    y = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    batch = torch.arange(n, device=data.device)[:, None, None]

    def corner(yi, xi):
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.clamp(0, W - 1).to(torch.int64)
        yc = yi.clamp(0, H - 1).to(torch.int64)
        v = data[batch, :, yc, xc].movedim(-1, 1)      # (n, c, h, w)
        return v * inside[:, None].to(data.dtype)

    return (corner(y0, x0) * (1 - wx) * (1 - wy)
            + corner(y0, x0 + 1) * wx * (1 - wy)
            + corner(y0 + 1, x0) * (1 - wx) * wy
            + corner(y0 + 1, x0 + 1) * wx * wy)


@register("BilinearSampler", aliases=("bilinear_sampler",))
def bilinear_sampler(data, grid, cudnn_off=None):
    return _bilinear_sample(data, grid)


@register("SpatialTransformer", aliases=("spatial_transformer",))
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=None):
    """Affine grid from ``loc`` (N, 6), then bilinear sampling."""
    if transform_type != "affine":
        raise MXNetError("SpatialTransformer supports transform_type="
                         "'affine' only; build warp grids with "
                         "GridGenerator + BilinearSampler")
    if sampler_type != "bilinear":
        raise MXNetError("SpatialTransformer supports sampler_type="
                         "'bilinear' only")
    return _bilinear_sample(data, grid_generator(
        loc, transform_type="affine", target_shape=target_shape))
