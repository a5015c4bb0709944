"""Image operators (counterpart of ``mxnet_tpu/ops/image_ops.py``), on HWC
images and NHWC batches.

``image_resize`` computes what the reference's ``jax.image.resize`` does,
which ``F.interpolate`` does not: for linear and cubic interpolation a
separable weight matrix per resized axis, half-pixel centred, whose kernel
(the triangle, or Keys' cubic with a = -0.5) is widened by the scale when
the axis shrinks (antialiasing), each column normalised to sum 1; for
nearest, the input pixel whose half-pixel-centred cell holds the output
pixel's centre.  The random ops draw their factors from the device's
generator (``mxnet_tpu_torch.random``).
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .. import random as _random
from .numerics import div_scalar
from .registry import register

_EPS32 = float(_np.finfo(_np.float32).eps)


def _hwc_axes(x):
    """(h_axis, w_axis, c_axis) of an HWC image or an NHWC batch."""
    return (0, 1, 2) if x.dim() == 3 else (1, 2, 3)


@register("image_to_tensor", aliases=("to_tensor",))
def image_to_tensor(x):
    """HWC (NHWC) in [0, 255] -> CHW (NCHW) float32 in [0, 1]."""
    y = div_scalar(x.to(torch.float32), 255.0)
    return y.permute(2, 0, 1) if x.dim() == 3 else y.permute(0, 3, 1, 2)


@register("image_normalize")
def image_normalize(x, mean=0.0, std=1.0):
    """(x - mean) / std over CHW (NCHW), per channel for a sequence."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    if mean.dim() == 1:
        mean, std = mean.reshape(-1, 1, 1), std.reshape(-1, 1, 1)
        if x.dim() == 4:
            mean, std = mean[None], std[None]
    return (x - mean) / std


# --------------------------------------------------------------------------
# resize: jax.image.resize's scale-and-translate
# --------------------------------------------------------------------------
def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x):
    """Keys' cubic convolution kernel with a = -0.5 on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(m, n, kernel, device):
    """(m, n) fp32 weights taking an axis of m pixels to n, antialiased
    when n < m."""
    scale = n / m
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    src = torch.arange(m, dtype=torch.float32, device=device)
    w = kernel(div_scalar(torch.abs(sample_f[None, :] - src[:, None]),
                          kernel_scale))
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(m, n, device):
    offsets = div_scalar((torch.arange(n, dtype=torch.float32,
                                       device=device) + 0.5) * m, n)
    return torch.floor(offsets).to(torch.int64)


def resize_axes(x, out_sizes, method):
    """``x`` (float) resized along each axis ``a`` of ``out_sizes`` (a dict
    axis -> size) by ``method`` ("nearest", "bilinear" or "bicubic"), as
    ``jax.image.resize`` does with its defaults."""
    for axis, n in out_sizes.items():
        m = x.shape[axis]
        if m == n:
            continue
        if method == "nearest":
            x = torch.index_select(x, axis,
                                   _nearest_index(m, n, x.device))
            continue
        kernel = _keys_cubic if method == "bicubic" else _triangle
        w = _resize_weights(m, n, kernel, x.device).to(x.dtype)
        x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)
    return x


@register("image_resize", aliases=("resize",))
def image_resize(x, size=None, keep_ratio=False, interp=1):
    """Resize HWC / NHWC to ``size`` = (w, h) (an int: square); ``interp``
    0 nearest, 1 bilinear, 2 bicubic.  ``keep_ratio`` is not read, as in
    the reference."""
    if isinstance(size, int):
        size = (size, size)
    w, h = size
    method = {0: "nearest", 1: "bilinear", 2: "bicubic"}.get(interp,
                                                             "bilinear")
    h_ax, w_ax, _ = _hwc_axes(x)
    y = resize_axes(x.to(torch.float32), {h_ax: h, w_ax: w}, method)
    return y.to(x.dtype)


@register("image_crop", aliases=("crop",))
def image_crop(x, x0=0, y0=0, width=None, height=None):
    """The (height, width) region at (y0, x0) of HWC / NHWC."""
    if x.dim() == 3:
        return x[y0:y0 + height, x0:x0 + width, :]
    return x[:, y0:y0 + height, x0:x0 + width, :]


@register("image_flip_left_right", aliases=("flip_left_right",))
def image_flip_left_right(x):
    return torch.flip(x, (_hwc_axes(x)[1],))


@register("image_flip_top_bottom", aliases=("flip_top_bottom",))
def image_flip_top_bottom(x):
    return torch.flip(x, (_hwc_axes(x)[0],))


def _coin(x):
    """A fair coin, drawn on ``x``'s device."""
    return torch.rand((), generator=_random.generator(x.device),
                      device=x.device) < 0.5


def _factor(x, lo, hi):
    """A factor uniform on [lo, hi), drawn on ``x``'s device (lo when
    lo == hi)."""
    u = torch.rand((), generator=_random.generator(x.device),
                   dtype=torch.float32, device=x.device)
    return u * (hi - lo) + lo


@register("image_random_flip_left_right",
          aliases=("random_flip_left_right",))
def image_random_flip_left_right(x):
    return torch.where(_coin(x), image_flip_left_right(x), x)


@register("image_random_flip_top_bottom",
          aliases=("random_flip_top_bottom",))
def image_random_flip_top_bottom(x):
    return torch.where(_coin(x), image_flip_top_bottom(x), x)


def _blend(a, b, alpha):
    return a * alpha + b * (1.0 - alpha)


def _grayscale(x, c_ax):
    shape = [1] * x.dim()
    shape[c_ax] = 3
    weights = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                           device=x.device).reshape(shape)
    return torch.sum(x * weights, dim=c_ax, keepdim=True).expand(x.shape)


@register("image_random_brightness", aliases=("random_brightness",))
def image_random_brightness(x, min_factor=1.0, max_factor=1.0):
    return x * _factor(x, min_factor, max_factor)


@register("image_random_contrast", aliases=("random_contrast",))
def image_random_contrast(x, min_factor=1.0, max_factor=1.0):
    """Blend with the image's mean, as the reference does."""
    alpha = _factor(x, min_factor, max_factor)
    return _blend(x, torch.mean(x).expand(x.shape), alpha)


@register("image_random_saturation", aliases=("random_saturation",))
def image_random_saturation(x, min_factor=1.0, max_factor=1.0):
    alpha = _factor(x, min_factor, max_factor)
    return _blend(x, _grayscale(x, _hwc_axes(x)[2]), alpha)


_T_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.321),
          (0.211, -0.523, 0.311))
_T_RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.107, 1.705))


@register("image_random_hue", aliases=("random_hue",))
def image_random_hue(x, min_factor=1.0, max_factor=1.0):
    """Hue jitter as the reference computes it: the chroma plane of YIQ
    rotated by alpha * pi, back to RGB."""
    alpha = _factor(x, min_factor, max_factor)
    u, w = torch.cos(alpha * math.pi), torch.sin(alpha * math.pi)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, u, -w]),
                       torch.stack([zero, w, u])])
    t_yiq = torch.tensor(_T_YIQ, dtype=torch.float32, device=x.device)
    t_rgb = torch.tensor(_T_RGB, dtype=torch.float32, device=x.device)
    m = t_rgb @ rot @ t_yiq
    c_ax = _hwc_axes(x)[2]
    return (x.movedim(c_ax, -1) @ m.T.to(x.dtype)).movedim(-1, c_ax)


_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009), (-0.5808, -0.0045, -0.814),
           (-0.5836, -0.6948, 0.4203))


@register("image_random_lighting", aliases=("random_lighting",))
def image_random_lighting(x, alpha_std=0.05):
    """AlexNet's PCA lighting noise."""
    alpha = torch.randn(3, generator=_random.generator(x.device),
                        dtype=torch.float32, device=x.device) * alpha_std
    eigval = torch.tensor(_EIGVAL, dtype=torch.float32, device=x.device)
    eigvec = torch.tensor(_EIGVEC, dtype=torch.float32, device=x.device)
    delta = eigvec @ (alpha * eigval)
    shape = [1] * x.dim()
    shape[_hwc_axes(x)[2]] = 3
    return x + delta.reshape(shape)


@register("image_random_color_jitter", aliases=("random_color_jitter",))
def image_random_color_jitter(x, brightness=0.0, contrast=0.0,
                              saturation=0.0, hue=0.0):
    """Brightness, contrast, saturation, then hue, each jittered by its
    own draw where its amount is > 0."""
    if brightness > 0:
        x = image_random_brightness(x, 1 - brightness, 1 + brightness)
    if contrast > 0:
        x = image_random_contrast(x, 1 - contrast, 1 + contrast)
    if saturation > 0:
        x = image_random_saturation(x, 1 - saturation, 1 + saturation)
    if hue > 0:
        x = image_random_hue(x, -hue, hue)
    return x
