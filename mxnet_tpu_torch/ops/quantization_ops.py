"""INT8 quantization operators (counterpart of
``mxnet_tpu/ops/quantization_ops.py``): symmetric int8 (scale =
max(|min|, |max|) / 127, round half to even, clip to +-127) and the
int8 x int8 -> int32 products of the quantized dense and convolution.

The int32 accumulator must equal the reference's exactly.  ``torch.matmul``
has no int8 path on CUDA, and an fp32 product rounds once a sum passes
2^24 (and TF32 far sooner), so the products run where they are exact:
``torch._int_mm`` (cuBLASLt's int8 GEMM, int32 accumulation) on the card
where its shape rules hold (more than 16 rows, a multiple of 8 for the
inner and the output width), else in fp64, which is exact while
127^2 * K < 2^53.  ``_int_mm`` takes the weight's transposed view, K
contiguous in both operands: a row-major copy of the transpose makes it
slower than fp64 (at ResNet-50's classifier on an H100 80GB HBM3 at
700 W, ``chip_smoke.py`` phase 8: 0.0337 ms on the view, 0.0943 ms on
the copy, 0.0771 ms in fp64).  The convolution runs in fp64.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .numerics import div_scalar
from .registry import register


def _symmetric_scale(min_range, max_range, qmax=127.0):
    amax = torch.maximum(torch.abs(min_range), torch.abs(max_range))
    return div_scalar(torch.clamp(amax, min=1e-12), qmax)


def _f32(v, like):
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def _quantize(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


@register("_contrib_quantize_v2", nout=3, differentiable=False,
          aliases=("quantize_v2",))
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """fp32 -> int8 over the calibrated range (the data's own without
    one); returns (quantized, -amax, amax)."""
    if min_calib_range is None or max_calib_range is None:
        lo, hi = torch.min(data), torch.max(data)
    else:
        lo, hi = _f32(min_calib_range, data), _f32(max_calib_range, data)
    scale = _symmetric_scale(lo, hi)
    amax = scale * 127.0
    return _quantize(data, scale), -amax, amax


@register("_contrib_quantize", nout=3, differentiable=False,
          aliases=("quantize",))
def quantize(data, min_range, max_range, out_type="int8"):
    """fp32 -> int8 over the range given as arrays."""
    scale = _symmetric_scale(torch.min(min_range), torch.max(max_range))
    amax = scale * 127.0
    return _quantize(data, scale), -amax, amax


@register("_contrib_dequantize", differentiable=False,
          aliases=("dequantize",))
def dequantize(data, min_range, max_range, out_type="float32"):
    scale = _symmetric_scale(torch.min(min_range), torch.max(max_range))
    return data.to(torch.float32) * scale


@register("_contrib_requantize", nout=3, differentiable=False,
          aliases=("requantize",))
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator -> int8: the int32 range is [min_range,
    max_range], the int8 one the calibrated range (else the data's)."""
    in_scale = _symmetric_scale(torch.min(min_range), torch.max(max_range),
                                qmax=2147483647.0)
    real = data.to(torch.float32) * in_scale
    if min_calib_range is not None and max_calib_range is not None:
        lo, hi = _f32(min_calib_range, data), _f32(max_calib_range, data)
    else:
        lo, hi = torch.min(real), torch.max(real)
    out_scale = _symmetric_scale(lo, hi)
    amax = out_scale * 127.0
    return _quantize(real, out_scale), -amax, amax


def int8_matmul_int_mm(a, b):
    """(M, K) int8 x (N, K) int8 -> (M, N) int32 by ``torch._int_mm``
    (M > 16; K and N multiples of 8), on the weight's transposed view."""
    return torch._int_mm(a.contiguous(), b.contiguous().t())


def int8_matmul_fp64(a, b):
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, accumulated in fp64."""
    k = a.shape[1]
    if k * 127 * 127 >= 2 ** 53:
        raise MXNetError(f"int8 product: K = {k} is too long for an exact "
                         f"fp64 accumulation")
    return torch.matmul(a.double(), b.double().t()).to(torch.int32)


def int8_matmul(a, b):
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exactly."""
    m, k = a.shape
    n = b.shape[0]
    if a.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return int8_matmul_int_mm(a, b)
    return int8_matmul_fp64(a, b)


def int8_conv(x, w, stride, padding, dilation, groups):
    """int8 NCHW x int8 OIHW -> int32, exactly (fp64 accumulation)."""
    k = w.shape[1] * w[0, 0].numel()
    if k * 127 * 127 >= 2 ** 53:
        raise MXNetError(f"int8 convolution: {k} products a sum is too "
                         f"many for an exact fp64 accumulation")
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[x.dim() - 2]
    return conv(x.double(), w.double(), stride=stride, padding=padding,
                dilation=dilation, groups=groups).to(torch.int32)


@register("_contrib_quantized_fully_connected", differentiable=False,
          aliases=("quantized_fully_connected",))
def quantized_fully_connected(x, weight_q, wscale, act_range, *maybe_bias,
                              num_hidden=None, no_bias=False, flatten=True):
    """Quantize ``x`` over the calibrated ``act_range`` (2,), the int8
    product with ``weight_q`` (units, in) in int32, then the fp32 rescale
    by ascale * ``wscale`` (per output unit) and the bias."""
    x2 = x.reshape(x.shape[0], -1) if flatten else x
    ascale = _symmetric_scale(act_range[0], act_range[1])
    xq = _quantize(x2, ascale)
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), weight_q)
    acc = acc.reshape(xq.shape[:-1] + (weight_q.shape[0],))
    y = acc.to(torch.float32) * (ascale * wscale)
    if maybe_bias and not no_bias:
        y = y + maybe_bias[0]
    return y


@register("_contrib_quantized_conv", differentiable=False,
          aliases=("quantized_conv",))
def quantized_conv(x, weight_q, wscale, act_range, *maybe_bias, kernel=None,
                   stride=None, pad=None, dilate=None, num_filter=None,
                   num_group=1, no_bias=False, layout=None):
    """The int8 NCHW convolution: ``x`` quantized over ``act_range``, the
    int32 product with ``weight_q`` (O, I / g, *k), the fp32 rescale by
    ascale * ``wscale`` (O,) and the bias."""
    if layout not in (None, "NCHW"):
        raise MXNetError(
            f"quantized_conv lowers NCHW only, got layout={layout!r}")
    nd = x.dim() - 2
    ascale = _symmetric_scale(act_range[0], act_range[1])
    acc = int8_conv(_quantize(x, ascale), weight_q,
                    tuple(stride) if stride else (1,) * nd,
                    tuple(pad) if pad else (0,) * nd,
                    tuple(dilate) if dilate else (1,) * nd, num_group)
    scale = (ascale * wscale).reshape((1, -1) + (1,) * nd)
    y = acc.to(torch.float32) * scale
    if maybe_bias and not no_bias:
        y = y + maybe_bias[0].reshape((1, -1) + (1,) * nd)
    return y
