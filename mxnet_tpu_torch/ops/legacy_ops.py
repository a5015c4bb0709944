"""Legacy standalone ops (counterpart of ``mxnet_tpu/ops/legacy_ops.py``):
FlowNet's ``Correlation`` and the ``SVMOutput`` loss layer.

``Correlation`` sums, for each displacement, the channel product of the
first map and the shifted second map over a k x k patch at the strided
output positions.  The reference rolls the padded second map; every
position it reads lies at most ``max_displacement + kernel radius`` from
an output position, which is at least that far from the padded edge, so
the roll never wraps and a slice of the padded map reads the same values.
The products of one vertical displacement are one batched matmul over the
channels, whose diagonals are the horizontal displacements.
``SVMOutput``'s gradient ignores the incoming one, as the reference's
``custom_vjp`` does: a ``torch.autograd.Function`` pins it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .numerics import div_scalar
from .registry import register

__all__ = ["correlation", "svm_output"]


@register("Correlation", aliases=("correlation",))
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """(N, C, H, W) x 2 -> (N, D * D, H_out, W_out) with
    D = 2 * (max_displacement // stride2) + 1: for each displacement (row
    major, dy then dx) the patch product (or minus the absolute difference)
    of data1 and data2 shifted by it, over the patch and the channels."""
    k = int(kernel_size)
    if k % 2 == 0:
        raise MXNetError("Correlation requires an odd kernel_size")
    md, s1, s2, pad = (int(max_displacement), int(stride1), int(stride2),
                       int(pad_size))
    n, c, h, w = data1.shape
    d1 = F.pad(data1, (pad, pad, pad, pad))
    d2 = F.pad(data2, (pad, pad, pad, pad))
    ph, pw = h + 2 * pad, w + 2 * pad
    kr = (k - 1) // 2
    border = md + kr
    out_h = math.ceil((ph - border * 2) / s1)
    out_w = math.ceil((pw - border * 2) / s1)
    if out_h < 1 or out_w < 1:
        raise MXNetError("Correlation: output would be empty; grow pad_size "
                         "or shrink max_displacement")
    # the rows and columns the patches of the output positions cover
    rh, rw = s1 * (out_h - 1) + k, s1 * (out_w - 1) + k
    y0 = x0 = border - kr
    a = d1[:, :, y0:y0 + rh, x0:x0 + rw]
    reach = (md // s2) * s2
    shifts = range(-reach, reach + 1, s2)
    maps = []
    if is_multiply:
        # for each dy, one batched product over the channels of a's rows
        # with the rows of data2 dy below, every column pair at once; the
        # dx products are its diagonals
        cols = torch.arange(rw, device=a.device)[:, None] + reach + \
            torch.tensor(list(shifts), device=a.device)[None, :]
        lhs = a.permute(0, 2, 3, 1).reshape(n * rh, rw, c)
        for dy in shifts:
            b = d2[:, :, y0 + dy:y0 + dy + rh, x0 - reach:x0 + rw + reach]
            m = torch.bmm(lhs, b.permute(0, 2, 1, 3).reshape(
                n * rh, c, rw + 2 * reach))              # (N rh, rw, rw + 2R)
            red = torch.gather(m, 2, cols.expand(n * rh, -1, -1))
            maps.append(red.reshape(n, rh, rw, -1).permute(0, 3, 1, 2))
    else:
        for dy in shifts:
            red = [-torch.abs(a - d2[:, :, y0 + dy:y0 + dy + rh,
                                     x0 + dx:x0 + dx + rw]).sum(dim=1)
                   for dx in shifts]
            maps.append(torch.stack(red, dim=1))
    red = torch.cat(maps, dim=1)                      # (N, D * D, rh, rw)
    if k > 1 or s1 > 1:
        red = F.avg_pool2d(red, k, stride=s1, divisor_override=1)
    return div_scalar(red, float(k * k * c))


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        d, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.cfg
        li = label.to(torch.int64)
        onehot = (li.unsqueeze(-1) == torch.arange(
            d.shape[-1], device=d.device)).to(d.dtype)
        score_y = torch.gather(d, -1, li.unsqueeze(-1))
        viol = margin - (score_y - d)        # the margin violation per class
        if use_linear:                       # L1-SVM: the hinge's subgradient
            mask = (viol > 0).to(d.dtype) * (1.0 - onehot)
            grad = reg * (mask - onehot * mask.sum(-1, keepdim=True))
        else:                                # L2-SVM: the squared hinge's
            act = torch.clamp(viol, min=0.0) * (1.0 - onehot)
            grad = 2.0 * reg * (act - onehot * act.sum(-1, keepdim=True))
        return grad, None, None, None, None


@register("SVMOutput", aliases=("svm_output",))
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """The identity on ``data``; its gradient is the multiclass hinge
    loss's (L2, or L1 with ``use_linear``), whatever the incoming one."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient), use_linear)
