"""Optimizer update operators (counterpart of
``mxnet_tpu/ops/optimizer_ops.py``): each update is a pure function of
(weight, grad, states...) returning the new (weight, states...), in plain
tensor arithmetic written as the reference writes it."""
from __future__ import annotations

import torch

from .registry import register


def _prep(grad, wd, weight, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


@register("sgd_update", differentiable=False)
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    return weight - lr * _prep(grad, wd, weight, rescale_grad, clip_gradient)


@register("sgd_mom_update", differentiable=False, nout=2)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register("adam_update", differentiable=False, nout=3)
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True, t=1):
    """Bias correction is folded into ``lr`` by the frontend, as in the
    reference."""
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var
