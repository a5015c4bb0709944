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


@register("nag_mom_update", differentiable=False, nout=2)
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register("adagrad_update", differentiable=False, nout=2)
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_hist = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(new_hist) + epsilon), new_hist


@register("adadelta_update", differentiable=False, nout=3)
def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(new_acc_g + epsilon) \
        * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - delta, new_acc_g, new_acc_delta


@register("rmsprop_update", differentiable=False, nout=2)
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n


@register("rmspropalex_update", differentiable=False, nout=3)
def rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    """Graves' RMSProp; the arrays are (weight, grad, n, g, delta) and the
    outputs (weight, n, g), as the reference returns them."""
    gr = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(gr)
    new_g = gamma1 * g_state + (1 - gamma1) * gr
    new_delta = gamma2 * delta - lr * gr / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    return weight + new_delta, new_n, new_g


def _scaled_clipped(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register("ftrl_update", differentiable=False, nout=3)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _scaled_clipped(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


@register("ftml_update", differentiable=False, nout=3)
def ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1):
    """Returns (weight, d, v), as the reference does (z stays with the
    frontend)."""
    g = _prep(grad, wd, weight, rescale_grad, clip_grad)
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(new_v / (1 - beta2 ** t))
                                   + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    return -new_z / d_t, d_t, new_v


@register("signsgd_update", differentiable=False)
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _scaled_clipped(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", differentiable=False, nout=2)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.9, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _scaled_clipped(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * (g + wd * weight)
    new_w = (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return new_w, new_mom


@register("lamb_update_phase1", differentiable=False)
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """The LAMB direction m_hat / (sqrt(v_hat) + eps) + wd * w; the moments
    themselves are not returned, as in the reference."""
    g = _scaled_clipped(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    m_hat, v_hat = new_mean, new_var
    if bias_correction:
        m_hat = new_mean / (1 - beta1 ** t)
        v_hat = new_var / (1 - beta2 ** t)
    return m_hat / (torch.sqrt(v_hat) + epsilon) + wd * weight


@register("lamb_update_phase2", differentiable=False)
def lamb_update_phase2(weight, g_update, r1, r2, lr=0.01, lower_bound=-1.0,
                       upper_bound=-1.0):
    """Scale the phase-1 direction by the trust ratio r1 / r2 (1 where
    either norm is 0), clipped to the bounds that are > 0."""
    one = torch.ones_like(r1)
    ratio = torch.where((r1 > 0) & (r2 > 0),
                        torch.where(r1 > 0, r1, one)
                        / torch.where(r2 > 0, r2, torch.ones_like(r2)), one)
    if lower_bound is not None and lower_bound > 0:
        ratio = torch.clamp(ratio, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        ratio = torch.clamp(ratio, max=upper_bound)
    return weight - lr * ratio * g_update


@register("multi_sgd_update", differentiable=False, nout="dynamic")
def multi_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    """SGD over many parameters in one call; ``arrays`` is
    [w0, g0, w1, g1, ...] and the result one new weight for each (a single
    tensor for one weight), as in the reference."""
    outs = tuple(sgd_update(arrays[2 * i], arrays[2 * i + 1], lr=lrs[i],
                            wd=wds[i], rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient)
                 for i in range(num_weights))
    return outs if len(outs) > 1 else outs[0]
