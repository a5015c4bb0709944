"""Random sampling and probability-density operators (counterpart of
``mxnet_tpu/ops/random_ops.py``).

The samplers draw from the device's generator (``mxnet_tpu_torch.random``)
where the reference threads a jax PRNG key (``needs_rng``): the same
distributions, from torch's streams, so ``mx.random.seed`` fixes the draws
of the port but they are not the reference's draws.  Each draws on the
device it returns on and reads nothing back to the host.

The densities (``_random_pdf_*``) are deterministic closed forms with a
trailing draw axis over the parameters' shape, differentiable with respect
to the sample and the parameters through torch autograd.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import torch_dtype
from .registry import register


def _dt(dtype):
    return torch.float32 if dtype in (None, "None") else torch_dtype(dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _float_draw(dtype):
    """The dtype a float sampler draws in: its own, or fp32 for the
    half-precision types (cast after the draw)."""
    return dtype if dtype in (torch.float32, torch.float64) else \
        torch.float32


@register("random_uniform", creation=True, differentiable=False,
          aliases=("uniform", "_sample_uniform"))
def random_uniform(low=0.0, high=1.0, shape=None, dtype="float32",
                   device=None):
    dt = _dt(dtype)
    u = torch.rand(_shape(shape), generator=_random.generator(device),
                   dtype=_float_draw(dt), device=device)
    return (u * (high - low) + low).to(dt)


@register("random_normal", creation=True, differentiable=False,
          aliases=("normal", "_sample_normal"))
def random_normal(loc=0.0, scale=1.0, shape=None, dtype="float32",
                  device=None):
    dt = _dt(dtype)
    z = torch.randn(_shape(shape), generator=_random.generator(device),
                    dtype=_float_draw(dt), device=device)
    return (z * scale + loc).to(dt)


def _standard_gamma(alpha, shape, device):
    a = torch.full(shape, float(alpha), dtype=torch.float32, device=device)
    return torch._standard_gamma(a, generator=_random.generator(device))


@register("random_gamma", creation=True, differentiable=False,
          aliases=("gamma_sample",))
def random_gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32",
                 device=None):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    return (_standard_gamma(alpha, _shape(shape), device) * beta).to(
        _dt(dtype))


@register("random_exponential", creation=True, differentiable=False)
def random_exponential(lam=1.0, shape=None, dtype="float32", device=None):
    """Exponential with rate ``lam``."""
    e = torch.empty(_shape(shape), dtype=torch.float32, device=device)
    e.exponential_(1.0, generator=_random.generator(device))
    return (e / lam).to(_dt(dtype))


@register("random_poisson", creation=True, differentiable=False)
def random_poisson(lam=1.0, shape=None, dtype="float32", device=None):
    rate = torch.full(_shape(shape), float(lam), dtype=torch.float32,
                      device=device)
    return torch.poisson(rate, generator=_random.generator(device)).to(
        _dt(dtype))


@register("random_negative_binomial", creation=True, differentiable=False)
def random_negative_binomial(k=1, p=1.0, shape=None, dtype="float32",
                             device=None):
    """The failures before the ``k``-th success at success probability
    ``p``, as Poisson(Gamma(k, (1 - p) / p)), the reference's mixture."""
    rate = _standard_gamma(k, _shape(shape), device) * (1 - p) / p
    return torch.poisson(rate, generator=_random.generator(device)).to(
        _dt(dtype))


@register("random_randint", creation=True, differentiable=False)
def random_randint(low=0, high=1, shape=None, dtype="int32", device=None):
    """Integers uniform on [low, high)."""
    r = torch.randint(int(low), int(high), _shape(shape),
                      generator=_random.generator(device), device=device)
    return r.to(_dt(dtype))


@register("sample_multinomial", differentiable=False,
          aliases=("multinomial",))
def sample_multinomial(data, shape=1, get_prob=False, dtype="int32"):
    """Category draws from the probabilities along the last axis of
    ``data`` (1-D, or one distribution per row): ``shape`` draws each
    (an int 1 gives one draw without its own axis), with replacement.  As
    in the reference, ``get_prob`` is not read and a probability is
    floored at 1e-30 before the draw."""
    n = shape if isinstance(shape, int) else math.prod(shape)
    draw_shape = (shape,) if isinstance(shape, int) else tuple(shape)
    probs = torch.clamp(data.float(), min=1e-30)
    rows = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(rows, n, replacement=True,
                              generator=_random.generator(data.device))
    if data.dim() == 1:
        out = draws.reshape(draw_shape)
    else:
        out = draws.reshape((data.shape[0],) + draw_shape)
        if isinstance(shape, int) and shape == 1:
            out = out.reshape(data.shape[0])
    return out.to(_dt(dtype))


@register("sample_uniform_like", differentiable=False,
          aliases=("uniform_like",))
def uniform_like(data, low=0.0, high=1.0):
    u = torch.rand(data.shape, generator=_random.generator(data.device),
                   dtype=_float_draw(data.dtype), device=data.device)
    return (u * (high - low) + low).to(data.dtype)


@register("sample_normal_like", differentiable=False,
          aliases=("normal_like",))
def normal_like(data, loc=0.0, scale=1.0):
    z = torch.randn(data.shape, generator=_random.generator(data.device),
                    dtype=_float_draw(data.dtype), device=data.device)
    return (z * scale + loc).to(data.dtype)


@register("bernoulli", creation=True, differentiable=False)
def bernoulli(prob=0.5, shape=None, dtype="float32", device=None):
    b = torch.empty(_shape(shape), dtype=torch.float32, device=device)
    b.bernoulli_(float(prob), generator=_random.generator(device))
    return b.to(_dt(dtype))


# --------------------------------------------------------------------------
# densities: the sample has one trailing draw axis over the parameters'
# shape (the Dirichlet's draw axis is second to last)
# --------------------------------------------------------------------------
def _pdf_out(logp, is_log):
    return logp if is_log else torch.exp(logp)


def _plog(x):
    """log with a finite gradient at the support's boundary."""
    return torch.log(torch.clamp(x, min=1e-30))


@register("_random_pdf_uniform", aliases=("random_pdf_uniform",))
def pdf_uniform(sample, low, high, is_log=False):
    lo, hi = low[..., None], high[..., None]
    inside = (sample >= lo) & (sample <= hi)
    logp = torch.where(inside, -_plog(hi - lo),
                       torch.full_like(sample, -math.inf))
    # the density is flat in the sample: a zero term keeps the sample in
    # the graph, so its gradient is 0 (as the reference's) and not missing
    flat = torch.where(inside, sample * 0.0, torch.zeros_like(sample))
    return _pdf_out(logp + flat, is_log)


@register("_random_pdf_normal", aliases=("random_pdf_normal",))
def pdf_normal(sample, mu, sigma, is_log=False):
    m, s = mu[..., None], sigma[..., None]
    logp = (-0.5 * ((sample - m) / s) ** 2 - _plog(s)
            - 0.5 * math.log(2 * math.pi))
    return _pdf_out(logp, is_log)


@register("_random_pdf_gamma", aliases=("random_pdf_gamma",))
def pdf_gamma(sample, alpha, beta, is_log=False):
    """Shape ``alpha``, rate ``beta``:
    beta^alpha x^(alpha - 1) e^(-beta x) / Gamma(alpha)."""
    a, b = alpha[..., None], beta[..., None]
    logp = (a * _plog(b) + (a - 1) * _plog(sample) - b * sample
            - torch.lgamma(a))
    return _pdf_out(logp, is_log)


@register("_random_pdf_exponential", aliases=("random_pdf_exponential",))
def pdf_exponential(sample, lam, is_log=False):
    lamb = lam[..., None]
    return _pdf_out(_plog(lamb) - lamb * sample, is_log)


@register("_random_pdf_poisson", aliases=("random_pdf_poisson",))
def pdf_poisson(sample, lam, is_log=False):
    lamb = lam[..., None]
    logp = sample * _plog(lamb) - lamb - torch.lgamma(sample + 1.0)
    return _pdf_out(logp, is_log)


@register("_random_pdf_negative_binomial",
          aliases=("random_pdf_negative_binomial",))
def pdf_negative_binomial(sample, k, p, is_log=False):
    """C(x + k - 1, x) p^k (1 - p)^x: ``k`` failures, success probability
    ``p``."""
    kk, pp = k[..., None], p[..., None]
    logp = (torch.lgamma(sample + kk) - torch.lgamma(sample + 1.0)
            - torch.lgamma(kk) + kk * _plog(pp) + sample * _plog(1.0 - pp))
    return _pdf_out(logp, is_log)


@register("_random_pdf_generalized_negative_binomial",
          aliases=("random_pdf_generalized_negative_binomial",))
def pdf_generalized_negative_binomial(sample, mu, alpha, is_log=False):
    """The gamma-Poisson mixture of mean ``mu`` and dispersion
    ``alpha``."""
    m, a = mu[..., None], alpha[..., None]
    r = 1.0 / a
    logp = (torch.lgamma(sample + r) - torch.lgamma(sample + 1.0)
            - torch.lgamma(r) + r * _plog(r / (r + m))
            + sample * _plog(m / (r + m)))
    return _pdf_out(logp, is_log)


@register("_random_pdf_dirichlet", aliases=("random_pdf_dirichlet",))
def pdf_dirichlet(sample, alpha, is_log=False):
    """sample (..., n, k) over alpha (..., k): each of the n draws a point
    of the k-simplex."""
    a = alpha[..., None, :]
    logp = (torch.sum((a - 1.0) * _plog(sample), dim=-1)
            + torch.lgamma(torch.sum(a, dim=-1))
            - torch.sum(torch.lgamma(a), dim=-1))
    return _pdf_out(logp, is_log)
