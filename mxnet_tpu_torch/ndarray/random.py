"""``mx.nd.random``: the samplers with MXNet's signatures (counterpart of
``mxnet_tpu/ndarray/random.py``).  A sampler draws from the generator of
the device it returns on (``ctx``, else the current context)."""
from __future__ import annotations

from .ndarray import NDArray, invoke

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "randint", "multinomial", "shuffle",
           "bernoulli"]


def _shape_t(shape):
    if shape is None:
        return (1,)
    return (shape,) if isinstance(shape, int) else tuple(shape)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    """Uniform on [low, high); with an NDArray bound, one draw of its
    shape and dtype on its device (the other bound a scalar)."""
    if isinstance(low, NDArray) or isinstance(high, NDArray):
        data = low if isinstance(low, NDArray) else high
        return invoke("sample_uniform_like", [data], {
            "low": 0.0 if isinstance(low, NDArray) else float(low),
            "high": 1.0 if isinstance(high, NDArray) else float(high)})
    return invoke("random_uniform", [], {"low": low, "high": high,
                                         "shape": _shape_t(shape),
                                         "dtype": dtype}, out=out, ctx=ctx)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    return invoke("random_normal", [], {"loc": loc, "scale": scale,
                                        "shape": _shape_t(shape),
                                        "dtype": dtype}, out=out, ctx=ctx)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **kw):
    return normal(loc, scale, shape=shape or (1,), dtype=dtype, ctx=ctx)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, **kw):
    return invoke("random_gamma", [], {"alpha": alpha, "beta": beta,
                                       "shape": _shape_t(shape),
                                       "dtype": dtype}, out=out, ctx=ctx)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None,
                **kw):
    return invoke("random_exponential", [], {"lam": 1.0 / scale,
                                             "shape": _shape_t(shape),
                                             "dtype": dtype},
                  out=out, ctx=ctx)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None, **kw):
    return invoke("random_poisson", [], {"lam": lam,
                                         "shape": _shape_t(shape),
                                         "dtype": dtype}, out=out, ctx=ctx)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None, **kw):
    return invoke("random_negative_binomial", [], {
        "k": k, "p": p, "shape": _shape_t(shape), "dtype": dtype},
        out=out, ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None,
            **kw):
    return invoke("random_randint", [], {"low": low, "high": high,
                                         "shape": _shape_t(shape),
                                         "dtype": dtype}, out=out, ctx=ctx)


def multinomial(data, shape=1, get_prob=False, dtype="int32", **kw):
    return invoke("sample_multinomial", [data], {"shape": shape,
                                                 "get_prob": get_prob,
                                                 "dtype": dtype})


def shuffle(data, **kw):
    return invoke("shuffle", [data], {})


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None, **kw):
    return invoke("bernoulli", [], {"prob": prob, "shape": _shape_t(shape),
                                    "dtype": dtype}, ctx=ctx)
