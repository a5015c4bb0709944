"""The random family of the port (``mxnet_tpu_torch.ops.random_ops``,
``mx.random``, ``mx.nd.random``) on the CPU.

The densities are deterministic: each is held to the reference's value and
to its gradient with respect to the sample and every parameter, at 1e-5.
The samplers draw torch's streams, not the reference's, so they are held
to their distributions by ``chip_smoke.distribution_check``, the check the
card's run makes: a continuous one by the one-sample Kolmogorov-Smirnov
statistic against scipy's CDF, a discrete one by its first two moments
and a chi-square over its bins, each bound at a p-value of 1e-6 for the
seeded sample (so a wrong scale or shape fails and the fixed draws pass
every run).  Then seeding and ``get_state`` /
``set_state`` replay, and the signatures of ``nd.random`` and
``mx.random`` against the reference's.
"""
import inspect
import json

import numpy as np
import pytest
import torch
from scipy import stats

import chip_smoke
import mxnet_tpu as ref_mx
from mxnet_tpu import autograd as ref_ag
from mxnet_tpu.ndarray.ndarray import array as ref_array
from mxnet_tpu.ndarray.ndarray import invoke as ref_invoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as port_ag
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray.ndarray import array as _port_array
from mxnet_tpu_torch.ndarray.ndarray import invoke as port_invoke
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
CPU = mx.cpu()
N_DRAWS = 40000


def port_array(a):
    return _port_array(a, ctx=CPU)


# ---------------------------------------------------------------------------
# densities, with gradients
# ---------------------------------------------------------------------------
def _positive(rs, shape, lo=0.5, hi=2.0):
    return rs.uniform(lo, hi, shape).astype("f")


DENSITIES = {
    "uniform": ("_random_pdf_uniform", lambda rs: [
        rs.uniform(-0.2, 1.2, (3, 6)).astype("f"),
        rs.uniform(-0.5, 0.0, (3,)).astype("f"),
        rs.uniform(0.8, 1.5, (3,)).astype("f")], [1, 2]),
    "normal": ("_random_pdf_normal", lambda rs: [
        rs.randn(2, 3, 6).astype("f"), rs.randn(2, 3).astype("f"),
        _positive(rs, (2, 3))], [0, 1, 2]),
    "gamma": ("_random_pdf_gamma", lambda rs: [
        _positive(rs, (3, 6), 0.2, 4.0), _positive(rs, (3,), 0.5, 4.0),
        _positive(rs, (3,))], [0, 1, 2]),
    "exponential": ("_random_pdf_exponential", lambda rs: [
        _positive(rs, (4, 5), 0.1, 3.0), _positive(rs, (4,))], [0, 1]),
    "poisson": ("_random_pdf_poisson", lambda rs: [
        rs.randint(0, 8, (3, 6)).astype("f"), _positive(rs, (3,), 0.5, 5.0)],
        [1]),
    "negative_binomial": ("_random_pdf_negative_binomial", lambda rs: [
        rs.randint(0, 8, (3, 6)).astype("f"), _positive(rs, (3,), 1.0, 5.0),
        rs.uniform(0.2, 0.8, (3,)).astype("f")], [1, 2]),
    "generalized_negative_binomial": (
        "_random_pdf_generalized_negative_binomial", lambda rs: [
            rs.randint(0, 8, (3, 6)).astype("f"),
            _positive(rs, (3,), 0.5, 4.0), _positive(rs, (3,), 0.2, 1.5)],
        [1, 2]),
    "dirichlet": ("_random_pdf_dirichlet", lambda rs: [
        stats.dirichlet.rvs([1.0, 2.0, 3.0, 0.5], size=(2, 5),
                            random_state=rs).astype("f"),
        _positive(rs, (2, 4))], [0, 1]),
}


def _density(side, name, arrs, grad_idx, is_log):
    array, invoke, ag = side
    nds = [array(a) for a in arrs]
    for i in grad_idx:
        nds[i].attach_grad()
    with ag.record():
        out = invoke(name, nds, {"is_log": is_log})
    head = np.random.RandomState(1).randn(*out.shape).astype("f")
    out.backward(array(head))
    return out.asnumpy(), [nds[i].grad.asnumpy() for i in grad_idx]


@pytest.mark.parametrize("is_log", [False, True])
@pytest.mark.parametrize("dist", sorted(DENSITIES))
def test_density_and_gradients_against_reference(dist, is_log):
    name, make, grad_idx = DENSITIES[dist]
    arrs = make(np.random.RandomState(0))
    ref, ref_g = _density((ref_array, ref_invoke, ref_ag), name, arrs,
                          grad_idx, is_log)
    port, port_g = _density((port_array, port_invoke, port_ag), name, arrs,
                            grad_idx, is_log)
    scale = max(1.0, float(np.abs(ref[np.isfinite(ref)]).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=TOL * scale)
    for i, r, p in zip(grad_idx, ref_g, port_g):
        gscale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(p, r, rtol=0, atol=TOL * gscale,
                                   err_msg=f"gradient of input {i}")


# ---------------------------------------------------------------------------
# samplers, by distribution
# ---------------------------------------------------------------------------
CONTINUOUS = {
    "uniform": (lambda: mx.nd.random.uniform(-2.0, 3.0, shape=(N_DRAWS,),
                                             ctx=CPU),
                stats.uniform(-2.0, 5.0)),
    "normal": (lambda: mx.nd.random.normal(0.5, 0.02, shape=(200, 200),
                                           ctx=CPU),
               stats.norm(0.5, 0.02)),
    "randn": (lambda: mx.nd.random.randn(N_DRAWS, loc=-1.0, scale=2.0,
                                         ctx=CPU),
              stats.norm(-1.0, 2.0)),
    "gamma": (lambda: mx.nd.random.gamma(2.5, 0.7, shape=(N_DRAWS,),
                                         ctx=CPU),
              stats.gamma(2.5, scale=0.7)),
    "gamma_small_shape": (lambda: mx.nd.random.gamma(
        0.3, 2.0, shape=(N_DRAWS,), ctx=CPU), stats.gamma(0.3, scale=2.0)),
    "exponential": (lambda: mx.nd.random.exponential(
        2.0, shape=(N_DRAWS,), ctx=CPU), stats.expon(scale=2.0)),
    "uniform_like": (lambda: mx.nd.random.uniform(
        mx.nd.zeros((N_DRAWS,), ctx=CPU), 4.0), stats.uniform(0.0, 4.0)),
    "normal_like": (lambda: mx.nd.sample_normal_like(
        mx.nd.zeros((N_DRAWS,), ctx=CPU), loc=3.0, scale=0.5),
        stats.norm(3.0, 0.5)),
}


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_sampler_by_kolmogorov_smirnov(name):
    draw, dist = CONTINUOUS[name]
    mx.random.seed(5)
    x = draw()
    assert x.dtype == np.float32 and x.context == CPU
    chip_smoke.distribution_check(name, x._data, dist, continuous=True)


DISCRETE = {
    "poisson": (lambda: mx.nd.random.poisson(3.5, shape=(N_DRAWS,),
                                             ctx=CPU),
                stats.poisson(3.5), "float32"),
    "negative_binomial": (lambda: mx.nd.random.negative_binomial(
        3, 0.4, shape=(N_DRAWS,), ctx=CPU), stats.nbinom(3, 0.4), "float32"),
    "randint": (lambda: mx.nd.random.randint(-3, 7, shape=(N_DRAWS,),
                                             ctx=CPU),
                stats.randint(-3, 7), "int32"),
    "bernoulli": (lambda: mx.nd.random.bernoulli(0.3, shape=(200, 200),
                                                 ctx=CPU),
                  stats.bernoulli(0.3), "float32"),
    "multinomial": (lambda: mx.nd.random.multinomial(port_array(np.array(
        [0.1, 0.0, 0.25, 0.4, 0.25], "f")), shape=N_DRAWS),
        stats.rv_discrete(values=(range(5), [0.1, 0.0, 0.25, 0.4, 0.25])),
        "int32"),
}


@pytest.mark.parametrize("name", sorted(DISCRETE))
def test_discrete_sampler_by_moments_and_chi_square(name):
    draw, dist, dtype = DISCRETE[name]
    mx.random.seed(6)
    out = draw()
    assert out.dtype == np.dtype(dtype) and out.context == CPU
    chip_smoke.distribution_check(name, out._data, dist, continuous=False)


def test_multinomial_rows_and_shapes():
    """One distribution per row; an int shape of 1 drops its axis; a zero
    probability is never drawn."""
    probs = np.array([[0.0, 1.0, 0.0], [0.5, 0.0, 0.5]], "f")
    mx.random.seed(0)
    one = mx.nd.random.multinomial(port_array(probs))
    many = mx.nd.random.multinomial(port_array(probs), shape=(40, 5))
    assert one.shape == (2,) and many.shape == (2, 40, 5)
    assert one.dtype == np.int32
    m = many.asnumpy()
    assert (m[0] == 1).all() and set(np.unique(m[1])) <= {0, 2}
    ref = ref_mx.nd.random.multinomial(ref_array(probs), shape=(40, 5))
    assert ref.shape == many.shape and ref.dtype == many.dtype


@pytest.mark.parametrize("name,attrs", [
    ("random_uniform", {"shape": (2, 3), "dtype": "float16"}),
    ("random_normal", {"shape": (4,), "dtype": "bfloat16"}),
    ("random_randint", {"low": 0, "high": 5, "shape": (3,)}),
    ("random_poisson", {"lam": 2.0, "shape": (2, 2), "dtype": "int32"}),
    ("random_gamma", {"alpha": 2.0, "shape": (5,)}),
    ("bernoulli", {"prob": 0.7, "shape": (3, 1)})])
def test_sampler_shape_and_dtype_against_reference(name, attrs):
    ref = ref_invoke(name, [], dict(attrs))
    port = port_invoke(name, [], dict(attrs), ctx=CPU)
    assert port.shape == ref.shape
    assert str(port.dtype) == str(ref.dtype)


# ---------------------------------------------------------------------------
# seeding and the state
# ---------------------------------------------------------------------------
def _draws():
    return [mx.nd.random.normal(shape=(5,), ctx=CPU).asnumpy(),
            mx.nd.random.randint(0, 100, shape=(5,), ctx=CPU).asnumpy(),
            mx.nd.random.gamma(2.0, shape=(5,), ctx=CPU).asnumpy(),
            mx.nd.random.poisson(3.0, shape=(5,), ctx=CPU).asnumpy(),
            mx.nd.random.multinomial(port_array(np.array(
                [0.2, 0.3, 0.5], "f")), shape=5).asnumpy()]


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_seed_fixes_the_draws():
    mx.random.seed(42)
    a = _draws()
    mx.random.seed(42)
    assert _same(_draws(), a)
    mx.random.seed(43)
    assert not _same(_draws(), a)


def test_set_state_of_get_state_replays_the_draws():
    mx.random.seed(7)
    _draws()
    state = json.loads(json.dumps(mx.random.get_state()))   # JSON-able
    after = _draws()
    assert not _same(_draws(), after)
    mx.random.set_state(state)
    assert _same(_draws(), after)
    # a generator created after the snapshot starts from the seed again
    mx.random.set_state({"seed": 7, "generators": {}})
    mx.random.seed(7)
    first = _draws()
    mx.random.set_state({"seed": 7, "generators": {}})
    assert _same(_draws(), first)
    mx.random.set_state(None)
    assert mx.random.get_state() == {"seed": 0, "generators": {}}


def test_seed_of_one_context():
    mx.random.seed(1)
    a = _draws()
    mx.random.seed(1)
    mx.random.seed(99, ctx=CPU)
    b = _draws()
    mx.random.seed(99, ctx=CPU)
    assert _same(_draws(), b) and not _same(a, b)


# ---------------------------------------------------------------------------
# the namespaces
# ---------------------------------------------------------------------------
ND_RANDOM = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
             "negative_binomial", "randint", "multinomial", "shuffle",
             "bernoulli"]


@pytest.mark.parametrize("name", ND_RANDOM)
def test_nd_random_signature(name):
    ref = inspect.signature(getattr(ref_mx.nd.random, name))
    port = inspect.signature(getattr(mx.nd.random, name))
    assert list(port.parameters) == list(ref.parameters)
    assert [p.default for p in port.parameters.values()] == \
        [p.default for p in ref.parameters.values()]


@pytest.mark.parametrize("name", ["uniform", "normal", "randint", "seed",
                                  "get_state", "set_state"])
def test_mx_random_signature(name):
    ref = inspect.signature(getattr(ref_mx.random, name))
    port = inspect.signature(getattr(mx.random, name))
    assert list(port.parameters) == list(ref.parameters)


def test_mx_random_helpers_draw_on_the_context():
    mx.random.seed(3)
    u = mx.random.uniform(1.0, 2.0, shape=(1000,), ctx=CPU)
    n = mx.random.normal(shape=(3, 4), ctx=CPU)
    r = mx.random.randint(2, 9, ctx=CPU)
    assert u.context == CPU and u.dtype == np.float32
    assert 1.0 <= u.asnumpy().min() and u.asnumpy().max() < 2.0
    assert n.shape == (3, 4) and r.shape == (1,) and r.dtype == np.int32
    assert 2 <= int(r.asscalar()) < 9


def test_nd_image_namespace():
    """nd.image holds every image_* op under its short name, as the
    reference's does."""
    ref = {n for n in dir(ref_mx.nd.image) if not n.startswith("_")}
    port = {n for n in dir(mx.nd.image) if not n.startswith("_")}
    assert {n for n in ref if callable(getattr(ref_mx.nd.image, n))} <= port
    x = np.random.RandomState(0).uniform(0, 1, (4, 6, 3)).astype("f")
    np.testing.assert_allclose(
        mx.nd.image.resize(port_array(x), (3, 2)).asnumpy(),
        ref_mx.nd.image.resize(ref_array(x), (3, 2)).asnumpy(), atol=TOL)


def test_a_sampler_asked_for_the_card_raises_without_one():
    """A sampler on a CUDA device draws there or raises: without a card it
    raises (no CPU stand-in)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.nd.random.normal(shape=(2,), ctx=mx.gpu(0))
