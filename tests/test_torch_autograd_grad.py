"""The port's functional autograd (``autograd.grad``, ``create_graph``,
``autograd.Function``, ``ndarray.apply_fn``) against the reference on the
CPU, after tests/test_autograd.py:140 and tests/test_higher_order_grad.py.

Inputs come from a numpy seed and go through both packages; values and
gradients agree within 1e-5 of the larger of 1 and their magnitude (fp32,
different summation orders), second-order gradients within 1e-4 (they
compound two such roundings)."""
import numpy as np
import pytest

import mxnet_tpu as rmx
from mxnet_tpu.ndarray.ndarray import apply_fn as ref_apply_fn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray.ndarray import apply_fn
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()


def _close(port, ref, atol=1e-5):
    ref = np.asarray(ref.asnumpy() if hasattr(ref, "asnumpy") else ref,
                     dtype=np.float64)
    port = np.asarray(port.asnumpy() if hasattr(port, "asnumpy") else port,
                      dtype=np.float64)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol * scale)


def _pair(x):
    return rmx.nd.array(x), nd.array(x, ctx=CPU)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(0.2, 2.0, shape) \
        .astype("float32")


# each case: f(F, x) on NDArrays of either package
CASES = {
    "sin": lambda F, x: F.sin(x),
    "log": lambda F, x: F.log(x),
    "cube_dot": lambda F, x: F.dot(x, x.T) ** 3,
    "tanh_mul": lambda F, x: F.tanh(x) * x,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_matches_reference(case):
    f = CASES[case]
    rx, px = _pair(_rand(3, 4))
    for x in (rx, px):
        x.attach_grad()
    with rmx.autograd.record():
        ry = f(rmx.nd, rx).sum()
    with autograd.record():
        py = f(nd, px).sum()
    rg = rmx.autograd.grad([ry], [rx])[0]
    pg = autograd.grad([py], [px])[0]
    _close(pg, rg)
    # grad() leaves the gradient buffers alone
    assert not px.grad.asnumpy().any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_create_graph_matches_reference(case):
    """d/dx sum(grad(f)(x)^2): the gradient is on the tape and a backward
    differentiates through it."""
    f = CASES[case]
    rx, px = _pair(_rand(3, 4, seed=1))
    for x in (rx, px):
        x.attach_grad()
    with rmx.autograd.record():
        rg = rmx.autograd.grad(f(rmx.nd, rx).sum(), rx,
                               create_graph=True)[0]
        rz = (rg * rg).sum()
    rz.backward()
    with autograd.record():
        pg = autograd.grad(f(nd, px).sum(), px, create_graph=True)[0]
        pz = (pg * pg).sum()
    pz.backward()
    _close(pg, rg)
    _close(px.grad, rx.grad, atol=1e-4)


def test_second_derivative_of_log_is_analytic():
    x = nd.array(np.array([0.5, 1.0, 1.5], "float32"), ctx=CPU)
    x.attach_grad()
    with autograd.record():
        g1 = autograd.grad(nd.log(x), x, create_graph=True)[0]
    g1.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), -1.0 / x.asnumpy() ** 2,
                               rtol=1e-5)


def test_grad_of_unreached_variable_is_zero_and_heads_must_be_recorded():
    a = nd.array([1.0, 2.0], ctx=CPU)
    b = nd.array([3.0, 4.0], ctx=CPU)
    a.attach_grad()
    b.attach_grad()
    with autograd.record():
        y = (a * a).sum()
    ga, gb = autograd.grad(y, [a, b])
    np.testing.assert_array_equal(ga.asnumpy(), [2.0, 4.0])
    np.testing.assert_array_equal(gb.asnumpy(), [0.0, 0.0])
    with pytest.raises(MXNetError, match="record"):
        autograd.grad(nd.array([1.0], ctx=CPU), [a])


def test_grad_with_head_grads_matches_reference():
    rx, px = _pair(_rand(2, 3, seed=2))
    hg = np.random.RandomState(3).randn(2, 3).astype("float32")
    for x in (rx, px):
        x.attach_grad()
    with rmx.autograd.record():
        ry = rmx.nd.exp(rx) * rx
    with autograd.record():
        py = nd.exp(px) * px
    _close(autograd.grad(py, px, head_grads=nd.array(hg, ctx=CPU))[0],
           rmx.autograd.grad(ry, rx, head_grads=rmx.nd.array(hg))[0])


def _function_classes(pkg):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + pkg.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    class MulAdd(pkg.autograd.Function):
        """Two inputs, two outputs, the second gradient scaled by 3 (not
        the true derivative: the user's backward is what counts)."""

        def forward(self, a, b):
            self.a, self.b = a, b
            return a * b, a + b

        def backward(self, d1, d2):
            return d1 * self.b + d2, 3 * (d1 * self.a + d2)

    return Sigmoid, MulAdd


def test_function_matches_reference():
    rS, rM = _function_classes(rmx)
    pS, pM = _function_classes(mx)
    ra, pa = _pair(np.random.RandomState(4).randn(3, 4).astype("float32"))
    rb, pb = _pair(np.random.RandomState(5).randn(3, 4).astype("float32"))
    for x in (ra, pa, rb, pb):
        x.attach_grad()
    with rmx.autograd.record():
        r1, r2 = rM()(ra, rb)
        rl = (rS()(r1) * r2).sum()
    rl.backward()
    with autograd.record():
        p1, p2 = pM()(pa, pb)
        pl = (pS()(p1) * p2).sum()
    pl.backward()
    _close(pl, rl)
    _close(pa.grad, ra.grad)
    _close(pb.grad, rb.grad)


def test_function_backward_with_wrong_arity_raises():
    class Bad(mx.autograd.Function):
        def forward(self, a, b):
            return a * b

        def backward(self, dy):
            return dy

    a, b = nd.array([1.0], ctx=CPU), nd.array([2.0], ctx=CPU)
    a.attach_grad()
    with autograd.record():
        y = Bad()(a, b)
    with pytest.raises(MXNetError, match="returned 1 gradients for 2"):
        y.backward()


def test_function_outside_record_is_its_forward():
    pS, _ = _function_classes(mx)
    x = np.linspace(-2, 2, 5).astype("float32")
    y = pS()(nd.array(x, ctx=CPU))
    np.testing.assert_allclose(y.asnumpy(), 1 / (1 + np.exp(-x)), rtol=1e-6)


def test_apply_fn_matches_reference():
    """A composite function over NDArrays, recorded as one computation:
    values and gradients of both its inputs, a scalar input taken as a
    constant."""
    import jax.numpy as jnp
    import torch

    ra, pa = _pair(_rand(2, 5, seed=6))
    rb, pb = _pair(_rand(5, 3, seed=7))
    for x in (ra, pa, rb, pb):
        x.attach_grad()
    with rmx.autograd.record():
        r1, r2 = ref_apply_fn(lambda a, b, s: (jnp.tanh(a @ b) * s,
                                               jnp.sum(a ** 2)),
                              [ra, rb, 0.5], name="composite")
        rl = r1.sum() + r2
    rl.backward()
    with autograd.record():
        p1, p2 = apply_fn(lambda a, b, s: (torch.tanh(a @ b) * s,
                                           torch.sum(a ** 2)),
                          [pa, pb, 0.5], name="composite")
        pl = p1.sum() + p2
    pl.backward()
    _close(p1, r1)
    _close(pl, rl)
    _close(pa.grad, ra.grad)
    _close(pb.grad, rb.grad)
    assert p1.context == CPU


def test_apply_fn_outside_record_builds_no_graph():
    a = nd.array([1.0, 2.0], ctx=CPU)
    a.attach_grad()
    out = apply_fn(lambda t: t * 2, [a])
    assert not out._data.requires_grad
    np.testing.assert_array_equal(out.asnumpy(), [2.0, 4.0])
