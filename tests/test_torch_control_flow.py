"""``nd.contrib.foreach``, ``while_loop`` and ``cond`` of the port against
the reference on the CPU, values and gradients, after
tests/test_contrib_ops.py:123-160.  Inputs from a numpy seed; agreement
within 1e-5 of the larger of 1 and the values' magnitude (fp32)."""
import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()


def _close(port, ref, atol=1e-5):
    ref = np.asarray(ref.asnumpy(), dtype=np.float64)
    port = np.asarray(port.asnumpy(), dtype=np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol * scale)


def _pair(x):
    return rmx.nd.array(x), nd.array(x, ctx=CPU)


def _run(pkg, fn, arrays):
    """``fn(pkg, *arrays)`` recorded, then a backward of the sum of every
    output against seeded weights: (outputs, each input's gradient)."""
    for a in arrays:
        a.attach_grad()
    with pkg.autograd.record():
        outs = fn(pkg, *arrays)
        flat = []
        for o in outs:
            flat += o if isinstance(o, (list, tuple)) else [o]
        total = None
        for i, o in enumerate(flat):
            w = np.random.RandomState(10 + i).randn(*o.shape) \
                .astype("float32")
            term = (o * pkg.nd.array(w, ctx=o.context)).sum()
            total = term if total is None else total + term
    total.backward()
    return flat, [a.grad for a in arrays]


def _compare(fn, *inputs):
    pairs = [_pair(x) for x in inputs]
    rout, rgrad = _run(rmx, fn, [r for r, _ in pairs])
    with CPU:
        pout, pgrad = _run(mx, fn, [p for _, p in pairs])
    assert len(pout) == len(rout)
    for p, r in zip(pout, rout):
        assert p.shape == r.shape
        _close(p, r)
    for p, r in zip(pgrad, rgrad):
        _close(p, r)


def _seq(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def test_foreach_single_data_and_state():
    def fn(pkg, data, s0):
        return pkg.nd.contrib.foreach(
            lambda x, s: (pkg.nd.tanh(x * s), s + x), data, s0)

    _compare(fn, _seq(5, 3), _seq(3, seed=1))


def test_foreach_lists_of_data_and_states():
    """An RNN-style body: two sequences, two states, two outputs."""
    def fn(pkg, xs, ys, h, c):
        def body(inp, st):
            x, y = inp
            h, c = st
            nh = pkg.nd.tanh(x * h + y)
            return [nh, nh * c], [nh, c + y]

        outs, states = pkg.nd.contrib.foreach(body, [xs, ys], [h, c])
        return outs + states

    _compare(fn, _seq(4, 2, 3), _seq(4, 2, 3, seed=1), _seq(2, 3, seed=2),
             _seq(2, 3, seed=3))


def test_foreach_cumsum_values():
    with CPU:
        data = nd.array(np.ones((5, 3), "f"))
        out, state = nd.contrib.foreach(lambda x, s: (x + s, x + s), data,
                                        nd.zeros((3,)))
    assert out.shape == (5, 3)
    np.testing.assert_array_equal(out.asnumpy()[:, 0], [1, 2, 3, 4, 5])
    np.testing.assert_array_equal(state.asnumpy(), [5, 5, 5])


@pytest.mark.parametrize("start", [0.0, 1.5, 9.0])
def test_while_loop_pads_to_max_iterations(start):
    """The loop stops early (or never starts), the outputs keep
    max_iterations rows with zeros after the exit, the final state is the
    one at the exit, and the gradient flows only through the steps
    taken."""
    def fn(pkg, s, w):
        outs, st = pkg.nd.contrib.while_loop(
            lambda s, w: (s.sum() < 6),
            lambda s, w: ([s * w, s + 1], [s * 1.5 + w, w]),
            [s, w], max_iterations=7)
        return outs + st

    _compare(fn, np.full((2,), start, "float32"), _seq(2, seed=4) * 0.1)


def test_while_loop_requires_max_iterations():
    with CPU:
        with pytest.raises(MXNetError, match="max_iterations"):
            nd.contrib.while_loop(lambda s: s.sum() < 1, lambda s: (s, s),
                                  nd.zeros((1,)))


@pytest.mark.parametrize("threshold", [-100.0, 100.0])
def test_cond_takes_each_branch(threshold):
    def fn(pkg, a, b):
        out = pkg.nd.contrib.cond(
            lambda a, b: a.sum() > threshold,
            lambda a, b: [a * b, pkg.nd.exp(a)],
            lambda a, b: [a - b, a * a * b],
            [a, b])
        return out

    _compare(fn, _seq(3, 2, seed=5), _seq(3, 2, seed=6))


def test_cond_single_output_and_reference_example():
    with CPU:
        x = nd.array([1.0, 2.0])
        r = nd.contrib.cond(lambda a: a.sum() > 0, lambda a: a * 2,
                            lambda a: a * 3, x)
        r2 = nd.contrib.cond(lambda a: a.sum() > 100, lambda a: a * 2,
                             lambda a: a * 3, x)
    np.testing.assert_array_equal(r.asnumpy(), [2.0, 4.0])
    np.testing.assert_array_equal(r2.asnumpy(), [3.0, 6.0])


def test_control_flow_in_a_hybridized_block_matches_eager():
    """The cached forward runs the same loop: a hybridized block's output
    and gradients equal its eager ones."""
    class Scan(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.w = self.params.get("w", shape=(3,))

        def hybrid_forward(self, F, x, w):
            out, s = F.contrib.foreach(lambda xt, s: (F.tanh(xt * w + s),
                                                      s + xt), x,
                                       F.zeros((3,), ctx=x.context))
            return out.sum(axis=0) + s

    net = Scan()
    net.initialize(mx.init.Normal(1.0), ctx=CPU)
    x = nd.array(_seq(4, 3, seed=7), ctx=CPU)
    res = []
    for hybrid in (False, True):
        if hybrid:
            net.hybridize()
        with autograd.record():
            y = net(x)
        y.backward()
        res.append((y.asnumpy(), net.w.grad().asnumpy().copy()))
    np.testing.assert_array_equal(res[0][0], res[1][0])
    np.testing.assert_array_equal(res[0][1], res[1][1])
