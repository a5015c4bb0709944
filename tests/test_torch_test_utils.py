"""``mx.test_utils`` and ``mx.viz`` of the port against the reference's on
the CPU: each oracle gives the reference's verdict (passes, or raises
AssertionError) on the same passing and failing cases; the symbolic
checks hold a bound symbol to numpy; ``print_summary``'s text and
``plot_network``'s DOT source equal the reference's for the same JSON."""
import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from mxnet_tpu.util import test_utils as rtu
from mxnet_tpu_torch import test_utils as tu
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


def _verdict(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except AssertionError:
        return "fails"
    return "passes"


_A = np.linspace(-1, 1, 12, dtype="float32").reshape(3, 4)
CLOSE = [(_A, _A + 5e-6, {}), (_A, _A + 5e-4, {}), (_A, _A * 1.001, {}),
         (_A, _A + 1e-2, {"atol": 2e-2}), (_A, _A * 1.05, {"rtol": 1e-2}),
         (_A.astype("float16"), (_A + 5e-3).astype("float16"), {}),
         (_A.astype("float64"), _A.astype("float64") + 1e-6, {}),
         (np.array([np.nan, 1.0], "f"), np.array([np.nan, 1.0], "f"), {})]


@pytest.mark.parametrize("i", range(len(CLOSE)))
def test_assert_almost_equal_verdicts_match(i):
    a, b, kw = CLOSE[i]
    assert _verdict(tu.assert_almost_equal, a, b, **kw) == \
        _verdict(rtu.assert_almost_equal, a, b, **kw)
    if a.dtype != np.float64:      # the reference has no fp64 arrays (x64 off)
        want = _verdict(rtu.assert_almost_equal,
                        rmx.nd.array(a, dtype=a.dtype), b, **kw)
        got = _verdict(tu.assert_almost_equal,
                       mx.nd.array(a, ctx=CPU, dtype=a.dtype), b, **kw)
        assert got == want
    assert tu.almost_equal(a, b, **kw) == rtu.almost_equal(a, b, **kw)
    assert tu.same(a, b) == rtu.same(a, b)


def _square(pkg):
    return lambda x: x * x


def _wrong_grad(pkg):
    # sign() has a zero gradient where the numeric one is not (at 0)
    return lambda x: pkg.nd.sign(x) + x * 0.0


@pytest.mark.parametrize("make,x,verdict", [
    (_square, np.array([0.5, -1.25, 2.0], "f"), "passes"),
    (_wrong_grad, np.array([0.0, 0.3], "f"), "fails")],
    ids=["square", "sign_at_0"])
def test_check_numeric_gradient_verdicts_match(make, x, verdict):
    want = _verdict(rtu.check_numeric_gradient, make(rmx), [x])
    got = _verdict(tu.check_numeric_gradient, make(mx), [x], ctx=CPU)
    assert got == want == verdict


@pytest.mark.parametrize("offset", [0.0, 1e-3], ids=["same", "planted"])
def test_check_consistency_verdicts_match(offset):
    """Two runs of the same function on CPU contexts: consistent, and with
    an offset planted in the second run, not (the card's check is
    ``[mx.cpu(), mx.gpu()]``)."""
    x = np.random.RandomState(0).randn(4, 5).astype("f")
    calls = []

    def make(pkg):
        def f(a):
            calls.append(1)
            return pkg.nd.tanh(a) + (offset if len(calls) % 2 == 0 else 0.0)
        return f

    want = _verdict(rtu.check_consistency, make(rmx), [x],
                    ctx_list=[rmx.cpu(), rmx.cpu()])
    calls.clear()
    got = _verdict(tu.check_consistency, make(mx), [x],
                   ctx_list=[CPU, CPU])
    assert got == want == ("passes" if offset == 0 else "fails")


def test_check_consistency_on_a_symbol():
    data = mx.sym.var("data")
    s = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    rs = np.random.RandomState(1)
    ins = [rs.randn(2, 4).astype("f"), rs.randn(3, 4).astype("f"),
           rs.randn(3).astype("f")]
    out = tu.check_consistency(s, ins, ctx_list=[CPU, CPU],
                               dtypes=("float32", "float64"))
    np.testing.assert_allclose(out, ins[0] @ ins[1].T + ins[2], rtol=1e-5)


def test_check_symbolic_forward_and_backward():
    a, b = mx.sym.var("a"), mx.sym.var("b")
    s = mx.sym.broadcast_mul(a, b, name="mul")
    rs = np.random.RandomState(2)
    av, bv = rs.randn(3, 4).astype("f"), rs.randn(3, 4).astype("f")
    g = rs.randn(3, 4).astype("f")
    tu.check_symbolic_forward(s, [av, bv], [av * bv], ctx=CPU)
    tu.check_symbolic_forward(s, {"a": av, "b": bv}, {"mul_output": av * bv},
                              ctx=CPU)
    grads = tu.check_symbolic_backward(s, [av, bv], [g], [g * bv, g * av],
                                       ctx=CPU)
    assert sorted(grads) == ["a", "b"]
    with pytest.raises(AssertionError):
        tu.check_symbolic_forward(s, [av, bv], [av * bv + 1e-2], ctx=CPU)
    with pytest.raises(AssertionError):
        tu.check_symbolic_backward(s, [av, bv], [g], {"a": g * av}, ctx=CPU)
    bn = mx.sym.BatchNorm(mx.sym.var("x"), fix_gamma=False, name="bn")
    x = rs.randn(4, 3).astype("f")
    mean, var = rs.randn(3).astype("f"), rs.rand(3).astype("f") + 0.5
    gamma, beta = rs.randn(3).astype("f"), rs.randn(3).astype("f")
    want = (x - mean) / np.sqrt(var + 1e-5) * gamma + beta
    tu.check_symbolic_forward(bn, [x, gamma, beta], [want],
                              aux_states=[mean, var], ctx=CPU)


def test_rand_ndarray_and_shapes():
    np.random.seed(0)
    shape = tu.rand_shape_nd(3, dim=4)
    assert len(shape) == 3 and all(1 <= d <= 4 for d in shape)
    x = tu.rand_ndarray((5, 6), ctx=CPU)
    assert x.shape == (5, 6) and x.context == CPU
    v = x.asnumpy()
    assert (v >= -1).all() and (v < 1).all()
    for stype in ("csr", "row_sparse"):
        s = tu.rand_ndarray((5, 6), stype=stype, density=0.3, ctx=CPU)
        assert s.stype == stype and s.shape == (5, 6)
    assert tu.default_context() == mx.current_context()


def _viz_symbol(sym):
    x = sym.var("data")
    h = sym.Convolution(x, kernel=(3, 3), num_filter=4, stride=(1, 1),
                        name="conv")
    h = sym.BatchNorm(h, name="bn")
    h = sym.Activation(h, act_type="relu", name="act")
    h = sym.Pooling(h, kernel=(2, 2), pool_type="max", name="pool")
    h = sym.Flatten(h, name="flat")
    h = sym.FullyConnected(h, num_hidden=8, name="fc")
    return sym.softmax(h, name="prob")


@pytest.mark.parametrize("hide_weights", [True, False])
def test_plot_network_and_print_summary_equal_the_reference(hide_weights,
                                                             tmp_path,
                                                             capsys):
    r = rmx.sym.load_json(_viz_symbol(rmx.sym).tojson())
    p = mx.sym.load_json(r.tojson())
    got = mx.viz.plot_network(p, title="net", hide_weights=hide_weights)
    want = rmx.viz.plot_network(r, title="net", hide_weights=hide_weights)
    assert got.source == want.source
    assert ("fc_weight" in got.source) != hide_weights
    path = got.render(str(tmp_path / "net"))
    assert open(path).read() == got.source
    assert mx.viz.print_summary(p) == rmx.viz.print_summary(r)
    assert "fc (FullyConnected)" in capsys.readouterr().out
    with pytest.raises(mx.MXNetError):
        mx.viz.plot_network("not a symbol")


def test_plot_network_of_a_traced_block():
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(4, in_units=3, activation="relu"))
    net.initialize(ctx=CPU)
    sym, _, _ = net._trace_to_symbol(mx.nd.ones((1, 3), ctx=CPU))
    assert "FullyConnected" in mx.viz.plot_network(sym).source


def test_util_helpers(tmp_path):
    mx.util.makedirs(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()
    assert mx.util.get_gpu_count() == mx.num_gpus()
    if not mx.num_gpus():
        assert mx.util.get_gpu_memory(0) == (0, 0)
