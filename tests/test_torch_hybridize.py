"""``HybridBlock.hybridize()`` of the port on the CPU: the cached forward
against the eager one (bit for bit: it runs the same ops) and against the
reference's hybridized net (1e-5 of the larger of 1 and the magnitude,
fp32), after tests/test_gluon.py:58,71; the cache's keys and every path
that must empty it; BatchNorm's running statistics; outputs that stay
fixed; ``Constant`` (:151); ``summary`` (:227); compile events.  On CPU
tensors a cache entry runs the functionalized forward without capture;
the CUDA-graph entries are held on the card by chip_smoke.py's phase 11."""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import load_reference_params
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()


def _close(port, ref, atol=1e-5):
    ref = np.asarray(ref.asnumpy() if hasattr(ref, "asnumpy") else ref,
                     dtype=np.float64)
    port = np.asarray(port.asnumpy() if hasattr(port, "asnumpy") else port,
                      dtype=np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol * scale)


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, activation="tanh", in_units=8),
            pkg.gluon.nn.Dense(4, in_units=16))
    return net


def _convnet(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Conv2D(6, 3, padding=1, in_channels=3),
            pkg.gluon.nn.BatchNorm(in_channels=6),
            pkg.gluon.nn.Activation("relu"), pkg.gluon.nn.Flatten(),
            pkg.gluon.nn.Dense(5, in_units=6 * 25))
    return net


def _pair(make, seed=0):
    prev = rmx.nd.set_eager_jit(False)
    rmx.random.seed(seed)
    try:
        ref = make(rmx)
        ref.initialize(rmx.init.Xavier())
    finally:
        rmx.nd.set_eager_jit(prev)
    port = make(mx)
    port.initialize(ctx=CPU)
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()})
    return ref, port


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _events(name):
    return [e for e in telemetry.compile_events() if e["name"] == name]


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


# -- hybrid against eager and against the reference ---------------------------
@pytest.mark.parametrize("make", [_mlp, _convnet], ids=["mlp", "convnet"])
def test_hybrid_forward_equals_eager_and_the_reference(make):
    ref, port = _pair(make)
    shape = (3, 8) if make is _mlp else (2, 3, 5, 5)
    x = _x(*shape)
    px = nd.array(x, ctx=CPU)
    eager = port(px).asnumpy()
    port.hybridize()
    ref.hybridize()
    np.testing.assert_array_equal(port(px).asnumpy(), eager)
    np.testing.assert_array_equal(port(px).asnumpy(), eager)   # cached
    _close(port(px), ref(rmx.nd.array(x)))


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_hybrid_gradients_equal_eager_and_the_reference(grad_req):
    """A train step under record(): the parameters' and the input's
    gradients through the cached forward equal the eager ones, by their
    grad_req (``add`` over two backward passes), and the reference's."""
    x = _x(2, 3, 5, 5, seed=1)
    grads = {}
    for hybrid in (False, True):
        ref, port = _pair(_convnet)
        port.collect_params().setattr("grad_req", grad_req)
        if hybrid:
            port.hybridize()
            ref.hybridize()
        px = nd.array(x, ctx=CPU)
        px.attach_grad(grad_req)
        for _ in range(2 if grad_req == "add" else 1):
            with autograd.record():
                loss = (port(px) ** 2).sum()
            loss.backward()
        grads[hybrid] = [px.grad.asnumpy()] + [
            p.grad().asnumpy() for p in port.collect_params().values()
            if p.grad_req != "null"]
    for a, b in zip(grads[False], grads[True]):
        np.testing.assert_array_equal(a, b)
    rx = rmx.nd.array(x)
    rx.attach_grad()
    with rmx.autograd.record():
        rl = (ref(rx) ** 2).sum()
    rl.backward()
    scale = 2 if grad_req == "add" else 1
    _close(grads[True][0], rx.grad.asnumpy() * scale)
    rgrads = [p.grad().asnumpy() for p in ref.collect_params().values()
              if p.grad_req != "null"]
    for a, b in zip(grads[True][1:], rgrads):
        _close(a, b * scale)


def test_batchnorm_running_stats_are_written_back():
    x = _x(4, 3, 5, 5, seed=2)
    stats = {}
    for hybrid in (False, True):
        ref, port = _pair(_convnet)
        if hybrid:
            port.hybridize()
            ref.hybridize()
        for _ in range(2):
            with autograd.record():
                port(nd.array(x, ctx=CPU))
        with rmx.autograd.record():
            for _ in range(2):
                ref(rmx.nd.array(x))
        bn, rbn = port[1], ref[1]
        stats[hybrid] = [bn.running_mean.data().asnumpy(),
                         bn.running_var.data().asnumpy()]
        if hybrid:
            _close(stats[True][0], rbn.running_mean.data())
            _close(stats[True][1], rbn.running_var.data())
    for a, b in zip(stats[False], stats[True]):
        np.testing.assert_array_equal(a, b)
    assert not np.allclose(stats[True][0], 0)


def test_single_output_unwrapped_and_tuples_kept():
    class Two(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x * 2, [x + 1, x - 1]

    net = Two()
    net.hybridize()
    x = nd.array(_x(2, 3), ctx=CPU)
    a, (b, c) = net(x)
    np.testing.assert_array_equal(b.asnumpy(), x.asnumpy() + 1)
    m = _mlp(mx)
    m.initialize(ctx=CPU)
    m.hybridize()
    assert isinstance(m(nd.array(_x(2, 8), ctx=CPU)), nd.NDArray)


def test_kept_output_stays_fixed():
    _, port = _pair(_mlp)
    port.hybridize()
    a = port(nd.array(_x(3, 8), ctx=CPU))
    kept = a.asnumpy().copy()
    port(nd.array(_x(3, 8, seed=5), ctx=CPU))
    np.testing.assert_array_equal(a.asnumpy(), kept)


# -- the cache's key ---------------------------------------------------------
def test_cache_key_and_compile_events():
    """One entry for each input signature, train/predict and record mode;
    the first entry's cause is new_block, the others' new_signature; a
    repeated call builds nothing."""
    _, port = _pair(_convnet)
    port.hybridize()
    name = port.name
    x1 = nd.array(_x(2, 3, 5, 5), ctx=CPU)
    x2 = nd.array(_x(3, 3, 5, 5), ctx=CPU)
    port(x1)
    port(x1)
    assert [e["cause"] for e in _events(name)] == ["new_block"]
    port(x2)
    with autograd.train_mode():
        port(x2)
    with autograd.record():
        port(x2)
    port(x1)
    evs = _events(name)
    assert [e["cause"] for e in evs] == ["new_block"] + \
        ["new_signature"] * 3
    assert all(e["kind"] == "block" and e["graph"] == "functional" and
               e["elapsed_s"] >= 0 for e in evs)
    assert len(port._cached_graph) == 4


def test_amp_target_is_part_of_the_key():
    from mxnet_tpu_torch.contrib import amp

    _, port = _pair(_mlp)
    port.hybridize()
    x = nd.array(_x(3, 8), ctx=CPU)
    port(x)
    amp.init("bfloat16", target_dtype_ops=[], fp32_ops=[])
    try:
        port(x)
    finally:
        amp.disable()
    assert len(port._cached_graph) == 2


def test_deferred_shapes_run_eagerly_first():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4), gluon.nn.Dense(2))
    net.initialize(ctx=CPU)
    net.hybridize()
    x = nd.array(_x(3, 5), ctx=CPU)
    y0 = net(x)
    assert not _events(net.name) and not net._cached_graph
    assert not any(b._cached_graph for b in net.modules()
                   if isinstance(b, gluon.HybridBlock))
    np.testing.assert_array_equal(net(x).asnumpy(), y0.asnumpy())
    assert len(_events(net.name)) == 1


# -- invalidation --------------------------------------------------------------
def _check_fresh(net, x, what):
    """The cached output equals an eager run on the current weights."""
    got = net(x).asnumpy()
    net.hybridize(False)
    want = net(x).asnumpy()
    net.hybridize()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=what)


def _loaded_file(tmp_path, make):
    other = make(mx)
    other.initialize(mx.init.Normal(3.0), ctx=CPU)
    path = str(tmp_path / "w.params")
    other.save_parameters(path)
    return path


@pytest.mark.parametrize("path", [
    "cast", "load_parameters", "set_data", "force_reinit", "reset_ctx",
    "to", "param_cast", "hybridize", "reseed", "set_state"])
def test_every_path_that_changes_the_weights_is_seen(path, tmp_path):
    """After each path the cached output follows the new weights; every
    path that replaces a parameter's tensor or storage (or the generators)
    empties the cache, set_data and load_parameters (in-place writes) keep
    it."""
    _, net = _pair(_mlp)
    net.hybridize()
    x = nd.array(_x(3, 8), ctx=CPU)
    net(x)
    version = net._cache_version
    w = net[0].weight
    if path == "cast":
        net.cast("float64")
        x = x.astype("float64")
    elif path == "load_parameters":
        net.load_parameters(_loaded_file(tmp_path, _mlp))
    elif path == "set_data":
        w.set_data(w.data().asnumpy() * 3)
    elif path == "force_reinit":
        net.initialize(mx.init.Normal(2.0), ctx=CPU, force_reinit=True)
    elif path == "reset_ctx":
        net.collect_params().reset_ctx(CPU)
    elif path == "to":
        net.to(torch.float64)
        x = x.astype("float64")
    elif path == "param_cast":
        w.cast("float64")
        w.cast("float32")
    elif path == "hybridize":
        net.hybridize()
    elif path == "reseed":
        mx.random.seed(7)
    elif path == "set_state":
        mx.random.set_state(mx.random.get_state())
    before = len(_events(net.name))
    _check_fresh(net, x, path)
    rebuilt = len(_events(net.name)) > before
    assert rebuilt == (path not in ("set_data", "load_parameters")), path
    if path in ("cast", "force_reinit", "to", "hybridize"):
        assert net._cache_version > version


def _grads(net, x, hybrid, reqs=("write",)):
    """The parameters' gradients after a recorded step for each grad_req
    of ``reqs`` given to the first layer in turn."""
    net.hybridize(hybrid)
    for req in reqs:
        for p in net[0].collect_params().values():
            p.grad_req = req
        with autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
    return {k: p.grad().asnumpy() for k, p in net.collect_params().items()}


def test_a_grad_req_change_rebuilds_the_entry():
    """Unfreezing a layer after a hybridized step (a fine-tuned backbone):
    the next call builds a new entry, whose gradients equal eager's (a
    graph captures which parameters it differentiates)."""
    _, net = _pair(_mlp)
    x = nd.array(_x(3, 8), ctx=CPU)
    net.hybridize()
    net(x)
    for p in net[0].collect_params().values():
        p.grad_req = "null"
    with autograd.record():
        net(x)
    before = len(_events(net.name))
    got = _grads(net, x, True)
    assert len(_events(net.name)) == before + 1
    want = _grads(net, x, False)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_two_recorded_calls_then_one_backward_equal_eager():
    """One hybridized block called twice in one record() (a discriminator
    on real and on fake data) and one backward: the gradients equal
    eager's."""
    _, net = _pair(_mlp)
    x1, x2 = (nd.array(_x(3, 8, seed=s), ctx=CPU) for s in (1, 2))
    grads = []
    for hybrid in (True, False):
        net.hybridize(hybrid)
        with autograd.record():
            y1 = net(x1)
            y2 = net(x2)
            loss = (y1 ** 2).sum() + (y1 * y2).sum() + y2.sum()
        loss.backward()
        grads.append({k: p.grad().asnumpy()
                      for k, p in net.collect_params().items()})
    for k in grads[1]:
        np.testing.assert_allclose(grads[0][k], grads[1][k], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_a_dropped_recorded_output_is_freed_at_once():
    """A recorded call's output dropped by the caller is freed by its
    reference count, with the collector off: nothing on the cached path
    (the input and output trees) keeps it in a reference cycle, so on the
    card its tape node ends and the entry's graph is free for the next
    call."""
    import gc
    import weakref

    _, net = _pair(_mlp)
    net.hybridize()
    x = nd.array(_x(3, 8), ctx=CPU)
    gc.disable()
    try:
        with autograd.record():
            ref = weakref.ref(net(x)._data)
            assert ref() is None
    finally:
        gc.enable()


def test_planted_stale_cache_is_caught(tmp_path, monkeypatch):
    """Without invalidation a replaced tensor leaves the cache reading the
    old one: the check above must fail then (here on the CPU entry, which
    reads the parameters each call, by planting a cache that keeps the
    tensors it was built with)."""
    from mxnet_tpu_torch.gluon import _cached_op

    real = _cached_op.FunctionalForward.__init__

    def keeps_tensors(self, apply_fn, plist, in_spec):
        real(self, apply_fn, plist, in_spec)
        kept = {n: p._nd._data for n, p in plist}
        self._plist = [(n, type("P", (), {"_nd": type(
            "N", (), {"_data": kept[n]})})) for n, _ in plist]

    monkeypatch.setattr(_cached_op.FunctionalForward, "__init__",
                        keeps_tensors)
    monkeypatch.setattr(gluon.HybridBlock, "_bump_cache_version",
                        lambda self: None)
    _, net = _pair(_mlp)
    net.hybridize()
    x = nd.array(_x(3, 8), ctx=CPU)
    net(x)
    net.initialize(mx.init.Normal(2.0), ctx=CPU, force_reinit=True)
    with pytest.raises(AssertionError):
        _check_fresh(net, x, "planted")


# -- host reads, Constant, summary ---------------------------------------------
def test_host_read_in_a_cached_cpu_forward_runs():
    """On the CPU nothing is captured, so a host read is allowed (on the
    card it raises; chip_smoke.py holds that)."""
    class Reads(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x * float(x.sum().asscalar())

    net = Reads()
    net.hybridize()
    x = nd.array(np.ones((2, 2), "f"), ctx=CPU)
    np.testing.assert_array_equal(net(x).asnumpy(), np.full((2, 2), 4.0))


def _const_net(pkg):
    class Net(pkg.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = pkg.gluon.nn.Dense(2, in_units=2)
            self.const = self.params.get_constant(
                "const", pkg.nd.array([[1.0, 2.0]], ctx=pkg.cpu()))

        def hybrid_forward(self, F, x, const):
            return self.dense(x) * const

    return Net()


@pytest.mark.parametrize("hybrid", [False, True])
def test_constant_matches_reference_and_is_never_trained(hybrid, tmp_path):
    ref, port = _pair(_const_net)
    if hybrid:
        port.hybridize()
    x = _x(3, 2, seed=3)
    _close(port(nd.array(x, ctx=CPU)), ref(rmx.nd.array(x)))
    assert port.const.grad_req == "null"
    port.const.grad_req = "write"
    assert port.const.grad_req == "null"
    trainer = gluon.Trainer(port.collect_params(), "sgd",
                            {"learning_rate": 1.0})
    with autograd.record():
        loss = port(nd.array(x, ctx=CPU)).sum()
    loss.backward()
    trainer.step(1)
    np.testing.assert_array_equal(port.const.data().asnumpy(), [[1.0, 2.0]])
    # saved and loaded like the other parameters, in either package
    path = str(tmp_path / "c.params")
    port.save_parameters(path)
    ref2 = _const_net(rmx)
    ref2.load_parameters(path)
    _close(ref2.const.data(), port.const.data())
    _close(ref2.dense.weight.data(), port.dense.weight.data())
    port2 = _const_net(mx)
    port2.load_parameters(path, ctx=CPU)
    np.testing.assert_array_equal(port2(nd.array(x, ctx=CPU)).asnumpy(),
                                  port(nd.array(x, ctx=CPU)).asnumpy())


def test_constant_initializes_whatever_the_initializer():
    net = _const_net(mx)
    net.initialize(mx.init.Normal(5.0), ctx=CPU)
    np.testing.assert_array_equal(net.const.data().asnumpy(), [[1.0, 2.0]])


@pytest.mark.parametrize("make", [_mlp, _convnet], ids=["mlp", "convnet"])
@pytest.mark.parametrize("hybrid", [False, True])
def test_summary_prints_the_reference_rows(make, hybrid):
    ref, port = _pair(make)
    if hybrid:
        port.hybridize()
    shape = (1, 8) if make is _mlp else (1, 3, 5, 5)
    x = _x(*shape)
    out_r, out_p = io.StringIO(), io.StringIO()
    with redirect_stdout(out_r):
        ref.summary(rmx.nd.array(x))
    with redirect_stdout(out_p):
        port.summary(nd.array(x, ctx=CPU))
    assert out_p.getvalue() == out_r.getvalue()
    assert "Total params (shown layers)" in out_p.getvalue()


def test_hybridize_inactive_runs_eagerly():
    _, net = _pair(_mlp)
    net.hybridize()
    net.hybridize(active=False)
    net(nd.array(_x(3, 8), ctx=CPU))
    assert not net._cached_graph and not _events(net.name)


def test_static_flags_are_accepted():
    _, net = _pair(_mlp)
    net.hybridize(static_alloc=True, static_shape=True)
    x = nd.array(_x(3, 8), ctx=CPU)
    np.testing.assert_array_equal(net(x).asnumpy(), net(x).asnumpy())


def test_host_read_guard_names_the_block():
    """The guard a capture sets (on the card) refuses a host read with
    the block's name."""
    from mxnet_tpu_torch.ndarray import ndarray as ndm

    ndm._CAPTURE.block = "reads0"
    try:
        with pytest.raises(MXNetError, match="reads0.*host read"):
            nd.array([1.0], ctx=CPU).asscalar()
    finally:
        ndm._CAPTURE.block = None
