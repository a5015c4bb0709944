"""The port's AMP loss scaling (``mxnet_tpu_torch.contrib.amp``:
``LossScaler``, ``init_trainer``, ``scale_loss``, ``unscale``,
``convert_model``) held against the reference's on the CPU.

A small Dense net trains through ``gluon.Trainer`` under ``amp.init()``
with empty op lists (so both packages compute in fp32 and the steps can
be compared; the cast policy itself is tested with the ops) and a dynamic
``LossScaler``: with inf planted in a gradient at chosen steps, the scale
sequence equals the reference's, a skipped step leaves every weight
unchanged bit for bit, and the weights follow the reference's within 1e-5
of their magnitude.  ``unscale`` divides the gradients once however often
it is called; ``convert_model`` leaves the same parameters in fp32 as the
reference.
"""
import numpy as np
import pytest

import mxnet_tpu as rmx
from mxnet_tpu import guard as ref_guard
from mxnet_tpu.contrib import amp as ref_amp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.contrib.amp import loss_scaler
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
TOL = 1e-5
BATCH = 4


@pytest.fixture(autouse=True)
def _amp_off():
    """Both packages' AMP state is global: off after every test."""
    yield
    amp.disable()
    ref_amp.disable()


def _net(g):
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(6, activation="relu", in_units=5),
            g.nn.Dense(3, in_units=6))
    return net


def _pair():
    ref, port = _net(rmx.gluon), _net(gluon)
    ref.initialize()
    port.initialize(ctx=CPU)
    gluon.load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                       ref.collect_params().items()})
    return ref, port


def _no_cast():
    for a in (amp, ref_amp):
        a.init("float16", target_dtype_ops=[], fp32_ops=[])


def _trainer(pkg, net, scaler_kw):
    g = rmx.gluon if pkg == "ref" else gluon
    a = ref_amp if pkg == "ref" else amp
    trainer = g.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
    a.init_trainer(trainer, a.LossScaler(**scaler_kw))
    return trainer


def _backward(pkg, net, trainer, x, plant=False):
    """record -> scale_loss -> backward; with ``plant``, inf in the first
    parameter's gradient."""
    a = ref_amp if pkg == "ref" else amp
    ag = rmx.autograd if pkg == "ref" else autograd
    xs = rmx.nd.array(x) if pkg == "ref" else nd.array(x, ctx=CPU)
    with ag.record():
        loss = (net(xs) ** 2).mean()
        with a.scale_loss(loss, trainer) as scaled:
            scaled.backward()
    if plant:
        g = next(iter(net.collect_params().values())).grad()
        g[0] = np.inf
    return float(loss.asnumpy().reshape(-1)[0])


def _weights(net):
    return [p.data().asnumpy().copy() for p in net.collect_params().values()]


def _close(port, ref, msg):
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, rtol=0,
                                   atol=TOL * max(1.0, np.abs(r).max()),
                                   err_msg=msg)


OVERFLOW_STEPS = {2, 3, 6}


def test_scale_sequence_under_planted_overflows():
    _no_cast()
    ref, port = _pair()
    kw = dict(init_scale=2.0 ** 10, scale_window=2)
    rt, pt = _trainer("ref", ref, kw), _trainer("port", port, kw)
    x = np.random.RandomState(0).randn(BATCH, 5).astype("float32")
    rscales, pscales = [], []
    for step in range(8):
        plant = step in OVERFLOW_STEPS
        before = _weights(port)
        rl = _backward("ref", ref, rt, x, plant)
        pl = _backward("port", port, pt, x, plant)
        assert pl == pytest.approx(rl, rel=TOL)
        rt.step(BATCH)
        pt.step(BATCH)
        rscales.append(rt._amp_loss_scaler.loss_scale)
        pscales.append(pt._amp_loss_scaler.loss_scale)
        if plant:
            for b, a in zip(before, _weights(port)):
                np.testing.assert_array_equal(a, b)
        _close(_weights(port), _weights(ref), f"step {step}")
    assert pscales == rscales
    assert pscales == [2.0 ** 10, 2.0 ** 11, 2.0 ** 10, 2.0 ** 9, 2.0 ** 9,
                       2.0 ** 10, 2.0 ** 9, 2.0 ** 9]
    assert pt.step_count == rt.step_count == 8 - len(OVERFLOW_STEPS)


def test_unscale_is_one_shot():
    """unscale twice divides the gradients by the scale once, and the
    step that follows does not divide them again."""
    _no_cast()
    ref, port = _pair()
    kw = dict(init_scale=2.0 ** 8)
    rt, pt = _trainer("ref", ref, kw), _trainer("port", port, kw)
    x = np.random.RandomState(1).randn(BATCH, 5).astype("float32")
    _backward("ref", ref, rt, x)
    _backward("port", port, pt, x)
    scaled = [p.grad().asnumpy().copy() for p in
              port.collect_params().values()]
    for _ in range(2):
        amp.unscale(pt)
        ref_amp.unscale(rt)
    for p, r, s in zip(port.collect_params().values(),
                       ref.collect_params().values(), scaled):
        np.testing.assert_array_equal(p.grad().asnumpy(), s / 2.0 ** 8)
        _close([p.grad().asnumpy()], [r.grad().asnumpy()], p.name)
    rt.step(BATCH)
    pt.step(BATCH)
    _close(_weights(port), _weights(ref), "after the step")
    assert pt._amp_unscaled is False


def test_default_scalers_and_init_order():
    for a, g in ((ref_amp, rmx.gluon), (amp, gluon)):
        net = _net(g)
        for target, scale in (("float16", 2.0 ** 16), ("bfloat16", 1.0)):
            a.init(target)
            trainer = a.init_trainer(
                g.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}))
            assert trainer._amp_loss_scaler.loss_scale == scale
        a.disable()
    with pytest.raises(MXNetError):
        amp.init_trainer(gluon.Trainer(_net(gluon).collect_params(), "sgd"))
    with pytest.raises(MXNetError):
        amp.init("float64")
    assert amp.list_fp16_ops() == ref_amp.list_fp16_ops()
    assert amp.list_fp32_ops() == ref_amp.list_fp32_ops()


def test_loss_scaler_arithmetic_matches_reference():
    verdicts = [False, False, True, False, False, False, True, True, False]
    for dynamic in (True, False):
        ref = ref_amp.LossScaler(init_scale=8.0, scale_window=2,
                                 min_scale=2.0, dynamic=dynamic)
        port = amp.LossScaler(init_scale=8.0, scale_window=2,
                              min_scale=2.0, dynamic=dynamic)
        seq = []
        for v in verdicts:
            assert port.update_scale(v) == ref.update_scale(v)
            seq.append((port.loss_scale, ref.loss_scale))
            assert port.state_dict() == ref.state_dict()
        assert all(p == r for p, r in seq)
    other = amp.LossScaler()
    other.load_state_dict(port.state_dict())
    assert other.state_dict() == port.state_dict()


def test_nonfinite_count_matches_the_reference_guard():
    ref, port = _pair()
    x = np.random.RandomState(2).randn(BATCH, 5).astype("float32")
    for pkg, net in (("ref", ref), ("port", port)):
        ag = rmx.autograd if pkg == "ref" else autograd
        xs = rmx.nd.array(x) if pkg == "ref" else nd.array(x, ctx=CPU)
        with ag.record():
            loss = net(xs).sum()
        loss.backward()
    rparams = list(ref.collect_params().values())
    pparams = list(port.collect_params().values())
    assert float(loss_scaler.nonfinite_total(pparams)) == 0.0
    assert not amp.LossScaler().has_overflow(pparams)
    for params in (rparams, pparams):
        g = params[0].grad()
        g[0, 0] = np.inf
        g[1, 1] = np.nan
        params[3].grad()[1] = -np.inf
    assert float(loss_scaler.nonfinite_total(pparams)) == \
        float(np.asarray(ref_guard.nonfinite_total(rparams))) == 3.0
    assert amp.LossScaler().has_overflow(pparams)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32",
                                   "float64"])
@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_has_overflow_sees_one_bad_value_and_leaves_gradients(dtype, bad):
    """has_overflow's one multi-tensor pass: a single non-finite value in
    any gradient is an overflow, whatever the gradients' dtype; the
    gradients come out bit for bit as they went in."""
    _, port = _pair()
    params = list(port.collect_params().values())
    for p in params:
        p.cast(dtype)
    r = np.random.RandomState(3)
    for p in params:
        p.grad()[:] = r.randn(*p.shape)
    before = [p.grad()._data.clone() for p in params]
    assert not amp.LossScaler().has_overflow(params)
    for i in range(len(params)):
        g = params[i].grad()
        flat = g._data.view(-1)
        flat[-1] = float(bad)
        assert amp.LossScaler().has_overflow(params)
        after = [p.grad()._data for p in params]
        assert all(a.view(-1)[:-1].equal(b.view(-1)[:-1]) if j == i
                   else a.equal(b)
                   for j, (a, b) in enumerate(zip(after, before)))
        flat[-1] = before[i].view(-1)[-1]
    assert not amp.LossScaler().has_overflow(params)


def test_convert_model_keeps_norm_parameters_fp32():
    nets = []
    for g, ctx in ((rmx.gluon, {}), (gluon, {"ctx": CPU})):
        net = g.nn.HybridSequential()
        net.add(g.nn.Dense(4, in_units=3), g.nn.BatchNorm(in_channels=4),
                g.nn.Dense(2, in_units=4), g.nn.LayerNorm(in_channels=2))
        net.initialize(**ctx)
        nets.append(net)
    ref_amp.convert_model(nets[0], "float16")
    amp.convert_model(nets[1], "float16")
    rd = [np.dtype(p.data().dtype).name for p in
          nets[0].collect_params().values()]
    pd = [p.data().dtype for p in nets[1].collect_params().values()]
    assert pd == rd
    assert pd.count("float16") == 4 and pd.count("float32") == 6
    assert amp.convert_hybrid_block is amp.convert_model
    y = nets[1][:1](nd.ones((2, 3), ctx=CPU, dtype="float16"))
    assert y.dtype == "float16"
