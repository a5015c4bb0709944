"""The port's Gluon (mxnet_tpu_torch.gluon: parameters, blocks, layers,
losses, Trainer) and TrainStep held against the reference on the CPU.

Weights are initialised by the reference and carried over with
``load_reference_params`` (jax and torch draw different random numbers);
inputs come from a numpy seed.  Tolerances, fp32: single layers 1e-5 of
the larger of 1 and the values' magnitude (summation order differs);
three optimizer steps on a small conv net 1e-5 (losses) and 2e-5 of the
magnitude (parameters and running stats).  Initializers are held by
their distributions, as their random streams differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as rmx
from mxnet_tpu.parallel.data_parallel import TrainStep as RefTrainStep
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import (DeferredInitializationError,
                                   load_reference_params)
from mxnet_tpu_torch.parallel import TrainStep, functionalize

CPU = mx.cpu()
ATOL = 1e-5


def _close(port, ref, atol=ATOL, msg=""):
    ref = np.asarray(ref, dtype=np.float32)
    port = port.asnumpy() if hasattr(port, "asnumpy") else \
        np.asarray(port.detach().float())
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol * scale,
                               err_msg=msg)


def _carry(ref_net, port_net, ref_x, port_x, seed=0):
    """Settle both nets' deferred shapes, give the reference non-trivial
    BatchNorm parameters and running stats, and load its weights into the
    port net."""
    ref_net(ref_x)
    port_net(port_x)
    r = np.random.RandomState(seed)
    for name, p in ref_net.collect_params().items():
        if name.endswith(("gamma", "running_var")):
            p.set_data(rmx.nd.array(
                (1 + 0.2 * r.rand(*p.shape)).astype("float32")))
        elif name.endswith(("beta", "running_mean")):
            p.set_data(rmx.nd.array(
                (0.2 * r.randn(*p.shape)).astype("float32")))
    load_reference_params(port_net, {k: p.data().asnumpy() for k, p in
                                     ref_net.collect_params().items()})


def _both(x):
    return rmx.nd.array(x), nd.array(x, ctx=CPU)


def _pairs(ref_net, port_net):
    return list(zip(ref_net.collect_params().values(),
                    port_net.collect_params().values()))


# -- layers --------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_layer(layout, train):
    """Outputs, input/gamma/beta gradients, and the running stats after
    the step (train mode moves them, predict mode must not)."""
    axis = 1 if layout == "NCHW" else -1
    ref, port = rmx.gluon.nn.BatchNorm(axis=axis), \
        gluon.nn.BatchNorm(axis=axis)
    ref.initialize()
    port.initialize(ctx=CPU)
    shape = (4, 3, 5, 6) if layout == "NCHW" else (4, 5, 6, 3)
    x = (np.random.RandomState(1).randn(*shape) * 2 + 0.5).astype("float32")
    rx, px = _both(x)
    _carry(ref, port, rx, px)
    rx.attach_grad()
    px.attach_grad()
    cot = np.random.RandomState(2).randn(*shape).astype("float32")
    with rmx.autograd.record(train_mode=train):
        ry = ref(rx)
    ry.backward(rmx.nd.array(cot))
    with autograd.record(train_mode=train):
        py = port(px)
    py.backward(nd.array(cot, ctx=CPU))
    _close(py, ry.asnumpy(), msg="output")
    _close(px.grad, rx.grad.asnumpy(), msg="x grad")
    for rp, pp in _pairs(ref, port):
        _close(pp.data(), rp.data().asnumpy(), msg=pp.name)
        if rp.grad_req != "null":
            _close(pp.grad(), rp.grad().asnumpy(), msg=pp.name + " grad")
    moved = not np.allclose(port.running_var.data().asnumpy(),
                            ref.running_var.data().asnumpy() * 0 + 1)
    assert moved or not train


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_conv2d_layer(layout):
    """A Conv2D with bias and relu, weights carried over in the layout's
    own weight shape: output and weight/bias/input gradients."""
    ref = rmx.gluon.nn.Conv2D(6, 3, strides=2, padding=1, layout=layout,
                              activation="relu")
    port = gluon.nn.Conv2D(6, 3, strides=2, padding=1, layout=layout,
                           activation="relu")
    ref.initialize()
    port.initialize(ctx=CPU)
    shape = (2, 4, 9, 9) if layout == "NCHW" else (2, 9, 9, 4)
    rx, px = _both(np.random.RandomState(3).randn(*shape).astype("float32"))
    _carry(ref, port, rx, px)
    assert port.weight.shape == ((6, 4, 3, 3) if layout == "NCHW"
                                 else (6, 3, 3, 4))
    rx.attach_grad()
    px.attach_grad()
    with rmx.autograd.record():
        rl = (ref(rx) ** 2).sum()
    rl.backward()
    with autograd.record():
        pl = (port(px) ** 2).sum()
    pl.backward()
    _close(pl, rl.asnumpy())
    _close(px.grad, rx.grad.asnumpy())
    for rp, pp in _pairs(ref, port):
        _close(pp.grad(), rp.grad().asnumpy(), msg=pp.name)


def test_dense_deferred_init():
    """in_units=0: the weight's shape is fixed by the first forward; until
    then data() and functionalize() refuse."""
    port = gluon.nn.Dense(5, activation="tanh")
    port.initialize(ctx=CPU)
    assert port.weight.shape == (5, 0)
    with pytest.raises(DeferredInitializationError):
        port.weight.data()
    with pytest.raises(DeferredInitializationError, match="run one forward"):
        functionalize(port)
    ref = rmx.gluon.nn.Dense(5, activation="tanh")
    ref.initialize()
    rx, px = _both(np.random.RandomState(4).randn(3, 2, 4).astype("float32"))
    _carry(ref, port, rx, px)
    assert port.weight.shape == (5, 8)
    _close(port(px), ref(rx).asnumpy())


@pytest.mark.parametrize("kind", ["sparse", "dense", "from_logits", "l2"])
def test_losses(kind):
    r = np.random.RandomState(5)
    pred = r.randn(4, 6).astype("float32")
    if kind == "sparse" or kind == "from_logits":
        label = r.randint(0, 6, (4,)).astype("float32")
    else:
        label = r.rand(4, 6).astype("float32")
    make = {"sparse": lambda g: g.loss.SoftmaxCrossEntropyLoss(),
            "dense": lambda g: g.loss.SoftmaxCrossEntropyLoss(
                sparse_label=False),
            "from_logits": lambda g: g.loss.SoftmaxCrossEntropyLoss(
                from_logits=True),
            "l2": lambda g: g.loss.L2Loss()}[kind]
    rp, pp = _both(pred)
    rl, pl = _both(label)
    rp.attach_grad()
    pp.attach_grad()
    with rmx.autograd.record():
        rloss = make(rmx.gluon)(rp, rl)
    rloss.backward()
    with autograd.record():
        ploss = make(gluon)(pp, pl)
    ploss.backward()
    assert ploss.shape == (4,)
    _close(ploss, rloss.asnumpy())
    _close(pp.grad, rp.grad.asnumpy())


# -- optimizers through Trainer and TrainStep ----------------------------------
def _small_net(g, layout="NHWC"):
    axis = -1 if layout == "NHWC" else 1
    net = g.nn.HybridSequential()
    net.add(g.nn.Conv2D(8, 3, padding=1, use_bias=False, layout=layout),
            g.nn.BatchNorm(axis=axis), g.nn.Activation("relu"),
            g.nn.MaxPool2D(2, layout=layout),
            g.nn.Conv2D(8, 3, padding=1, use_bias=False, layout=layout),
            g.nn.BatchNorm(axis=axis), g.nn.Activation("relu"),
            g.nn.GlobalAvgPool2D(layout=layout), g.nn.Dense(5))
    return net


def _small_pair():
    """A small conv net (convolutions without bias before BatchNorm, as in
    ResNet: such a bias gets a gradient of rounding noise only, which
    Adam would normalise into steps of size lr)."""
    ref, port = _small_net(rmx.gluon), _small_net(gluon)
    ref.initialize()
    port.initialize(ctx=CPU)
    x = np.random.RandomState(6).randn(8, 8, 8, 3).astype("float32")
    y = np.random.RandomState(7).randint(0, 5, (8,)).astype("int32")
    _carry(ref, port, *_both(x[:1]))
    return ref, port, x, y


OPTIMIZERS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
              ("adam", {"learning_rate": 0.01, "wd": 1e-3})]


def _trainer_rounds(opt, opt_params, rounds):
    """``rounds`` record / backward / Trainer.step rounds of both
    packages: the loss, every parameter and the running stats after
    each."""
    ref, port, x, y = _small_pair()
    rt = rmx.gluon.Trainer(ref.collect_params(), opt, dict(opt_params))
    pt = gluon.Trainer(port.collect_params(), opt, dict(opt_params))
    rloss_fn = rmx.gluon.loss.SoftmaxCrossEntropyLoss()
    ploss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rx, px = _both(x)
    ry, py = _both(y)
    for step in range(rounds):
        with rmx.autograd.record():
            rl = rloss_fn(ref(rx), ry)
        rl.backward()
        rt.step(len(x))
        with autograd.record():
            pl = ploss_fn(port(px), py)
        pl.backward()
        pt.step(len(x))
        _close(pl, rl.asnumpy(), msg=f"loss, step {step}")
        for rp, pp in _pairs(ref, port):
            _close(pp.data(), rp.data().asnumpy(), atol=2e-5,
                   msg=f"{pp.name}, step {step}")


@pytest.mark.parametrize("opt,opt_params", OPTIMIZERS)
def test_trainer_steps_match_reference(opt, opt_params):
    _trainer_rounds(opt, opt_params, 3)


@pytest.mark.parametrize("option", [{"clip_gradient": 1.0},
                                    {"param_idx2name": {0: "w"}},
                                    {"lazy_update": False}])
def test_trainer_refuses_unported_optimizer_options(option):
    """Options the port once refused (raising rather than ignoring them)
    are ported now: a Trainer step with each matches the reference's."""
    _trainer_rounds("sgd", dict(learning_rate=0.1, momentum=0.9, **option),
                    1)


def _ref_ce(logits, labels):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, labels[:, None], axis=-1)


def _port_ce(logits, labels):
    return -torch.log_softmax(logits, dim=-1).gather(
        -1, labels.long()[:, None])


@pytest.mark.parametrize("opt,opt_params", OPTIMIZERS)
def test_trainstep_steps_match_reference(opt, opt_params):
    ref, port, x, y = _small_pair()
    rs = RefTrainStep(ref, _ref_ce, optimizer=opt,
                      optimizer_params=opt_params)
    ps = TrainStep(port, _port_ce, optimizer=opt,
                   optimizer_params=opt_params, device="cpu")
    names = list(zip(ref.collect_params(), port.collect_params()))
    for step in range(3):
        rl, pl = rs(x, y), ps(x, y)
        assert pl.dtype == torch.float32 and pl.dim() == 0
        _close(pl, np.asarray(rl), msg=f"loss, step {step}")
        for rn, pn in names:
            _close(ps.params[pn], rs.params[rn], atol=2e-5,
                   msg=f"{pn}, step {step}")
    ps.write_back()
    for pn, p in port.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      ps.params[pn].detach().numpy())


def test_trainstep_takes_a_gluon_loss():
    """A Gluon loss block in place of a tensor function: the same step."""
    ref, port, x, y = _small_pair()
    port2 = _small_net(gluon)
    port2.initialize(ctx=CPU)
    port2(nd.array(x[:1], ctx=CPU))
    load_reference_params(port2, {k: p.data().asnumpy() for k, p in
                                  ref.collect_params().items()})
    a = TrainStep(port, _port_ce, optimizer_params={"learning_rate": 0.1},
                  device="cpu")
    b = TrainStep(port2, gluon.loss.SoftmaxCrossEntropyLoss(),
                  optimizer_params={"learning_rate": 0.1}, device="cpu")
    for _ in range(2):
        la, lb = a(x, y), b(x, y)
        assert abs(la.item() - lb.item()) < 1e-6
    for (_, ta), (_, tb) in zip(a.params.items(), b.params.items()):
        np.testing.assert_allclose(ta.detach().numpy(),
                                   tb.detach().numpy(), atol=1e-6)


# -- Block surface -------------------------------------------------------------
def test_hybridize_is_numerically_identical():
    ref, port, x, _ = _small_pair()
    px = nd.array(x, ctx=CPU)
    plain = port(px).asnumpy()
    port.hybridize()
    ref.hybridize()
    np.testing.assert_array_equal(port(px).asnumpy(), plain)
    _close(port(px), ref(rmx.nd.array(x)).asnumpy())


def test_load_reference_params_refuses_a_mismatched_net():
    ref, port, x, _ = _small_pair()
    good = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    before = [p.data().asnumpy().copy()
              for p in port.collect_params().values()]
    other = gluon.nn.HybridSequential()
    other.add(gluon.nn.Dense(3, in_units=4))
    with pytest.raises(MXNetError, match="parameters"):
        load_reference_params(other, good)            # counts differ
    bad_shape = dict(good)
    k = next(k for k in bad_shape if k.endswith("weight"))
    bad_shape[k] = np.zeros((2, 2, 2, 2), "float32")
    with pytest.raises(MXNetError, match="mismatch"):
        load_reference_params(port, bad_shape)
    swapped = list(good.items())
    swapped[1], swapped[2] = swapped[2], swapped[1]   # gamma <-> beta
    with pytest.raises(MXNetError, match="mismatch"):
        load_reference_params(port, dict(swapped))
    for p, b in zip(port.collect_params().values(), before):
        np.testing.assert_array_equal(p.data().asnumpy(), b)   # untouched


def test_block_is_an_nn_module():
    """parameters() and .double() work as on any module: the Gluon
    parameters follow, gradient buffers included."""
    _, port, x, y = _small_pair()
    assert isinstance(port, torch.nn.Module)
    assert len(list(port.parameters())) == len(port.collect_params())
    port.double()
    for p in port.collect_params().values():
        assert p.data()._data.dtype == torch.float64
        if p.grad_req != "null":
            assert p.grad()._data.dtype == torch.float64
    px = nd.array(x, ctx=CPU, dtype="float64")
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(port(px),
                                                    nd.array(y, ctx=CPU))
    loss.backward()
    assert port[0].weight.grad().dtype == np.float64


# -- initializers ---------------------------------------------------------------
@pytest.mark.parametrize("name,kwargs,shape,dist,scale", [
    ("uniform", {}, (256, 256), "uniform", 0.07),
    ("uniform", {"scale": 0.5}, (256, 256), "uniform", 0.5),
    ("normal", {"sigma": 0.3}, (256, 256), "normal", 0.3),
    # Xavier "avg": fan_in 32*9, fan_out 64*9; "in": fan_in
    ("xavier", {}, (64, 32, 3, 3), "uniform", (3 / 432) ** 0.5),
    ("xavier", {"rnd_type": "gaussian", "factor_type": "in",
                "magnitude": 2}, (64, 32, 3, 3), "normal", (2 / 288) ** 0.5),
    ("msraprelu", {}, (64, 32, 3, 3), "normal",
     (2 / (1 + 0.25 ** 2) / 432) ** 0.5),
])
def test_initializer_distributions(name, kwargs, shape, dist, scale):
    """A draw of ~65k values, from the port and from the reference, each
    held to the distribution it should follow: mean 0 and std scale/sqrt(3)
    (uniform on +-scale, all inside and reaching near the bound) or scale
    (normal), within 2%: the sampling error of the std is near 0.5%."""
    ref_p = rmx.gluon.Parameter("w_weight", shape=shape)
    ref_p.initialize(init=rmx.init.create(name, **kwargs))
    port_p = gluon.Parameter("w_weight", shape=shape)
    port_p.initialize(init=mx.init.create(name, **kwargs), ctx=CPU)
    std = scale / 3 ** 0.5 if dist == "uniform" else scale
    for draw in (ref_p.data().asnumpy(), port_p.data().asnumpy()):
        assert draw.dtype == np.float32 and draw.shape == shape
        assert abs(draw.std() / std - 1) < 0.02
        assert abs(draw.mean()) < 0.02 * std
        if dist == "uniform":
            assert scale * 0.99 < np.abs(draw).max() <= scale


@pytest.mark.parametrize("name,suffix,value", [
    ("zero", "weight", 0.0), ("one", "weight", 1.0),
    ("constant", "weight", 0.25), ("uniform", "bias", 0.0),
    ("uniform", "gamma", 1.0), ("uniform", "running_var", 1.0),
    ("uniform", "running_mean", 0.0)])
def test_initializer_fills_by_name(name, suffix, value):
    init = mx.init.create(name, **({"value": 0.25} if name == "constant"
                                   else {}))
    p = gluon.Parameter(f"layer0_{suffix}", shape=(3, 4))
    p.initialize(init=init, ctx=CPU)
    np.testing.assert_array_equal(p.data().asnumpy(), value)


def test_random_seed_makes_draws_reproducible():
    def draw():
        p = gluon.Parameter("w_weight", shape=(16,))
        p.initialize(init=mx.init.Normal(1.0), ctx=CPU)
        return p.data().asnumpy()

    mx.random.seed(3)
    a, b = draw(), draw()
    mx.random.seed(3)
    c = draw()
    mx.random.seed(4)
    d = draw()
    np.testing.assert_array_equal(a, c)
    assert not np.array_equal(a, b) and not np.array_equal(a, d)


def test_entry_points_default_to_cuda(monkeypatch):
    net = _small_net(gluon)
    cpu_net = _small_net(gluon)
    cpu_net.initialize(ctx=CPU)
    cpu_net(nd.zeros((1, 8, 8, 3), ctx=CPU))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        net.initialize()
    with pytest.raises(MXNetError, match="no CUDA device"):
        TrainStep(cpu_net, _port_ce)
