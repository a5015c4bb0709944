"""ResNet training on the port (mxnet_tpu_torch.gluon.model_zoo.vision,
gluon.Trainer, parallel.TrainStep) held against the reference on the CPU.

The reference initialises each net, its weights (running stats included)
are carried over with ``load_reference_params``, and the same numpy batch
goes through both.  Three checks per net: logits and gradients at the
initial weights, then parameters and running stats after two SGD steps
(lr 0.01, momentum 0.9, wd 1e-4).

Tolerances (fp32, of the larger of 1 and each tensor's magnitude): logits
and gradients 1e-4, parameters after two steps 5e-4.  Training a ResNet
at batch 4 amplifies rounding: perturbing the reference's own weights by
1e-6 (relative) moves its parameters by 2.5e-3 after these two steps
(1.7e-2 at lr 0.1, which is why lr is 0.01 here); the port lands within
1e-4 of the reference.  resnet50_v1 at 32x32 and batch 2 normalises its
last stage over 2 values per channel, where train-mode BatchNorm turns
1e-6 input differences into O(1) output differences, so that case trains
in predict mode (running stats), which still runs every bottleneck.
bf16: the port's step must land as close to the fp32 reference as the
reference's own bf16 step does, within 3x.

The reference draws its weights from its global RNG, seeded here (and
restored after: ``_ref_rng``), so they do not depend on which tests ran
before.  Train-mode ResNet-18 at batch 4 is ill-conditioned all the same:
where a ReLU's input lies within rounding of zero, the fp32 forward may
take the other branch than the fp64 one, depending on the order of a sum
(at OMP_NUM_THREADS=5 one input 1.6e-6 from zero, 2e-6 the layer's fp32
error, moves a convolution's weight gradient by 1.6e-2).  So each ResNet-18
case also runs the port in fp64 twice: once taking the fp32 run's ReLU
branches (``_relu_branches``), once its own.  The fp32 run must stay
within FWD_TOL of the first at every ReLU input, which makes every branch
they disagree on a rounding-scale one, and within the usual tolerance of
it in every gradient, loss and parameter: fp32 arithmetic alone.  It must
land within the usual tolerance of the reference plus the distance between
the two fp64 runs: the effect of those branches alone.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as rmx
from mxnet_tpu.gluon.model_zoo import vision as ref_vision
from mxnet_tpu.parallel.data_parallel import TrainStep as RefTrainStep
from mxnet_tpu.parallel.functional import functionalize as ref_functionalize
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import load_reference_params
from mxnet_tpu_torch.gluon.model_zoo import vision as port_vision
from mxnet_tpu_torch.ops import nn as port_nn
from mxnet_tpu_torch.parallel import TrainStep, functionalize
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
GRAD_TOL = 1e-4
STEP_TOL = 5e-4
# the reference's global RNG is seeded with this for the weights (the key
# an unseeded RNG starts from, so these are the weights of a fresh process)
REF_SEED = 0
# the fp32 forward's ReLU inputs within this of the fp64 forward's that takes
# the same branches, relative to each call's largest input: fp32 rounding
# through ResNet-18 reaches 3.2e-6 in the first forward and 1.3e-5 in the
# second step's (NHWC, OMP_NUM_THREADS=1); rounding one layer's output to
# bf16 would be 4e-3
FWD_TOL = 5e-5


def _ref_ce(logits, labels):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, labels[:, None], axis=-1)


def _port_ce(logits, labels):
    return -torch.log_softmax(logits, dim=-1).gather(
        -1, labels.long()[:, None])


def _close(port, ref, tol, msg="", slack=0.0):
    port = np.asarray(port.detach().float()) if isinstance(
        port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, dtype=np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale + slack,
                               err_msg=msg)


@contextlib.contextmanager
def _ref_rng():
    """The reference's global RNG seeded with REF_SEED while open, and
    restored after: the weights drawn inside do not depend on the tests
    that ran before."""
    state = rmx.random.get_state()
    rmx.random.seed(REF_SEED)
    try:
        yield
    finally:
        rmx.random.set_state(state)


def _build(name, layout, batch, **kw):
    """(reference net, port net with its weights, x, y, name pairs).  The
    reference builds with its eager jit cache off: one-off initializer and
    shape-settling ops would each compile."""
    size = 32
    one = (1, size, size, 3) if layout == "NHWC" else (1, 3, size, size)
    prev = rmx.nd.set_eager_jit(False)
    try:
        ref = getattr(ref_vision, name)(classes=10, layout=layout, **kw)
        ref.initialize()
        ref(rmx.nd.zeros(one))
    finally:
        rmx.nd.set_eager_jit(prev)
    port = getattr(port_vision, name)(classes=10, layout=layout, **kw)
    port.initialize(ctx=CPU)
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()})
    r = np.random.RandomState(0)
    x = r.uniform(-1, 1, (batch,) + one[1:]).astype("float32")
    y = r.randint(0, 10, (batch,)).astype("int32")
    names = list(zip(ref.collect_params(), port.collect_params()))
    return ref, port, x, y, names


def _ref_steps(ref, x, y, names, train_mode=True, dtype=None):
    """The reference's two TrainStep steps: (losses, {port name: params})."""
    rs = RefTrainStep(ref, _ref_ce, optimizer="sgd", optimizer_params=OPT,
                      train_mode=train_mode, dtype=dtype)
    losses = [float(np.asarray(rs(x, y))) for _ in range(2)]
    return losses, {pn: np.asarray(rs.params[rn], np.float32)
                    for rn, pn in names}


def _port_steps(port, x, y, train_mode=True, dtype=None):
    ps = TrainStep(port, _port_ce, optimizer="sgd", optimizer_params=OPT,
                   train_mode=train_mode, dtype=dtype, device="cpu")
    return [ps(x, y).item() for _ in range(2)], ps


@contextlib.contextmanager
def _relu_branches(replay=None):
    """While open, the port's ReLU keeps the input of each call in the list
    it yields.  Without ``replay`` it is ``torch.relu``; with another run's
    list it passes exactly the elements that run passed (``x * (r > 0)``),
    so an fp64 run takes the branches of the fp32 run recorded there."""
    inputs = []

    def relu(x):
        inputs.append(x.detach().clone())
        if replay is None:
            return torch.relu(x)
        return x * (replay[len(inputs) - 1] > 0).to(x.dtype)

    saved = port_nn._ACT["relu"]
    port_nn._ACT["relu"] = relu
    try:
        yield inputs
    finally:
        port_nn._ACT["relu"] = saved


def _check_branches(inputs32, inputs64):
    """Every ReLU input of the fp32 run within FWD_TOL of the fp64 run's
    that took its branches: the two differ by rounding alone, so a branch
    they disagree on had its input within rounding of zero."""
    assert len(inputs32) == len(inputs64)
    for i, (a, b) in enumerate(zip(inputs32, inputs64)):
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= FWD_TOL, (f"ReLU input {i}", err)


def _fp64_steps(port, x, y, layout, replay=None):
    """The port's two fp64 TrainStep steps from ``port``'s weights, taking
    the branches recorded in ``replay`` (or its own): (losses, {port name:
    params after the steps}, ReLU inputs)."""
    net = port_vision.resnet18_v1(classes=10, layout=layout, thumbnail=True)
    net.initialize(ctx=CPU)
    load_reference_params(net, {k: p.data().asnumpy().astype(np.float64)
                                for k, p in port.collect_params().items()})
    with _relu_branches(replay) as inputs:
        losses, ps = _port_steps(net.double(), x.astype(np.float64), y)
    return losses, {pn: ps.params[n].detach().numpy() for pn, n in zip(
        port.collect_params(), net.collect_params())}, inputs


def _fp64_grads(pf, pp, trainable, x, y, replay=None):
    """The port's fp64 gradients of the loss, taking the branches recorded
    in ``replay`` (or its own): (gradients, ReLU inputs)."""
    p64 = {k: v.detach().double() for k, v in pp.items()}
    leaves = {pn: p64[pn].clone().requires_grad_() for pn in trainable}
    with _relu_branches(replay) as inputs:
        out = pf(dict(p64, **leaves), torch.from_numpy(x).double())
    loss = _port_ce(out, torch.from_numpy(y)).mean()
    return torch.autograd.grad(loss, list(leaves.values())), inputs


@pytest.fixture(scope="module")
def resnet18():
    """Per layout: the nets, the batch, the reference's two steps and the
    port's two fp64 steps on its own branches."""
    out = {}
    with _ref_rng():
        nets = {layout: _build("resnet18_v1", layout, 4, thumbnail=True)
                for layout in ("NCHW", "NHWC")}
    for layout, (ref, port, x, y, names) in nets.items():
        out[layout] = (ref, port, x, y, names,
                       _ref_steps(ref, x, y, names),
                       _fp64_steps(port, x, y, layout)[:2])
    return out


def _check_steps(ref_result, losses, params, tol=STEP_TOL, fp64=None):
    """Losses within GRAD_TOL and parameters within ``tol`` of the
    reference's.  With ``fp64`` = (the port's fp64 steps on the fp32 run's
    branches, on its own), the fp32 run must also be within those of the
    first, and may stray from the reference by the distance between the
    two beyond them (module docstring)."""
    ref_losses, ref_params = ref_result
    for i, (rl, pl) in enumerate(zip(ref_losses, losses)):
        slack = 0.0
        if fp64:
            (same, _), (own, _) = fp64
            assert abs(pl - same[i]) <= GRAD_TOL * max(1, abs(rl)), \
                (i, same[i], pl)
            slack = abs(same[i] - own[i])
        assert abs(pl - rl) <= GRAD_TOL * max(1, abs(rl)) + slack, \
            (i, rl, pl)
    for pn, rv in ref_params.items():
        slack = 0.0
        if fp64:
            (_, same), (_, own) = fp64
            _close(params[pn], same[pn], tol, f"{pn} against fp64")
            slack = float(np.abs(same[pn] - own[pn]).max())
        _close(params[pn], rv, tol, pn, slack=slack)


def _steps_against_fp64(port, x, y, layout, own, run):
    """``run()`` (the fp32 steps: losses, params) with its ReLU inputs
    recorded, and the fp64 steps on its branches, checked: (losses,
    params, the ``fp64`` argument of _check_steps)."""
    with _relu_branches() as r32:
        losses, params = run()
    *same, r64 = _fp64_steps(port, x, y, layout, replay=r32)
    _check_branches(r32, r64)
    return losses, params, (same, own)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet18_logits_and_gradients(resnet18, layout):
    """Train mode: logits, loss and the gradient of every trainable
    parameter at the initial weights; each gradient within GRAD_TOL of the
    port's fp64 gradient on the same ReLU branches, and of the reference's
    plus the effect of the branches rounding flipped (module docstring)."""
    ref, port, x, y, names, _, _ = resnet18[layout]
    rf, rp = ref_functionalize(ref, train_mode=True)
    pf, pp = functionalize(port, train_mode=True)
    p2r = {pn: rn for rn, pn in names}
    trainable = [pn for pn, p in port.collect_params().items()
                 if p.grad_req != "null"]

    @jax.jit
    def ref_grads(tp, rest):
        def loss(tp):
            out = rf(dict(rest, **tp), jax.random.PRNGKey(0),
                     jnp.asarray(x))
            return jnp.mean(_ref_ce(out, jnp.asarray(y))), out
        return jax.value_and_grad(loss, has_aux=True)(tp)

    tp = {p2r[pn]: rp[p2r[pn]] for pn in trainable}
    (rl, rout), rg = ref_grads(tp, {k: v for k, v in rp.items()
                                    if k not in tp})
    leaves = {pn: pp[pn].detach().clone().requires_grad_()
              for pn in trainable}
    with _relu_branches() as r32:
        out = pf(dict(pp, **leaves), torch.from_numpy(x))
    loss = _port_ce(out, torch.from_numpy(y)).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _close(out, rout, GRAD_TOL, "logits")
    _close(loss, rl, GRAD_TOL, "loss")
    same, r64 = _fp64_grads(pf, pp, trainable, x, y, replay=r32)
    own, _ = _fp64_grads(pf, pp, trainable, x, y)
    _check_branches(r32, r64)
    for pn, g, gs, go in zip(leaves, grads, same, own):
        _close(g, gs.numpy(), GRAD_TOL, f"grad of {pn} against fp64")
        _close(g, rg[p2r[pn]], GRAD_TOL, f"grad of {pn}",
               slack=float((gs - go).abs().max()))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet18_trainstep_two_steps(resnet18, layout):
    _, port, x, y, _, ref_result, own = resnet18[layout]

    def run():
        losses, ps = _port_steps(port, x, y)
        return losses, ps.params

    losses, params, fp64 = _steps_against_fp64(port, x, y, layout, own, run)
    _check_steps(ref_result, losses, params, fp64=fp64)
    assert any("running_var" in pn and not torch.equal(
        v, port.collect_params()[pn].data()._data)
        for pn, v in params.items()), "running stats must move"


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet18_gluon_loop_two_steps(resnet18, layout):
    """The imperative path (record / backward / Trainer.step, on a fresh
    copy of the weights) against the reference's TrainStep: the two SGD
    forms agree while the learning rate is constant."""
    ref, port, x, y, _, ref_result, own = resnet18[layout]

    def run():
        net = port_vision.resnet18_v1(classes=10, layout=layout,
                                      thumbnail=True)
        net.initialize(ctx=CPU)
        load_reference_params(net, {k: p.data().asnumpy() for k, p in
                                    ref.collect_params().items()})
        trainer = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        X, Y = nd.array(x, ctx=CPU), nd.array(y, ctx=CPU)
        losses = []
        for _ in range(2):
            with autograd.record():
                loss = loss_fn(net(X), Y)
            loss.backward()
            trainer.step(len(x))
            losses.append(float(loss.mean().asscalar()))
        return losses, {pn: p.data()._data for pn, p in zip(
            port.collect_params(), net.collect_params().values())}

    losses, params, fp64 = _steps_against_fp64(port, x, y, layout, own, run)
    _check_steps(ref_result, losses, params, fp64=fp64)


def test_resnet50_bottleneck_two_steps():
    with _ref_rng():
        ref, port, x, y, names = _build("resnet50_v1", "NHWC", 2)
    assert len(names) == 299
    ref_result = _ref_steps(ref, x, y, names, train_mode=False)
    losses, ps = _port_steps(port, x, y, train_mode=False)
    _check_steps(ref_result, losses, ps.params)


def test_trainstep_bf16(resnet18):
    ref, port, x, y, names, (r32_losses, r32), _ = resnet18["NHWC"]
    r16_losses, r16 = _ref_steps(ref, x, y, names, dtype="bfloat16")
    p16_losses, ps16 = _port_steps(port, x, y, dtype="bfloat16")
    for r32l, r16l, p16l in zip(r32_losses, r16_losses, p16_losses):
        assert abs(p16l - r32l) <= 3 * abs(r16l - r32l) + 1e-5, \
            (r32l, r16l, p16l)
    assert abs(p16_losses[0] - r32_losses[0]) > 1e-6, \
        "the bf16 step must compute in bf16"
    for pn, v in ps16.params.items():
        assert v.dtype == torch.float32                   # master weights
        noise = np.abs(r16[pn] - r32[pn]).max()
        err = np.abs(v.detach().numpy() - r32[pn]).max()
        assert err <= 3 * noise + 1e-5, (pn, err, noise)


@pytest.fixture(scope="module")
def resnet18_v2():
    with _ref_rng():
        ref, _, x, _, _ = _build("resnet18_v2", "NHWC", 4, thumbnail=True)
    port = port_vision.get_model("resnet18_v2", classes=10, layout="NHWC",
                                 thumbnail=True)
    port.initialize(ctx=CPU)
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()})
    return ref, port, x


@pytest.mark.parametrize("train", [False, True])
def test_resnet18_v2_from_get_model(resnet18_v2, train):
    """The v2 path (pre-activation blocks, the input BatchNorm without
    scale and center) through get_model: logits in predict and train
    mode at the initial weights."""
    ref, port, x = resnet18_v2
    with (rmx.autograd.train_mode() if train
          else rmx.autograd.predict_mode()):
        rout = ref(rmx.nd.array(x)).asnumpy()
    with autograd.train_mode() if train else autograd.predict_mode():
        out = port(nd.array(x, ctx=CPU))
    _close(out._data, rout, GRAD_TOL, "logits")
