"""The port's optimizers and learning-rate schedulers
(``mxnet_tpu_torch.optimizer``, ``mxnet_tpu_torch.lr_scheduler``) held
against the reference's on the CPU.

Every registered optimizer runs 5 updates over 3 small fp32 tensors
(weights and gradients from a numpy seed, the same on both sides) through
``get_updater``, plain, with ``clip_gradient``, under a ``PolyScheduler``
with warm-up, and with ``set_lr_mult`` / ``set_wd_mult`` by index; each
weight and state agrees within 1e-6 of its largest magnitude (fp32, the
same arithmetic in another order).  SGLD draws its noise from another
generator than the reference's: its update less the deterministic part is
held to N(0, lr) by the KS statistic (p 1e-6).  The schedulers are pure
Python on both sides: their learning rates over updates 0 to 300 are
equal.

C10: through ``gluon.Trainer`` the port applies a Parameter's ``lr_mult``
and ``wd_mult`` (MXNet 1.x's lookup of ``param_dict`` by index); the
reference ignores both.  Held to a numpy formula of SGD's step.
"""
import math

import numpy as np
import pytest
import scipy.stats
import torch

import chip_smoke
import mxnet_tpu as rmx
from mxnet_tpu import lr_scheduler as ref_lrs
from mxnet_tpu.optimizer import optimizer as ref_opt
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, lr_scheduler, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.optimizer import optimizer as port_opt
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
TOL = 1e-6
SHAPES = [(4, 5), (7,), (3, 2, 2)]
STEPS = 5

# (registry name, hyper-parameters): every registered optimizer, and the
# variants with state or arithmetic of their own
OPTIMIZERS = [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("nag", {"momentum": 0.9}),
    ("adam", {}),
    ("adagrad", {}),
    ("adadelta", {}),
    ("rmsprop", {}),
    ("rmsprop", {"clip_weights": 0.3}),
    ("rmsprop", {"centered": True}),
    ("ftrl", {}),
    ("ftml", {}),
    ("signsgd", {}),
    ("signum", {"wd_lh": 0.01}),
    ("lamb", {}),
    ("lamb", {"lower_bound": 0.5, "upper_bound": 2.0}),
    ("lamb", {"bias_correction": False}),
    ("nadam", {}),
    ("adamax", {}),
    ("test", {}),
]

VARIANTS = ["plain", "clip", "scheduler", "mult"]


@pytest.fixture(scope="module", autouse=True)
def _reference_eager():
    """The reference's ops without its eager jit cache: each update's
    attributes (lr, t) change every call, and the cache would compile
    each new value."""
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


def _arrays(seed):
    r = np.random.RandomState(seed)
    weights = [r.randn(*s).astype("float32") for s in SHAPES]
    grads = [[r.randn(*s).astype("float32") for s in SHAPES]
             for _ in range(STEPS)]
    return weights, grads


def _make(pkg, name, params, variant):
    """The optimizer ``name`` of package ``pkg`` ("ref" or "port") in
    ``variant``."""
    kw = dict(params, learning_rate=0.05, wd=0.01, rescale_grad=0.5)
    if name == "adadelta":
        kw.pop("learning_rate")
    if variant == "clip":
        kw["clip_gradient"] = 0.2
    if variant == "scheduler":
        lrs = ref_lrs if pkg == "ref" else lr_scheduler
        kw["lr_scheduler"] = lrs.PolyScheduler(
            max_update=20, base_lr=0.05, pwr=2, final_lr=1e-3,
            warmup_steps=3, warmup_begin_lr=0.01)
    opt = (ref_opt if pkg == "ref" else port_opt).create(name, **kw)
    if variant == "mult":
        opt.set_lr_mult({0: 0.5, 2: 2.0})
        opt.set_wd_mult({1: 0.0, 2: 3.0})
    return opt


def _state_list(state):
    if state is None:
        return []
    return list(state) if isinstance(state, tuple) else [state]


def _run(pkg, name, params, variant, seed=0):
    """The weights and states after STEPS updates, and the optimizer."""
    weights, grads = _arrays(seed)
    lib = rmx.nd if pkg == "ref" else nd
    kw = {} if pkg == "ref" else {"ctx": CPU}
    opt = _make(pkg, name, params, variant)
    updater = (ref_opt if pkg == "ref" else port_opt).get_updater(opt)
    ws = [lib.array(w, **kw) for w in weights]
    for step in range(STEPS):
        for i, (w, g) in enumerate(zip(ws, grads[step])):
            updater(i, lib.array(g, **kw), w)
    states = [[s.asnumpy() for s in _state_list(updater.states[i])]
              for i in range(len(ws))]
    return [w.asnumpy() for w in ws], states, opt


def _close(port, ref, msg):
    ref = np.asarray(ref, np.float32)
    scale = max(1e-30, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=TOL * scale,
                               err_msg=msg)


def test_both_registries_hold_the_same_names():
    assert sorted(port_opt._REG._fmap) == sorted(ref_opt._REG._fmap)
    assert len(port_opt._REG._fmap) == 15


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name,params", OPTIMIZERS,
                         ids=[f"{n}-{'-'.join(p) or 'default'}"
                              for n, p in OPTIMIZERS])
def test_optimizer_updates_match_reference(name, params, variant):
    rw, rs, ropt = _run("ref", name, params, variant)
    pw, ps, popt = _run("port", name, params, variant)
    for i, (r, p) in enumerate(zip(rw, pw)):
        _close(p, r, f"{name} {variant}: weight {i}")
        assert not np.array_equal(p, _arrays(0)[0][i]) or variant == "mult"
    for i, (r, p) in enumerate(zip(rs, ps)):
        assert len(r) == len(p)
        for j, (a, b) in enumerate(zip(r, p)):
            _close(b, a, f"{name} {variant}: state {j} of weight {i}")
    # Test counts no updates, in both packages
    assert popt.num_update == ropt.num_update == \
        (0 if name == "test" else STEPS)
    if name == "nadam":
        assert popt.m_schedule == pytest.approx(ropt.m_schedule, rel=1e-12)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sgld_noise_is_normal_with_variance_lr(variant):
    """SGLD's update less its deterministic part, -lr / 2 * (clip(rescale
    * g) + wd * w), is N(0, lr): the KS statistic over 2e5 draws."""
    r = np.random.RandomState(3)
    w0 = r.randn(400, 500).astype("float32")
    g = r.randn(400, 500).astype("float32")
    opt = _make("port", "sgld", {}, variant)
    w = nd.array(w0, ctx=CPU)
    opt.update(2, w, nd.array(g, ctx=CPU), None)
    lr, wd = opt._get_lr(2), opt._get_wd(2)
    gg = g * 0.5
    if variant == "clip":
        gg = np.clip(gg, -0.2, 0.2)
    noise = (w.asnumpy().astype(np.float64) - w0
             + lr / 2 * (gg + wd * w0)) / math.sqrt(lr)
    chip_smoke.distribution_check("sgld", torch.from_numpy(noise.ravel()),
                                  scipy.stats.norm(), True)


def test_lamb_trust_ratio_is_pinned():
    """A LAMB whose trust ratio is forced to 1 (an Adam step with weight
    decay) misses the reference by far more than the tolerance."""
    rw, _, _ = _run("ref", "lamb", {}, "plain")
    orig = port_opt.lamb_trust_ratio
    port_opt.lamb_trust_ratio = lambda r1, r2: torch.ones_like(r1)
    try:
        pw, _, _ = _run("port", "lamb", {}, "plain")
    finally:
        port_opt.lamb_trust_ratio = orig
    dev = max(np.abs(p - r).max() / np.abs(r).max() for p, r in zip(pw, rw))
    assert dev > 1e3 * TOL


def test_scheduler_forbids_set_learning_rate():
    for pkg, err in (("ref", rmx.base.MXNetError), ("port", MXNetError)):
        opt = _make(pkg, "sgd", {}, "scheduler")
        with pytest.raises(err):
            opt.set_learning_rate(0.1)
        opt = _make(pkg, "sgd", {}, "plain")
        opt.set_learning_rate(0.25)
        assert opt.lr == 0.25


def test_optimizer_pickles_without_its_param_dict():
    import pickle

    opt = _make("port", "adam", {}, "plain")
    opt.param_dict = {0: object()}
    back = pickle.loads(pickle.dumps(opt))
    assert back.param_dict == {} and back.lr == opt.lr


SCHEDULERS = [
    ("FactorScheduler", dict(step=7, factor=0.8, stop_factor_lr=1e-3,
                             base_lr=0.1)),
    ("FactorScheduler", dict(step=11, factor=0.5, base_lr=0.2,
                             warmup_steps=5, warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[10, 40, 41, 200], factor=0.3,
                                  base_lr=0.1)),
    ("MultiFactorScheduler", dict(step=[30, 90], factor=0.1, base_lr=0.4,
                                  warmup_steps=20, warmup_mode="constant")),
    ("PolyScheduler", dict(max_update=250, base_lr=0.1, pwr=2,
                           final_lr=1e-4, warmup_steps=25,
                           warmup_begin_lr=1e-3)),
    ("PolyScheduler", dict(max_update=300, base_lr=0.01, pwr=1)),
    ("CosineScheduler", dict(max_update=280, base_lr=0.1, final_lr=1e-3,
                             warmup_steps=10, warmup_mode="constant")),
    ("CosineScheduler", dict(max_update=100, base_lr=0.05)),
]


@pytest.mark.parametrize("cls,kw", SCHEDULERS,
                         ids=[f"{c}-{i}" for i, (c, _) in
                              enumerate(SCHEDULERS)])
def test_schedulers_match_reference_exactly(cls, kw):
    ref = getattr(ref_lrs, cls)(**kw)
    port = getattr(lr_scheduler, cls)(**kw)
    want = [ref(n) for n in range(301)]
    assert [port(n) for n in range(301)] == want
    assert len(set(want)) > 3


def _dense_pair():
    ref, port = rmx.gluon.nn.Dense(3, in_units=4), \
        gluon.nn.Dense(3, in_units=4)
    ref.initialize()
    port.initialize(ctx=CPU)
    gluon.load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                       ref.collect_params().items()})
    return ref, port


def _sgd_step(pkg, net, x, lr, wd):
    g = rmx.gluon if pkg == "ref" else gluon
    ag = rmx.autograd if pkg == "ref" else autograd
    xs = rmx.nd.array(x) if pkg == "ref" else nd.array(x, ctx=CPU)
    trainer = g.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": lr, "wd": wd})
    with ag.record():
        loss = (net(xs) ** 2).sum()
    loss.backward()
    grads = [p.grad().asnumpy().copy() for p in
             net.collect_params().values()]
    trainer.step(1)
    return grads, trainer


def test_c10_parameter_multipliers_reach_the_update_through_trainer():
    """C10.  The weight with lr_mult 0 does not move; the bias with
    wd_mult 0 takes lr * g alone (numpy: w - lr * lr_mult * (g + wd *
    wd_mult * w)).  The reference, which looks param_dict up by name,
    moves the frozen weight and decays the bias."""
    lr, wd = 0.1, 0.5
    x = np.random.RandomState(4).randn(2, 4).astype("float32")
    ref, port = _dense_pair()
    before = [p.data().asnumpy().copy() for p in
              port.collect_params().values()]
    for net in (ref, port):
        net.weight.lr_mult = 0.0
        net.collect_params(".*bias").setattr("wd_mult", 0.0)
    grads, trainer = _sgd_step("port", port, x, lr, wd)
    w, b = (p.data().asnumpy() for p in port.collect_params().values())
    np.testing.assert_array_equal(w, before[0])
    np.testing.assert_allclose(b, before[1] - lr * grads[1], rtol=0,
                               atol=1e-7)
    assert trainer.optimizer._get_wd(1) == 0.0
    assert trainer.optimizer._get_lr(0) == 0.0
    assert trainer.step_count == 1
    _, rtrainer = _sgd_step("ref", ref, x, lr, wd)
    rw, rb = (p.data().asnumpy() for p in ref.collect_params().values())
    assert np.abs(rw - before[0]).max() > 1e-3       # the lr_mult ignored
    assert rtrainer.optimizer._get_wd(1) == wd       # the wd_mult ignored


def test_trainer_learning_rate_follows_the_scheduler():
    _, port = _dense_pair()
    sched = lr_scheduler.CosineScheduler(max_update=10, base_lr=0.2,
                                         warmup_steps=2)
    trainer = gluon.Trainer(port.collect_params(), "nag",
                            {"learning_rate": 0.2, "momentum": 0.9,
                             "lr_scheduler": sched})
    x = np.ones((1, 4), "float32")
    rates = []
    for _ in range(4):
        rates.append(trainer.learning_rate)
        with autograd.record():
            loss = port(nd.array(x, ctx=CPU)).sum()
        loss.backward()
        trainer.step(1)
    assert rates == [sched(n) for n in range(4)]
    assert trainer.step_count == 4
    with pytest.raises(MXNetError):
        trainer.set_learning_rate(0.1)


def test_trainer_rebinds_an_optimizer_instance():
    _, port = _dense_pair()
    opt = port_opt.create("sgd", learning_rate=0.1)
    trainer = gluon.Trainer(port.collect_params(), opt)
    params = list(port.collect_params().values())
    assert trainer.optimizer is opt
    assert opt.param_dict == dict(enumerate(params))
    with pytest.raises(MXNetError):
        gluon.Trainer(port.collect_params(), opt, {"learning_rate": 0.2})
