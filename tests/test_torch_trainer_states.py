"""``Trainer.save_states`` / ``load_states`` across the two packages.

For every registered optimizer: two Trainer steps of a Dense layer
(weights and inputs from a numpy seed, a warm-up ``PolyScheduler``) in one
package, ``save_states`` there, ``load_states`` into the other package's
Trainer over the same weights, then one more step on both sides: the
weights agree within 1e-5 of their largest magnitude (fp32, the same
arithmetic in another order), both ways.  The restored optimizer keeps the
update counts and the scheduler's position (mid-warm-up); LAMB's moments
and Nadam's shared ``m_schedule`` are compared as named cases.  SGLD draws
its noise from another generator in each package, so its next update is
not compared: its restored counts and learning rate are.

The port reads the reference's file without importing the reference (its
unpickler maps the reference's classes to the port's); the reference reads
the port's, whose pickle names the reference's classes.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as rmx
from mxnet_tpu import autograd as ref_ag
from mxnet_tpu import gluon as ref_gluon
from mxnet_tpu import lr_scheduler as ref_lrs
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, lr_scheduler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.optimizer import optimizer as port_opt
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
OPTIMIZERS = [
    ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}), ("adam", {}),
    ("adagrad", {}), ("adadelta", {}), ("rmsprop", {"centered": True}),
    ("ftrl", {}), ("ftml", {}), ("signsgd", {}), ("signum", {}),
    ("lamb", {}), ("nadam", {}), ("adamax", {}), ("sgld", {}), ("test", {}),
]
IDS = [name for name, _ in OPTIMIZERS]


@pytest.fixture(scope="module", autouse=True)
def _reference_eager():
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


class Side:
    """One package's Dense(3) on 4 inputs, its Trainer, and one step."""

    def __init__(self, pkg, name, kw, weights):
        self.pkg = pkg
        g, lrs = (gluon, lr_scheduler) if pkg == "port" else \
            (ref_gluon, ref_lrs)
        self.net = g.nn.Dense(3, in_units=4)
        ctx = mx.cpu() if pkg == "port" else rmx.cpu()
        self.net.initialize(ctx=ctx)
        self.set_weights(weights)
        sched = lrs.PolyScheduler(max_update=100, base_lr=0.05, pwr=1,
                                  warmup_steps=5, warmup_begin_lr=0.01)
        self.trainer = g.Trainer(self.net.collect_params(), name,
                                 dict(kw, learning_rate=0.05, wd=0.01,
                                      lr_scheduler=sched))

    def params(self):
        return [self.net.weight, self.net.bias]

    def weights(self):
        return [p.data().asnumpy() for p in self.params()]

    def set_weights(self, weights):
        for p, w in zip(self.params(), weights):
            p.set_data(mx.nd.array(w, ctx=mx.cpu()) if self.pkg == "port"
                       else rmx.nd.array(w))

    def step(self, x):
        if self.pkg == "port":
            xs, rec = mx.nd.array(x, ctx=mx.cpu()), autograd.record
        else:
            xs, rec = rmx.nd.array(x), ref_ag.record
        with rec():
            loss = (self.net(xs) ** 2).sum()
        loss.backward()
        self.trainer.step(x.shape[0])

    def optimizer(self):
        return self.trainer._optimizer


def _inputs(seed):
    r = np.random.RandomState(seed)
    weights = [r.randn(3, 4).astype("float32"),
               r.randn(3).astype("float32")]
    return weights, [r.randn(2, 4).astype("float32") for _ in range(3)]


def _close(a, b):
    return all(np.abs(x - y).max() <= TOL * max(1.0, np.abs(y).max())
               for x, y in zip(a, b))


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=IDS)
def test_states_cross_packages(name, kw, direction, tmp_path):
    weights, xs = _inputs(7)
    src_pkg, dst_pkg = ("reference", "port") \
        if direction == "reference_to_port" else ("port", "reference")
    src = Side(src_pkg, name, kw, weights)
    for x in xs[:2]:
        src.step(x)
    path = os.path.join(tmp_path, "trainer.states")
    src.trainer.save_states(path)
    dst = Side(dst_pkg, name, {}, src.weights())
    dst.trainer.load_states(path)
    so, do = src.optimizer(), dst.optimizer()
    assert type(do).__name__ == type(so).__name__
    # the "test" optimizer counts no updates, in either package
    assert do.num_update == so.num_update == (0 if name == "test" else 2)
    assert do._index_update_count == so._index_update_count
    # the scheduler's position: mid-warm-up, the same next learning rate
    assert do.lr_scheduler(do.num_update) == so.lr_scheduler(so.num_update)
    assert do.param_dict is not None and len(do.param_dict) in (0, 2)
    if name == "nadam":
        assert do.m_schedule == so.m_schedule != 1.0
    if name == "lamb":
        ss, ds = src.trainer, dst.trainer
        s_states = (ss._updater if src_pkg == "port"
                    else ss._updaters[0]).states
        d_states = (ds._updater if dst_pkg == "port"
                    else ds._updaters[0]).states
        for i in (0, 1):
            for a, b in zip(s_states[i], d_states[i]):
                np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    if name == "sgld":
        return
    src.step(xs[2])
    dst.step(xs[2])
    assert _close(dst.weights(), src.weights()), \
        f"{name}: the step after the load differs"


def test_port_file_names_the_reference_classes(tmp_path):
    side = Side("port", "lamb", {}, _inputs(0)[0])
    side.step(_inputs(0)[1][0])
    blob = side.trainer._states_blob()
    import pickletools

    names = [arg for op, arg, _ in pickletools.genops(blob)
             if op.name == "SHORT_BINUNICODE"]
    assert "mxnet_tpu.optimizer.optimizer" in names
    assert "mxnet_tpu.lr_scheduler" in names
    assert not any(n.startswith("mxnet_tpu_torch") for n in names)
    states, opt = pickle.loads(blob)     # the reference's own unpickler
    assert type(opt).__module__ == "mxnet_tpu.optimizer.optimizer"
    assert all(isinstance(a, np.ndarray) for v in states.values()
               for a in v)


def test_load_refuses_other_reference_globals(tmp_path):
    blob = pickle.dumps(({0: None}, rmx.nd.array([1.0])))
    side = Side("port", "sgd", {}, _inputs(0)[0])
    path = os.path.join(tmp_path, "bad.states")
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(MXNetError, match="mxnet_tpu"):
        side.trainer.load_states(path)


def test_load_refuses_zero_sharded_states(tmp_path):
    side = Side("port", "sgd", {}, _inputs(0)[0])
    path = os.path.join(tmp_path, "zero.states")
    with open(path, "wb") as f:
        f.write(side.trainer._ZERO_MAGIC + pickle.dumps({}))
    with pytest.raises(MXNetError, match="ZeRO"):
        side.trainer.load_states(path)


def test_jax_array_in_a_states_file_reads_as_numpy():
    import jax.numpy as jnp

    blob = pickle.dumps(({0: jnp.asarray([1.5, 2.5])}, None))
    states, _ = port_opt._StatesUnpickler(__import__("io").BytesIO(
        blob)).load()
    assert isinstance(states[0], np.ndarray)
    np.testing.assert_array_equal(states[0], [1.5, 2.5])


def test_restored_states_move_to_the_weight_device():
    side = Side("port", "adam", {}, _inputs(1)[0])
    side.step(_inputs(1)[1][0])
    blob = side.trainer._states_blob()
    upd = port_opt.get_updater(port_opt.create("sgd"))
    upd.set_states(blob)
    assert upd.states_synced == {0: False, 1: False}
    w = side.net.weight.data()
    upd(0, side.net.weight.grad(), w)
    assert upd.states_synced[0] and upd.states[0][0]._data.device == \
        torch.device("cpu")
    # the move itself, to a device other than the host's
    moved = port_opt._state_arrays(upd.states[1], torch.device("meta"))
    assert all(t._data.device.type == "meta" for t in moved)
