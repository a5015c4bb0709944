"""ZeRO-1 of the port (``parallel.zero``) held against the reference's
``MXNET_ZERO=1`` Trainer on the CPU.

The reference runs its ZeRO engine over a dp-2 slice of conftest's
virtual devices (its own test's sub-mesh engine) on the whole batch; the
port runs two (or four) spawned gloo processes (``tests/torch_dist_pool.py``),
each on its share of the batch, through ``Trainer(kvstore="dist_sync",
update_on_kvstore=False)``: a reduce-scatter of each flat bucket, the
update of this process's half of the optimizer state, an all-gather.
SGD with momentum and Adam agree after 3 steps within 1e-5 of the
magnitude (sums in another order), and each process holds half of the
replicated optimizer state (to the padding).  ``MXTRZRO1`` states files
cross both ways: the port's file written at world size 2 continues in
the reference and in the port at world size 4, and the reference's in the
port at 2; each resumed run equals the reference's uninterrupted run
within 1e-5.  Payloads fold into a replicated updater with ZeRO off, and
``reshard(plan=)`` names the resharding slice.
"""
import numpy as np
import pytest

import mxnet_tpu as rmx
from mxnet_tpu.parallel import zero as rzero
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.parallel import zero as pzero

from torch_dist_pool import DistPool
from torch_threads import one_torch_thread  # noqa: F401

OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9},
        "adam": {"learning_rate": 0.01}}


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    # both pools start now: their ranks import the port while the first
    # test computes the reference's side
    made = {world: DistPool(world, tmp_path_factory.mktemp(f"zero{world}"))
            for world in (2, 4)}

    def get(world):
        return made[world]

    yield get
    for p in made.values():
        p.close()


@pytest.fixture
def ref_zero_dp2(monkeypatch):
    """The reference's ZeRO engine over two of its virtual devices."""
    import jax

    class _Dp2Engine(rzero.ZeroBucketEngine):
        def _get_mesh(self):
            from jax.sharding import Mesh

            if self._mesh is None:
                self._mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
            return self._mesh

        @property
        def dp(self):
            return 2

    monkeypatch.setattr(rzero, "ZeroBucketEngine", _Dp2Engine)
    monkeypatch.setenv("MXNET_ZERO", "1")
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


def _ref_net(weights=None):
    net = rmx.gluon.nn.HybridSequential()
    net.add(rmx.gluon.nn.Dense(16, activation="relu"), rmx.gluon.nn.Dense(4))
    net.initialize()
    net(rmx.nd.zeros((1, 8)))
    if weights is not None:
        for p, v in zip(net.collect_params().values(), weights.values()):
            p.set_data(rmx.nd.array(v))
    return net


def _weights(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _data(seed=21, steps=5, batch=8):
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, 8).astype("f"), rs.randn(batch, 4).astype("f"))
            for _ in range(steps)]


def _ref_steps(net, data, optimizer, trainer=None):
    tr = trainer or rmx.gluon.Trainer(net.collect_params(), optimizer,
                                      dict(OPTS[optimizer]), kvstore="device")
    for x, y in data:
        with rmx.autograd.record():
            loss = ((net(rmx.nd.array(x)) - rmx.nd.array(y)) ** 2).sum(axis=1)
        loss.backward()
        tr.step(x.shape[0])
    return tr


def _close(got, want, tol=1e-5):
    want = list(want.values()) if isinstance(want, dict) else want
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(
            1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_zero_matches_the_reference_dp2_trainer(pools, ref_zero_dp2,
                                                optimizer):
    net = _ref_net()
    w0 = _weights(net)
    data = _data()[:3]
    tr = _ref_steps(net, data, optimizer)
    assert tr._zero is not None and tr._zero.dp == 2
    got = pools(2).run("t_mlp_trainer", w0, data, "dist_sync", optimizer,
                       OPTS[optimizer], False, 3, True)
    for g in got:
        _close(g["params"], _weights(net))
    # each process holds half of the replicated state (to the padding)
    n_state = 2 if optimizer == "adam" else 1
    full = sum(v.size for v in w0.values()) * 4 * n_state
    for g in got:
        assert full / 2 <= g["zero_bytes"] <= full / 2 + 4 * n_state * 2


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_zero_states_files_cross_packages_and_world_sizes(
        pools, ref_zero_dp2, optimizer, tmp_path):
    data = _data()
    net = _ref_net()
    w0 = _weights(net)
    _ref_steps(net, data, optimizer)
    full_run = _weights(net)               # 5 uninterrupted steps
    half = _ref_net(w0)
    ref_tr = _ref_steps(half, data[:3], optimizer)
    w3 = _weights(half)
    # the port at world size 2: 3 steps, its MXTRZRO1 file
    port_file = str(tmp_path / "port.states")
    got = pools(2).run("t_mlp_trainer", w0, data[:3], "dist_sync",
                       optimizer, OPTS[optimizer], False, 3, True, None,
                       port_file)
    _close(got[0]["params"], w3)
    with open(port_file, "rb") as f:
        assert f.read(8) == b"MXTRZRO1"
    # ... continues in the reference (ZeRO on, dp 2)
    net_r = _ref_net(w3)
    tr_r = rmx.gluon.Trainer(net_r.collect_params(), optimizer,
                             dict(OPTS[optimizer]), kvstore="device")
    tr_r.load_states(port_file)
    _ref_steps(net_r, data[3:], optimizer, trainer=tr_r)
    _close(list(_weights(net_r).values()), full_run)
    # ... and in the port at world size 4
    got4 = pools(4).run("t_mlp_trainer", w3, data[3:], "dist_sync",
                        optimizer, OPTS[optimizer], False, 2, True,
                        port_file)
    for g in got4:
        _close(g["params"], full_run)
    # the reference's file continues in the port at world size 2
    ref_file = str(tmp_path / "ref.states")
    ref_tr.save_states(ref_file)
    with open(ref_file, "rb") as f:
        assert f.read(8) == b"MXTRZRO1"
    got = pools(2).run("t_mlp_trainer", w3, data[3:], "dist_sync",
                       optimizer, OPTS[optimizer], False, 2, True, ref_file)
    for g in got:
        _close(g["params"], full_run)


def test_payload_folds_into_a_replicated_updater():
    from mxnet_tpu_torch import optimizer as opt

    payload = {"version": 1, "kind": "adam",
               "members": {0: (np.ones((2, 2), "f"), np.full((2, 2), 2, "f")),
                           1: (np.zeros(3, "f"), np.ones(3, "f"))}}
    states = pzero.payload_to_states(payload)
    ref_states = rzero.payload_to_states(payload)
    assert sorted(states) == sorted(ref_states)
    for k in states:
        for a, b in zip(states[k], ref_states[k]):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    up = opt.get_updater(opt.create("adam"))
    pzero.fold_into_updater(up, payload)
    assert up.states_synced == {0: False, 1: False}
    sgd = {"version": 1, "kind": "sgd",
           "members": {0: (np.ones(2, "f"),), 1: ()}}
    out = pzero.payload_to_states(sgd)
    assert out[1] is None and out[0].shape == (2,)


def test_engine_refuses_plans_and_unsupported_optimizers():
    from mxnet_tpu_torch import optimizer as opt

    from mxnet_tpu_torch.parallel import planner

    eng = pzero.ZeroBucketEngine(opt.create("sgd", momentum=0.9))
    assert eng.dp == 1 and not eng.has_state
    with pytest.raises(mx.MXNetError, match="resharding slice"):
        eng.reshard(plan=object())
    # a plan governs the shard count (tests/test_torch_planner.py holds
    # it across ranks); live resharding is the next slice's
    plan = planner.plan_sharding(planner.PlannerConfig(
        mesh={"dp": 1}, rules="replicated", hbm_gb=16.0),
        (("w", (4, 4), "float32"),), 1)
    eng = pzero.ZeroBucketEngine(opt.create("sgd"), plan=plan)
    assert eng.dp == 1 and eng._plan is plan
    with pytest.raises(mx.MXNetError, match="unsupported"):
        pzero.ZeroBucketEngine(opt.create("lamb"))
    with pytest.raises(mx.MXNetError, match="adam"):
        eng.load_state_payload({"kind": "adam", "members": {}})
    assert pzero.supports(opt.create("adam")) and \
        not pzero.supports(opt.create("nag"))


def test_one_process_zero_equals_the_replicated_update(monkeypatch):
    """One process, ZeRO on: the shard is the whole bucket and the update
    is the replicated kernels' math, so the weights are bit for bit the
    ZeRO-off run's (the reference's own one-process contract)."""
    from mxnet_tpu_torch import autograd, gluon, nd

    def run(zero):
        monkeypatch.setenv("MXNET_ZERO", "1" if zero else "0")
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(16, activation="relu", in_units=8),
                gluon.nn.Dense(4, in_units=16))
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        for p in net.collect_params().values():
            p.set_data(nd.array(np.random.RandomState(1).randn(
                *p.shape).astype("f"), ctx=mx.cpu()))
        tr = gluon.Trainer(net.collect_params(), "sgd", OPTS["sgd"],
                           kvstore="dist_sync", update_on_kvstore=False)
        for x, y in _data(steps=3):
            with autograd.record():
                loss = ((net(nd.array(x, ctx=mx.cpu())) -
                         nd.array(y, ctx=mx.cpu())) ** 2).sum()
            loss.backward()
            tr.step(8)
        return [p.data().asnumpy() for p in net.collect_params().values()]

    # the ZeRO run goes through the bucket engine (its collectives are a
    # process's identity), the other through the replicated updater
    for a, b in zip(run(True), run(False)):
        np.testing.assert_array_equal(a, b)
    from mxnet_tpu_torch import optimizer as opt
    from mxnet_tpu_torch.parallel import bucketing

    import torch

    w = torch.from_numpy(np.random.RandomState(2).randn(10).astype("f"))
    g = torch.from_numpy(np.random.RandomState(3).randn(10).astype("f"))
    (b,) = bucketing.assign_buckets([(0, (10,), "float32")]).buckets
    o1 = opt.create("adam", learning_rate=0.01)
    eng = pzero.ZeroBucketEngine(o1)
    out = eng.step_bucket(("gen", 1), b, [g], w.clone())
    o2 = opt.create("adam", learning_rate=0.01)
    wn = mx.nd.array(w.numpy(), ctx=mx.cpu())
    opt.get_updater(o2)(0, mx.nd.array(g.numpy(), ctx=mx.cpu()), wn)
    np.testing.assert_array_equal(out.numpy(), wn.asnumpy())
    assert eng.state_bytes() == 2 * 10 * 4

