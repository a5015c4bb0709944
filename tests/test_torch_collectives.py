"""The port's process mesh and collectives, and the agreements across
processes built on them, held against the reference on the CPU.

The port runs one process a device: its ranks are spawned CPU processes
in one gloo group (``tests/torch_dist_pool.py``; they never import JAX).
The reference's oracle is its own mesh over ``jax.devices()[:N]`` of
conftest's 8 virtual CPU devices: the same numpy inputs, one slice per
device through ``shard_map``, at N = 2 and 4.  Sums over 2-4 fp32 values
in another order: within 1e-6 of the magnitude; moves and gathers exact.
The int8 all-reduces against the reference's own ``_int8_quantize``
applied per rank: within 1e-6.

Agreements (one pool of 2 or 4 ranks): ``check_stop`` ends every rank at
the same step when one requests a stop, at ``MXNET_STOP_SYNC_EVERY`` 1
and 2; an overflow planted on one rank makes every rank skip through
``LossScaler`` and halve the scale; the guard's verdict is every rank's
and its canary vote names the minority rank on every rank (4 ranks);
eager ``SyncBatchNorm`` equals the reference's ``BatchNorm`` over the
global batch (1e-5); ``CheckpointManager`` publishes each step once,
from one writer, and every rank restores it; ``telemetry_agg`` reads the
ledger skew of real ranks (0, and 1 with a planted stamp).
"""
import numpy as np
import pytest

import mxnet_tpu as rmx
from mxnet_tpu.parallel import collectives as rcoll
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import collectives, mesh as pmesh

from torch_dist_pool import DistPool
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    # both pools start now: their ranks import the port while the first
    # test computes the reference's side
    made = {world: DistPool(world, tmp_path_factory.mktemp(f"coll{world}"))
            for world in (2, 4)}

    def get(world):
        return made[world]

    yield get
    for p in made.values():
        p.close()


def _inputs(world):
    rs = np.random.RandomState(world)
    return {"x": rs.randn(world, 3, 4).astype("f"),
            "m": rs.randn(world, 4, 6).astype("f")}


def _reference(world, inp):
    """The reference's collectives in shard_map over devices[:world]; each
    result is (world, ...) by device."""
    import jax
    from jax.sharding import Mesh

    from mxnet_tpu.parallel.planner.plan import ShardingPlan

    m = Mesh(np.array(jax.devices()[:world]), ("dp",))
    # dim 0 over dp: the planner's batch spec (the repo's lint routes
    # sharding intent through a plan)
    spec = ShardingPlan.from_specs({"dp": world}, {}, ("dp",)).batch_spec()
    ring = [(i, (i + 1) % world) for i in range(world)]

    def body(x, mm):
        x, mm = x[0], mm[0]
        outs = {
            "psum": rcoll.psum(x),
            "pmean": rcoll.pmean(x),
            "all_gather": rcoll.all_gather(x, axis=0, tiled=True),
            "all_gather_stack1": rcoll.all_gather(x, axis=1, tiled=False),
            "reduce_scatter": rcoll.reduce_scatter(mm),
            "ppermute": rcoll.ppermute(x, ring, axis_name="dp"),
            "ppermute_half": rcoll.ppermute(x, [(0, world - 1)],
                                            axis_name="dp"),
            "all_to_all": rcoll.all_to_all(mm, axis_name="dp", split_axis=0,
                                           concat_axis=1),
        }
        return {k: v[None] for k, v in outs.items()}

    f = rcoll.shard_map(body, m, in_specs=(spec, spec), out_specs=spec)
    out = jax.jit(f)(inp["x"], inp["m"])
    return {k: np.asarray(v) for k, v in out.items()}


def _q8_pieces(values):
    """The sum of every rank's int8 round trip, from the reference's own
    ``_int8_quantize``."""
    import jax.numpy as jnp

    total = 0.0
    for v in values:
        q, s = rcoll._int8_quantize(jnp.asarray(v))
        total = total + np.asarray(q, np.float32) * float(s)
    return total


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_the_reference_mesh(pools, world):
    inp = _inputs(world)
    want = _reference(world, inp)
    got = pools(world).run("t_collectives", inp)
    for name, ref in want.items():
        for r in range(world):
            np.testing.assert_allclose(
                got[r][name], ref[r], rtol=0, atol=TOL * max(
                    1.0, float(np.abs(ref).max())), err_msg=f"{name} r{r}")
    x, m = inp["x"], inp["m"]
    for r in range(world):
        np.testing.assert_allclose(got[r]["hosts"], x.sum(0), atol=TOL * 4)
        assert got[r]["any"] and not got[r]["none"]
        np.testing.assert_allclose(got[r]["q8"], _q8_pieces(list(x)),
                                   atol=TOL * 4)
        flat = np.concatenate([_q8_pieces(list(x)).ravel(),
                               _q8_pieces(list(m * 1e-3)).ravel()])
        np.testing.assert_allclose(got[r]["q8_multi"], flat, atol=TOL * 4)
        # a dp x fsdp = (world / 2) x 2 mesh: rank r's dp line is the
        # ranks with its fsdp coordinate
        np.testing.assert_allclose(got[r]["psum_dp_of_fsdp2"],
                                   x[r % 2::2].sum(0), atol=TOL * 4)
        # d/dx_r of sum_k (k + 1) * sum(psum(x))
        np.testing.assert_allclose(got[r]["psum_grad"],
                                   np.full_like(x[r], world * (world + 1) / 2))
        # one issue site, one count a call, the same on every rank
        assert got[r]["issued"] == got[0]["issued"]
    assert got[0]["issued"] == {
        "psum": 4, "psum_grad": 1, "all_gather": 2, "reduce_scatter": 1,
        "ppermute": 2, "all_to_all": 1, "allreduce": 1, "allreduce_any": 2,
        "allreduce_q8": 1, "allreduce_q8_multi": 1, "barrier": 1}


def test_one_process_collectives_and_quantized_math():
    """Without a process group every collective is the identity of one
    process; the forced paths match the reference's single-process
    tests (test_kvstore.py's quantized cases)."""
    import jax.numpy as jnp

    import torch

    x = torch.arange(6.0).reshape(2, 3)
    assert collectives.world_size() == 1 and collectives.rank() == 0
    for fn in (collectives.psum, collectives.pmean, collectives.reduce_scatter,
               collectives.all_gather):
        assert torch.equal(fn(x), x)
    assert collectives.all_gather(x, tiled=False).shape == (1, 2, 3)
    assert collectives.allreduce_any(True) is True
    collectives.barrier()
    v = np.array([0.9, -0.33, 0.0001, -1.7], "f")
    got = collectives.allreduce_hosts_quantized(torch.from_numpy(v),
                                                _testing_force=True)
    ref = np.asarray(rcoll.allreduce_hosts_quantized(jnp.asarray(v),
                                                     _testing_force=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-7)
    big, tiny = np.full((8,), 100.0, "f"), np.full((4,), 1e-4, "f")
    got = collectives.allreduce_hosts_quantized_multi(
        [torch.from_numpy(big), torch.from_numpy(tiny)], _testing_force=True)
    ref = rcoll.allreduce_hosts_quantized_multi(
        [jnp.asarray(big), jnp.asarray(tiny)], _testing_force=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    assert got[1].dtype == torch.float32
    q, s = collectives._int8_quantize(torch.from_numpy(v))
    rq, rs = rcoll._int8_quantize(jnp.asarray(v))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == pytest.approx(float(rs), rel=1e-7)


def test_a_card_tensor_on_a_group_without_nccl_raises():
    """No collective quietly reduces a card's tensor on the host: on a
    gloo-only group each raises, and only ``host=True`` (the host-reduced
    stores') goes through a host copy.  A CPU tensor that reports
    ``is_cuda`` stands in for the card's, in a one-rank gloo group."""
    import torch
    import torch.distributed as dist

    class _CudaLooking(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    x = torch.Tensor._make_subclass(_CudaLooking, torch.arange(4.0))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for fn in (lambda: collectives.psum(x, "world"),
                   lambda: collectives.psum_(x, "world"),
                   lambda: collectives.all_gather(x, "world"),
                   lambda: collectives.reduce_scatter(x, "world"),
                   lambda: collectives.allreduce_hosts(x),
                   lambda: collectives.allreduce_hosts_quantized(x),
                   lambda: collectives.allreduce_hosts_quantized_multi([x])):
            with pytest.raises(MXNetError, match="without NCCL"):
                fn()
        want = torch.arange(4.0)
        for got in (collectives.allreduce_hosts(x, host=True),
                    collectives.reduce_scatter(x, "world", host=True),
                    collectives.all_gather(x, "world", host=True)):
            assert torch.equal(got.as_subclass(torch.Tensor), want)
    finally:
        dist.destroy_process_group()


def test_mesh_keeps_the_reference_axes_and_rules():
    from mxnet_tpu.parallel import mesh as rmesh

    m = pmesh.make_mesh(devices=list(range(8)), fsdp=2)
    r = rmesh.make_mesh(fsdp=2)
    assert m.axis_names == r.axis_names == pmesh.AXES
    assert dict(m.shape) == dict(r.shape)
    assert pmesh.make_mesh().shape["dp"] == 1
    for axis in ("tp", "sp", "ep", "pp"):
        # every axis resolves as dp and fsdp do; dp absorbs the rest
        m = pmesh.make_mesh(devices=list(range(8)), **{axis: 2})
        assert dict(m.shape) == dict(rmesh.make_mesh(**{axis: 2}).shape)
        assert m.axis_ranks(axis, 0) == [0, 1]
    with pytest.raises(MXNetError, match="divisible"):
        pmesh.make_mesh(devices=[0, 1, 2], fsdp=2)
    pmesh.set_default_mesh(None)
    assert pmesh.get_default_mesh().size == 1


def test_init_reads_the_launcher_contract(monkeypatch):
    """One process is a no-op that returns False, as in the reference;
    several without a card raise unless the caller asks for the CPU."""
    import torch

    from mxnet_tpu_torch.parallel import distributed

    for var in ("MXNET_COORDINATOR_ADDRESS", "DMLC_PS_ROOT_URI",
                "DMLC_PS_ROOT_PORT", "MXNET_NUM_WORKERS", "DMLC_NUM_WORKER"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init() is False
    assert distributed.is_initialized() is False
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "1")
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    assert distributed.init() is False
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        distributed.init()


@pytest.mark.parametrize("every", [1, 2])
def test_check_stop_ends_every_rank_at_one_step(pools, every):
    got = pools(2).run("t_check_stop", 1, 2, 8, every)
    left = {g["left"] for g in got}
    assert left == {2 if every == 1 else 3}
    assert got[0]["issued"] == got[1]["issued"]


def _mlp_weights():
    prev = rmx.nd.set_eager_jit(False)
    try:
        net = rmx.gluon.nn.HybridSequential()
        net.add(rmx.gluon.nn.Dense(16, activation="relu"),
                rmx.gluon.nn.Dense(4))
        net.initialize()
        net(rmx.nd.zeros((1, 8)))
    finally:
        rmx.nd.set_eager_jit(prev)
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def test_loss_scaler_overflow_on_one_rank_skips_every_rank(pools):
    rs = np.random.RandomState(3)
    x, y = rs.randn(8, 8).astype("f"), rs.randn(8, 4).astype("f")
    got = pools(2).run("t_loss_scaler", _mlp_weights(), x, y, 1)
    assert [g["skipped"] for g in got] == [True, True]
    assert [g["scale"] for g in got] == [0.5, 0.5]


def test_guard_verdict_and_canary_vote_across_ranks(pools):
    rs = np.random.RandomState(4)
    x, y = rs.randn(8, 8).astype("f"), rs.randn(8, 4).astype("f")
    got = pools(4).run("t_guard", _mlp_weights(), x, y, 2)
    assert [g["clean"] for g in got] == ["ok"] * 4
    assert [g["verdict"] for g in got] == ["nonfinite"] * 4
    assert len({g["digest"] for g in got}) == 1
    assert [g["blamed"] for g in got] == [[2]] * 4


def test_sync_batch_norm_uses_the_global_batch(pools):
    rs = np.random.RandomState(5)
    x = rs.randn(4, 3, 2, 2).astype("f")
    gamma = (rs.rand(3) + 0.5).astype("f")
    beta = rs.randn(3).astype("f")
    got = pools(2).run("t_sync_bn", x, gamma, beta)
    prev = rmx.nd.set_eager_jit(False)
    try:
        bn = rmx.gluon.nn.BatchNorm(in_channels=3)
        bn.initialize()
        bn.gamma.set_data(rmx.nd.array(gamma))
        bn.beta.set_data(rmx.nd.array(beta))
        with rmx.autograd.record():
            want = bn(rmx.nd.array(x)).asnumpy()
        mean = bn.running_mean.data().asnumpy()
        var = bn.running_var.data().asnumpy()
    finally:
        rmx.nd.set_eager_jit(prev)
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got]), want,
                               atol=1e-5)
    for g in got:
        np.testing.assert_allclose(g["mean"], mean, atol=1e-6)
        np.testing.assert_allclose(g["var"], var, atol=1e-6)
        assert g["grad_finite"]


def test_checkpoint_has_one_writer_and_a_barrier(pools, tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    got = pools(2).run("t_checkpoint", _mlp_weights(), str(d))
    for g in got:
        # the barrier at publish: no rank saw the directory before the
        # writer had published step 1
        assert g["listing"] == ["step_00000001"]
        assert g["restored"] == 2 and g["same"] and g["steps"] == [1, 2]
    assert got[0]["timing"] == ["bytes", "fsync_s", "write_s"]
    assert got[1]["timing"] == []          # rank 1 wrote nothing
    assert sorted(p.name for p in d.iterdir()) == ["step_00000001",
                                                   "step_00000002"]


def test_ledger_skew_across_real_ranks(pools, tmp_path):
    d = tmp_path / "agg"
    d.mkdir()
    assert pools(2).run("t_ledger_skew", str(d), False)[0] == \
        {"positions": {0: 3.0, 1: 3.0}}
    assert pools(2).run("t_ledger_skew", str(d), True)[0] == \
        {"positions": {0: 4.0, 1: 3.0}}


def test_kv_and_kvstore_are_exported():
    assert mx.kv is mx.kvstore
