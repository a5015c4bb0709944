"""The sharding planner of the port (``mxnet_tpu_torch.parallel.planner``),
held against the reference's on the CPU: the same specs, chosen mesh,
HBM estimate, plan JSON, digest, report text and telemetry round trip for
the same signature, rules, device count and budget
(``tests/test_planner.py:84-447``), and its consumers: ``TrainStep(plan=)``
(bit for bit the legacy ``param_sharding`` path on the same mesh, a plan
that misses the mesh raising) and ``ZeroBucketEngine(plan=)`` (the shard
count from the plan's data axes), the latter on two spawned gloo ranks
(``tests/torch_dist_pool.py``).  Exact equality throughout: the planner
is pure integer and string arithmetic.
"""
import os

import numpy as np
import pytest

import jax
from mxnet_tpu import telemetry as ref_telemetry
from mxnet_tpu.parallel import make_mesh as ref_make_mesh
from mxnet_tpu.parallel import planner as ref_planner
from mxnet_tpu.parallel import tensor_parallel as ref_tp

from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import make_mesh, planner, tensor_parallel
from mxnet_tpu_torch.parallel.data_parallel import fsdp_specs

import torch_sharded_tasks as tasks
from torch_dist_pool import DistPool
from torch_threads import one_torch_thread  # noqa: F401

_KNOBS = ("MXNET_ZERO", "MXNET_PLANNER_MESH", "MXNET_PLANNER_HBM_GB",
          "MXNET_PLANNER_PIPELINE_IN_JIT", "MXNET_PLANNER_REPORT")


@pytest.fixture(autouse=True)
def _planner_env_clean():
    prev = {k: os.environ.pop(k, None) for k in _KNOBS}
    planner.set_default_plan(None)
    ref_planner.set_default_plan(None)
    yield
    planner.set_default_plan(None)
    ref_planner.set_default_plan(None)
    for k, v in prev.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = DistPool(2, tmp_path_factory.mktemp("planner"))
    yield p
    p.close()


def _sig(n_params=4, shape=(256, 256)):
    return tuple((f"p{i}_weight", shape, "float32") for i in range(n_params))


SIZES = {"dp": 2, "fsdp": 2, "tp": 2}
SHAPES = {"a_weight": (16, 8), "b_bias": (6,), "c_weight": (7, 5),
          "d_weight": (4, 16), "e_gamma": (2,), "f_w": (3, 3, 2),
          "model_layers_0_self_attn_q_proj_weight": (8, 8),
          "model_layers_0_self_attn_o_proj_weight": (8, 8),
          "model_layers_1_mlp_gate_proj_weight": (12, 8),
          "model_layers_1_mlp_down_proj_weight": (8, 12),
          "model_layers_0_mlp_up_proj_weight": (4, 8, 12),
          "model_layers_0_mlp_router_weight": (8, 4),
          "model_embed_tokens_weight": (64, 8),
          "lm_head_weight": (64, 8), "lm_head_bias": (64,),
          "model_norm_weight": (8,), "odd_weight": (7, 9),
          "x_q_proj_weight": (8, 8), "plain_weight": (8, 6)}


# ---------------------------------------------------------------------------
# the rule engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rules", ["replicated", "fsdp", "megatron",
                                   "megatron+fsdp"])
@pytest.mark.parametrize("sizes", [SIZES, {"dp": 4, "fsdp": 2, "tp": 1},
                                   {"ep": 4, "dp": 2}])
def test_rule_sets_give_the_reference_specs(rules, sizes):
    rs, ref = planner.named_rule_set(rules), ref_planner.named_rule_set(rules)
    assert rs.key() == ref.key()
    for name, shape in SHAPES.items():
        assert rs.spec_for(name, shape, sizes) == \
            ref.spec_for(name, shape, sizes), name


def test_overrides_fsdp_specs_and_megatron_specs_agree():
    rs = planner.named_rule_set("megatron+fsdp").with_overrides(
        {"plain_weight": ("model", None)})
    ref = ref_planner.named_rule_set("megatron+fsdp").with_overrides(
        {"plain_weight": ("model", None)})
    assert rs.spec_for("plain_weight", (8, 6), SIZES) == ("tp", None) == \
        ref.spec_for("plain_weight", (8, 6), SIZES)
    params = {k: np.zeros(s, "f") for k, s in SHAPES.items()}
    mesh = make_mesh(devices=list(range(8)), **SIZES)
    ref_mesh = ref_make_mesh(devices=jax.devices()[:8], **SIZES)
    from mxnet_tpu.parallel.data_parallel import fsdp_specs as ref_fsdp

    got, want = fsdp_specs(params, mesh), ref_fsdp(params, ref_mesh)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    got = tensor_parallel.megatron_specs(params, mesh)
    want = ref_tp.megatron_specs(params, ref_mesh)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    with pytest.raises(MXNetError, match="unknown planner rule set"):
        planner.named_rule_set("zigzag")


# ---------------------------------------------------------------------------
# the HBM model and the mesh choice
# ---------------------------------------------------------------------------
EST_CASES = [
    (_sig(2, (128, 64)), "replicated", {"dp": 4},
     dict(optimizer="sgd_momentum", zero=False, batch_rows=64,
          microbatches=2)),
    (_sig(2, (128, 64)), "replicated", {"dp": 4},
     dict(optimizer="sgd_momentum", zero=True)),
    (_sig(2, (128, 64)), "fsdp", {"dp": 1, "fsdp": 4}, {}),
    (_sig(2, (128, 64)), "fsdp", {"dp": 2, "fsdp": 4},
     dict(optimizer="sgd_momentum", zero=True)),
    (tuple((n, s, "bfloat16") for n, s in SHAPES.items() if len(s) == 2),
     "megatron+fsdp", SIZES, dict(optimizer="adam", batch_rows=32)),
]


@pytest.mark.parametrize("case", range(len(EST_CASES)))
def test_estimate_is_the_reference_estimate(case):
    sig, rules, axes, kw = EST_CASES[case]
    got = planner.estimate(sig, planner.named_rule_set(rules), axes, **kw)
    want = ref_planner.estimate(sig, ref_planner.named_rule_set(rules),
                                axes, **kw)
    assert got == want


@pytest.mark.parametrize("budget", [1 << 30, int(0.7 * (1 << 20)), 1024])
def test_choose_mesh_is_the_reference_choice(budget):
    sig = _sig(4, (256, 256))
    rs, ref = planner.named_rule_set("fsdp"), ref_planner.named_rule_set(
        "fsdp")
    if budget == 1024:
        with pytest.raises(MXNetError, match="HBM budget"):
            planner.choose_mesh(sig, rs, 8, budget_bytes=budget)
        got = planner.choose_mesh(sig, rs, 8, budget_bytes=budget,
                                  strict=False)
        want = ref_planner.choose_mesh(sig, ref, 8, budget_bytes=budget,
                                       strict=False)
        assert not got[1]["feasible"]
    else:
        got = planner.choose_mesh(sig, rs, 8, budget_bytes=budget)
        want = ref_planner.choose_mesh(sig, ref, 8, budget_bytes=budget)
    assert got == want
    for allow in (False, True):
        assert planner.enumerate_meshes(8, allow_pp=allow) == \
            ref_planner.enumerate_meshes(8, allow_pp=allow)


# ---------------------------------------------------------------------------
# plans: JSON, digest, report, telemetry
# ---------------------------------------------------------------------------
PLAN_CASES = [
    (dict(mesh="auto", rules="fsdp", hbm_gb=1.0), 8),
    (dict(mesh="auto", rules="fsdp", hbm_gb=0.0007), 8),
    (dict(mesh={"dp": 2, "ep": 4}, rules="megatron", hbm_gb=16.0), 8),
    (dict(mesh={"dp": 4, "fsdp": 2}, rules="fsdp", optimizer="sgd_momentum",
          batch_rows=32, hbm_gb=16.0), 8),
    (dict(mesh={"tp": 2}, rules="megatron+fsdp", optimizer="adam",
          zero=True, hbm_gb=2.0), 4),
    (dict(mesh={"dp": 4}, rules="replicated", hbm_gb=16.0), 8),
    (dict(mesh="auto", rules="megatron", pipeline=True, microbatches=4,
          batch_rows=64, hbm_gb=0.001), 8),
]


def _plans(case):
    kw, n = PLAN_CASES[case]
    sig = tuple((n_, s, "float32") for n_, s in SHAPES.items())
    return (planner.plan_sharding(planner.PlannerConfig(**kw), sig, n),
            ref_planner.plan_sharding(ref_planner.PlannerConfig(**kw), sig, n))


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_json_digest_and_report_are_the_reference_ones(case):
    got, want = _plans(case)
    assert got.to_json() == want.to_json()
    assert got.digest() == want.digest()
    assert got.visualize_sharding() == want.visualize_sharding()
    assert got.report() == want.report()
    assert {k: tuple(got.spec(k)) for k in got.specs} == \
        {k: tuple(want.spec(k)) for k in want.specs}
    assert tuple(got.batch_spec()) == tuple(want.batch_spec())
    assert got.zero_shards == want.zero_shards
    assert got.shard_layout(1000) == want.shard_layout(1000)
    assert dict(got.build_mesh().shape) == \
        {k: v for k, v in dict(want.build_mesh().shape).items()}


def test_plan_determinism_and_validation():
    sig = planner.signature_of(
        {"w": np.zeros((16, 8), "f"), "b": np.zeros((16,), "f")})
    assert sig == ref_planner.signature_of(
        {"w": np.zeros((16, 8), "f"), "b": np.zeros((16,), "f")})
    cfg = planner.PlannerConfig(mesh="auto", rules="fsdp", hbm_gb=1.0)
    a = planner.plan_sharding(cfg, sig, 8)
    assert a.digest() == planner.plan_sharding(
        planner.PlannerConfig(mesh="auto", rules="fsdp", hbm_gb=1.0),
        sig, 8).digest()
    assert planner.plan_sharding(cfg, sig, 4).digest() != a.digest()
    small = _sig(1, (8, 8))
    with pytest.raises(MXNetError, match="not divisible"):
        planner.plan_sharding(planner.PlannerConfig(mesh={"tp": 3}), small, 8)
    with pytest.raises(MXNetError, match="covers"):
        planner.plan_sharding(planner.PlannerConfig(mesh={"dp": 3, "tp": 4}),
                              small, 8)
    assert planner.plan_sharding(planner.PlannerConfig(mesh={"dp": 4}),
                                 small, 8).device_count() == 4
    for bad in ({"tp": 0}, {"dp": 0}, {"dp": -2}, "dp=0"):
        with pytest.raises(MXNetError, match="must be >= 1"):
            planner.PlannerConfig(mesh=bad)
    with pytest.raises(MXNetError, match="resharding"):
        a.transfer_plan_to(a)


def test_planner_config_reads_the_reference_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_PLANNER_MESH", "dp=2,tp=4")
    monkeypatch.setenv("MXNET_PLANNER_PIPELINE_IN_JIT", "1")
    monkeypatch.setenv("MXNET_PLANNER_HBM_GB", "3.5")
    cfg, ref = planner.PlannerConfig(), ref_planner.PlannerConfig()
    assert cfg.key() == ref.key()
    assert cfg.mesh == {"dp": 2, "tp": 4} and cfg.pipeline_in_jit_sharding
    with pytest.raises(MXNetError, match="bad mesh axis"):
        planner.PlannerConfig(mesh="zz=2")
    with pytest.raises(MXNetError, match="bad mesh size"):
        planner.PlannerConfig(mesh="dp=x")
    monkeypatch.delenv("MXNET_PLANNER_HBM_GB")
    # no card here: the reference's default budget
    assert planner.PlannerConfig().hbm_gb == 16.0


def test_published_report_round_trips_through_the_snapshot():
    got, want = _plans(3)
    rep = got.publish()
    assert rep == want.publish()
    rt = planner.report_from_snapshot(telemetry.snapshot())
    ref_rt = ref_planner.report_from_snapshot(ref_telemetry.snapshot())
    for key in ("axes", "components", "feasible", "budget_bytes"):
        assert rt[key] == rep[key] == ref_rt[key]
    assert sorted((r["param"], r["spec"], r["bytes_per_device"])
                  for r in rt["params"]) == \
        sorted((r["param"], r["spec"], r["bytes_per_device"])
               for r in rep["params"])
    # a second publish retires the first plan's rows
    mk = lambda sig: planner.plan_sharding(  # noqa: E731
        planner.PlannerConfig(mesh={"dp": 4}, rules="replicated",
                              hbm_gb=16.0), sig, 4)
    mk((("neta_w", (16, 8), "float32"),)).publish()
    mk((("netb_w", (8, 4), "float32"),)).publish()
    rt = planner.report_from_snapshot(telemetry.snapshot())
    assert [r["param"] for r in rt["params"]] == ["netb_w"]


# ---------------------------------------------------------------------------
# the consumers: TrainStep and the ZeRO engine
# ---------------------------------------------------------------------------
def test_trainstep_rejects_a_plan_off_its_mesh():
    from mxnet_tpu_torch.parallel import TrainStep

    net, loss = tasks._net("mlp_bn", {"classes": 4}, _mlp_weights())
    sig = planner.signature_of(net)
    plan = planner.plan_sharding(
        planner.PlannerConfig(mesh={"dp": 4}, rules="replicated",
                              hbm_gb=16.0), sig, 4)
    with pytest.raises(MXNetError, match="does not match the mesh"):
        TrainStep(net, loss, plan=plan, device="cpu",
                  mesh=make_mesh(devices=list(range(8)), **SIZES))


def test_trainstep_warns_about_a_plan_missing_parameters():
    """A plan keyed on another net's names (block counters differ between
    instances) would replicate everything without a word: it warns, as
    the reference does."""
    from mxnet_tpu_torch.parallel import TrainStep

    weights = _mlp_weights()
    net, loss = tasks._net("mlp_bn", {"classes": 4}, weights)
    other, _ = tasks._net("mlp_bn", {"classes": 4}, weights)
    plan = planner.plan_sharding(
        planner.PlannerConfig(mesh={"dp": 1}, rules="replicated",
                              hbm_gb=16.0), planner.signature_of(other), 1)
    with pytest.warns(UserWarning, match="missing"):
        TrainStep(net, loss, plan=plan, device="cpu")


def _mlp_weights():
    from mxnet_tpu import gluon as rgluon
    import mxnet_tpu as rmx

    rmx.random.seed(0)
    net = rgluon.nn.HybridSequential()
    net.add(rgluon.nn.Dense(16, activation="relu"), rgluon.nn.BatchNorm(),
            rgluon.nn.Dense(4))
    net.initialize()
    net(rmx.nd.zeros((2, 8)))
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.mark.parametrize("rules", ["replicated", "fsdp"])
def test_trainstep_plan_is_the_legacy_path_bit_for_bit(pool, rules):
    weights = _mlp_weights()
    r = np.random.RandomState(3)
    batches = [(r.randn(8, 8).astype("f"),
                r.randint(0, 4, (8,)).astype("int32")) for _ in range(5)]
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    args = ("mlp_bn", {"classes": 4}, weights, batches, {"fsdp": 2})
    by_plan = pool.run("torch_sharded_tasks.t_train", *args,
                       {"rules": rules}, "sgd", opt)
    legacy = pool.run("torch_sharded_tasks.t_train", *args,
                      {"param_sharding": rules}, "sgd", opt)
    for a, b in zip(by_plan, legacy):
        assert a["losses"] == b["losses"]
        assert all(np.array_equal(x, y) for x, y in zip(a["params"],
                                                        b["params"]))
        assert a["execution"] == b["execution"]
    kinds = set(by_plan[0]["execution"].values())
    assert kinds == ({"local"} if rules == "replicated"
                     else {"local", "gathered"})


def test_zero_engine_takes_its_shards_from_the_plan(pool):
    r = np.random.RandomState(0)
    weights = {"dense0_weight": r.randn(16, 8).astype("f"),
               "dense0_bias": np.zeros(16, "f"),
               "dense1_weight": r.randn(4, 16).astype("f"),
               "dense1_bias": np.zeros(4, "f")}
    data = [(r.randn(8, 8).astype("f"), r.randn(8, 4).astype("f"))
            for _ in range(2)]
    out = pool.run("torch_sharded_tasks.t_zero_plan", weights, data,
                   {"dp": 2}, 2)
    plain = pool.run("t_mlp_trainer", weights, data, "dist_sync", "sgd",
                     {"learning_rate": 0.1, "momentum": 0.9}, False, 2, True)
    for o, p in zip(out, plain):
        assert o["dp"] == 2 and o["governed"]
        assert o["axis"] == repr(("dp", "fsdp"))
        for a, b in zip(o["params"], p["params"]):
            np.testing.assert_array_equal(a, b)
        assert "resharding" in o["sub_mesh"]
