"""Pipeline parallelism of the port (GPipe and 1F1B over ``pp`` by
send/recv), held against the reference on the CPU.

Four spawned gloo ranks (``tests/torch_dist_pool.py``, tasks in
``tests/torch_sharded_tasks.py``):

- ``pipeline_apply`` at the reference's (S, M) grid and both schedules:
  output within 1e-5 and every gradient (stacked stage params and input)
  within 1e-4 of the sequential composition, computed by the reference's
  jax (``tests/test_pipeline.py``'s oracle); ``remat_stage`` within 1e-6
  of the plain pipeline, ``in_jit_sharding=True`` equal to it; a stage
  that makes NaN from a zero input gives finite outputs and gradients
  (``tests/test_parallel.py:332-396``); the reference's rejections of
  bad configurations.
- ``TrainStep(pipeline=)`` of Llama (4 layers, hidden 32) on dp = 2 x
  pp = 2, M = 2, SGD 0.1 with momentum 0.9 (linear in the gradients, so
  a relative bound means what it says), 3 steps, both schedules: the
  losses and every parameter within 1e-4 of the reference's own pipelined
  step (1F1B on the same mesh; relative to each tensor's largest entry),
  and losses within rtol 1e-4, atol 1e-5 of the port's unsharded step
  (the reference's pipeline bound).  A planted fault (the last stage
  seeding each microbatch's backward with another's cotangent) must miss
  that bound.  ``remat_stage`` gives the same losses (rtol 1e-5).
- The 4-axis composition (fsdp = 2 x pp = 2, fsdp specs, the head's tp
  spec) and BERT (2 layers, 1F1B) against the unsharded step at the same
  bound; the MoE Llama trains (finite, falling loss).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import mxnet_tpu as rmx
from mxnet_tpu.gluon.model_zoo.language import llama as ref_llama
from mxnet_tpu.parallel import make_mesh as ref_make_mesh
from mxnet_tpu.parallel.data_parallel import TrainStep as RefTrainStep

import torch_sharded_tasks as tasks
from torch_dist_pool import DistPool
from torch_threads import one_torch_thread  # noqa: F401

ADAM = {"learning_rate": 1e-3}
SGD = {"learning_rate": 0.1, "momentum": 0.9}
REL = 1e-4
LLAMA4 = dict(tasks.LLAMA, num_layers=4)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = DistPool(4, tmp_path_factory.mktemp("pp"))
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _no_eager_jit():
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


def _rel(got, want):
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------
def _tanh_stage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _norm_stage(p, h):            # NaN on an all-zero input
    return (h / jnp.linalg.norm(h, axis=-1, keepdims=True)) @ p["w"]


def _sequential(stage, per, x):
    """The oracle: y, d(sum y^2)/d(stage params) stacked, d/dx."""
    def loss(pl, xx):
        h = xx
        for p in pl:
            h = stage(p, h)
        return (h * h).sum(), h

    (_, y), (g, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(per, x)
    return (np.asarray(y), {k: np.stack([np.asarray(gi[k]) for gi in g])
                            for k in per[0]}, np.asarray(gx))


def _stages(rs, S, D, bias=True):
    out = []
    for _ in range(S):
        s = {"w": (rs.randn(D, D) * 0.5).astype("f")}
        if bias:
            s["b"] = (rs.randn(D) * 0.1).astype("f")
        out.append(s)
    return out


@pytest.mark.parametrize("S,M", [(2, 2), (4, 4), (4, 2), (2, 6)])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_apply_matches_the_sequential_stack(pool, S, M, schedule):
    D = 8
    rs = np.random.RandomState(0)
    per = _stages(rs, S, D)
    x = rs.randn(12 if M == 6 else 8, D).astype("f")
    y, g, gx = _sequential(_tanh_stage, per, x)
    out = pool.run("torch_sharded_tasks.t_pipeline_apply", per, x, M,
                   schedule)
    for r in out:
        assert np.abs(r["y"] - y).max() < 1e-5
        for k in ("w", "b"):
            assert np.abs(r["grads"][k] - g[k]).max() < 1e-4, k
        assert np.abs(r["gx"] - gx).max() < 1e-4
    if S == 2:
        assert out[0]["issued"]["send"] == M     # stage 0: M forward sends


def test_pipeline_remat_stage_and_nan_safety(pool):
    rs = np.random.RandomState(1)
    per = _stages(rs, 2, 4)
    x = rs.randn(8, 4).astype("f")
    plain = pool.run("torch_sharded_tasks.t_pipeline_apply", per, x, 4,
                     "gpipe")[0]
    remat = pool.run("torch_sharded_tasks.t_pipeline_apply", per, x, 4,
                     "gpipe", True)[0]
    assert np.abs(plain["y"] - remat["y"]).max() < 1e-6
    # the reference's stage-layout flag is taken, and either value runs
    # the same pipeline (its default False is the oracle, ROADMAP C2)
    flagged = pool.run("torch_sharded_tasks.t_pipeline_apply", per, x, 4,
                       "gpipe", False, "tanh", True)[0]
    assert np.array_equal(flagged["y"], plain["y"])
    assert np.array_equal(flagged["grads"]["w"], plain["grads"]["w"])
    # a stage that makes NaN on an all-zero input: no bubble ever reaches
    # it, forward or backward
    rs = np.random.RandomState(2)
    per = _stages(rs, 2, 4, bias=False)
    x = rs.randn(8, 4).astype("f")
    y, g, _ = _sequential(_norm_stage, per, x)
    for schedule in ("gpipe", "1f1b"):
        r = pool.run("torch_sharded_tasks.t_pipeline_apply", per, x, 4,
                     schedule, False, "norm")[0]
        assert np.isfinite(r["y"]).all() and np.isfinite(r["grads"]["w"]).all()
        assert np.abs(r["y"] - y).max() < 1e-4
        assert np.abs(r["grads"]["w"] - g["w"]).max() < 1e-4


def test_pipeline_rejects_bad_configs(pool):
    msgs = pool.run("torch_sharded_tasks.t_pipeline_rejects")[0]
    assert "leading dim" in msgs[0]
    assert "num_microbatches" in msgs[1]
    assert "schedule" in msgs[2]


# ---------------------------------------------------------------------------
# TrainStep(pipeline=)
# ---------------------------------------------------------------------------
def _lm_loss(logits, labels):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, labels[..., None], axis=-1)


def _ref_llama(cfg):
    rmx.random.seed(0)
    net = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig(**cfg))
    net.initialize(ctx=rmx.cpu())
    net(rmx.nd.zeros((1, 8), dtype="int32"))
    return net


def _batches(seed, vocab=64, rows=8, steps=3, labels_extra=False):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (rows, 8)).astype("int32")
    if labels_extra:
        lbl = np.concatenate([rs.randint(0, vocab, (rows, 8)),
                              rs.randint(0, 2, (rows, 1))],
                             axis=1).astype("int32")
    else:
        lbl = rs.randint(0, vocab, (rows, 8)).astype("int32")
    return [(ids, lbl)] * steps


def _plain(model, cfg, weights, batches, optimizer="adam", opt=ADAM):
    from mxnet_tpu_torch.parallel import TrainStep

    net, loss = tasks._net(model, cfg, weights)
    step = TrainStep(net, loss, optimizer=optimizer, optimizer_params=opt,
                     device="cpu")
    return [float(step(x, y)) for x, y in batches]


@pytest.fixture(scope="module")
def llama_pp(pool):
    net = _ref_llama(LLAMA4)
    weights = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    batches = _batches(0)
    mesh = ref_make_mesh(dp=2, pp=2, devices=jax.devices()[:4])
    step = RefTrainStep(net, _lm_loss, optimizer="sgd",
                        optimizer_params=dict(SGD), mesh=mesh,
                        batch_axes=("dp",),
                        pipeline={"num_microbatches": 2,
                                  "schedule": "1f1b"})
    ref = ([float(step(x, y)) for x, y in batches],
           [np.asarray(step.params[k]) for k in net.collect_params()])
    runs = {}
    for sched, remat, fault in (("gpipe", False, None), ("1f1b", False, None),
                                ("gpipe", True, None),
                                ("1f1b", False, "reversed_backward")):
        pipe = {"num_microbatches": 2, "schedule": sched,
                "remat_stage": remat}
        runs[(sched, remat, fault)] = pool.run(
            "torch_sharded_tasks.t_train", "llama", LLAMA4, weights, batches,
            {"dp": 2, "pp": 2}, {"param_sharding": "replicated"}, "sgd",
            SGD, pipe, fault)[0]
    return ref, runs, _plain("llama", LLAMA4, weights, batches, "sgd", SGD)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_llama_pipeline_matches_the_reference(llama_pp, schedule):
    ref, runs, plain = llama_pp
    got = runs[(schedule, False, None)]
    np.testing.assert_allclose(got["losses"], ref[0], rtol=REL)
    assert _rel(got["params"], ref[1]) <= REL
    np.testing.assert_allclose(got["losses"], plain, rtol=1e-4, atol=1e-5)
    assert got["issued"]["send"] > 0 and got["issued"]["recv"] > 0
    assert got["losses"][-1] < got["losses"][0]


def test_llama_pipeline_remat_stage_and_planted_fault(llama_pp):
    _, runs, plain = llama_pp
    np.testing.assert_allclose(runs[("gpipe", True, None)]["losses"],
                               runs[("gpipe", False, None)]["losses"],
                               rtol=1e-5)
    bad = runs[("1f1b", False, "reversed_backward")]["losses"]
    assert not np.allclose(bad, plain, rtol=1e-4, atol=1e-5)


def test_four_axis_mesh_composition(pool):
    """fsdp = 2 x pp = 2 (tp and sp of size 1), the fsdp layout with the
    head's column-parallel spec, 1F1B: the unsharded step's losses."""
    from mxnet_tpu_torch.parallel.data_parallel import fsdp_specs
    from mxnet_tpu_torch.parallel import make_mesh

    net = _ref_llama(LLAMA4)
    weights = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    mesh = make_mesh(fsdp=2, pp=2, devices=[0, 1, 2, 3])
    shapes = {str(i): v for i, v in enumerate(weights.values())}
    specs = {i: tuple(s) for i, s in fsdp_specs(shapes, mesh).items()}
    head = [i for i, k in enumerate(weights) if k.endswith("lm_head_weight")]
    specs[str(head[0])] = ("tp", None)
    batches = _batches(2)
    got = pool.run("torch_sharded_tasks.t_train", "llama", LLAMA4, weights,
                   batches, {"fsdp": 2, "pp": 2}, {"specs": specs}, "adam",
                   ADAM, {"num_microbatches": 2, "schedule": "1f1b"})[0]
    assert np.isfinite(got["losses"]).all()
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"],
                               _plain("llama", LLAMA4, weights, batches),
                               rtol=1e-4, atol=1e-5)
    assert "gathered" in got["execution"].values()


def test_bert_pipeline_and_moe_llama(pool):
    from mxnet_tpu.gluon.model_zoo.language import bert as ref_bert

    cfg = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64, max_position=32, dropout=0.0)
    rmx.random.seed(0)
    net = ref_bert.BertForPretraining(ref_bert.BertConfig(**cfg))
    net.initialize(ctx=rmx.cpu())
    net(rmx.nd.zeros((1, 8), dtype="int32"))
    weights = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    batches = _batches(0, vocab=128, labels_extra=True)
    got = pool.run("torch_sharded_tasks.t_train", "bert", cfg, weights,
                   batches, {"dp": 2, "pp": 2},
                   {"param_sharding": "replicated"}, "adam", ADAM,
                   {"num_microbatches": 2, "schedule": "1f1b"})[0]
    np.testing.assert_allclose(got["losses"],
                               _plain("bert", cfg, weights, batches),
                               rtol=1e-4, atol=1e-5)
    moe_cfg = dict(LLAMA4, num_experts=2, intermediate_size=32)
    mnet = _ref_llama(moe_cfg)
    mw = {k: p.data().asnumpy() for k, p in mnet.collect_params().items()}
    moe = pool.run("torch_sharded_tasks.t_train", "llama", moe_cfg, mw,
                   _batches(3, steps=4), {"dp": 2, "pp": 2},
                   {"param_sharding": "replicated"}, "adam", ADAM,
                   {"num_microbatches": 2, "schedule": "1f1b"})[0]
    assert np.isfinite(moe["losses"]).all()
    assert moe["losses"][-1] < moe["losses"][0]
