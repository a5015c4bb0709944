"""Megatron tensor parallelism and FSDP of the port, held against the
reference on the CPU.

The spec builders (``specs_from_rules``, ``megatron_specs``,
``moe_expert_specs``, ``validate_specs``) give the reference's specs on the
same names and shapes.  The sharded steps run on four spawned gloo ranks
(``tests/torch_dist_pool.py``, tasks in ``tests/torch_sharded_tasks.py``),
each on its rows of the global batch; the reference runs the same step on
the same mesh over four of the eight virtual devices (GSPMD), from the
same weights (``load_reference_params``):

- Llama (2 layers, hidden 32, 4/2 heads) under the ``megatron`` plan on
  dp = 2 x tp = 2, 3 steps: with SGD 0.1 and momentum 0.9 (linear in the
  gradients) the losses and every parameter within 1e-4 of the
  reference's (relative to each tensor's largest entry); with Adam 1e-3,
  the reference's own test, against the port's own unsharded step at the
  reference's bounds (``tests/test_tensor_parallel.py``: losses rtol
  2e-4, atol 2e-5; parameters rtol 2e-3, atol 2e-4).  q_proj is held
  as its tp tile and runs as ``tp``; the tp all-reduces show in the
  collectives' counter.
  Two planted faults (the row-parallel all-reduce left out, the kv heads
  cut off their query groups) must each miss the plain-step bound.
- The reference's ``test_train_step_fsdp_mesh_matches_single_device``
  net (Dense, BatchNorm, Dense) with ``param_sharding="fsdp"`` on dp = 2
  x fsdp = 2, SGD 0.1: losses and parameters within 1e-4 relative of the
  reference's, and of the port's plain step at the reference's bound
  (rtol 1e-4, atol 1e-5); every split parameter runs ``gathered``.
"""
import numpy as np
import pytest

import jax
import mxnet_tpu as rmx
from mxnet_tpu.gluon.model_zoo.language import llama as ref_llama
from mxnet_tpu.parallel import make_mesh as ref_make_mesh
from mxnet_tpu.parallel import tensor_parallel as ref_tp
from mxnet_tpu.parallel.data_parallel import TrainStep as RefTrainStep

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.parallel import make_mesh
from mxnet_tpu_torch.parallel import tensor_parallel as tp

import torch_sharded_tasks as tasks
from torch_dist_pool import DistPool
from torch_threads import one_torch_thread  # noqa: F401

ADAM = {"learning_rate": 1e-3}
SGD = {"learning_rate": 0.1}
SGD_MOM = {"learning_rate": 0.1, "momentum": 0.9}
REL = 1e-4                      # port vs reference, each tensor


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = DistPool(4, tmp_path_factory.mktemp("tp"))
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
# the spec builders
# ---------------------------------------------------------------------------
class _A:
    def __init__(self, shape):
        self.shape = shape


def _both(fn, params, sizes, **kw):
    """``fn`` of the reference and of the port on the same names and
    shapes, over a mesh of ``sizes``: both as {name: tuple}."""
    n = int(np.prod(list(sizes.values())))
    ref_mesh = ref_make_mesh(devices=jax.devices()[:n], **sizes)
    got = getattr(tp, fn)(params, make_mesh(devices=list(range(n)),
                                            **sizes), **kw)
    want = getattr(ref_tp, fn)(params, ref_mesh, **kw)
    return ({k: tuple(v) for k, v in got.items()},
            {k: tuple(v) for k, v in want.items()})


def _llama_params():
    net = tasks._net("llama", tasks.LLAMA, _ref_llama_weights()[1])[0]
    return {k: p.data() for k, p in net.collect_params().items()}


SPEC_CASES = {
    "megatron_llama": ("megatron_specs", None, {"tp": 2}),
    "indivisible": ("specs_from_rules", {"x_q_proj_weight": _A((12, 6))},
                    {"tp": 8}),
    "pinned": ("specs_from_rules", {"a_weight": _A((4, 4)),
                                    "b_weight": _A((4, 4))}, {"tp": 2}),
    "moe_rank_exact": ("megatron_specs", {
        "layers_0_mlp_gate_proj_weight": _A((4, 16, 32)),
        "layers_0_mlp_router_weight": _A((16, 4)),
        "layers_0_self_attn_q_proj_weight": _A((32, 16))},
        {"tp": 2, "ep": 4}),
    "moe_expert": ("moe_expert_specs", {
        "layers_0_mlp_gate_proj_weight": _A((4, 16, 32)),
        "layers_0_mlp_router_weight": _A((16, 4)),
        "layers_0_self_attn_q_proj_weight": _A((32, 16))},
        {"tp": 2, "ep": 4}),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_specs_match_the_reference(case):
    fn, params, sizes = SPEC_CASES[case]
    if params is None:
        params = _llama_params()
    if case == "indivisible":
        got = tp.specs_from_rules(params, tp.MEGATRON_RULES,
                                  make_mesh(devices=list(range(8)), tp=8))
        want = ref_tp.specs_from_rules(
            params, ref_tp.MEGATRON_RULES,
            ref_make_mesh(tp=8, devices=jax.devices()[:8]))
        got, want = ({k: tuple(v) for k, v in got.items()},
                     {k: tuple(v) for k, v in want.items()})
    elif case == "pinned":
        rules = (("a_weight$", (None, None)), ("b_weight$", ("tp", None)))
        got = tp.specs_from_rules(params, rules,
                                  make_mesh(devices=[0, 1], tp=2))
        want = ref_tp.specs_from_rules(
            params, rules, ref_make_mesh(tp=2, devices=jax.devices()[:2]))
        got, want = ({k: tuple(v) for k, v in got.items()},
                     {k: tuple(v) for k, v in want.items()})
    else:
        got, want = _both(fn, params, sizes)
    if case == "megatron_llama":
        # the names differ by their counters; the positions agree
        got, want = list(got.values()), list(want.values())
        assert ("tp", None) in got and (None, "tp") in got
    assert got == want


def test_validate_specs_and_missing_axis_raise():
    params = {"w": np.zeros((12, 6))}
    mesh = make_mesh(devices=list(range(8)), tp=8)
    with pytest.raises(mx.MXNetError):
        tp.validate_specs(params, {"w": ("tp", None)}, mesh)
    assert tp.validate_specs({"w": np.zeros((16, 6))}, {"w": ("tp", None)},
                             mesh)
    with pytest.raises(mx.MXNetError):
        tp.megatron_specs({}, {"x": 8})        # no 'tp' axis


# ---------------------------------------------------------------------------
# the sharded steps against the reference's
# ---------------------------------------------------------------------------
def _ref_lm_loss(logits, labels):
    import jax.numpy as jnp

    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, labels[..., None], axis=-1)


_CACHE = {}


def _ref_llama_weights(cfg=None):
    cfg = dict(cfg or tasks.LLAMA)
    key = ("llama", tuple(sorted(cfg.items())))
    if key not in _CACHE:
        rmx.random.seed(0)
        net = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig(**cfg))
        net.initialize()
        net(rmx.nd.zeros((1, 8), dtype="int32"))
        _CACHE[key] = (net, {k: p.data().asnumpy()
                             for k, p in net.collect_params().items()})
    return _CACHE[key]


def _llama_batches(steps=3):
    x = np.random.RandomState(0).randint(0, 64, (4, 16)).astype("int32")
    y = np.random.RandomState(1).randint(0, 64, (4, 16)).astype("int32")
    return [(x, y)] * steps


def _ref_run(net, loss, batches, optimizer, opt, mesh_kw, specs_fn=None):
    n = int(np.prod(list(mesh_kw.values())))
    mesh = ref_make_mesh(devices=jax.devices()[:n], **mesh_kw)
    kw = {}
    if specs_fn is not None:
        params = {k: p.data() for k, p in net.collect_params().items()}
        kw["extra_param_specs"] = specs_fn(params, mesh)
    step = RefTrainStep(net, loss, optimizer=optimizer,
                        optimizer_params=dict(opt), mesh=mesh, **kw)
    losses = [float(step(x, y)) for x, y in batches]
    params = [np.asarray(step.params[k]) for k in net.collect_params()]
    return losses, params


@pytest.fixture(scope="module")
def llama_runs(pool):
    """The megatron step on the port's ranks (clean and the two planted
    faults), the reference's, and the port's plain one-process step."""
    net, weights = _ref_llama_weights()
    batches = _llama_batches()
    ref = _ref_run(net, _ref_lm_loss, batches, "sgd", SGD_MOM,
                   {"dp": 2, "tp": 2}, ref_tp.megatron_specs)
    runs = {"sgd": pool.run("torch_sharded_tasks.t_train", "llama",
                            tasks.LLAMA, weights, batches, {"dp": 2, "tp": 2},
                            {"rules": "megatron"}, "sgd", SGD_MOM)}
    for fault in (None, "no_row_reduce", "kv_split"):
        runs[fault] = pool.run("torch_sharded_tasks.t_train", "llama",
                               tasks.LLAMA, weights, batches,
                               {"dp": 2, "tp": 2}, {"rules": "megatron"},
                               "adam", ADAM, None, fault)
    from mxnet_tpu_torch.parallel import TrainStep

    pnet, loss = tasks._net("llama", tasks.LLAMA, weights)
    step = TrainStep(pnet, loss, optimizer="adam", optimizer_params=ADAM,
                     device="cpu")
    plain = ([float(step(x, y)) for x, y in batches],
             [step.params[k].detach().numpy()
              for k in pnet.collect_params()])
    return ref, runs, plain


def test_megatron_step_matches_the_reference(llama_runs):
    ref, runs, _ = llama_runs
    got = runs["sgd"][0]
    for r in runs["sgd"][1:]:       # every rank holds the same result
        assert r["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], ref[0], rtol=REL)
    assert _rel(got["params"], ref[1]) <= REL


def test_megatron_step_runs_tensor_parallel(llama_runs):
    _, runs, plain = llama_runs
    got = runs[None][0]
    np.testing.assert_allclose(got["losses"], plain[0], rtol=2e-4,
                               atol=2e-5)
    for g, w in zip(got["params"], plain[1]):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)
    ex = got["execution"]
    assert set(ex.values()) == {"tp", "local"}
    # q_proj of layer 0: position 3 in collect_params order, held as its
    # tile of 32 / 2 output rows
    pnet = tasks._net("llama", tasks.LLAMA, _ref_llama_weights()[1])[0]
    names = list(pnet.collect_params())
    q = next(i for i, n in enumerate(names) if "0_self_attn_q_proj" in n)
    assert ex[q] == "tp" and got["local_shapes"][q] == (16, 32)
    assert got["issued"]["psum"] >= 4 * 3 * 2      # o and down, fwd+bwd
    assert "execution" in got["plan_text"]


@pytest.mark.parametrize("fault", ["no_row_reduce", "kv_split"])
def test_megatron_planted_faults_miss_the_bound(llama_runs, fault):
    _, runs, plain = llama_runs
    got = runs[fault][0]
    close = np.allclose(got["losses"], plain[0], rtol=2e-4, atol=2e-5) and \
        all(np.allclose(g, w, rtol=2e-3, atol=2e-4)
            for g, w in zip(got["params"], plain[1]))
    assert not close, fault


def _ref_tiny_bn():
    from mxnet_tpu import gluon as rgluon

    rmx.random.seed(0)
    net = rgluon.nn.HybridSequential()
    net.add(rgluon.nn.Dense(16, activation="relu"), rgluon.nn.BatchNorm(),
            rgluon.nn.Dense(4))
    net.initialize()
    net(rmx.nd.zeros((2, 8)))
    return net


def _ref_ce(logits, labels):
    import jax.numpy as jnp

    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, labels[:, None], axis=-1)


def test_fsdp_step_matches_the_reference_and_the_plain_step(pool):
    net = _ref_tiny_bn()
    weights = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    r = np.random.RandomState(0)
    x = r.randn(8, 8).astype("float32")
    y = (x.sum(axis=1) > 0).astype("int32")
    batches = [(x, y)] * 3
    ref = _ref_run(net, _ref_ce, batches, "sgd", SGD, {"dp": 2, "fsdp": 2})
    # the reference's step with param_sharding="fsdp"
    net2 = _ref_tiny_bn()
    for p, v in zip(net2.collect_params().values(), weights.values()):
        p.set_data(rmx.nd.array(v))
    mesh = ref_make_mesh(dp=2, fsdp=2, devices=jax.devices()[:4])
    rstep = RefTrainStep(net2, _ref_ce, optimizer="sgd",
                         optimizer_params=dict(SGD), mesh=mesh,
                         param_sharding="fsdp")
    ref_fsdp = [float(rstep(x, y)) for x, y in batches]
    ref_params = [np.asarray(rstep.params[k]) for k in net2.collect_params()]
    np.testing.assert_allclose(ref_fsdp, ref[0], rtol=1e-4, atol=1e-5)
    out = pool.run("torch_sharded_tasks.t_train", "mlp_bn", {"classes": 4},
                   weights, batches, {"dp": 2, "fsdp": 2},
                   {"param_sharding": "fsdp"}, "sgd", SGD)
    got = out[0]
    np.testing.assert_allclose(got["losses"], ref_fsdp, rtol=REL)
    assert _rel(got["params"], ref_params) <= REL
    split = {i for i, e in got["execution"].items() if e != "local"}
    assert split and {got["execution"][i] for i in split} == {"gathered"}
    assert got["issued"].get("reduce_scatter", 0) > 0
    # against the port's own plain step
    from mxnet_tpu_torch.parallel import TrainStep

    pnet, loss = tasks._net("mlp_bn", {"classes": 4}, weights)
    step = TrainStep(pnet, loss, optimizer="sgd", optimizer_params=SGD,
                     device="cpu")
    plain = [float(step(x, y)) for x, y in batches]
    np.testing.assert_allclose(got["losses"], plain, rtol=1e-4, atol=1e-5)
