"""Context parallelism (ring and Ulysses attention over ``sp``) and expert
parallelism (``moe_apply`` over ``ep``) of the port, held against the
reference on the CPU.

Four spawned gloo ranks (``tests/torch_dist_pool.py``, tasks in
``tests/torch_sharded_tasks.py``), the sequence or the experts split four
ways:

- ``context_parallel_attention`` (K/V around the ring by ``ppermute``)
  and ``ulysses_context_parallel_attention`` (two ``all_to_all``s) on the
  reference's (2, 8, 64, 16) inputs, causal and not: every rank's output
  within 1e-4 of the reference's dense ``_mha_reference`` over the whole
  sequence, and the gradient to q within 1e-3 of the reference's
  (``tests/test_parallel.py:455-500``).  The ring's rotations and the
  all-to-alls show in the collectives' counter.  A planted fault (the
  ring taking each K/V shard for its neighbour's, an off-by-one in the
  source shard) must miss the 1e-4 bound; Ulysses with heads the axis
  does not divide raises ValueError.
- ``moe_apply(mesh=)``: the output within 1e-5 of the reference's
  ``moe_apply`` on an ep mesh (``tests/test_parallel.py:253-293``), the
  gradients to the stacked expert weights and the router within 1e-5 of
  the reference's, each rank computing only its own experts.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mxnet_tpu.ops.flash_attention import _mha_reference
from mxnet_tpu.parallel.expert_parallel import moe_apply as ref_moe_apply
from mxnet_tpu.parallel.expert_parallel import \
    stack_expert_params as ref_stack

from torch_dist_pool import DistPool
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = DistPool(WORLD, tmp_path_factory.mktemp("cp"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def qkv():
    rs = np.random.RandomState(0)
    return tuple(rs.randn(2, 8, 64, 16).astype("f") for _ in range(3))


def _ref(q, k, v, causal):
    scale = 1.0 / np.sqrt(16)
    o = _mha_reference(q, k, v, causal, scale)
    g = jax.grad(lambda qq: (_mha_reference(qq, k, v, causal, scale)
                             ** 2).sum())(q)
    return np.asarray(o), np.asarray(g)


@pytest.mark.parametrize("which", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_the_reference(pool, qkv, which, causal):
    q, k, v = qkv
    o, g = _ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    out = pool.run("torch_sharded_tasks.t_attention", q, k, v, causal, which,
                   None, True)
    for r in out:
        assert np.abs(r["o"] - o).max() < 1e-4
        assert np.abs(r["gq"] - g).max() < 1e-3
    issued = out[0]["issued"]          # the forward's
    if which == "ring":
        assert issued["ppermute"] == 2 * (WORLD - 1)   # K and V, n - 1 hops
    else:
        assert issued["all_to_all"] == 4               # q, k, v there, o back


def test_ring_planted_source_fault_and_ulysses_heads(pool, qkv):
    q, k, v = qkv
    o, _ = _ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    bad = pool.run("torch_sharded_tasks.t_attention", q, k, v, True, "ring",
                   "ring_source")[0]
    assert np.abs(bad["o"] - o).max() > 1e-4
    msgs = pool.run("torch_sharded_tasks.t_ulysses_indivisible")
    assert all(m is not None and "divisible" in m for m in msgs)


def test_moe_over_ep_matches_the_reference(pool):
    rs = np.random.RandomState(0)
    T, d, E = 32, 8, 4
    x = rs.randn(T, d).astype("f")
    wr = (rs.randn(d, E) * 0.5).astype("f")
    per = [{"w": (rs.randn(d, d) * 0.4).astype("f")} for _ in range(E)]

    def expert_fn(p, toks):
        return jnp.tanh(toks @ p["w"])

    mesh = Mesh(np.array(jax.devices()[:E]), ("ep",))
    params = ref_stack([{"w": jnp.asarray(p["w"])} for p in per])

    def total(p, w):
        return ref_moe_apply(expert_fn, p, w, jnp.asarray(x), mesh=mesh,
                             capacity_factor=8.0)[0].sum()

    ref_out = np.asarray(jax.jit(lambda p, w: ref_moe_apply(
        expert_fn, p, w, jnp.asarray(x), mesh=mesh,
        capacity_factor=8.0)[0])(params, jnp.asarray(wr)))
    gw, gr = jax.grad(total, argnums=(0, 1))(params, jnp.asarray(wr))
    out = pool.run("torch_sharded_tasks.t_moe", x, wr, per, 8.0)
    for r in out:
        assert np.abs(r["out"] - ref_out).max() < 1e-5
        assert np.abs(r["gw"] - np.asarray(gw["w"])).max() < 1e-5
        assert np.abs(r["gr"] - np.asarray(gr)).max() < 1e-5
        assert r["dropped"] == 0
    assert out[0]["issued"]["all_gather"] >= 1
