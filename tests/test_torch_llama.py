"""The port's Llama (mxnet_tpu_torch.gluon.model_zoo.language.llama) held
against the reference on the CPU.

The reference ``llama_tiny`` is initialised in JAX, its weights handed over
as numpy arrays through ``load_reference_params``, and the same token ids
(numpy, seeded) go through both.  Tolerance: 1e-5 absolute in fp32 on
logits of magnitude ~1 and on the k/v stacks (the two frameworks sum in
different orders).  Decode is held to the reference's ``decode_apply`` and
to the port's own full-context forward at the same 1e-5: the reference's
decode is itself not bit-equal to its full-context forward on this JAX
version, so no test here asks for bit equality.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo.language import llama as ref_llama
from mxnet_tpu.ops import attention_ops as ref_ops
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.language import llama as port_llama
from mxnet_tpu_torch.ops import attention_ops as port_ops

ATOL = 1e-5


@pytest.fixture(scope="module")
def nets():
    """(reference net, port net with the reference's weights)."""
    ref = ref_llama.llama_tiny()
    ref.initialize()
    ref(nd.zeros((1, 8), dtype="int32"))     # settle deferred shapes
    params = {k: np.asarray(v)
              for k, v in ref_llama.serving_params(ref).items()}
    # give the norms non-trivial weights so their carry-over is tested too
    r = np.random.RandomState(7)
    for name in params:
        if name.endswith("norm.weight"):
            params[name] = (1.0 + 0.1 * r.randn(*params[name].shape)) \
                .astype("float32")
    for name, p in ref._collect_params_with_prefix().items():
        p.set_data(nd.array(params[name]))
    port = port_llama.llama_tiny(device="cpu")
    port_llama.load_reference_params(port, params)
    return ref, port, params


def _ids(seed, b, l):
    return np.random.RandomState(seed).randint(0, 512, (b, l)) \
        .astype("int32")


# -- attention ops ---------------------------------------------------------
def test_rms_norm_matches_reference():
    r = np.random.RandomState(0)
    x = r.randn(2, 5, 64).astype("float32")
    g = r.randn(64).astype("float32")
    ref = np.asarray(ref_ops.rms_norm(jnp.asarray(x), jnp.asarray(g),
                                      eps=1e-5))
    out = port_ops.rms_norm(torch.from_numpy(x), torch.from_numpy(g),
                            eps=1e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    # fp32 inside, the input dtype outside
    assert port_ops.rms_norm(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(g)).dtype == torch.bfloat16


@pytest.mark.parametrize("form", ["none", "shared", "per_row"])
def test_rope_matches_reference(form):
    r = np.random.RandomState(1)
    x = r.randn(2, 3, 7, 32).astype("float32")
    pos = {"none": None,
           "shared": np.arange(3, 10, dtype="int32"),
           "per_row": r.randint(0, 50, (2, 7)).astype("int32")}[form]
    ref = np.asarray(ref_ops.rope(
        jnp.asarray(x), positions=None if pos is None else jnp.asarray(pos),
        base=500000.0))
    out = port_ops.rope(torch.from_numpy(x),
                        positions=None if pos is None
                        else torch.from_numpy(pos), base=500000.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_swiglu_matches_reference():
    r = np.random.RandomState(2)
    g, u = r.randn(4, 33).astype("float32"), r.randn(4, 33).astype("float32")
    ref = np.asarray(ref_ops.swiglu(jnp.asarray(g), jnp.asarray(u)))
    out = port_ops.swiglu(torch.from_numpy(g), torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


# -- weights ---------------------------------------------------------------
def test_state_dict_keys_are_the_reference_structural_names(nets):
    ref, port, params = nets
    assert set(port.state_dict()) == set(params)
    for name, p in port.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), params[name])


def test_load_reference_params_rejects_mismatches(nets):
    _, _, params = nets
    port = port_llama.llama_tiny(device="cpu")
    missing = dict(params)
    missing.pop("model.norm.weight")
    with pytest.raises(MXNetError, match="missing"):
        port_llama.load_reference_params(port, missing)
    extra = dict(params, **{"model.layers.9.mlp.up_proj.weight":
                            params["model.layers.0.mlp.up_proj.weight"]})
    with pytest.raises(MXNetError, match="extra"):
        port_llama.load_reference_params(port, extra)
    bad = dict(params)
    bad["lm_head.weight"] = bad["lm_head.weight"][:, :64]
    with pytest.raises(MXNetError, match="shape"):
        port_llama.load_reference_params(port, bad)


def test_init_random_is_seeded_and_keeps_norms_at_one():
    a = port_llama.init_random_(port_llama.llama_tiny(device="cpu"), 5)
    b = port_llama.init_random_(port_llama.llama_tiny(device="cpu"), 5)
    for (name, pa), (_, pb) in zip(sorted(a.state_dict().items()),
                                   sorted(b.state_dict().items())):
        assert torch.equal(pa, pb)
        if name.endswith("norm.weight"):
            assert torch.all(pa == 1.0)
        else:
            assert abs(pa.std().item() - 0.02) < 0.004


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(MXNetError, match="no CUDA device"):
        port_llama.llama_tiny()
    with pytest.raises(MXNetError, match="no CUDA device"):
        port_llama.LlamaForCausalLM(port_llama.LlamaConfig(
            vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
            num_kv_heads=1, intermediate_size=64)).initialize()


def test_moe_config_is_refused():
    """An MoE net builds and trains; the serving entry points refuse it,
    as the reference's prefill_apply / decode_apply / ServingEngine do."""
    from mxnet_tpu_torch.serving import ServingEngine

    net = port_llama.llama_tiny(device="cpu", num_experts=4)
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(MXNetError, match="MoE"):
        port_llama.prefill_apply(port_llama.serving_params(net), net.config,
                                 ids)
    with pytest.raises(MXNetError, match="MoE"):
        port_llama.decode_apply(port_llama.serving_params(net), net.config,
                                ids[:, 0], ids[:, 0], None)
    with pytest.raises(MXNetError, match="MoE"):
        ServingEngine(net, device="cpu")


# -- forwards --------------------------------------------------------------
def test_full_forward_logits_match_reference(nets):
    ref, port, _ = nets
    ids = _ids(3, 2, 11)
    want = ref(nd.array(ids, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_parameter_gradients_match_reference(nets):
    """Every parameter's gradient of sum(logits * cotangent) against the
    reference's (``autograd.record`` / ``backward``, weights carried over),
    within 1e-5 of the larger of 1 and the gradient's magnitude.  The
    attention's gradients pass through the port's flash-attention backward
    (causal, GQA 4/2), so the q/k/v projections must get theirs."""
    from mxnet_tpu import autograd as ref_autograd

    ref, port, _ = nets
    ids = _ids(8, 2, 24)
    cot = np.random.RandomState(9).randn(2, 24, 512).astype("float32")
    with ref_autograd.record():
        logits = ref(nd.array(ids))
        head = (logits * nd.array(cot)).sum()
    head.backward()
    ref_grads = {k: p.grad().asnumpy()
                 for k, p in ref._collect_params_with_prefix().items()}
    port.zero_grad()
    (port(torch.from_numpy(ids)) * torch.from_numpy(cot)).sum().backward()
    for name, p in port.named_parameters():
        want = ref_grads[name]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=ATOL * scale, err_msg=name)
        if "_proj" in name:
            assert np.abs(p.grad.numpy()).max() > 0, name
    port.zero_grad()


def test_prefill_apply_logits_and_kv_match_reference(nets):
    ref, port, _ = nets
    ids = _ids(4, 2, 13)
    cfg = ref.config
    logits_r, k_r, v_r = ref_llama.prefill_apply(
        ref_llama.serving_params(ref), cfg, jnp.asarray(ids))
    with torch.no_grad():
        logits, k, v = port_llama.prefill_apply(
            port_llama.serving_params(port), port.config,
            torch.from_numpy(ids))
    assert k.shape == (cfg.num_layers, 2, cfg.num_kv_heads, 13,
                       cfg.head_dim)
    for got, want in ((logits, logits_r), (k, k_r), (v, v_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def _staggered_cache(net, ids_a, ids_b, n_a, n_b):
    """One dense 2-row cache holding ids_a[:n_a] in row 0 and ids_b[:n_b]
    in row 1 (per-row positions, the continuous-batching case)."""
    cache = net.init_decode_cache(2, max_len=16)
    for row, (ids, n) in enumerate(((ids_a, n_a), (ids_b, n_b))):
        c = net.init_decode_cache(1, max_len=16)
        net.prefill(ids[:, :n], c)
        if isinstance(c["k"], torch.Tensor):
            cache["k"][:, row] = c["k"][:, 0]
            cache["v"][:, row] = c["v"][:, 0]
        else:
            cache["k"] = cache["k"].at[:, row].set(c["k"][:, 0])
            cache["v"] = cache["v"].at[:, row].set(c["v"][:, 0])
    return cache


def test_decode_per_row_positions_gqa_matches_reference_and_full(nets):
    ref, port, _ = nets
    assert port.config.num_heads != port.config.num_kv_heads   # GQA
    ids_a, ids_b = _ids(5, 1, 9), _ids(6, 1, 7)
    toks = np.array([ids_a[0, 6], ids_b[0, 4]], dtype="int32")
    pos = np.array([6, 4], dtype="int32")
    rcache = _staggered_cache(ref, nd.array(ids_a, dtype="int32")._get(),
                              nd.array(ids_b, dtype="int32")._get(), 6, 4)
    want = ref.decode_step(toks, rcache, positions=jnp.asarray(pos)) \
        .asnumpy()
    pcache = _staggered_cache(port, ids_a, ids_b, 6, 4)
    got = port.decode_step(toks, pcache, positions=pos).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    with torch.no_grad():
        full_a = port(torch.from_numpy(ids_a)).numpy()
        full_b = port(torch.from_numpy(ids_b)).numpy()
    np.testing.assert_allclose(got[0], full_a[0, 6], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[1], full_b[0, 4], rtol=0, atol=ATOL)


def test_sequential_decode_matches_full_context(nets):
    _, port, _ = nets
    ids = _ids(8, 2, 10)
    cache = port.init_decode_cache(2, max_len=16)
    port.prefill(ids[:, :4], cache)
    with torch.no_grad():
        full = port(torch.from_numpy(ids)).numpy()
    for t in range(4, 10):
        step = port.decode_step(ids[:, t], cache).numpy()
        np.testing.assert_allclose(step, full[:, t], rtol=0, atol=ATOL)
    assert cache["len"] == 10
