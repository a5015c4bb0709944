"""The port's Llama training path held against the reference on the CPU: the
LLM ops of the op table, the Gluon Llama blocks, ``TrainStep`` (SGD, Adam,
bf16, ``remat``), the imperative Trainer loop, the switch-MoE FFN
(``parallel.expert_parallel``) and serving a net after training it.

The reference builds its nets with ``nd.set_eager_jit(False)`` (eager
initializer ops would each compile) and its weights are carried over with
``gluon.load_reference_params`` (by position); inputs come from seeded
numpy.

Tolerances, each of the larger of 1 and the tensor's magnitude:
- fp32 forwards, the ops, one SGD step: 1e-5.
- Adam (``ADAM_TOL``, 1e-4 = a tenth of one step's lr of 1e-3): Adam's
  first steps move each weight by about lr times the sign of its
  gradient, so a weight whose gradient is rounding noise may step either
  way.  Measured: 1 or 2 elements of a tensor move apart, by up to
  2.7e-5 after three steps; every other element agrees to 1e-6
  (``ADAM_OUTLIERS`` bounds their share).  A fault in the update moves
  whole tensors by about lr.
- remat against no remat: bit-equal (the same ops recomputed on the same
  inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as rautograd
from mxnet_tpu import gluon as rgluon
from mxnet_tpu import nd as rnd
from mxnet_tpu.contrib.amp import lists as ref_amp_lists
from mxnet_tpu.gluon.model_zoo.language import llama as ref_llama
from mxnet_tpu.parallel import expert_parallel as ref_ep
from mxnet_tpu.parallel.data_parallel import TrainStep as RefTrainStep
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp as port_amp
from mxnet_tpu_torch.contrib.amp import lists as port_amp_lists
from mxnet_tpu_torch.gluon.model_zoo.language import llama as port_llama
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.parallel import expert_parallel as port_ep
from mxnet_tpu_torch.parallel import functional as port_functional

CPU = mx.cpu()
TOL = 1e-5
ADAM_TOL = 1e-4
ADAM_OUTLIERS = 1e-3
SGD = {"learning_rate": 0.1}
ADAM = {"learning_rate": 1e-3}
# test_llm.py's MoE configuration
MOE_CFG = dict(vocab_size=48, hidden_size=16, num_layers=2, num_heads=2,
               num_kv_heads=2, intermediate_size=24, max_seq_len=8,
               num_experts=4, moe_capacity_factor=2.0)


def _ref_ce(logits, y):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, y[..., None], axis=-1)


def _port_ce(logits, y):
    return -torch.log_softmax(logits, dim=-1).gather(-1, y.long()[..., None])


def _close(port, ref, tol=TOL, msg=""):
    port = port.detach().float().numpy() if isinstance(
        port, torch.Tensor) else np.asarray(port, np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale,
                               err_msg=msg)


def _ref_net(**cfg):
    prev = rnd.set_eager_jit(False)
    try:
        net = ref_llama.llama_tiny(**cfg)
        net.initialize()
        net(rnd.zeros((1, 8), dtype="int32"))
    finally:
        rnd.set_eager_jit(prev)
    return net


def _port_net(ref, **cfg):
    """The port's llama_tiny(**cfg) holding ``ref``'s weights."""
    net = port_llama.llama_tiny(device="cpu", **cfg)
    gluon.load_reference_params(net, {k: p.data().asnumpy() for k, p in
                                      ref.collect_params().items()})
    return net


def _batch(seed, b=2, l=16, vocab=512):
    r = np.random.RandomState(seed)
    return (r.randint(0, vocab, (b, l)).astype("int32"),
            r.randint(0, vocab, (b, l)).astype("int32"))


@pytest.fixture(scope="module")
def tiny():
    """(reference llama_tiny, the names of both nets in order)."""
    ref = _ref_net()
    port = _port_net(ref)
    return ref, list(zip(ref.collect_params(), port.collect_params()))


def _ref_steps(ref, opt, params, n, x, y, dtype=None):
    rs = RefTrainStep(ref, _ref_ce, optimizer=opt, optimizer_params=params,
                      dtype=dtype)
    return [float(np.asarray(rs(x, y))) for _ in range(n)], rs.params


def _port_steps(net, opt, params, n, x, y, loss_fn=_port_ce, **kw):
    ps = TrainStep(net, loss_fn, optimizer=opt, optimizer_params=params,
                   device="cpu", **kw)
    return [ps(x, y).item() for _ in range(n)], ps


# -- the LLM ops -----------------------------------------------------------
def test_llm_ops_are_registered_and_match_reference():
    r = np.random.RandomState(0)
    x = r.randn(2, 5, 64).astype("float32")
    g = r.randn(64).astype("float32")
    _close(nd.rms_norm(nd.array(x, ctx=CPU), nd.array(g, ctx=CPU),
                       eps=1e-5).asnumpy(),
           rnd.rms_norm(rnd.array(x), rnd.array(g), eps=1e-5).asnumpy())
    a, b = r.randn(3, 7, 33).astype("float32"), r.randn(3, 7, 33) \
        .astype("float32")
    _close(nd.swiglu(nd.array(a, ctx=CPU), nd.array(b, ctx=CPU)).asnumpy(),
           rnd.swiglu(rnd.array(a), rnd.array(b)).asnumpy())
    q = r.randn(2, 3, 7, 32).astype("float32")
    pos = r.randint(0, 50, (2, 7)).astype("float32")        # (B, L)
    _close(nd.rope(nd.array(q, ctx=CPU), nd.array(pos, ctx=CPU),
                   base=500000.0).asnumpy(),
           rnd.rope(rnd.array(q), rnd.array(pos), base=500000.0).asnumpy())
    _close(nd.rope(nd.array(q, ctx=CPU)).asnumpy(),
           rnd.rope(rnd.array(q)).asnumpy())


@pytest.mark.parametrize("weight", [0.0, 0.5])
def test_moe_swiglu_op_matches_reference(weight):
    r = np.random.RandomState(1)
    E, H, I = 4, 16, 24
    args = [r.randn(2, 8, H), r.randn(H, E), 0.3 * r.randn(E, H, I),
            0.3 * r.randn(E, H, I), 0.3 * r.randn(E, I, H)]
    args = [a.astype("float32") for a in args]
    kw = dict(capacity_factor=1.0, aux_loss_weight=weight)
    got = nd.moe_swiglu(*(nd.array(a, ctx=CPU) for a in args), **kw)
    want = rnd.moe_swiglu(*(rnd.array(a) for a in args), **kw)
    _close(got.asnumpy(), want.asnumpy())
    assert get_op("moe_swiglu") is get_op("_contrib_moe_swiglu")


def test_llm_ops_run_in_the_dtype_they_receive_under_amp():
    """No LLM op is on either package's AMP lists, so under a bf16 step
    each computes in the dtype that reaches it (fp32 inside rms_norm and
    rope's angles, the input dtype outside)."""
    names = ("rms_norm", "rope", "swiglu", "_contrib_moe_swiglu",
             "moe_swiglu")
    for lists in (ref_amp_lists, port_amp_lists):
        assert not set(names) & set(lists.TARGET_DTYPE_OPS + lists.FP32_OPS)
    r = np.random.RandomState(2)
    x = r.randn(1, 2, 4, 8).astype("float32")
    with port_amp._cast_scope("bfloat16"):
        for dt in ("float32", "bfloat16"):
            t = nd.array(x, ctx=CPU).astype(dt)
            g = nd.array(np.ones(8, "float32"), ctx=CPU)
            assert nd.rms_norm(t, g).dtype == dt
            assert nd.rope(t).dtype == dt
            assert nd.swiglu(t, t).dtype == dt
            # FullyConnected is on the target list: it casts down
            w = nd.array(np.ones((3, 8), "float32"), ctx=CPU)
            assert nd.FullyConnected(t, w, num_hidden=3, no_bias=True,
                                     flatten=False).dtype == "bfloat16"


# -- the Gluon Llama -------------------------------------------------------
def test_gluon_llama_has_the_reference_parameters(tiny):
    ref, names = tiny
    port = port_llama.llama_tiny(device="cpu")
    assert [n.split("_", 1)[1] for n, _ in names] == \
        [n.split("_", 1)[1] for _, n in names]
    assert list(port._collect_params_with_prefix()) == \
        list(ref._collect_params_with_prefix())
    for (rn, rp), (pn, pp) in zip(ref.collect_params().items(),
                                  port.collect_params().items()):
        assert rp.shape == pp.shape, (rn, pn)
    assert port.config.num_layers == 2 and port.config.remat is False


def test_gluon_forward_logits_match_reference(tiny):
    ref, _ = tiny
    port = _port_net(ref)
    ids, _ = _batch(3)
    want = ref(rnd.array(ids, dtype="int32")).asnumpy()
    got = port(nd.array(ids, ctx=CPU, dtype="int32"))
    assert isinstance(got, nd.NDArray)
    _close(got.asnumpy(), want)
    with torch.no_grad():
        _close(port(torch.from_numpy(ids)), want)


# -- TrainStep ---------------------------------------------------------------
@pytest.mark.parametrize("opt,n", [("sgd", 1), ("adam", 3)])
def test_trainstep_matches_reference(tiny, opt, n):
    ref, names = tiny
    params = {"sgd": SGD, "adam": ADAM}[opt]
    x, y = _batch(0)
    ref_losses, ref_params = _ref_steps(ref, opt, params, n, x, y)
    net = _port_net(ref)
    losses, ps = _port_steps(net, opt, params, n, x, y)
    for rl, pl in zip(ref_losses, losses):
        assert abs(rl - pl) <= TOL * max(1.0, abs(rl)), (ref_losses, losses)
    tol = TOL if opt == "sgd" else ADAM_TOL
    for (rn, _), pn in zip(names, net.collect_params()):
        want = np.asarray(ref_params[rn])
        got = ps.params[pn].detach().numpy()
        _close(got, want, tol, pn)
        if opt == "adam":
            share = np.mean(np.abs(got - want) > 1e-6)
            assert share <= ADAM_OUTLIERS, (pn, share)


def test_imperative_loop_matches_reference(tiny):
    """test_llm.py's loop (record / backward / Trainer.step, Adam 1e-3,
    five steps) on both packages from the same weights."""
    ref = _ref_net()
    port = _port_net(ref)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (2, 32)).astype("i")
    labels = rng.randint(0, 512, (2, 32)).astype("f")
    runs = {}
    for pkg, net, ag, gl, ndm, kw in (
            ("ref", ref, rautograd, rgluon, rnd, {}),
            ("port", port, autograd, gluon, nd, {"ctx": CPU})):
        trainer = gl.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 1e-3})
        loss_fn = gl.loss.SoftmaxCrossEntropyLoss()
        x, y = ndm.array(ids, **kw), ndm.array(labels, **kw)
        losses = []
        for _ in range(5):
            with ag.record():
                out = net(x)
                loss = loss_fn(out.reshape((-1, 512)), y.reshape((-1,)))
            loss.backward()
            trainer.step(2)
            losses.append(float(loss.mean().asscalar()))
        runs[pkg] = losses
    assert runs["port"][-1] < runs["port"][0], runs["port"]
    np.testing.assert_allclose(runs["port"], runs["ref"], rtol=TOL)
    for (rn, rp), (pn, pp) in zip(ref.collect_params().items(),
                                  port.collect_params().items()):
        _close(pp.data().asnumpy(), rp.data().asnumpy(), ADAM_TOL, pn)


# -- remat -------------------------------------------------------------------
def _remat_pair(ref, **kw):
    """(no-remat, remat) port nets with ``ref``'s weights."""
    return _port_net(ref, **kw), _port_net(ref, remat=True, **kw)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_layer_remat_equals_no_remat(tiny, dtype):
    """LlamaConfig(remat=True) under TrainStep: the losses and the weights
    after two SGD steps bit-equal the plain step's, in fp32 and in a bf16
    TrainStep (the recomputation re-enters the AMP policy)."""
    ref, _ = tiny
    plain, remat = _remat_pair(ref)
    x, y = _batch(4)
    lp, sp = _port_steps(plain, "sgd", SGD, 2, x, y, dtype=dtype)
    lr_, sr = _port_steps(remat, "sgd", SGD, 2, x, y, dtype=dtype)
    assert lp == lr_
    for (k, a), b in zip(sp.params.items(), sr.params.values()):
        assert torch.equal(a, b), k
        assert a.dtype == torch.float32


def test_trainstep_remat_equals_no_remat(tiny):
    ref, _ = tiny
    x, y = _batch(5)
    lp, sp = _port_steps(_port_net(ref), "adam", ADAM, 2, x, y)
    lr_, sr = _port_steps(_port_net(ref), "adam", ADAM, 2, x, y, remat=True)
    assert lp == lr_
    for (k, a), b in zip(sp.params.items(), sr.params.values()):
        assert torch.equal(a, b), k
    with pytest.raises(MXNetError, match="pipeline"):
        TrainStep(_port_net(ref), _port_ce, device="cpu", remat=True,
                  pipeline={"num_microbatches": 2})


def _bert_steps(remat):
    """Two SGD steps of a tiny BertForPretraining with dropout 0.1 from
    fixed seeds: (losses, parameters in collect_params() order)."""
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    mx.random.seed(3)
    net = bert.BertForPretraining(bert.BertConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_position=32, dropout=0.1))
    net.initialize(ctx=CPU)
    net(nd.zeros((1, 16), ctx=CPU, dtype="int32"))
    mx.random.seed(11)

    def mlm_loss(outs, labels):
        return _port_ce(outs[0], labels) + 0 * outs[1].sum()

    x, y = _batch(9, b=4, l=16, vocab=64)
    losses, ps = _port_steps(net, "sgd", SGD, 2, x, y, mlm_loss,
                             remat=remat)
    return losses, [ps.params[n] for n in net.collect_params()]


def test_trainstep_remat_replays_dropout_masks(monkeypatch):
    """The recomputation draws the forward's dropout masks again (the
    port's generator is rewound for it): bit-equal to no remat.  With the
    rewind planted away, the recomputed activations differ."""
    lp, pp = _bert_steps(False)
    lr_, pr = _bert_steps(True)
    assert lp == lr_
    assert all(torch.equal(a, b) for a, b in zip(pp, pr))
    monkeypatch.setattr(port_functional._random, "generator",
                        lambda device: torch.Generator(device=device))
    lf, pf = _bert_steps(True)
    assert max((a - b).abs().max().item() for a, b in zip(pp, pf)) > 0


def test_remat_recomputes_every_layer(tiny, monkeypatch):
    """The checkpointed layer runs twice per step (forward, then again in
    the backward), so the attention runs 2 x num_layers times a step."""
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    ref, _ = tiny
    calls = []
    orig = fa_mod._mha_with_lse
    monkeypatch.setattr(fa_mod, "_mha_with_lse",
                        lambda *a: calls.append(1) or orig(*a))
    x, y = _batch(6)
    for remat, want in ((False, 2), (True, 4)):
        calls.clear()
        _port_steps(_port_net(ref, remat=remat), "sgd", SGD, 1, x, y)
        assert len(calls) == want, (remat, len(calls))


def test_remat_warns_on_the_eager_tape(tiny):
    ref, _ = tiny
    net = _port_net(ref, remat=True)
    with pytest.warns(UserWarning, match="remat"):
        with autograd.record():
            net(nd.array(_batch(0)[0], ctx=CPU))


def test_remat_outside_the_trace_is_caught(tiny, monkeypatch):
    """A planted fault: the recomputation does not re-enter functionalize's
    trace, so it recomputes from the net's own Parameters instead of the
    step's weights.  Equal at the first step (the two hold the same
    values), wrong from the second on."""
    ref, _ = tiny

    def reenter_without_trace(scopes, _orig=port_functional._reenter):
        return _orig((None,) + tuple(scopes[1:]))

    plain, remat = _remat_pair(ref)
    x, y = _batch(7)
    lp, sp = _port_steps(plain, "sgd", SGD, 3, x, y)
    monkeypatch.setattr(port_functional, "_reenter", reenter_without_trace)
    lr_, sr = _port_steps(remat, "sgd", SGD, 3, x, y)
    assert lp[0] == lr_[0]
    worst = max((a - b).abs().max().item()
                for a, b in zip(sp.params.values(), sr.params.values()))
    assert worst > 100 * TOL, worst


def test_a_dropped_net_is_freed_at_once():
    """A Parameter holds its owning Blocks weakly, so a net nobody holds
    is freed at once (a full-width one leaves the card at once), not at
    the next cyclic garbage collection."""
    import gc
    import weakref

    gc.disable()
    try:
        net = port_llama.llama_tiny(device="cpu")
        refs = [weakref.ref(net), weakref.ref(net.lm_head.weight),
                weakref.ref(net.lm_head.weight.data()._data)]
        del net
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()


def test_gradient_buffers_come_with_the_first_gradient():
    """A served net holds no gradient buffers (a full-width one would hold
    a second copy of its weights); the imperative loop gets them with its
    first backward, and grad() before any backward reads zeros."""
    net = port_llama.llama_tiny(device="cpu")
    params = list(net.collect_params().values())
    assert all(p.data()._grad is None for p in params)
    assert float(params[0].grad().asnumpy().sum()) == 0.0
    ids = nd.array(_batch(0)[0], ctx=CPU)
    with autograd.record():
        loss = net(ids).sum()
    loss.backward()
    assert all(p.data()._grad is not None for p in params)
    assert float(abs(params[-1].grad().asnumpy()).max()) > 0


# -- MoE ---------------------------------------------------------------------
def _moe_inputs(T=32, d=16, E=4, I=24, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(T, d).astype("float32")
    wr = r.randn(d, E).astype("float32")
    per = [{"g": (0.3 * r.randn(d, I)).astype("float32"),
            "u": (0.3 * r.randn(d, I)).astype("float32"),
            "d": (0.3 * r.randn(I, d)).astype("float32")} for _ in range(E)]
    return x, wr, per


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
def test_moe_apply_matches_reference(capacity_factor):
    x, wr, per = _moe_inputs()

    def ref_fn(p, t):
        return (jax.nn.silu(t @ p["g"]) * (t @ p["u"])) @ p["d"]

    def port_fn(p, t):
        return (torch.nn.functional.silu(t @ p["g"]) * (t @ p["u"])) @ p["d"]

    want, want_aux = ref_ep.moe_apply(
        ref_fn, ref_ep.stack_expert_params(
            [{k: jnp.asarray(v) for k, v in e.items()} for e in per]),
        jnp.asarray(wr), jnp.asarray(x), capacity_factor=capacity_factor)
    got, aux = port_ep.moe_apply(
        port_fn, port_ep.stack_expert_params(
            [{k: torch.from_numpy(v) for k, v in e.items()} for e in per]),
        torch.from_numpy(wr), torch.from_numpy(x),
        capacity_factor=capacity_factor)
    _close(got, want)
    _close(aux["load_balance_loss"], want_aux["load_balance_loss"])
    assert aux["load_balance_loss"].dtype == torch.float32
    for key in ("expert_load", "dropped"):
        assert aux[key].dtype == torch.int32
        np.testing.assert_array_equal(aux[key].numpy(),
                                      np.asarray(want_aux[key]))
    if capacity_factor < 1:
        assert int(aux["dropped"]) > 0
    with pytest.raises(MXNetError, match="mesh"):
        port_ep.moe_apply(port_fn, {}, torch.from_numpy(wr),
                          torch.from_numpy(x), mesh=object())


def test_moe_bf16_queue_positions_do_not_collide():
    """The reference's test_parallel.py case on the port: 600 bf16 tokens
    all routed to expert 0 at capacity T, none dropped (a bf16 cumsum
    would collide above 256)."""
    T, d, E = 600, 4, 2
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(T, d).astype("f")).bfloat16()
    wr = torch.zeros((d, E), dtype=torch.bfloat16)
    params = port_ep.stack_expert_params(
        [{"w": torch.from_numpy(rs.randn(d, d).astype("f") * 0.3)
          .bfloat16()} for _ in range(E)])
    out, aux = port_ep.moe_apply(lambda p, t: torch.tanh(t @ p["w"]),
                                 params, wr, x, capacity_factor=float(E))
    assert int(aux["dropped"]) == 0
    assert int(aux["expert_load"][0]) == T
    assert torch.isfinite(out.float()).all()


def test_inject_aux_loss_gradient_semantics():
    """Forward identity; the aux term's gradient arrives with weight 1
    whatever the reduction downstream (the reference's test)."""
    w = torch.tensor([2.0, -1.0], requires_grad=True)
    x = torch.tensor([1.0, 3.0])
    y = port_ep.inject_aux_loss(x * w, 0.5 * (w ** 2).sum())
    assert torch.equal(y, x * w)
    y.mean().backward()
    assert torch.allclose(w.grad, x / 2 + w.detach(), atol=1e-6)


def test_moe_single_expert_equals_dense():
    """test_llm.py's case: with one expert the gate is exactly 1, so the
    MoE FFN equals the dense SwiGLU MLP with the same weights."""
    cfg = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
               num_kv_heads=2, intermediate_size=24, max_seq_len=8)
    dense = port_llama.llama_tiny(device="cpu", **cfg)
    moe = port_llama.llama_tiny(device="cpu", num_experts=1,
                                moe_capacity_factor=64.0, **cfg)
    dp = {k: p.data()._data for k, p in
          dense._collect_params_with_prefix().items()}
    for name, p in moe._collect_params_with_prefix().items():
        if name.endswith("mlp.router"):
            continue
        src = dp[name + ".weight"].T[None] if ".mlp." in name else dp[name]
        p.set_data(src)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 32, (2, 8)))
    with torch.no_grad():
        _close(moe(ids), dense(ids).numpy(), 1e-5)


def _moe_pair(**cfg):
    prev = rnd.set_eager_jit(False)
    try:
        ref = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig(**cfg))
        ref.initialize()
        ref(rnd.zeros((1, 8), dtype="int32"))
    finally:
        rnd.set_eager_jit(prev)
    port = port_llama.LlamaForCausalLM(port_llama.LlamaConfig(**cfg))
    port.initialize(ctx=CPU)
    gluon.load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                       ref.collect_params().items()})
    return ref, port


def test_moe_trainstep_matches_reference():
    ref, port = _moe_pair(**MOE_CFG)
    x, y = _batch(1, b=4, l=8, vocab=48)
    ref_losses, ref_params = _ref_steps(ref, "sgd", SGD, 1, x, y)
    losses, ps = _port_steps(port, "sgd", SGD, 1, x, y)
    assert abs(ref_losses[0] - losses[0]) <= TOL * max(1, ref_losses[0])
    for (rn, _), pn in zip(ref.collect_params().items(),
                           port.collect_params()):
        _close(ps.params[pn], ref_params[rn], TOL, pn)


def test_moe_aux_loss_reaches_router():
    """test_llm.py's case: the injected balance loss changes the router's
    step (weight 0 against 0.5, SGD at lr 1), and the port's router after
    the step equals the reference's at each weight."""
    cfg = dict(MOE_CFG, num_layers=1, vocab_size=32, moe_capacity_factor=4.0)
    x, y = _batch(0, l=8, vocab=32)
    routers = {}
    for w in (0.0, 0.5):
        ref, port = _moe_pair(moe_aux_loss_weight=w, **cfg)
        _, ref_params = _ref_steps(ref, "sgd", {"learning_rate": 1.0}, 1,
                                   x, y)
        _, ps = _port_steps(port, "sgd", {"learning_rate": 1.0}, 1, x, y)
        rname = [k for k in ps.train_params if "router" in k][0]
        ref_rname = [k for k in ref_params if "router" in k][0]
        routers[w] = ps.train_params[rname].detach().numpy()
        _close(routers[w], ref_params[ref_rname], TOL, f"router at {w}")
    assert not np.allclose(routers[0.0], routers[0.5], atol=1e-7)


# -- training, then serving -----------------------------------------------
def test_serve_after_training(tiny):
    """Three Adam steps, write_back, then the trained net served: prefill
    and ServingEngine's greedy tokens agree with the net's own forward."""
    from mxnet_tpu_torch.serving import ServingEngine

    ref, _ = tiny
    net = _port_net(ref)
    before = port_llama.serving_params(net)["lm_head.weight"].clone()
    x, y = _batch(8)
    _, ps = _port_steps(net, "adam", ADAM, 3, x, y)
    ps.write_back()
    params = port_llama.serving_params(net)
    assert not torch.equal(params["lm_head.weight"], before)
    assert params["lm_head.weight"].data_ptr() == \
        net.lm_head.weight.data()._data.data_ptr()          # no copy
    ids = x[:1, :12]
    with torch.no_grad():
        full = net(torch.from_numpy(ids))
    cache = net.init_decode_cache(1, max_len=16)
    _close(net.prefill(ids, cache), full.numpy())
    eng = ServingEngine(net, batch_buckets=[1], prefill_buckets=[16],
                        kv_pages=8, page_size=8, max_batch=1,
                        device="cpu").start()
    try:
        toks = eng.submit(ids[0], max_new_tokens=4).result(timeout=60)[
            "token_ids"]
    finally:
        eng.close()
    seq = list(ids[0])
    for tok in toks:
        with torch.no_grad():
            want = int(net(torch.tensor([seq]))[0, -1].argmax())
        assert tok == want
        seq.append(tok)
