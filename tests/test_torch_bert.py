"""BERT on the port (mxnet_tpu_torch: the Embedding, slice_axis, arange,
gelu, LayerNorm and Dropout ops, the Gluon Dropout / LayerNorm / Embedding
layers, gluon.model_zoo.language.bert and TrainStep with several heads)
held against the reference on the CPU.

Ops: forward and gradient against ``jax.vjp`` of the reference's op on the
same numpy inputs (seeded), within 1e-5 of the larger of 1 and the
reference's magnitude (fp32, sums in different orders).  Dropout draws
from another generator than the reference's, so it is held by its
distribution: the kept fraction within 6 standard deviations of the
binomial, kept values scaled by exactly 1 / (1 - p).

Models: the reference ``BertForPretraining`` at a small config (dropout 0)
is initialised in JAX and its weights carried over with
``load_reference_params``.  Logits and every parameter's gradient of the
MLM + NSP loss (bench.py's) agree within 1e-4 of the larger of 1 and the
magnitude.  Two Adam ``TrainStep`` steps (lr 1e-3, epsilon 1e-6) agree
within 1e-2 of lr per parameter: Adam's first steps are ~lr times the sign
of each gradient entry, so the bound is a fraction of lr, and epsilon is
1e-6 so that the key projections' biases, whose gradients are rounding
noise (softmax ignores a shift of a query's scores), do not take steps of
~lr from noise (the reference's own gluon test leaves such biases out for
the same reason).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as rmx
import mxnet_tpu.ops  # noqa: F401  (populates the reference table)
from mxnet_tpu.gluon.model_zoo.language import bert as ref_bert
from mxnet_tpu.ops.registry import get_op as ref_get_op
from mxnet_tpu.parallel.data_parallel import TrainStep as RefTrainStep
from mxnet_tpu.parallel.functional import functionalize as ref_functionalize
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import load_reference_params
from mxnet_tpu_torch.gluon.model_zoo.language import bert as port_bert
from mxnet_tpu_torch.ops import flash_attention as port_fa
from mxnet_tpu_torch.ops.registry import get_op as port_get_op
from mxnet_tpu_torch.parallel import TrainStep, functionalize
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
ATOL = 1e-5
MODEL_TOL = 1e-4
LR = 1e-3
STEP_TOL = 1e-2 * LR
CFG = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position=32, dropout=0.0)
BATCH, SEQ = 3, 16


def _scale(ref):
    ref = np.asarray(ref, dtype=np.float32)
    return max(1.0, float(np.abs(ref).max())) if ref.size else 1.0


def _close(port, ref, tol, msg=""):
    port = np.asarray(port.detach().float()) if isinstance(
        port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref, np.float32), rtol=0,
                               atol=tol * _scale(ref), err_msg=msg)


def _check_op(name, arrays, attrs, diff=None):
    """Forward of ``name`` and the vjp of its output w.r.t. the inputs
    listed in ``diff`` (default: every float input)."""
    if diff is None:
        diff = [i for i, a in enumerate(arrays)
                if np.issubdtype(a.dtype, np.floating)]
    j_in = [jnp.asarray(a) for a in arrays]

    def ref_fn(*d):
        args = list(j_in)
        for i, t in zip(diff, d):
            args[i] = t
        return ref_get_op(name).fn(*args, **attrs)

    ref_out, vjp = jax.vjp(ref_fn, *(j_in[i] for i in diff))
    t_in = [torch.from_numpy(np.array(a)).requires_grad_(i in diff)
            for i, a in enumerate(arrays)]
    out = port_get_op(name).fn(*t_in, **attrs)
    assert tuple(out.shape) == tuple(ref_out.shape), name
    _close(out, ref_out, ATOL, name)
    cot = np.random.RandomState(1).randn(*ref_out.shape).astype("float32")
    ref_grads = vjp(jnp.asarray(cot))
    grads = torch.autograd.grad(out, [t_in[i] for i in diff],
                                torch.from_numpy(cot))
    for i, g, rg in zip(diff, grads, ref_grads):
        _close(g, rg, ATOL, f"{name}: gradient of input {i}")


# -- ops -------------------------------------------------------------------------
def test_embedding_op_clips_ids():
    r = np.random.RandomState(0)
    ids = np.array([[0, 5, 9, -3], [12, 2, 2, 7]], dtype="int32")
    w = r.randn(10, 6).astype("float32")
    _check_op("Embedding", [ids, w], {"input_dim": 10, "output_dim": 6})
    out = port_get_op("Embedding").fn(torch.from_numpy(ids),
                                      torch.from_numpy(w))
    np.testing.assert_array_equal(out[1, 0].numpy(), w[9])   # 12 -> 9
    np.testing.assert_array_equal(out[0, 3].numpy(), w[0])   # -3 -> 0


@pytest.mark.parametrize("axis,begin,end", [(1, 0, 1), (0, 1, None),
                                            (-1, 2, 5)])
def test_slice_axis_op(axis, begin, end):
    x = np.random.RandomState(1).randn(3, 4, 6).astype("float32")
    _check_op("slice_axis", [x], {"axis": axis, "begin": begin, "end": end})


@pytest.mark.parametrize("attrs", [{"start": 0, "stop": 7, "dtype": "int32"},
                                   {"start": 2, "stop": 9, "step": 3.0},
                                   {"start": 5},
                                   {"start": 1, "stop": 4, "repeat": 2}])
def test_arange_op(attrs):
    ref = np.asarray(ref_get_op("arange").fn(**attrs))
    out = port_get_op("arange").fn(device="cpu", **attrs)
    assert out.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(out.numpy(), ref)


def test_arange_is_made_on_the_given_context():
    out = nd.arange(0, 4, dtype="int32", ctx=CPU)
    assert out.context == CPU and out.dtype == np.int32
    assert not port_get_op("arange").differentiable


def test_gelu_op_is_the_erf_form():
    x = np.random.RandomState(2).randn(4, 9).astype("float32") * 3
    _check_op("gelu", [x], {})
    tanh_form = 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi)
                                       * (x + 0.044715 * x ** 3)))
    out = port_get_op("gelu").fn(torch.from_numpy(x)).numpy()
    assert np.abs(out - tanh_form).max() > 1e-4


@pytest.mark.parametrize("axis,eps", [(-1, 1e-12), (1, 1e-5)])
def test_layer_norm_op(axis, eps):
    r = np.random.RandomState(3)
    x = (r.randn(2, 5, 8) * 2 + 1).astype("float32")
    c = x.shape[axis]
    gamma = (1 + 0.3 * r.randn(c)).astype("float32")
    beta = (0.3 * r.randn(c)).astype("float32")
    _check_op("LayerNorm", [x, gamma, beta], {"axis": axis, "eps": eps})


def test_layer_norm_op_statistics_in_fp32():
    """A bf16 input comes back bf16, normalised with fp32 statistics: one
    rounding of the fp32 result."""
    r = np.random.RandomState(4)
    x = torch.from_numpy((r.randn(4, 64) * 5 + 3).astype("float32"))
    xb = x.bfloat16()
    g, b = torch.ones(64), torch.zeros(64)
    out = port_get_op("LayerNorm").fn(xb, g, b, eps=1e-12)
    assert out.dtype == torch.bfloat16
    xf = xb.float()
    want = (xf - xf.mean(-1, keepdim=True)) / torch.sqrt(
        xf.var(-1, unbiased=False, keepdim=True) + 1e-12)
    torch.testing.assert_close(out, want.bfloat16(), rtol=0, atol=0)


def _dropout(x, **attrs):
    return port_get_op("Dropout").fn(torch.from_numpy(x), **attrs)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_fraction_and_scale(p):
    x = np.ones((400, 500), dtype="float32")
    mx.random.seed(0)
    out = _dropout(x, p=p, training=True).numpy()
    kept = out != 0
    n, keep = x.size, 1 - p
    sd = np.sqrt(n * keep * p)
    assert abs(kept.sum() - n * keep) <= 6 * sd, (kept.sum(), n * keep)
    np.testing.assert_array_equal(out[kept], np.float32(1) / np.float32(keep))


def test_dropout_identity_in_predict_mode_and_at_zero():
    x = np.random.RandomState(5).randn(6, 7).astype("float32")
    ref = ref_get_op("Dropout").fn
    key = jax.random.PRNGKey(0)
    for attrs in ({"p": 0.5, "training": False}, {"p": 0.0, "training": True}):
        np.testing.assert_array_equal(_dropout(x, **attrs).numpy(), x)
        np.testing.assert_array_equal(
            np.asarray(ref(key, jnp.asarray(x), **attrs)), x)
    # mode="always" drops in predict mode too
    assert (_dropout(x, p=0.5, training=False, mode="always").numpy()
            == 0).any()


def test_dropout_axes_broadcast_the_mask():
    x = np.ones((8, 5, 32), dtype="float32")
    out = _dropout(x, p=0.5, training=True, axes=(1,)).numpy()
    assert (out == out[:, :1, :]).all()          # one mask over axis 1
    assert 0 < (out[:, 0] == 0).mean() < 1


def test_dropout_draws_from_the_port_generator():
    """The mask follows mx.random.seed, not torch's global generator."""
    x = np.ones((64, 64), dtype="float32")
    mx.random.seed(7)
    torch.manual_seed(1)
    a = _dropout(x, p=0.5, training=True)
    mx.random.seed(7)
    torch.manual_seed(2)
    b = _dropout(x, p=0.5, training=True)
    c = _dropout(x, p=0.5, training=True)
    assert torch.equal(a, b) and not torch.equal(b, c)


def test_dropout_gradient_is_the_mask():
    x = torch.ones(32, 32, requires_grad=True)
    mx.random.seed(3)
    out = port_get_op("Dropout").fn(x, p=0.25, training=True)
    (g,) = torch.autograd.grad(out.sum(), x)
    torch.testing.assert_close(g, out.detach())


# -- Gluon layers ----------------------------------------------------------------
def _stripped(net):
    from mxnet_tpu_torch.gluon.parameter import _strip_counter

    return [(_strip_counter(k), tuple(p.shape))
            for k, p in net.collect_params().items()]


def test_layers_parameter_names_and_shapes():
    x = np.random.RandomState(6).randn(2, 3, 10).astype("float32")
    for make in (lambda g: g.nn.LayerNorm(),
                 lambda g: g.nn.LayerNorm(axis=1, in_channels=3),
                 lambda g: g.nn.Embedding(50, 10),
                 lambda g: g.nn.Dropout(0.3)):
        ref, port = make(rmx.gluon), make(gluon)
        ref.initialize()
        port.initialize(ctx=CPU)
        if not isinstance(port, gluon.nn.Embedding):
            ref(rmx.nd.array(x))
            port(nd.array(x, ctx=CPU))
        assert _stripped(port) == _stripped(ref)
    emb = gluon.nn.Embedding(50, 10)
    assert emb.prefix.startswith("embedding")
    ln = gluon.nn.LayerNorm()
    ln.initialize(ctx=CPU)
    ln(nd.array(x, ctx=CPU))
    assert ln.gamma.data().asnumpy().tolist() == [1.0] * 10
    assert ln.beta.data().asnumpy().tolist() == [0.0] * 10


def test_dropout_layer_follows_train_mode():
    layer = gluon.nn.Dropout(0.5)
    x = nd.array(np.ones((16, 16), "float32"), ctx=CPU)
    assert (layer(x).asnumpy() == 1).all()          # predict mode
    with autograd.train_mode():
        assert (layer(x).asnumpy() == 0).any()
    assert (gluon.nn.Dropout(0.0)(x).asnumpy() == 1).all()


# -- BertForPretraining against the reference ------------------------------------
def _ref_loss(outs, labels):
    mlm, nsp = outs
    logp = jax.nn.log_softmax(mlm, axis=-1)
    mlm_l = -jnp.take_along_axis(logp, labels[:, :-1, None], axis=-1)
    nsp_logp = jax.nn.log_softmax(nsp, axis=-1)
    nsp_l = -jnp.take_along_axis(nsp_logp, labels[:, -1:], axis=-1)
    return jnp.mean(mlm_l) + jnp.mean(nsp_l)


def _port_loss(outs, labels):
    mlm, nsp = outs
    labels = labels.long()
    mlm_l = -torch.log_softmax(mlm, -1).gather(-1, labels[:, :-1, None])
    nsp_l = -torch.log_softmax(nsp, -1).gather(-1, labels[:, -1:])
    return mlm_l.mean() + nsp_l.mean()


def _batch(seed):
    r = np.random.RandomState(seed)
    ids = r.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype("int32")
    labels = np.concatenate(
        [r.randint(0, CFG["vocab_size"], (BATCH, SEQ)),
         r.randint(0, 2, (BATCH, 1))], axis=1).astype("int32")
    return ids, labels


@pytest.fixture(scope="module")
def bert_pair():
    """(reference BertForPretraining, the port's with its weights, name
    pairs).  LayerNorm gammas and betas are moved off 1 and 0 so that
    their carry-over is tested too."""
    prev = rmx.nd.set_eager_jit(False)
    try:
        ref = ref_bert.BertForPretraining(ref_bert.BertConfig(**CFG))
        ref.initialize()
        ref(rmx.nd.zeros((1, SEQ), dtype="int32"))
        r = np.random.RandomState(9)
        for name, p in ref.collect_params().items():
            if name.endswith(("gamma", "beta", "bias")):
                base = 1.0 if name.endswith("gamma") else 0.0
                p.set_data(rmx.nd.array(
                    (base + 0.1 * r.randn(*p.shape)).astype("float32")))
    finally:
        rmx.nd.set_eager_jit(prev)
    port = port_bert.BertForPretraining(port_bert.BertConfig(**CFG))
    port.initialize(ctx=CPU)
    port(nd.zeros((1, SEQ), ctx=CPU, dtype="int32"))
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()})
    names = list(zip(ref.collect_params(), port.collect_params()))
    return ref, port, names


def test_bert_parameter_names_and_shapes_match(bert_pair):
    ref, port, _ = bert_pair
    assert _stripped(port) == _stripped(ref)
    assert len(_stripped(port)) == 5 + 16 * CFG["num_layers"] + 2 + 8


def test_bert_logits_and_gradients_match_reference(bert_pair):
    ref, port, names = bert_pair
    ids, labels = _batch(0)
    rf, rp = ref_functionalize(ref, train_mode=True)
    pf, pp = functionalize(port, train_mode=True)

    def ref_loss(p):
        outs = rf(p, jax.random.PRNGKey(0), jnp.asarray(ids))
        return _ref_loss(outs, jnp.asarray(labels)), outs

    (rl, (rmlm, rnsp)), rg = jax.value_and_grad(ref_loss, has_aux=True)(
        dict(rp))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in pp.items()}
    mlm, nsp = pf(leaves, torch.from_numpy(ids))
    loss = _port_loss((mlm, nsp), torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    _close(mlm, rmlm, MODEL_TOL, "mlm logits")
    _close(nsp, rnsp, MODEL_TOL, "nsp logits")
    _close(loss, rl, MODEL_TOL, "loss")
    by_name = dict(zip(leaves, grads))
    for rn, pn in names:
        g = by_name[pn]
        if g is None:       # the token-type embedding: no token types
            assert "embedding" in pn
            assert not np.asarray(rg[rn]).any()
            continue
        _close(g, rg[rn], MODEL_TOL, f"gradient of {pn}")


def test_bert_adam_trainstep_two_steps(bert_pair):
    ref, port, names = bert_pair
    ids, labels = _batch(1)
    opt = {"learning_rate": LR, "epsilon": 1e-6}
    rs = RefTrainStep(ref, _ref_loss, optimizer="adam", optimizer_params=opt)
    ps = TrainStep(port, _port_loss, optimizer="adam", optimizer_params=opt,
                   device="cpu")
    for step in range(2):
        rl, pl = float(np.asarray(rs(ids, labels))), ps(ids, labels).item()
        assert abs(rl - pl) <= MODEL_TOL * max(1.0, abs(rl)), (step, rl, pl)
    moved = 0
    for rn, pn in names:
        want = np.asarray(rs.params[rn], np.float32)
        got = ps.params[pn].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=STEP_TOL,
                                   err_msg=pn)
        moved += not np.array_equal(
            got, port.collect_params()[pn].data().asnumpy())
    assert moved == len(names) - 1       # all but the token-type embedding


def test_bert_bf16_trainstep_casts_outputs_to_fp32(bert_pair):
    """Under dtype="bfloat16" both heads reach the loss in fp32, and the
    bf16 step lands near the fp32 one."""
    _, port, _ = bert_pair
    ids, labels = _batch(2)
    seen = []

    def loss_fn(outs, y):
        seen.extend(o.dtype for o in outs)
        return _port_loss(outs, y)

    opt = {"learning_rate": LR}
    l16 = TrainStep(port, loss_fn, optimizer="adam", optimizer_params=opt,
                    dtype="bfloat16", device="cpu")(ids, labels).item()
    l32 = TrainStep(port, _port_loss, optimizer="adam", optimizer_params=opt,
                    device="cpu")(ids, labels).item()
    assert seen == [torch.float32, torch.float32]
    assert l16 != l32 and abs(l16 - l32) < 2e-2 * abs(l32)


def test_trainstep_catches_a_cut_attention_graph(bert_pair, monkeypatch):
    """A detached attention output cuts the q/k/v projections out of the
    graph: TrainStep names them instead of training on zero gradients.
    The token-type embedding, never read, still trains silently on zeros."""
    _, port, _ = bert_pair
    ids, labels = _batch(3)
    op = port_get_op("flash_attention")
    fn = op.fn
    monkeypatch.setattr(op, "fn", lambda *a, **kw: fn(*a, **kw).detach())
    step = TrainStep(port, _port_loss, optimizer="sgd",
                     optimizer_params={"learning_rate": 0.1}, device="cpu")
    with pytest.raises(MXNetError, match="no gradient for") as err:
        step(ids, labels)
    msg = str(err.value)
    attn = port.bert.encoder[0].attention
    assert attn.query.weight.name in msg and attn.key.bias.name in msg
    assert port.bert.token_type_embed.weight.name not in msg
    monkeypatch.setattr(op, "fn", fn)
    step(ids, labels)                  # the whole graph: no error
    tt = port.bert.token_type_embed.weight.name
    assert torch.equal(step.params[tt],
                       port.collect_params()[tt].data()._data)


def test_bert_trainstep_reaches_the_flash_attention_function(bert_pair,
                                                             monkeypatch):
    """The encoder's attention goes through _FlashAttention (the ported
    backward), once per layer and step."""
    _, port, _ = bert_pair
    calls = []
    bwd = port_fa._fa_backward_blockwise

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return bwd(*a, **kw)

    monkeypatch.setattr(port_fa, "_fa_backward_blockwise", counting)
    ids, labels = _batch(4)
    TrainStep(port, _port_loss, optimizer="sgd", device="cpu")(ids, labels)
    assert calls == [(BATCH, CFG["num_heads"], SEQ,
                      CFG["hidden_size"] // CFG["num_heads"])] * \
        CFG["num_layers"]


def test_trainstep_dropout_follows_the_seed():
    """With dropout on, a TrainStep step draws its masks from the port's
    device generator: the same seed gives the same step, another seed
    another one."""
    cfg = port_bert.BertConfig(**dict(CFG, dropout=0.3))
    net = port_bert.BertForPretraining(cfg)
    net.initialize(ctx=CPU)
    net(nd.zeros((1, SEQ), ctx=CPU, dtype="int32"))
    ids, labels = _batch(5)

    def one_step(seed):
        mx.random.seed(seed)
        return TrainStep(net, _port_loss, optimizer="sgd",
                         device="cpu")(ids, labels).item()

    assert one_step(1) == one_step(1) != one_step(2)


# -- the reference's own BERT tests (tests/test_llm.py), on the port -------------
def test_bert_forward_and_pretrain_heads():
    net = port_bert.bert_tiny()
    net.initialize(ctx=CPU)
    ids = nd.array(np.random.RandomState(0).randint(0, 256, (2, 24))
                   .astype("i"), ctx=CPU)
    seq, pooled = net(ids)
    assert seq.shape == (2, 24, 64)
    assert pooled.shape == (2, 64)
    cfg = port_bert.BertConfig(vocab_size=256, hidden_size=64, num_layers=2,
                               num_heads=2, intermediate_size=128,
                               max_position=64)
    bp = port_bert.BertForPretraining(cfg)
    bp.initialize(ctx=CPU)
    mlm, nsp = bp(ids)
    assert mlm.shape == (2, 24, 256)
    assert nsp.shape == (2, 2)


def test_bert_trains():
    net = port_bert.bert_tiny()
    net.initialize(ctx=CPU)
    head = gluon.nn.Dense(2, flatten=False)
    head.initialize(ctx=CPU)
    params = dict(net.collect_params())
    params.update(head.collect_params())
    trainer = gluon.Trainer(params, "adam", {"learning_rate": 1e-3})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    ids = nd.array(rng.randint(0, 256, (4, 16)).astype("i"), ctx=CPU)
    labels = nd.array(rng.randint(0, 2, (4,)).astype("f"), ctx=CPU)
    losses = []
    for _ in range(5):
        with autograd.record():
            _, pooled = net(ids)
            loss = loss_fn(head(pooled), labels)
        loss.backward()
        trainer.step(4)
        losses.append(float(loss.mean().asscalar()))
    assert losses[-1] < losses[0], losses


def test_bert_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = port_bert.bert_tiny()
    with pytest.raises(MXNetError, match="no CUDA device"):
        net.initialize()
