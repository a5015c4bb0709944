"""The checks of ``chip_smoke.py`` on the CPU at a small size.

Serving: the fp32 check passes a correct engine, and each planted fault in
the paged cache (a decode position off by one, page-table rows of the
batch swapped, a prompt written into the wrong pages) fails it.  On the
card the same check runs at Llama-3-8B widths; here it shows the
tolerance sits between fp32 rounding and what a paging fault does to the
logits.

Training: the tight step check (fp64, card against CPU on the card; here
CPU against CPU on a tiny ResNet of ResNet-50's structure) passes the
same step and fails each planted fault in it; the bf16 check (the card's
bf16 step against the fp64 step, within a multiple of the CPU's bf16
step's deviation from it) passes the same bf16 step and fails the planted
bf16 faults; the Gluon loop agrees with TrainStep.

Transformer training: the attention gradient checks pass the port and fail
the planted backward faults, the BERT step check fails a planted fault,
and the per-layer check of a bf16 step's attention fails a planted error
in the forward's output.

Llama training: the fp32 step check (against the fp64 step) passes the
port and fails the planted faults (the GQA fold, the rope sign), the remat
step equals the plain one, the bf16 check fails the rope fault, and the
MoE check holds its step and sees the aux loss move the router.
The new entry points raise without a card unless asked for the CPU.
"""
import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention_ops as port_attention_ops
from mxnet_tpu_torch.ops import nn as port_nn
from mxnet_tpu_torch.ops.registry import get_op as port_get_op
from mxnet_tpu_torch.parallel import data_parallel
from mxnet_tpu_torch.gluon.model_zoo.language import llama as port_llama
from mxnet_tpu_torch.ops import flash_attention as port_fa
from mxnet_tpu_torch.serving import ServingEngine

_MAKE_SGD = data_parallel.make_sgd_update


def _plant(engine, fault):
    """Wrap one engine seam so that it does ``fault``."""
    if fault == "decode_position":
        body = engine._decode_body
        engine._decode_body = lambda ids, pos, table: body(
            ids, (pos - 1).clamp_min(0), table)
    elif fault == "table_rows":
        table_rows = engine._kv.table_rows

        def swapped(sids, n_pages):
            rows = table_rows(sids, n_pages)
            real = sum(s is not None for s in sids)
            return rows[1:real] + rows[:1] + rows[real:] if real > 1 \
                else rows
        engine._kv.table_rows = swapped
    elif fault == "prefill_pages":
        body = engine._prefill_body
        engine._prefill_body = lambda ids, lb, table: body(
            ids, lb, table[1:] + table[:1])


@pytest.mark.parametrize("fault", [None, "decode_position", "table_rows",
                                   "prefill_pages"])
def test_fp32_serving_check_catches_paging_faults(fault, monkeypatch):
    net = port_llama.init_random_(port_llama.llama_tiny(device="cpu"), 0)
    cfg = net.config
    engine = ServingEngine(net, batch_buckets=[1, 2, 4],
                           prefill_buckets=[32, 64], kv_pages=64,
                           page_size=8, max_batch=4, device="cpu").start()
    _plant(engine, fault)
    r = np.random.RandomState(0)
    prompts = [r.randint(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in (20, 37, 50, 61)]
    temps = [0.0, 0.8, 0.0, 0.0]
    monkeypatch.setattr(chip_smoke, "MAX_NEW", 6)
    try:
        results, rows = chip_smoke.serve(engine, prompts, temps, 0)
    finally:
        engine.close()
    if fault is None:
        chip_smoke.check_fp32_run(port_llama, port_fa, net, prompts, temps,
                                  results, rows)
    else:
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            chip_smoke.check_fp32_run(port_llama, port_fa, net, prompts,
                                      temps, results, rows)
    assert port_llama.flash_attention is port_fa.flash_attention


# -- the training checks -------------------------------------------------------
def _tiny_resnet():
    """ResNet-50 v1's structure (bottleneck blocks, conv7 stem, NHWC) at
    one block per stage and narrow widths."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    return resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                           [8, 16, 24, 32, 40], classes=10, layout="NHWC")


@pytest.fixture(scope="module")
def tiny_train():
    """A tiny ResNet on the CPU in fp64 (as the tight check on the card
    runs), a batch, and the TrainStep step the checks hold others to."""
    net = chip_smoke.init_net(_tiny_resnet, 0, mx.cpu(), size=32).double()
    x, y = chip_smoke.train_batch(0, 4, size=32, classes=10)
    x = x.astype(np.float64)
    names = list(net.collect_params())
    ref = chip_smoke.trainstep_result(net, x, y, "cpu")
    return net, x, y, names, ref


@pytest.mark.parametrize("fault", [None, "unbiased", "momentum", "no_wd"])
def test_train_step_check_catches_faults(tiny_train, fault):
    """The fp64 step check passes the same step and fails each planted
    fault: the running variance taken unbiased, BatchNorm's momentum
    convention inverted, weight decay dropped."""
    net, x, y, names, ref = tiny_train
    other = chip_smoke.copy_net(net, _tiny_resnet, mx.cpu(), size=32)
    other.double()
    scope = chip_smoke.planted_fault(fault) if fault else \
        contextlib.nullcontext()
    with scope:
        cand = chip_smoke.trainstep_result(other, x, y, "cpu")
    bound = chip_smoke.FP64_STEP_BOUND
    if fault is None:
        assert chip_smoke.check_steps(cand, ref, names, "same step",
                                      bound) == 0.0
    else:
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            chip_smoke.check_steps(cand, ref, names, fault, bound)
    assert port_get_op("BatchNorm").fn is port_nn.batch_norm
    assert data_parallel.make_sgd_update is _MAKE_SGD


def test_gluon_loop_check_agrees_with_trainstep(tiny_train):
    net, x, y, names, ref = tiny_train
    other = chip_smoke.copy_net(net, _tiny_resnet, mx.cpu(), size=32)
    loop = chip_smoke.gluon_loop_result(other.double(), x, y)
    assert chip_smoke.check_steps(loop, ref, names, "gluon loop",
                                  chip_smoke.LOOP_BOUND) < 1e-9


def test_training_entry_points_default_to_cuda(monkeypatch, tiny_train):
    net, x, y, _, _ = tiny_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        chip_smoke.resnet50().initialize()
    with pytest.raises(MXNetError, match="no CUDA device"):
        chip_smoke.trainstep_result(net, x, y, None)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.nd.array(x)


def test_fp32_step_held_to_the_fp64_step(tiny_train):
    """compare_steps casts the candidate to the reference's dtype: the
    fp32 step of the same weights sits within the fp32 bound of the fp64
    step (the card's check of fp32 rounding)."""
    net, x, y, names, ref = tiny_train
    net32 = chip_smoke.copy_net(net, _tiny_resnet, mx.cpu(), size=32)
    cand = chip_smoke.trainstep_result(net32, x.astype(np.float32), y, "cpu")
    ratio = chip_smoke.check_steps(cand, ref, names, "fp32 vs fp64",
                                   chip_smoke.FP32_STEP_BOUND)
    assert 0.0 < ratio


@pytest.mark.parametrize("fault", [None, "momentum"])
def test_bf16_step_check_catches_faults(tiny_train, fault):
    """The bf16 check holds a TrainStep(dtype="bfloat16") step to the fp64
    step within BF16_NOISE_FACTOR x an independent bf16 step's deviation
    (on the card, the CPU's; here the same step): it passes the step
    itself and fails BatchNorm's momentum convention inverted in the bf16
    path."""
    net, x, y, names, ref = tiny_train
    net32 = chip_smoke.copy_net(net, _tiny_resnet, mx.cpu(), size=32)
    x32 = x.astype(np.float32)
    noise = chip_smoke.trainstep_result(net32, x32, y, "cpu",
                                        dtype="bfloat16")
    assert all(t.dtype == torch.float32 for t in noise[2])
    scales = chip_smoke.noise_scales(noise, ref, names)
    scope = chip_smoke.planted_fault(fault) if fault else \
        contextlib.nullcontext()
    with scope:
        cand = chip_smoke.trainstep_result(net32, x32, y, "cpu",
                                           dtype="bfloat16")
    bound = chip_smoke.BF16_NOISE_FACTOR
    if fault is None:
        assert chip_smoke.check_steps(cand, ref, names, "bf16", bound,
                                      scales) <= 1.0
    else:
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            chip_smoke.check_steps(cand, ref, names, fault, bound, scales)
    assert port_get_op("BatchNorm").fn is port_nn.batch_norm
    assert data_parallel.make_sgd_update is _MAKE_SGD


def test_update_floor_is_per_kind():
    """The running variances' large updates do not lift the floor of the
    trainable tensors: each kind's floor is UPDATE_FLOOR of its own
    largest update."""
    names = ["conv0_weight", "conv0_bias", "bn0_running_mean",
             "bn0_running_var"]
    before = [torch.zeros(3, dtype=torch.float64) for _ in names]
    upd = [1e-3, 1e-9, 1e-2, 2.0]
    after = [b + u for b, u in zip(before, upd)]
    ref = (1.0, before, after)
    floor = chip_smoke.UPDATE_FLOOR
    assert chip_smoke.update_floors(ref, names) == {
        "trainable": (pytest.approx(1e-3 * floor), "conv0_weight"),
        "stats": (pytest.approx(2.0 * floor), "bn0_running_var")}
    assert chip_smoke.update_scales(ref, names) == pytest.approx(
        [1.0, 1e-3, 1e-3 * floor, 1e-2, 2.0])
    cand = (1.0, before, [a + 1e-4 * (n == "conv0_weight")
                          for a, n in zip(after, names)])
    assert chip_smoke.compare_steps(cand, ref, names) == \
        (pytest.approx(0.1), "conv0_weight")


# -- the transformer-training checks --------------------------------------------
# small counterparts of chip_smoke's attention cases: GQA causal, plain
# non-causal, and Lq < Lk causal (the diagonal offset)
_GQA = (1, 4, 2, 64, 64, 32, True)
_PLAIN = (2, 2, 2, 32, 32, 32, False)
_OFFSET = (1, 4, 2, 32, 96, 32, True)


def _gen(seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_attention_grad_checks_pass_the_port():
    for shape in (_GQA, _PLAIN, _OFFSET):
        assert chip_smoke.check_attention_grads(port_fa, shape, _gen(),
                                                device="cpu") < 1e-5
        chip_smoke.check_attention_grads_bf16(port_fa, shape, _gen(),
                                              device="cpu")


@pytest.mark.parametrize("fault,shape", [("no_gqa_fold", _GQA),
                                         ("no_delta", _PLAIN),
                                         ("offset_0", _OFFSET)])
def test_attention_grad_check_catches_planted_faults(fault, shape):
    """Each planted backward fault moves the gradients far past the fp32
    bound, and the check fails on it."""
    ratio = chip_smoke.attention_fault_ratio(port_fa, fault, shape, _gen(),
                                             device="cpu")
    assert ratio > 10 * chip_smoke.ATTN_FP32_BOUND, ratio
    with chip_smoke.planted_attention_fault(port_fa, fault):
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            chip_smoke.check_attention_grads(port_fa, shape, _gen(),
                                             device="cpu")
    # the fault is gone after the scope
    chip_smoke.check_attention_grads(port_fa, shape, _gen(), device="cpu")


def test_llama_grad_check_runs_on_the_cpu():
    """On the CPU the check holds the CPU's fp32 gradients to its fp64
    ones: a rounding-sized deviation, within the card's bound."""
    worst = chip_smoke.check_llama_grads(port_llama, 0, device="cpu")
    assert 0.0 < worst <= chip_smoke.LLAMA_GRAD_BOUND


def _tiny_bert_cfg():
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    return bert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                           num_heads=2, intermediate_size=64,
                           max_position=32, dropout=0.0)


@pytest.fixture(scope="module")
def tiny_bert():
    """A small BertForPretraining on the CPU in fp64 (as the CPU's
    reference step runs on the chip), a batch, and its SGD step."""
    cfg = _tiny_bert_cfg()
    net = chip_smoke.init_bert(cfg, 0, mx.cpu(), seq=16).double()
    ids, labels = chip_smoke.bert_batch(0, 4, 16, cfg.vocab_size)
    ref = chip_smoke.trainstep_result(net, ids, labels, "cpu",
                                      chip_smoke.BERT_CHECK_OPT, None,
                                      chip_smoke.bert_loss)
    return cfg, net, ids, labels, ref


@pytest.mark.parametrize("fault", [None, "no_delta"])
def test_bert_step_check_catches_a_planted_fault(tiny_bert, fault):
    cfg, net, ids, labels, ref = tiny_bert
    names = list(net.collect_params())
    other = chip_smoke.copy_bert(net, cfg, mx.cpu()).double()
    scope = chip_smoke.planted_attention_fault(port_fa, fault) if fault \
        else contextlib.nullcontext()
    with scope:
        cand = chip_smoke.trainstep_result(other, ids, labels, "cpu",
                                           chip_smoke.BERT_CHECK_OPT, None,
                                           chip_smoke.bert_loss)
    bound = chip_smoke.BERT_FP32_BOUND
    if fault is None:
        assert chip_smoke.check_steps(cand, ref, names, "same step",
                                      bound) == 0.0
    else:
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            chip_smoke.check_steps(cand, ref, names, fault, bound)


@pytest.mark.parametrize("fault", [None, "o_scaled"])
def test_attention_layer_check_catches_a_faulty_forward(tiny_bert, fault):
    """The per-layer check of the bf16 step's attention records one
    backward call per layer; on the CPU the forward that ran is the plain
    version, so it passes at a ratio of exactly 1, and an o 5% off (a
    planted forward fault) fails it."""
    cfg, net, ids, labels, _ = tiny_bert
    other = chip_smoke.copy_bert(net, cfg, mx.cpu())
    with chip_smoke.record_backward(port_fa) as calls:
        chip_smoke.trainstep_result(other, ids, labels, "cpu",
                                    chip_smoke.BERT_CHECK_OPT, "bfloat16",
                                    chip_smoke.bert_loss)
    assert len(calls) == cfg.num_layers
    assert all(c[0].dtype == torch.bfloat16 for c in calls)
    if fault is None:
        rows = chip_smoke.attention_layer_errors(port_fa, calls)
        assert [r[0] for r in rows] == list(range(cfg.num_layers))
        assert all(ran == plain for _, ran, plain, _ in rows)
        chip_smoke.check_attention_layers(port_fa, calls)
    else:
        calls = [(q, k, v, (o.float() * 1.05).to(o.dtype), *rest)
                 for q, k, v, o, *rest in calls]
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            chip_smoke.check_attention_layers(port_fa, calls)


def test_bert_step_leaves_only_the_token_type_embedding(tiny_bert):
    """Under the checked SGD step only the token-type embedding (no token
    types are passed) has a zero gradient, so only it stays unchanged."""
    _, net, _, _, ref = tiny_bert
    assert chip_smoke.unchanged(ref, list(net.collect_params())) == \
        [net.bert.token_type_embed.weight.name]


def test_bert_loss_is_bench_loss():
    """chip_smoke's torch loss against bench.py's jax formula."""
    import jax
    import jax.numpy as jnp

    r = np.random.RandomState(0)
    mlm = r.randn(2, 5, 11).astype("float32")
    nsp = r.randn(2, 2).astype("float32")
    labels = np.concatenate([r.randint(0, 11, (2, 5)),
                             r.randint(0, 2, (2, 1))], 1).astype("int32")
    logp = jax.nn.log_softmax(jnp.asarray(mlm), axis=-1)
    want = -jnp.take_along_axis(logp, jnp.asarray(labels[:, :-1, None]),
                                axis=-1).mean()
    nlogp = jax.nn.log_softmax(jnp.asarray(nsp), axis=-1)
    want += -jnp.take_along_axis(nlogp, jnp.asarray(labels[:, -1:]),
                                 axis=-1).mean()
    got = chip_smoke.bert_loss((torch.from_numpy(mlm),
                                torch.from_numpy(nsp)),
                               torch.from_numpy(labels))
    assert abs(got.item() - float(want)) < 1e-5


# -- the Llama-training checks ------------------------------------------------
@pytest.fixture(scope="module")
def tiny_llama():
    """llama_tiny with init_random_ weights on the CPU, a batch, and the
    fp64 SGD step the checks hold others to (as the CPU's step on the
    chip)."""
    net = chip_smoke.init_llama(port_llama.llama_tiny(device="cpu").config,
                                0, mx.cpu())
    ids, labels = chip_smoke.llama_batch(0, 2, 32, net.config.vocab_size)
    ref = chip_smoke.trainstep_result(
        chip_smoke.copy_llama(net, mx.cpu()).double(), ids, labels, "cpu",
        chip_smoke.LLAMA_CHECK_OPT, None, chip_smoke.llama_loss)
    return net, ids, labels, list(net.collect_params()), ref


def _llama_step(net, ids, labels, ref, dtype=None):
    return chip_smoke.trainstep_result(net, ids, labels, "cpu",
                                       chip_smoke.LLAMA_CHECK_OPT, dtype,
                                       chip_smoke.llama_loss, ref[1])


@pytest.mark.parametrize("fault", [None, "no_gqa_fold", "rope_sign"])
def test_llama_step_check_catches_planted_faults(tiny_llama, fault):
    """The fp32 step sits within LLAMA_FP32_BOUND of the fp64 step, every
    tensor moves, and each planted fault (the GQA fold of the attention
    backward, rope rotating the wrong way) fails the check."""
    net, ids, labels, names, ref = tiny_llama
    scope = chip_smoke.llama_fault(port_fa, fault) if fault else \
        contextlib.nullcontext()
    with scope:
        cand = _llama_step(net, ids, labels, ref)
    bound = chip_smoke.LLAMA_FP32_BOUND
    if fault is None:
        assert 0.0 < chip_smoke.check_steps(cand, ref, names, "fp32", bound)
        assert chip_smoke.unchanged(cand, names) == []
    else:
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            chip_smoke.check_steps(cand, ref, names, fault, bound)
    assert port_get_op("rope").fn is port_attention_ops.rope


def test_llama_remat_step_equals_the_plain_step(tiny_llama):
    net, ids, labels, names, ref = tiny_llama
    plain = _llama_step(net, ids, labels, ref)
    rnet = chip_smoke.copy_llama(
        net, mx.cpu(), port_llama.llama_tiny(device="cpu", remat=True).config)
    remat = _llama_step(rnet, ids, labels, ref)
    assert chip_smoke.check_steps(remat, plain, names, "remat",
                                  chip_smoke.LLAMA_REMAT_BOUND) == 0.0


def test_llama_bf16_step_check_catches_rope_sign(tiny_llama):
    net, ids, labels, names, ref = tiny_llama
    noise = _llama_step(net, ids, labels, ref, "bfloat16")
    scales = chip_smoke.noise_scales(noise, ref, names)
    bound = chip_smoke.BF16_NOISE_FACTOR
    assert chip_smoke.check_steps(_llama_step(net, ids, labels, ref,
                                              "bfloat16"),
                                  ref, names, "bf16", bound, scales) <= 1.0
    with chip_smoke.planted_rope_fault():
        cand = _llama_step(net, ids, labels, ref, "bfloat16")
    with pytest.raises(SystemExit, match="CHECK FAILED"):
        chip_smoke.check_steps(cand, ref, names, "rope_sign", bound, scales)


def test_llama_moe_check_runs_on_the_cpu():
    ratio, moved = chip_smoke.llama_moe_check(0, device="cpu")
    assert 0.0 < ratio <= chip_smoke.LLAMA_FP32_BOUND < moved


def test_llama_loss_is_bench_loss():
    """chip_smoke's torch loss against bench.py's jax formula."""
    import jax
    import jax.numpy as jnp

    r = np.random.RandomState(0)
    logits = r.randn(2, 5, 11).astype("float32")
    labels = r.randint(0, 11, (2, 5)).astype("int32")
    logp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    want = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None],
                                axis=-1)
    got = chip_smoke.llama_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
