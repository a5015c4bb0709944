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
The new entry points raise without a card unless asked for the CPU.
"""
import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
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
    cfg = port_llama.LlamaConfig(vocab_size=512, hidden_size=128,
                                 num_layers=2, num_heads=4, num_kv_heads=2,
                                 intermediate_size=256, max_seq_len=256)
    net = port_llama.init_random_(
        port_llama.LlamaForCausalLM(cfg, device="cpu"), 0)
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
