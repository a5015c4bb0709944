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

The mx.nd op table (phase 8): at tiny shapes, CPU against CPU in fp64,
(a) passes every op call of the phase (all 278 definitions) and fails an
argsort that returns int64, a topk with is_ascend flipped, a where_index
that goes through the host, a box_nms whose sort breaks ties the other
way, a MultiBoxTarget whose shared anchor keeps the first row, int8
products accumulated in fp32 and a bicubic resize by F.interpolate, and
the coverage check fails when a definition is left out; (b) the LSTM
LM's step check passes the port and fails each of its three planted
faults; (d) the sampler checks pass the port and fail a random_normal
drawing at 1.05 times its scale, and the random image ops meet their
closed forms; (e) the detection chains agree CPU against CPU.

Serving over HTTP (phase 4b): the client's checks pass a correct port
and fail a route that drops a token and a drain that serves the queued
request instead of rejecting it.

The Gluon frontend (phase 11): (a) autograd.grad, create_graph, a
Function and the control flow, (b) a zoo family's hybridized forward and
step against the eager ones and the fp32 step against the fp64 step, (d)
the hybridized gluon.rnn word LM's step (two planted faults of the fused
LSTM fail it) and the cells' unroll against the layer, and (e) the BERT
recipe with the model and the loss hybridized, all at tiny sizes, CPU
against CPU.  The six planted faults of the cache need a CUDA graph and
are caught on the card.

The serving fleet (phase 4c): the local-mode checks pass a correct port
and fail a ``join_replica`` that copies the weights, a router that
delivers a completion twice, a request lost after the crash and a replica
that is never replaced; the process-mode checks pass a fleet of CPU
children serving llama_tiny.

The runtime planes (phase 13, ``--planes``): the flag parses and needs a
card; at a tiny BERT on the CPU (host trace only: the card's kernels are
traced on the card) (a) the profiled losses equal the plain ones and the
dumps() rows the ops invoked; (b) the counted step equals the analytic
count and the attention's report left out misses it, and the serving
engine's accounted FLOPs equal the analytic count by signature; (c) the
guard keeps the clean losses, skips the planted NaN with the state
untouched, catches the spike, the planted guard fault misses the NaN, and
the rewind goes through run_with_recovery to the ``rewind`` bucket with
the unguarded losses after it; (d) the watchdog child (the tiny recipe)
exits 45 within the deadline plus a poll with its black box; (f) rank 0
publishes and merges.
"""
import contextlib
import json
import os
import sys
import time

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


# -- phase 4b: serve() over HTTP -------------------------------------------------
def _route_dropping_a_token(original):
    def route(self, method, path, query, body):
        status, ctype, payload = original(self, method, path, query, body)
        if status == 200:
            doc = json.loads(payload)
            doc["token_ids"] = doc["token_ids"][:-1]
            payload = json.dumps(doc).encode()
        return status, ctype, payload
    return route


def _step_admitting_after_stop(self):
    """ServingEngine._step without its stop check: queued work is served
    after a stop instead of rejected."""
    did = False
    while len(self._active) < self._max_batch:
        req = self._queue.pop_ready()
        if req is None:
            break
        admitted = self._timed("prefill", self._admit, req)
        did = True
        if not admitted:
            break
    if self._active:
        self._timed("decode", self._decode_step)
        did = True
    self._publish_gauges()
    return did


@pytest.mark.parametrize("fault", [None, "drop_token", "serve_queued"])
def test_http_phase_checks_catch_planted_faults(fault, monkeypatch):
    """Phase 4b's client and checks on llama_tiny (fp32, rows held by the
    fp32 check), with lifecycle.request_stop for the SIGTERM and no signal
    handlers: a correct port passes, a route that drops a token and a
    drain that serves the queued request fail."""
    from mxnet_tpu_torch import lifecycle

    net = port_llama.init_random_(port_llama.llama_tiny(device="cpu"), 0)
    r = np.random.RandomState(1)
    prompts = [r.randint(0, net.config.vocab_size, (int(n),))
               .astype(np.int32) for n in (20, 37, 50, 61)]
    temps = [0.0, 0.8, 0.0, 0.0]
    monkeypatch.setattr(chip_smoke, "MAX_NEW", 6)
    monkeypatch.setattr(chip_smoke, "N_REQUESTS", len(prompts))
    monkeypatch.setattr(chip_smoke, "HTTP_TIMEOUT", 120)
    monkeypatch.setattr(ServingEngine, "_MAX_CONSEC_STEP_FAILURES", 5)
    decode = ServingEngine._decode_body

    def slow_decode(self, *args):       # the drain's request stays in flight
        time.sleep(0.01)
        return decode(self, *args)

    monkeypatch.setattr(ServingEngine, "_decode_body", slow_decode)
    if fault == "drop_token":
        monkeypatch.setattr(
            ServingEngine, "_http_completions",
            _route_dropping_a_token(ServingEngine._http_completions))
    elif fault == "serve_queued":
        monkeypatch.setattr(ServingEngine, "_step",
                            _step_admitting_after_stop)
    engine_kw = dict(batch_buckets=[1, 2, 4], prefill_buckets=[32, 64],
                     kv_pages=64, page_size=8, max_batch=4)

    def run():
        return chip_smoke.http_phase(
            net, engine_kw, prompts, temps, 0, port_fa._flash_fwd_cuda,
            lambda res, rows: chip_smoke.check_fp32_run(
                port_llama, port_fa, net, prompts, temps, res, rows),
            stop=lambda: lifecycle.request_stop("test stop"),
            install_signals=False, device="cpu", drain_tokens=120)

    if fault is None:
        out = run()
        assert out["rc"] == lifecycle.EXIT_PREEMPTED
        assert [len(r["token_ids"]) for r in out["results"]] == [6] * 4
        assert out["launches"] == 0          # no kernel on the CPU
    else:
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            run()
    assert not lifecycle.stop_requested()
    from mxnet_tpu_torch import telemetry
    assert telemetry._HTTP_SERVER is None


# -- phase 4c: the serving fleet ------------------------------------------------
FLEET_KW = dict(batch_buckets=[1, 2, 4], prefill_buckets=[32, 64],
                kv_pages=64, page_size=8, max_batch=4)


def _fleet_prompts(vocab, n=8):
    r = np.random.RandomState(1)
    return [r.randint(0, vocab, (int(m),)).astype(np.int32)
            for m in r.randint(20, 62, n)]


def _slow_decode(monkeypatch, seconds):
    """Each decode step takes ``seconds`` more: requests stay in flight
    long enough to be caught there."""
    decode = ServingEngine._decode_body

    def slow(self, *args):
        time.sleep(seconds)
        return decode(self, *args)

    monkeypatch.setattr(ServingEngine, "_decode_body", slow)


def _plant_fleet_fault(monkeypatch, fault):
    from mxnet_tpu_torch.serving.fleet import (FairShareQueue, FleetManager,
                                               IdempotencyLedger, Router)

    if fault == "copy_join":
        join = ServingEngine.join_replica.__func__

        def copying(cls, net, donor, **kw):
            eng = join(cls, net, donor, **kw)
            eng._params = {k: v.clone() for k, v in eng._params.items()}
            return eng
        monkeypatch.setattr(ServingEngine, "join_replica",
                            classmethod(copying))
    elif fault == "duplicate":
        attempt = Router._attempt

        def twice(self, req, replica, kind):
            attempt(self, req, replica, kind)
            attempt(self, req, replica, kind)
        monkeypatch.setattr(IdempotencyLedger, "claim", lambda self, rid: True)
        monkeypatch.setattr(Router, "_attempt", twice)
    elif fault == "lost":
        monkeypatch.setattr(FairShareQueue, "requeue",
                            lambda self, req, tenant="default": None)
        monkeypatch.setattr(chip_smoke, "FLEET_DEADLINE_MS", 8_000)
    elif fault == "never_replaced":
        monkeypatch.setattr(FleetManager, "on_replica_dead",
                            lambda self, r: self.router.remove_replica(r))
        monkeypatch.setattr(chip_smoke, "FLEET_WAIT", 5)


@pytest.mark.parametrize("fault", [None, "copy_join", "duplicate", "lost",
                                   "never_replaced"])
def test_fleet_local_checks_catch_planted_faults(fault, monkeypatch):
    """Phase 4c (1) and (2) on llama_tiny in fp32 on the CPU, the rows held
    by the fp32 check, lifecycle.request_stop for the SIGTERM."""
    from mxnet_tpu_torch import lifecycle, telemetry

    net = port_llama.init_random_(port_llama.llama_tiny(device="cpu"), 0)
    prompts = _fleet_prompts(net.config.vocab_size)
    temps = [0.8 if i in (1, 5) else 0.0 for i in range(len(prompts))]
    monkeypatch.setattr(chip_smoke, "MAX_NEW", 6)
    monkeypatch.setattr(chip_smoke, "N_REQUESTS", len(prompts))
    monkeypatch.setattr(chip_smoke, "HTTP_TIMEOUT", 120)
    _slow_decode(monkeypatch, 0.05)
    _plant_fleet_fault(monkeypatch, fault)

    def run():
        return chip_smoke.fleet_local_phase(
            net, FLEET_KW, prompts, temps, port_fa._flash_fwd_cuda,
            lambda idx, res, rows: chip_smoke.check_fp32_run(
                port_llama, port_fa, net, [prompts[i] for i in idx],
                [temps[i] for i in idx], res, rows),
            stop=lambda: lifecycle.request_stop("test stop"),
            install_signals=False, device="cpu")

    if fault is None:
        out = run()
        assert out["rc"] == lifecycle.EXIT_PREEMPTED
        assert [len(r["token_ids"]) for r in out["results"]] == [6] * 8
        assert out["launches"] == 0          # no kernel on the CPU
        assert out["crash"]["dead"] in ("replica-1", "replica-2")
        assert len(out["spawn_s"]) == 3 and len(out["join_s"]) == 2
    else:
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            run()
    assert not lifecycle.stop_requested()
    assert telemetry._HTTP_SERVER is None


FLEET_CHILD = r'''
import os, sys, time
fd = os.open(sys.argv[1], os.O_WRONLY | os.O_CREAT | os.O_APPEND)
os.dup2(fd, 2)
from mxnet_tpu_torch.gluon.model_zoo.language import llama
from mxnet_tpu_torch.serving import ServingEngine, serve
decode = ServingEngine._decode_body
def slow(self, *args):
    time.sleep(0.05)
    return decode(self, *args)
ServingEngine._decode_body = slow
net = llama.init_random_(llama.llama_tiny(device="cpu"), 0)
sys.exit(serve(net, port=0, device="cpu", batch_buckets=[1, 2, 4],
               prefill_buckets=[32, 64], kv_pages=64, page_size=8,
               max_batch=4))
'''


def test_fleet_process_checks_pass_cpu_children(monkeypatch):
    """Phase 4c (3) with two CPU children serving llama_tiny (the card's
    children serve the Llama-3-8B-width net): the SIGKILL, exactly-once
    answers, the death noted within a probe interval, a replacement that
    serves, and a drain after which every child exited 43."""
    from mxnet_tpu_torch import lifecycle, telemetry

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setattr(chip_smoke, "HTTP_TIMEOUT", 120)
    monkeypatch.setenv("PYTHONPATH", repo)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    prompts = _fleet_prompts(512)
    out = chip_smoke.fleet_process_phase(
        prompts, lambda rid, log: [sys.executable, "-c", FLEET_CHILD, log],
        stop=lambda: lifecycle.request_stop("test stop"),
        install_signals=False, n_tokens=6)
    assert out["rc"] == lifecycle.EXIT_PREEMPTED
    assert [k for _, k, _ in out["spawn_s"]] == ["initial", "initial",
                                                 "replacement"]
    assert len(out["results"]) == len(prompts)
    assert out["crash"]["extra_attempts"] + out["crash"]["resubmits"] > 0
    assert not lifecycle.stop_requested()
    assert telemetry._HTTP_SERVER is None


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


# ---------------------------------------------------------------------------
# phase 8: the mx.nd op table
# ---------------------------------------------------------------------------
TINY_OP_SHAPES = {
    "hidden": (2, 3, 4), "logits": (2, 64),
    "scores": ((6, 4, 3), (6, 3, 4)), "ffn": (8, 6, 10), "spd": (2, 8),
    "nhwc": (2, 20, 20, 8), "ids": (16, 40, 6), "tnc": (6, 3, 4),
    "nchw": (2, 8, 6, 6), "up": (2, 4, 4, 4), "loss": (8, 12),
    "ctc": (12, 3, 5, 4), "stn": (2, 3, 5, 6), "rnn": (4, 3, 5, 2),
    "eye": 8, "opt": (6, 4), "interleaved": (4, 2, 2, 3),
    "rope": (1, 2, 4, 4), "swiglu": (3, 5), "moe": (1, 4, 6, 2, 4),
    "attn": (1, 2, 4, 4), "flow": (1, 3, 6, 7, 2), "image": (2, 8, 11, 5),
    "draws": (4, 5), "pdf": (3, 8), "qconv": (2, 3, 5, 4),
    "qfc": (4, 2048, 8), "ssd": (2, 5, 4, 6, (4, 2, 1)),
    "rcnn": (1, 3, 4, 5, 6, 20), "dcn": (1, 3, 5)}
TINY_SAMPLERS = {"embed": (500, 400), "vocab": (2, 50), "draws": 200_000,
                 "multinomial_draws": 4000, "image": (2, 6, 7, 3),
                 "image_draws": 40}
TINY_LM = dict(vocab=30, embed=6, hidden=6, layers=2, steps=5, batch=3,
               dropout=0.5)


def test_op_table_checks_pass_the_port():
    devs = chip_smoke.op_table_checks(0, "cpu", TINY_OP_SHAPES,
                                      dtype=torch.float64)
    assert len(devs) >= len(chip_smoke.op_table_definitions()) == 278
    assert max(devs.values()) == 0.0


@pytest.mark.parametrize("fault,op", [("argsort_int64", "argsort"),
                                      ("topk_flipped", "topk"),
                                      ("where_index_host", "where_index")])
def test_op_table_check_catches_planted_faults(fault, op):
    cases = [c for c in chip_smoke.op_cases(TINY_OP_SHAPES) if c.name == op]
    assert cases
    for i, case in enumerate(cases):
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            chip_smoke.check_op_case(case, i, "cpu", torch.float64,
                                     fault=chip_smoke.planted_op_fault(fault))
        # the fault is gone again
        chip_smoke.check_op_case(case, i, "cpu", torch.float64)


def test_op_table_coverage_fails_without_an_op():
    cases = chip_smoke.op_cases(TINY_OP_SHAPES)
    chip_smoke.check_op_coverage(cases)
    with pytest.raises(SystemExit, match="linalg_det"):
        chip_smoke.check_op_coverage(
            [c for c in cases if c.name != "linalg_det"])


@pytest.mark.parametrize("fault", [None, "gates_if", "first_h",
                                   "null_batch"])
def test_lm_step_check_catches_planted_faults(fault):
    ratio, where, _ = chip_smoke.lm_step_check(TINY_LM, 0, "cpu",
                                               torch.float64, fault=fault)
    if fault is None:
        assert ratio == 0.0
    else:
        assert ratio > chip_smoke.LM_BOUND, (fault, ratio, where)


def test_lm_fp32_step_held_to_the_fp64_step():
    """The card's check in miniature: the fp32 step (here the CPU's) within
    LM_BOUND of the fp64 step."""
    ratio, where, _ = chip_smoke.lm_step_check(TINY_LM, 0, "cpu",
                                               torch.float32)
    assert 0.0 < ratio <= chip_smoke.LM_BOUND, (ratio, where)


@pytest.mark.parametrize("fault,label", [
    ("nms_unstable", "_contrib_box_nms"),
    ("target_first_write", "_contrib_MultiBoxTarget"),
    ("int8_fp32", "_contrib_quantized_fully_connected (sums past 2^24)"),
    ("resize_interpolate", "image_resize bicubic to 11"),
    ("resize_interpolate", "image_resize bicubic to 5")])
def test_op_table_check_catches_planted_family_faults(fault, label):
    """Phase 8 (a) fails a box_nms whose sort breaks ties the other way, a
    MultiBoxTarget whose shared anchor keeps the first row, int8 products
    accumulated in fp32 and a bicubic resize by F.interpolate."""
    cases = [c for c in chip_smoke.op_cases(TINY_OP_SHAPES)
             if c.label == label]
    assert len(cases) == 1
    with pytest.raises(SystemExit, match="CHECK FAILED"):
        chip_smoke.check_op_case(cases[0], 0, "cpu", torch.float64,
                                 fault=chip_smoke.planted_family_fault(fault))
    chip_smoke.check_op_case(cases[0], 0, "cpu", torch.float64)


@pytest.mark.parametrize("name", ["_contrib_box_nms", "random_normal",
                                  "_contrib_quantized_conv",
                                  "image_random_hue", "lamb_update_phase2"])
def test_op_table_coverage_fails_without_a_new_definition(name):
    cases = [c for c in chip_smoke.op_cases(TINY_OP_SHAPES)
             if c.name != name]
    with pytest.raises(SystemExit, match=name):
        chip_smoke.check_op_coverage(cases)


def test_sampler_checks_pass_the_port_and_fail_a_planted_scale():
    stats_, _ = chip_smoke.sampler_checks(0, "cpu", TINY_SAMPLERS)
    assert len(stats_) == 12
    assert all(stat < bound for stat, bound in stats_.values())
    with pytest.raises(SystemExit, match="random_normal"):
        with chip_smoke.planted_sampler_fault():
            chip_smoke.sampler_checks(0, "cpu", TINY_SAMPLERS,
                                      only="random_normal")


def test_image_factor_checks_pass_the_port():
    worst, share = chip_smoke.image_factor_checks(0, "cpu", TINY_SAMPLERS)
    assert worst <= chip_smoke.OP_TOL and 0.0 < share < 1.0


def test_detection_chains_run_on_the_cpu():
    out = chip_smoke.detection_chains(0, TINY_OP_SHAPES, device="cpu",
                                      repeats=1)
    assert len(out) == 3
    assert all(dev == 0.0 for _, _, dev in out.values())


# -- the Gluon training surface (phase 9) ----------------------------------------
def test_gluon_train_flag_needs_a_card(monkeypatch, capsys):
    """``--gluon-train`` parses; without a card the script exits nonzero
    and prints no result."""
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--gluon-train"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_gluon_bert_seeds_flag_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--gluon-bert-seeds",
                                      "1", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_gluon_path_is_on_the_kernels_line():
    assert chip_smoke.PATH_SHAPES["gluon_bert_lamb"] == chip_smoke.BERT_SHAPE


TINY_OPT_SHAPES = ((300, 16), (16,))


@pytest.mark.parametrize("fault", [None, "lamb_ratio_1"])
def test_gluon_optimizer_checks_catch_a_unit_trust_ratio(fault):
    """Every registered optimizer (SGLD by its noise's KS) passes; a LAMB
    whose trust ratio is forced to 1 fails."""
    if fault is None:
        devs = chip_smoke.gluon_optimizer_checks(0, "cpu", TINY_OPT_SHAPES)
        assert len(devs) == len(chip_smoke.GLUON_OPTIMIZERS) + 1
        assert {label.split()[0] for label in devs} == \
            set(chip_smoke.GLUON_OPTIMIZERS[i][0]
                for i in range(len(chip_smoke.GLUON_OPTIMIZERS))) | {"sgld"}
    else:
        with pytest.raises(SystemExit, match="optimizer lamb"):
            chip_smoke.gluon_optimizer_checks(0, "cpu", TINY_OPT_SHAPES,
                                              fault, only="lamb")


def test_gluon_bert_recipe_check_catches_ignored_multipliers():
    """GluonNLP's step on the CPU (fp32 and bf16 against fp64) passes,
    the reference's param_dict lookup fails the fp32 bound, and the
    tensors held to lr are exactly the key projections' biases."""
    cfg = _tiny_bert_cfg()
    # the planted bf16 faults are sized for BERT-base (fp16's underflow
    # needs its small gradients): their check runs on the card only
    out = chip_smoke.bert_recipe_check(cfg, 0, "cpu", batch=4, seq=16,
                                       check_bounds=False)
    assert out["fp32"] <= chip_smoke.GLUON_FP32_NOISE_FACTOR
    assert out["fp32 median"] <= out["fp32"]
    assert "tf32" not in out           # a control of the card's alone
    assert out["bf16"] <= chip_smoke.BF16_NOISE_FACTOR
    assert out["bf16"] == out["bf16 readings"]["bf16"]["worst"]
    # the scale control is read under --gluon-bert-seeds only
    readings = out["bf16 readings"]
    assert set(readings) == {"bf16", "fp16", "master", "fp32 list"}
    # weights kept in bf16 fail the bound; AMP's fp32 list dropped leaves
    # the loss a bf16 number, which the right step's never is
    assert readings["master"]["worst"] > chip_smoke.GLUON_BF16_NOISE_FACTOR
    assert readings["fp32 list"]["loss in bf16"]
    assert not readings["bf16"]["loss in bf16"]
    assert out["fault"] > chip_smoke.GLUON_FP32_NOISE_FACTOR
    assert len(out["noisy"]) == cfg.num_layers
    assert all(n.startswith("dense") and n.endswith("bias")
               for n in out["noisy"])


def test_lamb_scales_floor_only_noise_tensors():
    info = {"lr": 0.5, "grad_max": [1.0, 1e-12, 0.0, 2e-3]}
    assert chip_smoke.lamb_scales([1.0, 1e-3, 1e-4, 1e-5, 1e-6], info) == \
        [1.0, 1e-3, 0.5, 1e-5, 1e-6]


def test_loss_scale_check_runs_on_the_cpu():
    scales, launches = chip_smoke.loss_scale_check(
        0, "cpu", cfg=_tiny_bert_cfg(), batch=2, seq=8)
    assert scales == [1024.0, 2048.0, 1024.0]
    assert launches == 0               # the plain version on the CPU


def test_resnet_recipe_check_catches_an_ignored_warmup():
    ratio, fault = chip_smoke.resnet_recipe_check(
        _tiny_resnet, 0, "cpu", batch=4, size=32, classes=10)
    assert ratio <= chip_smoke.FP32_STEP_BOUND < fault


# -- the Gluon frontend (phase 11) -----------------------------------------------
def test_frontend_flag_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--frontend"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_frontend_path_is_on_the_kernels_line():
    assert chip_smoke.PATH_SHAPES["gluon_bert_lamb_hybrid"] == \
        chip_smoke.BERT_SHAPE


def test_frontend_autograd_checks_run_on_the_cpu():
    """(a) in miniature, CPU against CPU: every reading exactly 0 (the
    hybridized penalty runs the same ops on the CPU)."""
    out = chip_smoke.autograd_checks(0, "cpu", widths=(16, 32), batch=4,
                                     flow_shape=(5, 3, 8))
    assert set(out) == {"grad", "create_graph", "hybrid grad",
                        "hybrid create_graph", "control flow and Function"}
    assert all(v == 0.0 for v in out.values())


def test_frontend_zoo_checks_run_on_the_cpu():
    """(b) in miniature: the hybridized forward and step equal the eager
    ones, and the fp32 step lies within phase 5's bound of the fp64 step
    (fp64 against itself: 0)."""
    out = chip_smoke.zoo_checks(
        0, "cpu", families=(("squeezenet1_1", 31, {}),
                            ("resnet18_v1", 32, {"stem": "s2d"})),
        batch=2, cpu_batch=2, classes=10)
    for r in out.values():
        assert r["forward"] == r["step"] == r["fp64"] == 0.0
        assert 0.0 < r["fp32"] <= chip_smoke.FP32_STEP_BOUND


TINY_WORD_LM = dict(vocab=50, embed=8, hidden=8, layers=2, steps=5, batch=3,
                    dropout=0.5)


@pytest.mark.parametrize("fault", [None, "gates_if", "first_h"])
def test_frontend_lm_check_catches_planted_faults(fault):
    """(d): the hybridized gluon.rnn LM's fp32 step passes, and each
    planted fault of the fused LSTM fails it."""
    if fault is None:
        ratio, unroll = chip_smoke.lm_checks(0, "cpu", TINY_WORD_LM)
        assert 0.0 < ratio <= chip_smoke.LM_BOUND
        assert unroll <= chip_smoke.UNROLL_TOL
    else:
        with pytest.raises(SystemExit, match="LM step"):
            chip_smoke.lm_checks(0, "cpu", TINY_WORD_LM, fault=fault)


def test_frontend_bert_checks_run_on_the_cpu():
    """(e) in miniature: the recipe with the model and the loss hybridized
    equals the eager recipe, and its fp32 step lies within phase 9 (b)'s
    bound of the fp64 step."""
    out = chip_smoke.bert_hybrid_checks(0, "cpu", cfg=_tiny_bert_cfg(),
                                        batch=2, seq=8)
    assert out["vs eager"] == 0.0
    assert out["vs CPU"] <= chip_smoke.GLUON_FP32_NOISE_FACTOR


@pytest.mark.parametrize("fault", chip_smoke.FRONT_FAULTS)
def test_frontend_fault_checks_pass_the_port(fault):
    """The planted-fault checks pass the port on the CPU.  Every planted
    fault needs a CUDA graph (an output returned without a copy, a graph
    reading a replaced tensor, a failed capture answered eagerly, a graph
    on a replaced generator, a graph differentiating a stale set of
    parameters, a graph whose kept activations a second call overwrites),
    and a CPU entry captures nothing: they are caught on the card.  Here
    each fault's scope restores what it patched."""
    from mxnet_tpu_torch import random as rnd
    from mxnet_tpu_torch.gluon import _cached_op, block, parameter

    def state():
        G = _cached_op.GraphForward
        return (G.replay, G.__init__, G.__call__, G._busy,
                block.HybridBlock._bump_cache_version,
                block.HybridBlock._valid_params, rnd.epoch,
                parameter.Parameter.__dict__["grad_req"])

    saved = state()
    assert chip_smoke.frontend_fault_checks(0, "cpu") == {}
    with chip_smoke.planted_frontend_fault(fault):
        pass
    assert state() == saved


# -- phase 13: the runtime planes ----------------------------------------------
def test_planes_flags_parse_and_need_a_card(monkeypatch, capsys):
    args = chip_smoke.parse_args(["--planes", "--seed", "3"])
    assert args.planes and args.seed == 3
    args = chip_smoke.parse_args(["--watchdog-worker", "--watchdog-dir",
                                  "d", "--resume-device", "cpu"])
    assert args.watchdog_worker and args.watchdog_dir == "d"
    assert chip_smoke.parse_args(["--tune-replay"]).tune_replay
    assert chip_smoke.parse_args(["--nvcc-seconds", "a.cu", "b.cu"]) \
        .nvcc_seconds == ["a.cu", "b.cu"]
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--planes"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    assert chip_smoke.PATH_SHAPES["gluon_bert_planes"] == \
        chip_smoke.BERT_SHAPE


@pytest.fixture
def planes_kw():
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    cfg = bert.BertConfig(dropout=0.1, **chip_smoke.RESUME_TINY)
    return dict(device="cpu", cfg=cfg, batch=2, seq=8)


def test_planes_profiler_checks_on_the_cpu(planes_kw, tmp_path):
    out = chip_smoke.planes_profiler(0, str(tmp_path), steps=2, **planes_kw)
    chip_smoke.check_planes_profiler(out, planes_kw["cfg"], steps=2,
                                     cuda=False)
    assert out["op_events"] > 0 and out["rows"]


def test_planes_flop_checks_and_the_planted_omission(planes_kw):
    out = chip_smoke.planes_flops(0, **planes_kw)
    chip_smoke.check_planes_flops(out, cuda=False)
    assert out["eager"] == out["want"]
    assert out["planted"] == out["want"] - out["attention"]


def test_serving_flops_match_the_analytic_count():
    out = chip_smoke.planes_serving(0, device="cpu")
    assert out == {"prefill": 0.0, "decode": 0.0}


def test_planes_guard_and_rewind_on_the_cpu(planes_kw, tmp_path):
    out = chip_smoke.planes_guard(0, **planes_kw)
    chip_smoke.check_planes_guard(out, cuda=False)
    rew = chip_smoke.planes_rewind(0, str(tmp_path), out["u_losses"],
                                   **planes_kw)
    chip_smoke.check_planes_rewind(rew)
    # the planted guard fault is the check's own: a vector that skips
    # the poisoned parameter reads no non-finite element
    assert out["nf_planted"] == 0 < out["nf_full"]


def test_planes_watchdog_child_exits_45(tmp_path):
    out = chip_smoke.planes_watchdog(0, str(tmp_path), device="cpu",
                                     tiny=True)
    chip_smoke.check_planes_watchdog(out)


def test_planes_aggregation(tmp_path):
    doc = chip_smoke.planes_agg(str(tmp_path / "agg"))
    assert doc["ranks"] == [0]
