"""Online MFU accounting of the port (``mxnet_tpu_torch.introspection``)
against the reference's (``mxnet_tpu.introspection``) on the CPU.

- Under one fake clock the same accounted events give the same trailing
  window, the same ``utilization`` (1e-12 relative) and the same gauge
  absence without a peak.
- A 2-layer BERT's ``TrainStep`` step is counted once, at its first call,
  and equals the analytic count of its products plus the attention's
  forward and backward (``chip_smoke.bert_step_flops``) exactly; without
  the attention's report (planted) it misses by the attention's share.
- Against the reference's count (XLA's cost analysis of the same step,
  which also counts elementwise work, the softmaxes, the norms and the
  optimizer) the port's is lower: REF_RATIO_BOUNDS holds the measured
  ratio (reference / port 1.214 at this size, jax 0.9.0), with room for
  XLA's version-to-version changes of its cost model.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu as rmx
from mxnet_tpu import introspection as rintro
from mxnet_tpu.gluon.model_zoo.language import bert as ref_bert
from mxnet_tpu.parallel.data_parallel import TrainStep as RefTrainStep
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import introspection as pintro
from mxnet_tpu_torch import nd, telemetry
from mxnet_tpu_torch.gluon import load_reference_params
from mxnet_tpu_torch.gluon.model_zoo.language import bert as port_bert
from mxnet_tpu_torch.ops import flash_attention as port_fa
from mxnet_tpu_torch.parallel import TrainStep

CFG = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position=32, dropout=0.0)
BATCH, SEQ = 3, 16
REF_RATIO_BOUNDS = (1.0, 1.3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MXNET_DEVICE_PEAK_FLOPS", raising=False)
    pintro.reset()
    rintro.reset()
    yield
    pintro.reset()
    rintro.reset()


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("events", [[(0.0, 1e9), (0.5, 2e9), (1.5, 1e9)],
                                    [(0.0, 5e12)] + [(0.01 * i, 3e11)
                                                     for i in range(1, 40)]])
def test_window_and_utilization_match_under_a_fake_clock(monkeypatch,
                                                         events):
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setenv("MXNET_DEVICE_PEAK_FLOPS", "1e12")
    for mod in (pintro, rintro):
        mod._DEVICES[0] = 1            # one device in both (jax sees 8)
    got = []
    for dt, flops in events:
        clock.t = 1000.0 + dt
        pintro.account_flops(flops, kind="train_step")
        rintro.account_flops(flops, kind="train_step")
        got.append((pintro.utilization(clock.t + 0.25),
                    rintro.utilization(clock.t + 0.25)))
    assert got[0] == (None, None)      # one event: no window yet
    for p, r in got[1:]:
        assert p == pytest.approx(r, rel=1e-12)
    ps, rs = pintro.window_stats(), rintro.window_stats()
    for key in ("events", "flops", "span_s", "peak", "devices"):
        assert ps[key] == rs[key], key


def test_the_gauge_is_absent_without_a_peak():
    # no card and no MXNET_DEVICE_PEAK_FLOPS: unknown peak in both
    assert pintro.device_peak_flops() is None
    assert rintro.device_peak_flops() is None
    for mod in (pintro, rintro):
        mod.account_flops(1e9)
        mod.account_flops(1e9)
        assert mod.utilization() is None
    # the family itself never appears in a process without a peak (the
    # fake-clock test above registered it in this one)
    code = ("import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch import introspection as i, telemetry\n"
            "i.account_flops(1e9); i.account_flops(1e9)\n"
            "m = telemetry.snapshot()['metrics']\n"
            "print('mxnet_model_flops_utilization' in m, "
            "'mxnet_executable_flops_total' in m)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("MXNET_DEVICE_PEAK_FLOPS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "True"], out.stderr


def _port_loss(outs, labels):
    mlm, nsp = outs
    labels = labels.long()
    mlm_l = -torch.log_softmax(mlm, -1).gather(-1, labels[:, :-1, None])
    nsp_l = -torch.log_softmax(nsp, -1).gather(-1, labels[:, -1:])
    return mlm_l.mean() + nsp_l.mean()


def _ref_loss(outs, labels):
    import jax
    import jax.numpy as jnp

    mlm, nsp = outs
    logp = jax.nn.log_softmax(mlm, axis=-1)
    mlm_l = -jnp.take_along_axis(logp, labels[:, :-1, None], axis=-1)
    nsp_l = -jnp.take_along_axis(jax.nn.log_softmax(nsp, axis=-1),
                                 labels[:, -1:], axis=-1)
    return jnp.mean(mlm_l) + jnp.mean(nsp_l)


def _batch(seed):
    r = np.random.RandomState(seed)
    ids = r.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype("int32")
    labels = np.concatenate(
        [r.randint(0, CFG["vocab_size"], (BATCH, SEQ)),
         r.randint(0, 2, (BATCH, 1))], axis=1).astype("int32")
    return ids, labels


@pytest.fixture(scope="module")
def bert_pair():
    prev = rmx.nd.set_eager_jit(False)
    try:
        ref = ref_bert.BertForPretraining(ref_bert.BertConfig(**CFG))
        ref.initialize()
        ref(rmx.nd.zeros((1, SEQ), dtype="int32"))
    finally:
        rmx.nd.set_eager_jit(prev)
    port = port_bert.BertForPretraining(port_bert.BertConfig(**CFG))
    port.initialize(ctx=mx.cpu())
    port(nd.zeros((1, SEQ), ctx=mx.cpu(), dtype="int32"))
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()})
    return ref, port


def _port_step(port):
    return TrainStep(port, _port_loss, optimizer="sgd",
                     optimizer_params={"learning_rate": 1e-3}, device="cpu")


def test_step_is_counted_once_and_equals_the_analytic_count(bert_pair):
    _, port = bert_pair
    step = _port_step(port)
    ids, labels = _batch(0)
    before = telemetry.snapshot()["metrics"]
    for _ in range(3):
        step(ids, labels)
    assert pintro.count_passes() == 1
    (flops,) = step._flops.values()
    want = chip_smoke.bert_step_flops(port_bert.BertConfig(**CFG), BATCH,
                                      SEQ)
    assert flops == want
    fam = telemetry.snapshot()["metrics"]["mxnet_executable_flops_total"]
    total = {tuple(sorted(s["labels"].items())): s["value"]
             for s in fam["samples"]}[(("kind", "train_step"),)]
    prior = {tuple(sorted(s["labels"].items())): s["value"]
             for s in before.get("mxnet_executable_flops_total",
                                 {"samples": []})["samples"]}
    assert total - prior.get((("kind", "train_step"),), 0.0) == 3 * want
    assert pintro.window_stats()["events"] == 3


def test_the_attention_report_left_out_misses(bert_pair, monkeypatch):
    _, port = bert_pair
    monkeypatch.setattr(port_fa, "_report", lambda *a, **k: None)
    step = _port_step(port)
    ids, labels = _batch(0)
    step(ids, labels)
    (flops,) = step._flops.values()
    cfg = port_bert.BertConfig(**CFG)
    assert flops == chip_smoke.bert_step_flops(cfg, BATCH, SEQ,
                                               attention=False)
    assert flops < chip_smoke.bert_step_flops(cfg, BATCH, SEQ)


def test_step_count_against_the_reference_cost_analysis(bert_pair):
    ref, port = bert_pair
    ids, labels = _batch(1)
    prev = rmx.nd.set_eager_jit(False)
    try:
        rs = RefTrainStep(ref, _ref_loss, optimizer="sgd",
                          optimizer_params={"learning_rate": 1e-3})
        rs(ids, labels)
    finally:
        rmx.nd.set_eager_jit(prev)
    (variants,) = rs._compiled.values()
    ref_flops = variants[0][1]
    ps = _port_step(port)
    ps(ids, labels)
    (flops,) = ps._flops.values()
    ratio = ref_flops / flops
    assert REF_RATIO_BOUNDS[0] <= ratio <= REF_RATIO_BOUNDS[1], ratio
