"""Preemption and exact resume on the port, on the CPU: the step-boundary
poll (``lifecycle.check_stop`` and its ``lifecycle.sigterm`` seam), the
final checkpoint (``publish_final_checkpoint``, honouring
``MXNET_PREEMPTION_CHECKPOINT``), the train state
(``capture_train_state`` / ``restore_train_state``), ``Estimator.fit`` and
``TrainStep.run`` stopping at a boundary, the device prefetcher, the
callbacks, and ``chip_smoke.py``'s phase 10 (d) and (e) at a tiny size:
``TrainStep.run``'s prefetch 2 gives prefetch 0's losses and the seam
stops it after step 3; ``Estimator.fit`` with a checkpoint manager stops
on the seam and its checkpoint restores.  Phase 10 (a)-(c), the exact
resume, are in ``tests/test_torch_resume.py``.
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu.contrib.amp import loss_scaler as ref_loss_scaler
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import (callback, env, fault, flight_recorder, gluon,
                             guard, lifecycle, nd, telemetry)
from mxnet_tpu_torch import random as mx_random
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon.contrib import Estimator
from mxnet_tpu_torch.gluon.data import PrefetchIterator, device_put_batch
from mxnet_tpu_torch.gluon.model_zoo.language import bert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
from mxnet_tpu_torch.parallel import TrainStep

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _planes():
    lifecycle.reset()
    fault.reset_stats()
    yield
    lifecycle.reset()
    fault.reload_spec()
    amp.disable()


def _tiny_bert_cfg(dropout=0.1):
    return bert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                           num_heads=2, intermediate_size=64,
                           max_position=32, dropout=dropout)


def _tiny_resnet():
    return resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                           [8, 16, 24, 32, 40], classes=10, layout="NHWC")


def _dense():
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)
    return net


# -- check_stop ----------------------------------------------------------
def test_check_stop_polls_the_flag_the_seam_and_the_heartbeat():
    before = telemetry.last_heartbeat()
    assert lifecycle.check_stop() is False
    assert telemetry.last_heartbeat() is not None
    assert before is None or telemetry.last_heartbeat() >= before
    with fault.inject("lifecycle.sigterm"):
        assert lifecycle.check_stop() is True
    assert "fault-injected preemption" in lifecycle.stop_reason()
    assert fault.stats()["lifecycle.sigterm"]["trips"] == 1
    assert lifecycle.check_stop() is True        # the flag stays set
    lifecycle.reset()
    assert lifecycle.check_stop() is False
    lifecycle.request_stop("programmatic")
    assert lifecycle.check_stop() is True


def test_check_stop_agreement_across_processes_raises(monkeypatch):
    """With more than one process and agreement on, every
    MXNET_STOP_SYNC_EVERY-th call is one allreduce_any; the calls between
    return the last agreed verdict, and a stop agreed from a peer stops
    this process too.  (The real two-process agreement is in
    tests/test_torch_collectives.py.)"""
    from mxnet_tpu_torch.parallel import collectives

    votes = []

    def peer_stops(flag):
        votes.append(flag)
        return True

    monkeypatch.setattr(lifecycle, "world_size", lambda: 2)
    monkeypatch.setattr(collectives, "allreduce_any", peer_stops)
    assert lifecycle.check_stop() is False       # agreement off: local
    assert votes == []
    monkeypatch.setenv("MXNET_STOP_SYNC_EVERY", "2")
    lifecycle.coordinate_stops(True)
    assert lifecycle.check_stop() is False       # off-stride: last agreed
    assert votes == []
    assert lifecycle.check_stop() is True        # the vote: a peer stops
    assert votes == [False] and lifecycle.stop_requested()
    assert lifecycle.check_stop() is True        # off-stride: agreed
    assert lifecycle.check_stop(sync=False) is True


# -- publish_final_checkpoint and the train state ------------------------
def test_publish_final_checkpoint_honours_the_env(tmp_path, monkeypatch):
    net = _dense()
    mgr = CheckpointManager(str(tmp_path / "c"))
    monkeypatch.setenv("MXNET_PREEMPTION_CHECKPOINT", "0")
    assert env.preemption_checkpoint_default() is False
    assert lifecycle.publish_final_checkpoint(mgr, 3, net) is None
    assert mgr.all_steps() == []
    monkeypatch.delenv("MXNET_PREEMPTION_CHECKPOINT")
    d = lifecycle.publish_final_checkpoint(mgr, 3, net,
                                           train_state={"step": 3})
    assert d == mgr._step_dir(3) and mgr.latest_valid_step() == 3
    assert mgr.read_train_state(3) == {"step": 3}


class _Loader:
    def __init__(self):
        self.pos = 0

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, state):
        self.pos = state["pos"]


def test_capture_and_restore_train_state():
    mx.random.seed(7)
    gen = mx_random.generator("cpu")
    torch.randn(3, generator=gen)
    scaler = amp.LossScaler(init_scale=8.0, scale_window=2)
    scaler.update_scale(False)
    loader = _Loader()
    loader.pos = 5
    net = _dense()
    trainer = gluon.Trainer(net.collect_params(), "sgd")
    state = lifecycle.capture_train_state(
        4, dataloader=loader, scaler=scaler, trainer=trainer,
        extra={"note": 1})
    want = torch.randn(4, generator=mx_random.generator("cpu"))
    assert state["step"] == 4 and state["extra"] == {"note": 1}
    assert state["trainer"] == {"num_update": 0}
    assert state["loss_scaler"] == {"loss_scale": 8.0, "unskipped": 1}
    mx.random.seed(99)
    loader2, scaler2 = _Loader(), amp.LossScaler()
    assert lifecycle.restore_train_state(state, dataloader=loader2,
                                         scaler=scaler2) == 4
    assert loader2.pos == 5 and scaler2.state_dict() == \
        scaler.state_dict()
    assert torch.equal(torch.randn(4, generator=mx_random.generator("cpu")),
                       want)
    assert lifecycle.restore_train_state(None) is None
    g = guard.Guard()
    g._classify(0.0, 4.0, 2.0, 1.0)
    state = lifecycle.capture_train_state(guard=g)
    g2 = guard.Guard()
    lifecycle.restore_train_state(state, guard=g2)
    assert g2.state_dict() == g.state_dict() == state["guard"]
    with pytest.raises(MXNetError, match="reference"):
        mx_random.set_state([1, 2])      # the reference's key words


def test_loss_scaler_state_crosses_packages():
    ref = ref_loss_scaler.LossScaler(init_scale=64.0, scale_window=3)
    ref.update_scale(False)
    port = amp.LossScaler()
    port.load_state_dict(ref.state_dict())
    assert port.state_dict() == ref.state_dict()
    port.update_scale(True)
    ref.load_state_dict(port.state_dict())
    assert ref.state_dict() == port.state_dict() == {"loss_scale": 32.0,
                                                     "unskipped": 0}


def test_env_accessors_defaults(monkeypatch):
    for name in ("MXNET_CHECKPOINT_ASYNC", "MXNET_PREFETCH_BUFFER",
                 "MXNET_PREEMPTION_CHECKPOINT"):
        monkeypatch.delenv(name, raising=False)
    assert env.checkpoint_async_default() is False
    assert env.prefetch_buffer() == 2
    assert env.preemption_checkpoint_default() is True
    monkeypatch.setenv("MXNET_PREFETCH_BUFFER", "-3")
    assert env.prefetch_buffer() == 0
    assert "MXNET_CHECKPOINT_ASYNC" in env.describe()


# -- Estimator.fit and TrainStep.run -------------------------------------
def _fit_batches(n, arm_at=None):
    r = np.random.RandomState(0)
    for i in range(n):
        item = (nd.array(r.randn(4, 3).astype("f"), ctx=CPU),
                nd.array(r.randint(0, 2, 4).astype("f"), ctx=CPU))
        if arm_at == i + 1:
            with fault.inject("lifecycle.sigterm"):
                yield item
        else:
            yield item


def test_estimator_fit_runs_and_stops_without_a_manager():
    net = _dense()
    est = Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                    trainer=gluon.Trainer(net.collect_params(), "sgd"))
    history = est.fit(list(_fit_batches(3)), epochs=2, telemetry=True)
    assert [h["epoch"] for h in history] == [0, 1]
    assert est.global_step == 6 and "accuracy" in history[0]
    with pytest.raises(lifecycle.GracefulExit) as e:
        est.fit(_fit_batches(5, arm_at=2))
    assert e.value.step == 8


def test_estimator_fit_stops_with_a_manager():
    assert chip_smoke.estimator_stop_check(_tiny_resnet, 0, "cpu", batch=2,
                                           size=32, classes=10) == \
        chip_smoke.FIT_STOP_AFTER


def test_trainstep_run_prefetch_and_stop():
    times, launches = chip_smoke.trainstep_run_check(
        0, "cpu", cfg=_tiny_bert_cfg(), batch=2, seq=16, steps=5)
    assert set(times) == {0, chip_smoke.RUN_PREFETCH} and launches == 0


def test_trainstep_run_failure_dumps_the_black_box(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path))
    flight_recorder.reset()
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)

    def loss(out, y):
        raise RuntimeError("bad step")

    step = TrainStep(net, loss, device="cpu")
    batches = [(np.ones((2, 3), "f"), np.zeros(2, "f"))]
    with pytest.raises(RuntimeError, match="bad step"):
        step.run(iter(batches), prefetch=1)
    assert os.path.exists(os.path.join(tmp_path, "blackbox.rank0.json"))
    # a guarded run fails the same way (the failure is not the guard's)
    os.remove(os.path.join(tmp_path, "blackbox.rank0.json"))
    with pytest.raises(RuntimeError, match="bad step"):
        step.run(iter(batches), guard=guard.Guard())
    assert os.path.exists(os.path.join(tmp_path, "blackbox.rank0.json"))


# -- the prefetcher ------------------------------------------------------
def test_prefetch_keeps_order_structure_and_errors():
    data = [(np.full((2,), i, "f"), [torch.tensor([i]), "tag"])
            for i in range(5)]
    for depth in (0, 1, 3):
        got = list(PrefetchIterator(iter(data), depth=depth, device="cpu"))
        assert [float(b[0]._data[0]) for b in got] == list(range(5))
        assert isinstance(got[0][1], list) and got[0][1][1] == "tag"
        assert isinstance(got[0][1][0], nd.NDArray)

    def broken():
        yield data[0]
        raise ValueError("source broke")

    it = PrefetchIterator(broken(), depth=2, device="cpu")
    next(it)
    with pytest.raises(ValueError, match="source broke"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_close_drops_staged_batches():
    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield np.zeros(1, "f")

    with PrefetchIterator(source(), depth=2, device="cpu") as it:
        next(it)
    assert len(pulled) <= 5
    with pytest.raises(StopIteration):
        next(it)
    staged = device_put_batch({"not": "an array"}, device="cpu")
    assert staged == {"not": "an array"}


# -- callbacks -----------------------------------------------------------
class _Param:
    def __init__(self, nbatch, metric=None):
        self.nbatch, self.epoch, self.eval_metric = nbatch, 0, metric


def test_callbacks(tmp_path, caplog, capsys):
    speed = callback.Speedometer(batch_size=4, frequent=2, telemetry=True)
    metric = mx.metric.Accuracy()
    metric.update([nd.array([1.0], ctx=CPU)], [nd.array([[0.2, 0.8]],
                                                        ctx=CPU)])
    with caplog.at_level(logging.INFO):
        for n in range(5):
            speed(_Param(n, metric))
        callback.log_train_metric(1)(_Param(3, metric))
    assert any("samples/sec" in m for m in caplog.messages)
    assert "mxnet_speedometer_samples_per_sec" in \
        telemetry.render_prometheus()
    save = callback.do_checkpoint(str(tmp_path / "m"), period=2)
    w = nd.array([1.0, 2.0], ctx=CPU)
    save(0, arg={"w": w})
    assert not os.path.exists(str(tmp_path / "m-0001.params"))
    save(1, arg={"w": w}, aux={"s": w})
    loaded = nd.load(str(tmp_path / "m-0002.params"), ctx=CPU)
    assert sorted(loaded) == ["arg:w", "aux:s"]
    callback.ProgressBar(total=4, length=8)(2)
    assert "[====----] 50.0%" in capsys.readouterr().out


def test_resume_worker_needs_a_card_only_by_default():
    argv = chip_smoke.resume_worker_argv(0, "d", "l", "cpu", tiny=True)
    assert argv[1] == "-c" and "--resume-tiny" in argv
    argv = chip_smoke.resume_worker_argv(0, "d", "l")
    assert argv[1].endswith("chip_smoke.py") and "--resume-worker" in argv
    args = chip_smoke.parse_args(["--persistence"])
    assert args.persistence and not args.resume_worker


def test_telemetry_heartbeat_beats_at_step_boundaries():
    telemetry.step_begin()
    t0 = telemetry.last_heartbeat()
    telemetry.step_end()
    assert telemetry.last_heartbeat() >= t0


# -- the stall watchdog ---------------------------------------------------------
class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def test_watchdog_fake_clock_stall_matches_the_reference(tmp_path,
                                                         monkeypatch):
    import time

    from mxnet_tpu import lifecycle as rlifecycle
    from mxnet_tpu import telemetry as rtelemetry

    clock = _Clock(100.0)
    monkeypatch.setattr(time, "monotonic", clock)
    telemetry.heartbeat()
    rtelemetry.heartbeat()
    kw = dict(timeout_s=5.0, abort=False, poll_s=0.01)
    pw = lifecycle.Watchdog(dump_dir=str(tmp_path / "port"), **kw)
    rw = rlifecycle.Watchdog(dump_dir=str(tmp_path / "ref"), **kw)
    clock.t = 104.0
    assert pw.poll() is False
    clock.t = 106.0
    assert pw.poll() is True
    assert pw.poll() is False          # one fire per stall
    rw.start()
    try:
        deadline = time.perf_counter() + 5
        while rw.stall_count == 0 and time.perf_counter() < deadline:
            time.sleep(0.01)
    finally:
        rw.stop()
    assert pw.stall_count == rw.stall_count == 1
    pdoc = json.load(open(pw.last_dump))
    rdoc = json.load(open(rw.last_dump))
    assert pdoc["cause"] == rdoc["cause"] == \
        "no step heartbeat for 6.0s (deadline 5.0s)"
    assert set(pdoc) == set(rdoc)
    assert lifecycle.EXIT_STALLED == rlifecycle.EXIT_STALLED == 45
    # a new heartbeat re-arms it; the seam fires at once, heartbeat or not
    telemetry.heartbeat()
    assert pw.poll() is False
    with fault.inject("watchdog.stall"):
        assert pw.poll() is True
    assert pw.stall_count == 2


_WATCHDOG_CHILD = """
import os, sys, time
pkg = __import__(sys.argv[1], fromlist=["lifecycle", "telemetry"])
pkg.telemetry.heartbeat()
pkg.lifecycle.start_watchdog(timeout_s=0.3, poll_s=0.05,
                             dump_dir=os.environ["MXNET_FLIGHT_DIR"])
time.sleep(30)
"""


def test_watchdog_exits_45_with_the_black_box_in_both(tmp_path):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {}
    for pkg in ("mxnet_tpu_torch", "mxnet_tpu"):
        env = dict(os.environ, PYTHONPATH=repo,
                   MXNET_FLIGHT_DIR=str(tmp_path / pkg),
                   JAX_PLATFORMS="cpu")
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-c", _WATCHDOG_CHILD, pkg], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for pkg, p in procs.items():
        _, err = p.communicate(timeout=120)
        assert p.returncode == 45, (pkg, err[-2000:])
        box = json.load(open(tmp_path / pkg / "blackbox.rank0.json"))
        assert box["reason"] == "watchdog_stall"
        assert any(e.get("event") == "watchdog_stall"
                   for e in box["events"])
