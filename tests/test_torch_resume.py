"""Exact resume on the CPU: ``chip_smoke.py``'s phase 10 (a)-(c) at a tiny
size, through the same functions the card runs.

- (a) ``nd.save`` / ``nd.load`` of every dtype and a 0-d array;
- (b) GluonNLP's BERT recipe under ``amp.init("float16")`` (a 2-layer
  BERT, dropout 0.1, its dynamic loss scale doubling every 2 steps): two
  uninterrupted runs U repeat bit for bit; run R, stopped by the
  ``lifecycle.sigterm`` seam at step 4 and resumed by a fresh net from
  another seed, restores exactly what was saved and repeats U's losses
  and loss scales bit for bit; the planted faults (no
  ``restore_train_state``: other dropout masks; the scale reset) fail
  the check;
- (c) a child process that gets a real SIGTERM exits 43, its relaunch
  resumes and finishes, and the joined losses and loss scales are U's,
  bit for bit.
"""
import pytest

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import fault, lifecycle
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.contrib import amp
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _planes():
    lifecycle.reset()
    fault.reset_stats()
    yield
    lifecycle.reset()
    fault.reload_spec()
    amp.disable()


def test_phase10_files_of_every_dtype():
    assert chip_smoke.persist_dtype_check(0, "cpu") > 0


@pytest.fixture(scope="module")
def resume_u():
    cfg, seq, batch = chip_smoke.resume_cfg(tiny=True)
    u = [chip_smoke.resume_u(cfg, seq, batch, 0, "cpu") for _ in range(2)]
    return u, (cfg, seq, batch)


def test_phase10_exact_resume_and_its_faults(resume_u, tmp_path):
    (u1, u2), (cfg, seq, batch) = resume_u
    allowed, gap = chip_smoke.resume_rule(u1["losses"], u2["losses"])
    assert gap == 0 and allowed == 0           # the CPU repeats bit for bit
    assert len(set(u1["scales"].values())) > 2  # the scale moves in the run
    r = chip_smoke.resume_r(cfg, seq, batch, 0, "cpu",
                            str(tmp_path / "ck"))
    assert chip_smoke.snapshot_mismatch(r["restored"], r["saved"]) is None
    worst, bad, same = chip_smoke.resume_verdict(r, u1, allowed)
    assert worst == 0 and not bad and same
    assert r["num_update"] == u1["num_update"]
    for planted in ("no_train_state", "scale_reset"):
        f = chip_smoke.resume_r(cfg, seq, batch, 0, "cpu",
                                str(tmp_path / "ck"), fault=planted,
                                first=r["first"])
        _, fbad, fsame = chip_smoke.resume_verdict(f, u1, allowed)
        assert fbad or not fsame, planted
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.all_steps() == [2, 4]


def test_phase10_real_sigterm_resumes_exactly(resume_u, tmp_path):
    (u1, _), _ = resume_u
    joined, stopped, launches = chip_smoke.resume_sigterm_run(
        0, str(tmp_path), "cpu", tiny=True)
    assert chip_smoke.RESUME_SIGTERM_AFTER <= stopped < \
        chip_smoke.RESUME_STEPS
    worst, bad, same = chip_smoke.resume_verdict(joined, u1, 0.0)
    assert worst == 0 and not bad and same
    assert launches == 0                       # no kernel on the CPU


def test_phase10_checks_catch_a_lost_generator_state(resume_u):
    """The rule itself: a run whose dropout masks differ from U's (the
    generator seeded anew) differs from the first step."""
    (u1, _), (cfg, seq, batch) = resume_u
    amp.init("float16")
    try:
        net, trainer = chip_smoke.resume_build(cfg, seq, 0, "cpu")
        mx.random.seed(5)
        rec = chip_smoke.resume_train(net, trainer, None, 0, 1, 0, cfg, seq,
                                      batch, "cpu")
    finally:
        amp.disable()
    assert rec["losses"][1] != u1["losses"][1]


def test_phase10_faults_resumed_from_the_host_copy(resume_u, tmp_path):
    """The whole script resumes (b)'s planted faults from the first
    restore's host copy instead of the files: that resume is R's bit for
    bit, and both faults still fail the rule."""
    (u1, _), (cfg, seq, batch) = resume_u
    r = chip_smoke.resume_r(cfg, seq, batch, 0, "cpu", str(tmp_path / "ck"))
    again = chip_smoke.resume_r(cfg, seq, batch, 0, "cpu",
                                str(tmp_path / "ck"), first=r["first"],
                                host=r["host"])
    assert chip_smoke.snapshot_mismatch(again["restored"],
                                        r["restored"]) is None
    assert again["losses"] == r["losses"]
    for planted in ("no_train_state", "scale_reset"):
        f = chip_smoke.resume_r(cfg, seq, batch, 0, "cpu",
                                str(tmp_path / "ck"), fault=planted,
                                first=r["first"], host=r["host"])
        _, fbad, fsame = chip_smoke.resume_verdict(f, u1, 0.0)
        assert fbad or not fsame, planted
