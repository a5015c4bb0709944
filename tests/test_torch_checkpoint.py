"""``checkpoint.CheckpointManager`` and ``run_with_recovery`` of the port,
on the CPU.

The cases of the reference's ``tests/test_checkpoint.py`` run on the port
(round trip, retention, an uncommitted step invisible, checksums, the
bit-flip, truncation, missing-file and unreadable-meta fall-backs, every
step corrupt, the strict explicit step, ``_load_failed``, the orphan
sweep, the restart log without a logger, the budget that resets on
progress), with the async save, the three fault seams and the seven
telemetry families.  Across the packages: a checkpoint directory the
reference writes (a 2-layer BERT under LAMB and a warm-up poly schedule,
stopped mid-warm-up) is restored by the port, and the port's next step
agrees with the reference's within 1e-5 of the larger of 1 and the
value; and the reverse.
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as rmx
from mxnet_tpu.checkpoint import CheckpointManager as RefManager
from mxnet_tpu.gluon.model_zoo.language import bert as ref_bert
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, fault, gluon, nd, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager, run_with_recovery
from mxnet_tpu_torch.gluon.model_zoo.language import bert as port_bert

CPU = mx.cpu()
TOL = 1e-5
LOGGER = "mxnet_tpu_torch.checkpoint"


def _net(seed=0):
    mx.random.seed(seed)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, in_units=4, activation="relu"),
            gluon.nn.Dense(2, in_units=8))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    return net


def _trainer(net, **kw):
    return gluon.Trainer(net.collect_params(), "sgd",
                         dict({"learning_rate": 0.1}, **kw))


def _data(seed):
    r = np.random.RandomState(seed)
    x = r.randn(16, 4).astype("f")
    return x, (x.sum(1) > 0).astype("f")


def _step(net, trainer, x, y):
    lf = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = lf(net(nd.array(x, ctx=CPU)), nd.array(y, ctx=CPU))
    loss.backward()
    trainer.step(x.shape[0])
    return float(loss.mean().asscalar())


def _out(net, x):
    return net(nd.array(x, ctx=CPU)).asnumpy()


def _flip(path):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))


@pytest.fixture(autouse=True)
def _planes():
    fault.reset_stats()
    yield
    fault.reload_spec()


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_save_restore_roundtrip(tmp_path, async_):
    x, y = _data(0)
    net = _net()
    tr = _trainer(net, momentum=0.9)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.restore(net, tr) == 0
    for _ in range(3):
        _step(net, tr, x, y)
    mgr.save(3, net, tr, extra={"note": "epoch3"}, async_=async_,
             train_state={"step": 3})
    want = _out(net, x)
    _step(net, tr, x, y)     # the snapshot, not this step, is what is saved
    mgr.close()
    net2 = _net(1)
    tr2 = _trainer(net2, momentum=0.9)
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr2.restore(net2, tr2) == 3
    np.testing.assert_array_equal(_out(net2, x), want)
    assert mgr2.read_meta(3)["extra"]["note"] == "epoch3"
    assert mgr2.read_train_state(3) == {"step": 3}
    assert set(mgr2.read_meta(3)["files"]) == {
        "model.params", "trainer.states", "train_state.json"}
    # the momentum came back: the next steps match (net took one more)
    net3 = _net(2)
    tr3 = _trainer(net3, momentum=0.9)
    mgr2.restore(net3, tr3)
    assert _step(net3, tr3, x, y) == _step(net2, tr2, x, y)


def test_retention_and_latest(tmp_path):
    net = _net()
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, net)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_uncommitted_checkpoint_invisible(tmp_path):
    net = _net()
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, net)
    os.makedirs(str(tmp_path / "c" / "step_00000002"))
    open(str(tmp_path / "c" / "step_00000002" / "model.params"), "w").close()
    assert mgr.latest_step() == 1


def test_run_with_recovery_resumes_from_checkpoint(tmp_path):
    x, y = _data(1)
    mgr = CheckpointManager(str(tmp_path / "c"))
    attempts = []

    def train(start, manager):
        net = _net()
        tr = _trainer(net)
        manager.restore(net, tr)
        attempts.append(start)
        for epoch in range(start, 4):
            _step(net, tr, x, y)
            manager.save(epoch + 1, net, tr)
            if epoch == 1 and len(attempts) == 1:
                raise RuntimeError("simulated preemption")
        return "done"

    assert run_with_recovery(train, mgr, max_restarts=2,
                             backoff_ms=0) == "done"
    assert attempts == [0, 2]
    assert mgr.latest_step() == 4


def test_run_with_recovery_bounded_and_filtered(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))

    def always_fails(start, manager):
        raise RuntimeError("boom")

    with pytest.raises(MXNetError, match="without progress"):
        run_with_recovery(always_fails, mgr, max_restarts=2, backoff_ms=0)

    def fails(start, manager):
        raise ValueError("not retryable")

    with pytest.raises(ValueError):
        run_with_recovery(fails, mgr, max_restarts=5, backoff_ms=0,
                          should_retry=lambda e: not isinstance(
                              e, ValueError))
    with pytest.raises(MXNetError, match="resharding"):
        run_with_recovery(fails, mgr, resharder=lambda e: None)


def test_meta_records_per_file_checksums(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, _net())
    files = mgr.read_meta(1)["files"]
    assert len(files["model.params"]["sha256"]) == 64
    assert files["model.params"]["size"] > 0
    assert mgr.verify(1) is None


def test_bitflipped_checkpoint_falls_back_to_older_step(tmp_path):
    x, y = _data(2)
    net = _net()
    tr = _trainer(net)
    mgr = CheckpointManager(str(tmp_path / "c"))
    _step(net, tr, x, y)
    mgr.save(1, net, tr)
    want = _out(net, x)
    _step(net, tr, x, y)
    mgr.save(2, net, tr)
    _flip(os.path.join(mgr._step_dir(2), "model.params"))
    assert "sha256 mismatch" in mgr.verify(2)
    assert mgr.latest_valid_step() == 1
    net2 = _net(3)
    assert mgr.restore(net2, _trainer(net2)) == 1
    np.testing.assert_array_equal(_out(net2, x), want)


@pytest.mark.parametrize("damage", ["truncated", "missing", "meta"])
def test_damaged_checkpoint_falls_back(tmp_path, damage):
    net = _net()
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, net)
    mgr.save(2, net)
    d = mgr._step_dir(2)
    p = os.path.join(d, "model.params")
    if damage == "truncated":
        open(p, "wb").write(open(p, "rb").read()[:10])
        assert "truncated" in mgr.verify(2)
    elif damage == "missing":
        os.remove(p)
        assert "missing" in mgr.verify(2)
    else:
        with open(os.path.join(d, "meta.json"), "w") as f:
            f.write('{"step": 2, "files": {')
        assert "unreadable" in mgr.verify(2)
    assert mgr.restore(_net()) == 1


def test_every_checkpoint_corrupt_returns_zero(tmp_path, caplog):
    net = _net()
    mgr = CheckpointManager(str(tmp_path / "c"))
    for s in (1, 2):
        mgr.save(s, net)
        os.remove(os.path.join(mgr._step_dir(s), "model.params"))
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        assert mgr.restore(_net()) == 0
    assert sum("failed verification" in m for m in caplog.messages) == 2


def test_restore_explicit_step_is_strict(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    with pytest.raises(MXNetError, match="not committed"):
        mgr.restore(step=7)
    net = _net()
    mgr.save(1, net)
    mgr.save(2, net)
    os.remove(os.path.join(mgr._step_dir(2), "model.params"))
    with pytest.raises(MXNetError, match="failed verification"):
        mgr.restore(_net(), step=2)
    assert mgr.restore(_net(), step=1) == 1


def test_latest_valid_step_skips_corrupt_newest(tmp_path):
    net = _net()
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, net)
    mgr.save(2, net)
    assert mgr.latest_valid_step() == 2
    os.remove(os.path.join(mgr._step_dir(2), "model.params"))
    assert mgr.latest_step() == 2
    assert mgr.latest_valid_step() == 1
    starts = []

    def train(start, manager):
        starts.append(start)
        return "done"

    run_with_recovery(train, mgr, max_restarts=1, backoff_ms=0)
    assert starts == [1]


def test_load_failed_step_stops_advertising_as_valid(tmp_path):
    net = _net()
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, net)
    mgr.save(2, net)
    d2 = mgr._step_dir(2)
    meta = json.load(open(os.path.join(d2, "meta.json")))
    del meta["files"]          # a checkpoint written before the sums
    json.dump(meta, open(os.path.join(d2, "meta.json"), "w"))
    open(os.path.join(d2, "model.params"), "wb").write(b"torn")
    assert mgr.verify(2) is None
    assert mgr.latest_valid_step() == 2
    assert mgr.restore(_net()) == 1
    assert mgr._load_failed == {2}
    assert mgr.latest_valid_step() == 1


def test_orphaned_tmp_staging_dirs_swept_on_init(tmp_path):
    d = tmp_path / "c"
    mgr = CheckpointManager(str(d))
    mgr.save(1, _net())
    os.makedirs(str(d / ".tmp_step_2_abc"))
    open(str(d / ".tmp_step_2_abc" / "model.params"), "w").close()
    os.makedirs(str(d / ".tmp_step_3_xyz"))
    mgr2 = CheckpointManager(str(d))
    assert [n for n in os.listdir(str(d)) if n.startswith(".tmp_")] == []
    assert mgr2.latest_step() == 1


def test_recovery_logs_without_logger(tmp_path, caplog):
    mgr = CheckpointManager(str(tmp_path / "c"))

    def always_fails(start, manager):
        raise RuntimeError("boom")

    with caplog.at_level(logging.WARNING, logger=LOGGER):
        with pytest.raises(MXNetError):
            run_with_recovery(always_fails, mgr, max_restarts=1,
                              backoff_ms=0)
    assert any("restart 1/1" in m for m in caplog.messages)


def test_restart_budget_resets_on_checkpoint_progress(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    attempts = []

    def makes_progress(start, manager):
        attempts.append(start)
        if start < 4:
            manager.save(start + 1)
            raise RuntimeError("preempted")
        return "done"

    assert run_with_recovery(makes_progress, mgr, max_restarts=1,
                             backoff_ms=0) == "done"
    assert attempts == [0, 1, 2, 3, 4]
    stuck = CheckpointManager(str(tmp_path / "c2"))

    def no_progress(start, manager):
        raise RuntimeError("crash loop")

    with pytest.raises(MXNetError, match="without progress"):
        run_with_recovery(no_progress, stuck, max_restarts=2, backoff_ms=0)


@pytest.mark.parametrize("seam", ["checkpoint.write", "checkpoint.fsync",
                                  "checkpoint.publish"])
@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_fault_seams_publish_nothing(tmp_path, seam, async_):
    net = _net()
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, net)
    with fault.inject(seam):
        if async_:
            mgr.save(2, net, async_=True)     # the snapshot succeeds
            with pytest.raises(MXNetError, match="async checkpoint write"):
                mgr.close()
        else:
            with pytest.raises(OSError):
                mgr.save(2, net)
    assert fault.stats()[seam]["trips"] == 1
    assert mgr.all_steps() == [1]
    assert [n for n in os.listdir(mgr.directory)
            if n.startswith(".tmp_")] == []
    mgr.save(2, net)        # the seam is spent: the next save publishes
    assert mgr.latest_valid_step() == 2


def test_async_save_snapshots_and_joins(tmp_path):
    x, y = _data(4)
    net = _net()
    tr = _trainer(net, momentum=0.9)
    _step(net, tr, x, y)
    mgr = CheckpointManager(str(tmp_path / "c"))
    inflight = telemetry.gauge("mxnet_checkpoint_inflight")
    mgr.save(1, net, tr, async_=True)
    want = _out(net, x)
    for p in net.collect_params().values():   # changed right after
        p.set_data(torch.zeros(p.shape))
    assert mgr.latest_valid_step() == 1       # joins the write
    assert inflight.value == 0
    net2 = _net(5)
    assert mgr.restore(net2, _trainer(net2)) == 1
    np.testing.assert_array_equal(_out(net2, x), want)
    with mgr:
        mgr.save(2, net, async_=True)
    assert mgr.all_steps() == [1, 2]


def test_telemetry_families(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    names = ("mxnet_checkpoint_save_seconds",
             "mxnet_checkpoint_restore_seconds",
             "mxnet_checkpoint_saves_total",
             "mxnet_checkpoint_restores_total",
             "mxnet_recovery_restarts_total", "mxnet_checkpoint_inflight",
             "mxnet_checkpoint_snapshot_seconds")
    text0 = telemetry.render_prometheus()

    def value(text, name):
        for line in text.splitlines():
            if line.startswith(name + " ") or \
                    line.startswith(name + "_count "):
                return float(line.split()[-1])
        return 0.0

    net = _net()
    mgr.save(1, net)
    mgr.save(2, net, async_=True)
    mgr.restore(_net())

    def once(start, manager):
        if start == 2 and not once.failed:
            once.failed = True
            raise RuntimeError("once")
        return start

    once.failed = False
    run_with_recovery(once, mgr, backoff_ms=0)
    text = telemetry.render_prometheus()
    for name in names:
        assert f"# TYPE {name}" in text, name
    assert value(text, "mxnet_checkpoint_saves_total") - \
        value(text0, "mxnet_checkpoint_saves_total") == 2
    assert value(text, "mxnet_checkpoint_snapshot_seconds") - \
        value(text0, "mxnet_checkpoint_snapshot_seconds") == 1
    assert value(text, "mxnet_recovery_restarts_total") - \
        value(text0, "mxnet_recovery_restarts_total") == 1


# -- across the packages: a tiny BERT under LAMB, mid-warm-up --------------
BERT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=16, dropout=0.0)
SEQ, BATCH = 8, 2


def _bert_batch(seed):
    r = np.random.RandomState(seed)
    return (r.randint(0, 64, (BATCH, SEQ)).astype("int32"),
            r.randint(0, 64, (BATCH, SEQ)).astype("int32"),
            r.randint(0, 2, (BATCH,)).astype("int32"))


class _BertSide:
    """One package's BERT, Trainer (LAMB, warm-up PolyScheduler, weight
    decay) and recipe step.  Every multiplier stays 1: through Trainer the
    reference ignores them (ROADMAP C10)."""

    def __init__(self, pkg):
        self.ref = pkg == "reference"
        self.mx = rmx if self.ref else mx
        bert = ref_bert if self.ref else port_bert
        self.net = bert.BertForPretraining(bert.BertConfig(**BERT))
        if self.ref:
            self.net.initialize()
        else:
            self.net.initialize(ctx=CPU)
        self.net(self.array(np.zeros((1, SEQ), "int32")))
        sched = self.mx.lr_scheduler.PolyScheduler(
            max_update=50, base_lr=5e-3, pwr=1, warmup_steps=6,
            warmup_begin_lr=1e-3)
        self.trainer = self.mx.gluon.Trainer(
            self.net.collect_params(), "lamb",
            {"learning_rate": 5e-3, "wd": 0.01, "lr_scheduler": sched})

    def array(self, a):
        return self.mx.nd.array(a, dtype=a.dtype) if self.ref else \
            nd.array(a, ctx=CPU, dtype=a.dtype)

    def step(self, batch):
        ids, mlm_labels, nsp_labels = (self.array(a) for a in batch)
        ce = self.mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with self.mx.autograd.record():
            mlm, nsp = self.net(ids)
            loss = ce(mlm, mlm_labels).mean() + ce(nsp, nsp_labels).mean()
        loss.backward()
        self.trainer.step(1)
        return float(loss.asnumpy().reshape(-1)[0])

    def params(self):
        return {k: p.data().asnumpy() for k, p in
                self.net._collect_params_with_prefix().items()}

    def manager(self, directory):
        return (RefManager if self.ref else CheckpointManager)(directory)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoint_directory_crosses_packages(tmp_path, direction):
    prev = rmx.nd.set_eager_jit(False)
    try:
        src_pkg, dst_pkg = direction.split("_to_")
        src, dst = _BertSide(src_pkg), _BertSide(dst_pkg)
        src.step(_bert_batch(0))
        d = str(tmp_path / "ckpt")
        src.manager(d).save(1, src.net, src.trainer)
        assert dst.manager(d).restore(dst.net, dst.trainer) == 1
        assert dst.trainer._optimizer.num_update == 1
        lr = dst.trainer._optimizer.lr_scheduler(1)
        assert 1e-3 < lr < 5e-3          # mid-warm-up
        src_loss, dst_loss = (s.step(_bert_batch(1)) for s in (src, dst))
        assert abs(dst_loss - src_loss) <= TOL * max(1.0, abs(src_loss))
        want, got = src.params(), dst.params()
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=TOL * max(1.0, float(np.abs(want[k]).max())),
                err_msg=k)
    finally:
        rmx.nd.set_eager_jit(prev)


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_sums_hashed_as_written_equal_a_read_back(tmp_path, async_):
    """The sums in meta.json are taken from the bytes as they are written
    (no read-back); each equals the sha256 of the file read back, and the
    write and fsync seconds are recorded apart."""
    from mxnet_tpu_torch import checkpoint as ckpt_mod

    net = _net()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, net, trainer, async_=async_, train_state={"step": 1})
    mgr.close()
    meta = mgr.read_meta(1)
    assert sorted(meta["files"]) == ["model.params", "train_state.json",
                                     "trainer.states"]
    for name, want in meta["files"].items():
        path = os.path.join(str(tmp_path), "step_00000001", name)
        assert ckpt_mod._sha256(path) == want["sha256"]
        assert os.path.getsize(path) == want["size"]
    timing = mgr.last_save_timing
    assert timing["bytes"] == sum(v["size"] for v in meta["files"].values())
    assert timing["write_s"] >= 0 and timing["fsync_s"] >= 0
    assert CheckpointManager(str(tmp_path)).verify(1) is None
