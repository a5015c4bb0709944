"""The numerical-integrity guard of the port (``mxnet_tpu_torch.guard``)
against the reference's (``mxnet_tpu.guard``) on the CPU.

- The same loss and gradient series (the same net's gradients, carried
  over as numpy arrays) give the same verdict sequence and the same
  ladder of actions in both.
- ``integrity_stats`` within 1e-6 (relative): every channel on a clean
  step; on a step with a NaN the count and the loss channels, and the
  norm over the gradients without one (the port sums the clean tensors'
  squared norms, the reference zeroes only the non-finite elements).
- ``state_dict`` crosses the packages both ways and the next verdict is
  the same.
- ``attach`` skips a NaN step and rewinds from a ``CheckpointManager`` as
  the reference does (the parameters within 1e-6 of the reference's);
  ``TrainStep.run(guard=)`` escalates a persistent NaN loss to
  ``GuardRewind`` at the step the reference's ``poll_loss`` does, and
  ``run_with_recovery`` charges it to the ``rewind`` bucket.
- ``capture_train_state(guard=)`` round-trips.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as rmx
from mxnet_tpu import autograd as rautograd
from mxnet_tpu import gluon as rgluon
from mxnet_tpu import guard as rguard
from mxnet_tpu import telemetry as rtelemetry
from mxnet_tpu.checkpoint import CheckpointManager as RefManager
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, fault, gluon, guard, lifecycle, nd
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.checkpoint import CheckpointManager, run_with_recovery
from mxnet_tpu_torch.gluon import load_reference_params
from mxnet_tpu_torch.parallel import TrainStep

TOL = 1e-6
CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXNET_GUARD", "MXNET_GUARD_CHECKSUM", "MXNET_FAULT_SPEC"):
        monkeypatch.delenv(var, raising=False)
    telemetry.reset()
    fault.reload_spec()
    fault.reset_stats()
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)
    telemetry.reset()
    rtelemetry.reset()


def _nets(seed=0):
    ref = rgluon.nn.HybridSequential()
    ref.add(rgluon.nn.Dense(8, in_units=4, activation="relu"),
            rgluon.nn.Dense(2, in_units=8))
    ref.initialize(rmx.init.Xavier())
    port = gluon.nn.HybridSequential()
    port.add(gluon.nn.Dense(8, in_units=4, activation="relu"),
             gluon.nn.Dense(2, in_units=8))
    port.initialize(ctx=CPU)
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()})
    return ref, port


def _data(step):
    r = np.random.RandomState(step)
    x = r.randn(16, 4).astype("float32")
    return x, (x.sum(1) > 0).astype("float32")


def _backward(pkg_nd, pkg_ag, pkg_gluon, net, x, y, ctx=None):
    lf = pkg_gluon.loss.SoftmaxCrossEntropyLoss()
    kw = {} if ctx is None else {"ctx": ctx}
    with pkg_ag.record():
        loss = lf(net(pkg_nd.array(x, **kw)), pkg_nd.array(y, **kw))
    loss.backward()
    return loss


def _both_backward(ref, port, step):
    x, y = _data(step)
    rl = _backward(rmx.nd, rautograd, rgluon, ref, x, y)
    pl = _backward(nd, autograd, gluon, port, x, y, ctx=CPU)
    return rl, pl


def _set_grads(ref, port, grads):
    """The same gradients (numpy arrays, collect_params order) in both."""
    import jax.numpy as jnp

    for p, g in zip(ref.collect_params().values(), grads):
        p.list_grad()[0]._set(jnp.asarray(g))
    for p, g in zip(port.collect_params().values(), grads):
        p.grad()._data.copy_(torch.from_numpy(g))


def _series():
    """(gradient scale, loss, NaN?) per step: 10 clean steps, a NaN, a loss
    spike, a gradient spike, then clean again."""
    out = [(1.0, 2.0 + 0.01 * (i % 3), False) for i in range(10)]
    out += [(1.0, 2.0, True), (1.0, 50.0, False), (1e3, 2.0, False)]
    out += [(1.0, 2.01, False)] * 2
    return out


def test_verdicts_and_ladder_match_the_reference():
    ref, port = _nets()
    _both_backward(ref, port, 0)
    shapes = [p.shape for p in port.collect_params().values()]
    rg = rguard.Guard(rewind_after=2)
    pg = guard.Guard(rewind_after=2)
    # a bound manager (never used here) makes "rewind" a reachable action
    rg._manager = pg._manager = object()
    r = np.random.RandomState(5)
    seen = []
    for scale, loss, nan in _series():
        grads = [(scale * r.randn(*s)).astype("float32") for s in shapes]
        if nan:
            grads[1][0] = np.nan
        _set_grads(ref, port, grads)
        rv = rg.check(list(ref.collect_params().values()),
                      loss=rmx.nd.array(np.float32([loss])))
        pv = pg.check(list(port.collect_params().values()),
                      loss=torch.tensor([loss]))
        seen.append((pv, pg.action(pv)))
        assert (pv, seen[-1][1]) == (rv, rg.action(rv))
    verdicts = [v for v, _ in seen]
    assert verdicts[10:13] == ["nonfinite", "loss_spike", "grad_anomaly"]
    assert [a for _, a in seen][10:13] == ["skip", "rewind", "rewind"]
    _same_state(pg.state_dict(), rg.state_dict())


def _same_state(a, b):
    """Two guards' windows: the fp32 sums of the norms may differ at their
    rounding (1e-6), the rest exactly."""
    assert a["norms"] == pytest.approx(b["norms"], rel=TOL)
    assert a["losses"] == pytest.approx(b["losses"], rel=TOL)
    for key in ("recent", "calls", "agreed"):
        assert a[key] == b[key], key


def test_integrity_stats_match_within_tolerance():
    ref, port = _nets()
    rl, pl = _both_backward(ref, port, 1)
    rp = list(ref.collect_params().values())
    pp = list(port.collect_params().values())
    want = np.asarray(rguard.integrity_stats(rp, loss=rl))
    got = guard.integrity_stats(pp, loss=pl).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    # a NaN in one gradient: the count and the loss match; the norm is
    # the norm of the other gradients in both
    grads = [p.grad()._data.numpy().copy() for p in pp]
    grads[2][0, 0] = np.nan
    _set_grads(ref, port, grads)
    want = np.asarray(rguard.integrity_stats(rp, loss=rl))
    got = guard.integrity_stats(pp, loss=pl).numpy()
    assert got[0] == want[0] == 1
    np.testing.assert_allclose(got[2:], want[2:], rtol=TOL, atol=0)
    clean = [p for i, p in enumerate(rp) if i != 2]
    np.testing.assert_allclose(
        got[1], np.asarray(rguard.integrity_stats(clean))[1], rtol=TOL)
    assert guard.nonfinite_total(pp).item() == 1


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_state_dict_crosses_both_ways(direction):
    src, dst = (rguard.Guard(), guard.Guard()) \
        if direction == "reference_to_port" else \
        (guard.Guard(), rguard.Guard())
    for i in range(12):
        src._classify(0.0, 4.0 + 0.01 * i, 2.0 + 0.01 * (i % 4), 1.0)
    dst.load_state_dict(src.state_dict())
    assert dst.state_dict() == src.state_dict()
    for vec in [(0.0, 4.0, 2.0, 1.0), (0.0, 4.0, 90.0, 1.0),
                (0.0, 4e6, 2.0, 1.0)]:
        assert dst._classify(*vec) == src._classify(*vec)


def _train(pkg, net, trainer, steps, nan_at=(), ctx=None):
    """SGD steps through the attached guard, a NaN planted in the first
    weight's gradient at the steps of ``nan_at``."""
    nd_, ag, gl = (rmx.nd, rautograd, rgluon) if pkg == "ref" else \
        (nd, autograd, gluon)
    for k in range(1, steps + 1):
        x, y = _data(100 + k)
        loss = _backward(nd_, ag, gl, net, x, y, ctx)
        if k in nan_at:
            p = next(iter(net.collect_params().values()))
            if pkg == "ref":
                import jax.numpy as jnp

                g = p.list_grad()[0]
                g._set(g._get().at[0, 0].set(jnp.nan))
            else:
                p.grad()._data[0, 0] = float("nan")
        trainer._guard.observe_loss(loss.mean())
        trainer.step(16)


def _params(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def test_attach_skips_a_nan_step_as_the_reference_does():
    ref, port = _nets()
    rt = rgluon.Trainer(ref.collect_params(), "sgd",
                        {"learning_rate": 0.1})
    pt = gluon.Trainer(port.collect_params(), "sgd",
                       {"learning_rate": 0.1})
    rguard.attach(rt, rguard.Guard())
    guard.attach(pt, guard.Guard())
    _train("ref", ref, rt, 2)
    _train("port", port, pt, 2, ctx=CPU)
    before = _params(port)
    _train("ref", ref, rt, 1, nan_at=(1,))
    _train("port", port, pt, 1, nan_at=(1,), ctx=CPU)
    assert pt._guard._agreed == rt._guard._agreed == "nonfinite"
    for a, b in zip(_params(port), before):
        assert np.array_equal(a, b)          # the update was skipped
    _train("ref", ref, rt, 3)
    _train("port", port, pt, 3, ctx=CPU)
    for a, b in zip(_params(port), _params(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_attach_rewinds_from_the_manager_as_the_reference_does(tmp_path):
    ref, port = _nets()
    rt = rgluon.Trainer(ref.collect_params(), "sgd",
                        {"learning_rate": 0.1})
    pt = gluon.Trainer(port.collect_params(), "sgd",
                       {"learning_rate": 0.1})
    rm = RefManager(str(tmp_path / "ref"))
    pm = CheckpointManager(str(tmp_path / "port"))
    rguard.attach(rt, rguard.Guard(rewind_after=2), manager=rm, net=ref)
    guard.attach(pt, guard.Guard(rewind_after=2), manager=pm, net=port)
    _train("ref", ref, rt, 2)
    _train("port", port, pt, 2, ctx=CPU)
    rm.save(2, ref, rt, async_=False)
    pm.save(2, port, pt, async_=False)
    saved = _params(port)
    _train("ref", ref, rt, 1)
    _train("port", port, pt, 1, ctx=CPU)
    # a persistent fault: the first NaN step skips, the second rewinds
    _train("ref", ref, rt, 2, nan_at=(1, 2))
    _train("port", port, pt, 2, nan_at=(1, 2), ctx=CPU)
    for a, b, c in zip(_params(port), _params(ref), saved):
        assert np.array_equal(a, c)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert telemetry.goodput_summary()["buckets"].get("rewind", 0) > 0


def _tiny_step():
    net = gluon.nn.Dense(2, in_units=4)
    net.initialize(ctx=CPU)
    return TrainStep(net, lambda out, y: ((out - y) ** 2).mean(),
                     optimizer="sgd", optimizer_params={"learning_rate": 0.01},
                     device="cpu")


def test_trainstep_run_escalates_as_the_reference_poll_loss():
    step = _tiny_step()
    x = np.ones((8, 4), np.float32)
    y = np.zeros((8, 2), np.float32)
    bad = np.full((8, 4), np.nan, np.float32)
    batches = [(x, y)] * 9 + [(bad, y)] * 3
    pg = guard.Guard(rewind_after=2)
    with pytest.raises(guard.GuardRewind):
        step.run(iter(batches), guard=pg)
    assert step.step_count == 11          # the 2nd NaN step escalated
    # the reference's poll_loss on the same losses escalates at the same
    # step
    rg = rguard.Guard(rewind_after=2)
    losses = [1.0] * 9 + [float("nan")] * 3
    raised_at = None
    for k, loss in enumerate(losses, 1):
        try:
            rg.poll_loss(rmx.nd.array(np.float32([loss])), step=k)
        except rguard.GuardRewind:
            raised_at = k
            break
    assert raised_at == 11


def test_run_with_recovery_charges_a_rewind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    calls = []

    def train_fn(start, manager):
        calls.append(start)
        if len(calls) == 1:
            raise guard.GuardRewind("persistent anomaly")
        return "done"

    before = telemetry.goodput_summary()["buckets"]
    assert run_with_recovery(train_fn, mgr, backoff_ms=0) == "done"
    after = telemetry.goodput_summary()["buckets"]
    assert after.get("rewind", 0) > before.get("rewind", 0)
    assert after.get("restart", 0) == before.get("restart", 0)


def test_capture_train_state_round_trips_the_guard():
    g = guard.Guard()
    for i in range(10):
        g._classify(0.0, 1.0 + 0.1 * i, 3.0 - 0.1 * i, 1.0)
    state = lifecycle.capture_train_state(step=7, guard=g)
    assert state["guard"] == g.state_dict()
    g2 = guard.Guard()
    assert lifecycle.restore_train_state(state, guard=g2) == 7
    assert g2.state_dict() == g.state_dict()
    # the reference reads the same entry
    rg = rguard.Guard()
    rg.load_state_dict(state["guard"])
    assert rg.state_dict() == g.state_dict()


def test_checksum_stamps_and_more_than_one_process(monkeypatch):
    from mxnet_tpu_torch import flight_recorder

    flight_recorder.reset()
    monkeypatch.setenv("MXNET_GUARD_CHECKSUM", "1")
    _, port = _nets()
    pt = gluon.Trainer(port.collect_params(), "sgd", {"learning_rate": 0.1})
    x, y = _data(3)
    _backward(nd, autograd, gluon, port, x, y, ctx=CPU)
    pt.step(16)
    stamps = [e for e in flight_recorder.snapshot_doc()["events"]
              if e.get("kind") == "guard_checksum"]
    assert len(stamps) == 1 and stamps[0]["key"] == "__grad_bucket0"
    # the agreement's path on one process: the sentinel vector goes
    # through the collectives' issue site (the real two-process vote is
    # in tests/test_torch_collectives.py)
    from mxnet_tpu_torch.parallel import collectives

    collectives.reset_issued()
    assert guard.Guard(_testing_force=True).check(
        list(port.collect_params().values())) == "ok"
    assert collectives.issued() == {"allreduce": 1}


def test_amp_init_trainer_refuses_a_guarded_trainer():
    from mxnet_tpu_torch.contrib import amp

    _, port = _nets()
    pt = gluon.Trainer(port.collect_params(), "sgd", {"learning_rate": 0.1})
    guard.attach(pt)
    amp.init()
    try:
        with pytest.raises(mx.MXNetError, match="attach order"):
            amp.init_trainer(pt)
    finally:
        amp.disable()
