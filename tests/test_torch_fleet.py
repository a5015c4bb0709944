"""The port's serving fleet (``mxnet_tpu_torch.serving.fleet``) held against
the reference's (``mxnet_tpu.serving.fleet``) on the CPU.

Host-only layers (health state machine, monitor, fair-share queue, hedging,
rendezvous affinity, shedding, autoscaler, idempotency ledger, the router
over fake replicas, the spawn seam, the lifecycle hooks, the router's HTTP
front door) run the same scenario on both packages, parametrised, with the
same asserted states, orders, counts and status codes; scripted sequences
and hypothesis-drawn prompts are also run through both and compared
outright.  The chaos tests inject at deterministic points (the reference's
own exhaustion test races its 20 ms monitor; the port's counterpart
freezes the monitor).

Real engines: ``llama_tiny`` on the CPU with the reference's weights
(``load_reference_params``).  A two-replica fleet whose second replica is
``ServingEngine.join_replica`` of the first gives the reference engine's
greedy token ids (the near-tie rule of ``test_torch_serving.py``); the
joiner shares the donor's storage; a crash resolves every request exactly
once; the manager reaps a crashed replica and heals through
``join_replica``; ``serve_fleet`` returns 43 after ``request_stop``; and a
process-mode fleet of CPU children survives a SIGKILL.
"""
import ast
import gc
import json
import os
import pathlib
import signal
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mxnet_tpu import env as ref_env
from mxnet_tpu import fault as ref_fault
from mxnet_tpu import flight_recorder as ref_flight
from mxnet_tpu import lifecycle as ref_lifecycle
from mxnet_tpu import nd
from mxnet_tpu import serving as ref_serving
from mxnet_tpu import telemetry as ref_telemetry
from mxnet_tpu.gluon.model_zoo.language import llama as ref_llama
from mxnet_tpu.serving import fleet as ref_fleet
from mxnet_tpu.serving.scheduler import QueueFullError as RefQueueFullError
from mxnet_tpu_torch import env as port_env
from mxnet_tpu_torch import fault as port_fault
from mxnet_tpu_torch import flight_recorder as port_flight
from mxnet_tpu_torch import lifecycle as port_lifecycle
from mxnet_tpu_torch import telemetry as port_telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.language import llama as port_llama
from mxnet_tpu_torch.serving import ServingEngine
from mxnet_tpu_torch.serving import fleet as port_fleet
from mxnet_tpu_torch.serving.fleet import health as port_health
from mxnet_tpu_torch.serving.scheduler import QueueFullError as PortQueueFull
from test_torch_serving import assert_greedy_match, full_logits

REPO = pathlib.Path(__file__).resolve().parents[1]
ENGINE_KW = dict(batch_buckets=[1, 2], prefill_buckets=[8, 16],
                 kv_pages=32, page_size=8, max_batch=2)
TIMEOUT = 120          # seconds, every wait on a real engine

PKGS = {
    "reference": SimpleNamespace(
        fleet=ref_fleet, fault=ref_fault, lifecycle=ref_lifecycle,
        telemetry=ref_telemetry, env=ref_env, flight=ref_flight,
        QueueFullError=RefQueueFullError),
    "port": SimpleNamespace(
        fleet=port_fleet, fault=port_fault, lifecycle=port_lifecycle,
        telemetry=port_telemetry, env=port_env, flight=port_flight,
        QueueFullError=PortQueueFull),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# -- fakes --------------------------------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


_FAKES = {}


def fake_replica(pkg, rid, body=None, **kw):
    """A replica of ``pkg``'s ReplicaHandle with a programmable body; its
    transport goes through the package's funnel, so the router.dispatch
    and router.health_probe seams are live as in production."""
    cls = _FAKES.get(id(pkg))
    if cls is None:
        fleet = pkg.fleet

        class FakeReplica(fleet.ReplicaHandle):
            def __init__(self, rid, body=None, **kw):
                super().__init__(rid, **kw)
                self._up = True
                self.served = []

                def default_body(freq):
                    return {"rid": self.rid, "request_id": freq.id,
                            "token_ids": [1, 2], "finish_reason": "length"}

                self._body = body or default_body

            def alive(self):
                return self._up

            def kill(self):
                self._up = False

            def probe(self):
                return fleet.call_local(self._probe_body,
                                        deadline=time.monotonic() + 1.0,
                                        seam="router.health_probe")

            def _probe_body(self):
                if not self._up:
                    raise ConnectionError(f"{self.rid} is down")
                return {"queue_depth": 0, "ttft_s": {"p99": 0.001}}

            def submit(self, freq, retries=0):
                return fleet.call_local(self._submit_body, freq,
                                        deadline=freq.deadline,
                                        seam="router.dispatch",
                                        retries=retries)

            def _submit_body(self, freq):
                if not self._up:
                    raise ConnectionError(f"{self.rid} is down")
                res = self._body(freq)
                self.served.append(freq.id)
                return res

            def shutdown(self, drain=True, timeout=30):
                self._up = False

        cls = _FAKES[id(pkg)] = FakeReplica
    return cls(rid, body=body, **kw)


def mk_router(pkg, replicas, **kw):
    kw.setdefault("hedge_ms", 10_000)      # no hedging unless asked
    kw.setdefault("retry_budget", 0)
    kw.setdefault("probe_interval_ms", 20)
    kw.setdefault("trace_requests", True)
    return pkg.fleet.Router(replicas=replicas, **kw)


def home_and_other(pkg, prompt, ids=("r1", "r2")):
    order = pkg.fleet.rendezvous_order(pkg.fleet.prefix_key(prompt),
                                       sorted(ids))
    return order[0], order[1]


# -- health state machine -----------------------------------------------------
def test_health_ejects_after_threshold_then_halfopen_recovers(pkg):
    f = pkg.fleet
    clk = FakeClock()
    h = f.ReplicaHealth(eject_threshold=3, cooldown_s=1.0, probe_budget=2,
                        probe_successes=2, clock=clk)
    assert h.state == f.HEALTHY
    h.note_failure()
    assert h.state == f.SUSPECT
    h.note_failure()
    h.note_failure()
    assert h.state == f.EJECTED and not h.dispatchable()
    clk.advance(0.5)
    h.tick()
    assert h.state == f.EJECTED
    clk.advance(0.6)
    h.tick()
    assert h.state == f.PROBING
    assert h.try_acquire_probe() and h.try_acquire_probe()
    assert not h.try_acquire_probe()
    h.release_probe()
    assert h.try_acquire_probe()
    h.note_success()
    assert h.state == f.PROBING
    h.note_success()
    assert h.state == f.HEALTHY and h.ejections == 0
    assert h.try_acquire_probe()


def test_health_probe_failure_reejects_with_doubled_cooldown(pkg):
    f = pkg.fleet
    clk = FakeClock()
    h = f.ReplicaHealth(eject_threshold=1, cooldown_s=1.0, clock=clk)
    h.note_failure()
    assert h.state == f.EJECTED and h.cooldown_s() == 1.0
    clk.advance(1.1)
    h.tick()
    assert h.state == f.PROBING
    h.note_failure()
    assert h.state == f.EJECTED and h.cooldown_s() == 2.0
    clk.advance(1.5)
    h.tick()
    assert h.state == f.EJECTED
    clk.advance(1.0)
    h.tick()
    assert h.state == f.PROBING


def test_health_suspect_is_soft(pkg):
    f = pkg.fleet
    h = f.ReplicaHealth()
    h.note_suspect("queue depth 40")
    assert h.state == f.SUSPECT and h.consecutive_failures == 0
    assert h.dispatchable()
    h.note_success()
    assert h.state == f.HEALTHY


def _health_script(pkg, seed):
    """A random sequence of health signals on an injected clock: every
    transition and snapshot along the way."""
    rng = np.random.RandomState(seed)
    clk = FakeClock()
    h = pkg.fleet.ReplicaHealth(eject_threshold=3, cooldown_s=0.5,
                                max_cooldown_s=4.0, probe_budget=2,
                                probe_successes=2, clock=clk)
    seen = []
    for _ in range(300):
        op = rng.randint(8)
        if op == 0:
            h.note_failure(reason="x")
        elif op == 1:
            h.note_success()
        elif op == 2:
            h.note_suspect("gauge")
        elif op == 3:
            clk.advance(float(rng.uniform(0.0, 1.5)))
            h.tick()
        elif op == 4:
            seen.append(("acquire", h.try_acquire_probe()))
        elif op == 5:
            h.release_probe()
        elif op == 6:
            h.note_heartbeat(queue_depth=int(rng.randint(50)),
                             ttft_p99=float(rng.uniform()))
        else:
            seen.append(("dispatchable", h.dispatchable()))
        seen.append(h.snapshot())
    return seen, list(h.transitions)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_script_matches_reference(seed):
    assert _health_script(PKGS["port"], seed) == \
        _health_script(PKGS["reference"], seed)


def test_monitor_detects_dead_replica_and_fires_once(pkg):
    r = fake_replica(pkg, "r1")
    dead = []
    mon = pkg.fleet.HealthMonitor(lambda: [r], on_dead=dead.append)
    mon.poll_once()
    assert r.health.state == pkg.fleet.HEALTHY and dead == []
    r.kill()
    mon.poll_once()
    mon.poll_once()
    assert dead == [r]
    assert r.health.consecutive_failures >= 2


def test_monitor_heartbeat_gauges_mark_overload_suspect(pkg):
    r = fake_replica(pkg, "r1")
    r._probe_body = lambda: {"queue_depth": 99, "ttft_s": {"p99": 0.5}}
    mon = pkg.fleet.HealthMonitor(lambda: [r], suspect_queue_depth=32)
    mon.poll_once()
    assert r.health.state == pkg.fleet.SUSPECT
    assert r.health.queue_depth == 99 and r.health.ttft_p99 == 0.5


def test_chaos_health_probe_seam_counts_as_failure(pkg):
    r = fake_replica(pkg, "r1")
    mon = pkg.fleet.HealthMonitor(lambda: [r], on_dead=lambda _: None)
    with pkg.fault.inject("router.health_probe", error=ConnectionError,
                          times=2):
        mon.poll_once()
        mon.poll_once()
    assert r.health.consecutive_failures == 2
    assert r.health.state == pkg.fleet.SUSPECT
    mon.poll_once()
    assert r.health.state == pkg.fleet.HEALTHY


# -- policy -------------------------------------------------------------------
def test_fair_share_interleaves_tenants(pkg):
    q = pkg.fleet.FairShareQueue(bound=64, tenant_bound=32)
    for i in range(6):
        q.put(("a", i), tenant="a")
    for i in range(2):
        q.put(("b", i), tenant="b")
    order = [q.pop_ready() for _ in range(8)]
    assert {t for t, _ in order[:4]} == {"a", "b"}
    assert order.count(("b", 0)) == 1 and len(q) == 0


def test_fair_share_bounds_and_requeue_exemption(pkg):
    q = pkg.fleet.FairShareQueue(bound=3, tenant_bound=2)
    q.put(1, tenant="a")
    q.put(2, tenant="a")
    with pytest.raises(pkg.QueueFullError):
        q.put(3, tenant="a")
    q.put(4, tenant="b")
    with pytest.raises(pkg.QueueFullError):
        q.put(5, tenant="b")
    q.requeue(6, tenant="b")
    assert len(q) == 4


def test_fair_share_pop_ready_expires_outside_lock(pkg):
    q = pkg.fleet.FairShareQueue()
    q.put("dead", tenant="a")
    q.put("live", tenant="a")
    expired = []
    got = q.pop_ready(is_expired=lambda r: r == "dead",
                      on_expire=expired.append)
    assert got == "live" and expired == ["dead"]


def _queue_script(pkg, seed):
    """Weighted tenants, puts, requeues and pops from a seed: the pop
    order, depths and every rejected put."""
    rng = np.random.RandomState(seed)
    q = pkg.fleet.FairShareQueue(bound=24, tenant_bound=9,
                                 weights={"t0": 2, "t2": 3})
    seen = []
    for i in range(400):
        op = rng.randint(6)
        tenant = f"t{rng.randint(4)}"
        if op < 3:
            try:
                q.put(i, tenant=tenant)
            except pkg.QueueFullError as e:
                seen.append(("full", str(e)))
        elif op == 3:
            q.requeue(-i, tenant=tenant)
        else:
            seen.append(q.pop_ready(is_expired=lambda r: r % 7 == 3,
                                    on_expire=lambda r: seen.append(
                                        ("expired", r))))
        seen.append(q.depths())
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_fair_share_order_matches_reference(seed):
    assert _queue_script(PKGS["port"], seed) == \
        _queue_script(PKGS["reference"], seed)


def test_hedge_policy_floor_then_p99(pkg):
    hp = pkg.fleet.HedgePolicy(floor_ms=50, min_samples=4)
    assert hp.delay_s() == 0.05
    for _ in range(10):
        hp.observe(0.2)
    assert hp.delay_s() == pytest.approx(0.2)
    hp2 = pkg.fleet.HedgePolicy(floor_ms=500, min_samples=4)
    for _ in range(10):
        hp2.observe(0.01)
    assert hp2.delay_s() == 0.5


def test_hedge_delays_match_reference():
    rng = np.random.RandomState(3)
    lats = rng.lognormal(-3, 1, 700)
    out = {}
    for name, p in PKGS.items():
        hp = p.fleet.HedgePolicy(floor_ms=20, window=256, min_samples=16)
        out[name] = []
        for x in lats:
            hp.observe(float(x))
            out[name].append(hp.delay_s())
    assert out["port"] == out["reference"]


def test_rendezvous_fallback_is_stable_under_removal(pkg):
    f = pkg.fleet
    ids = ["r1", "r2", "r3", "r4"]
    key = f.prefix_key([5, 6, 7])
    order = f.rendezvous_order(key, ids)
    survivors = [r for r in ids if r != order[0]]
    assert f.rendezvous_order(key, survivors) == order[1:]
    assert f.prefix_key(list(range(16)) + [99]) == \
        f.prefix_key(list(range(16)) + [42])
    assert f.prefix_key([1, 2]) != f.prefix_key([2, 1])


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=40),
       st.integers(1, 24),
       st.lists(st.text(min_size=1, max_size=12), min_size=1, max_size=8,
                unique=True))
def test_prefix_key_and_rendezvous_match_reference_bit_for_bit(tokens, k,
                                                              rids):
    key = port_fleet.prefix_key(tokens, k=k)
    assert key == ref_fleet.prefix_key(tokens, k=k)
    assert key == port_fleet.prefix_key(np.asarray(tokens, np.int64), k=k)
    assert port_fleet.rendezvous_order(key, rids) == \
        ref_fleet.rendezvous_order(key, rids)


def test_shedding_policy_retry_after_tracks_drain_rate(pkg):
    clk = FakeClock()
    sp = pkg.fleet.SheddingPolicy(slo_depth=4, clock=clk)
    assert not sp.should_shed(3) and sp.should_shed(4)
    assert sp.retry_after_s(8) == 1.0
    for _ in range(11):
        sp.note_completion()
        clk.advance(0.5)
    assert sp.retry_after_s(8) == pytest.approx(4.0)
    assert sp.retry_after_s(1000) == 30.0


def test_autoscaler_debounce_and_idle_scale_down(pkg):
    clk = FakeClock()
    ups, downs = [], []
    a = pkg.fleet.Autoscaler(scale_up=ups.append, scale_down=downs.append,
                             min_replicas=1, max_replicas=3,
                             replica_count=lambda: 2, cooldown_s=5.0,
                             idle_ticks=3, clock=clk)
    assert a.note_queue_breach(50)
    assert not a.note_queue_breach(60)
    clk.advance(6)
    assert a.note_goodput_breach(0.80, 0.95, 3)
    assert len(ups) == 2 and not downs
    clk.advance(6)
    for _ in range(3):
        a.note_tick(queue_depth=0)
    assert downs and "idle" in downs[0]
    a2 = pkg.fleet.Autoscaler(scale_up=ups.append, replica_count=lambda: 3,
                              max_replicas=3, clock=clk)
    assert not a2.note_queue_breach(9)


def _autoscaler_script(pkg, seed):
    rng = np.random.RandomState(seed)
    clk = FakeClock()
    count = [2]
    hooks = []

    def up(reason):
        count[0] += 1
        hooks.append(("up", reason))

    def down(reason):
        count[0] -= 1
        hooks.append(("down", reason))

    a = pkg.fleet.Autoscaler(scale_up=up, scale_down=down, min_replicas=1,
                             max_replicas=4, replica_count=lambda: count[0],
                             cooldown_s=2.0, idle_ticks=4, clock=clk)
    for _ in range(300):
        op = rng.randint(4)
        clk.advance(float(rng.uniform(0, 0.8)))
        if op == 0:
            hooks.append(a.note_queue_breach(int(rng.randint(100))))
        elif op == 1:
            hooks.append(a.note_goodput_breach(0.5, 0.9, 3))
        else:
            hooks.append(a.note_tick(int(rng.randint(2))))
    return hooks, list(a.actions)


def test_autoscaler_actions_match_reference():
    assert _autoscaler_script(PKGS["port"], 5) == \
        _autoscaler_script(PKGS["reference"], 5)


def test_idempotency_ledger_first_claim_wins(pkg):
    led = pkg.fleet.IdempotencyLedger(cap=4)
    assert led.claim(1)
    assert not led.claim(1)
    assert led.stats()["duplicates_suppressed"] == 1
    for rid in range(2, 8):
        assert led.claim(rid)
    assert led.stats()["claimed"] <= 4


# -- router on fake replicas --------------------------------------------------
def test_router_round_trip_and_trace_tree(pkg):
    r1 = fake_replica(pkg, "r1")
    router = mk_router(pkg, [r1]).start()
    try:
        req = router.submit([1, 2, 3], max_new_tokens=4, deadline_ms=10_000)
        res = req.response(timeout=10)
        assert res["rid"] == "r1"
        tree = req.trace.to_dict()
        names = [s["name"] for s in tree["tree"]["children"]]
        assert "queue_wait" in names and "dispatch" in names
        assert tree["trace_id"] == req.id
    finally:
        router.close()


def test_hedge_dedup_delivers_exactly_one_completion(pkg):
    release = threading.Event()

    def slow_body(freq):
        release.wait(5)
        return {"rid": "slow", "request_id": freq.id}

    prompt = [7, 8, 9]
    home, other = home_and_other(pkg, prompt)
    reps = {home: fake_replica(pkg, home, body=slow_body),
            other: fake_replica(pkg, other)}
    router = mk_router(pkg, [reps["r1"], reps["r2"]], hedge_ms=30).start()
    try:
        req = router.submit(prompt, deadline_ms=10_000)
        res = req.response(timeout=10)
        assert res["rid"] == other and req.hedges == 1
        release.set()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and \
                router._ledger.stats()["duplicates_suppressed"] < 1:
            time.sleep(0.01)
        assert router._ledger.stats()["duplicates_suppressed"] == 1
        assert req.result["rid"] == other
        events = [e["name"] for e in req.trace.to_dict()["events"]]
        assert "hedged" in events
    finally:
        release.set()
        router.close()


def test_hedge_not_sent_when_primary_is_fast(pkg):
    r1, r2 = fake_replica(pkg, "r1"), fake_replica(pkg, "r2")
    router = mk_router(pkg, [r1, r2], hedge_ms=2_000).start()
    try:
        for _ in range(4):
            req = router.submit([3, 1, 4], deadline_ms=10_000)
            req.response(timeout=10)
            assert req.hedges == 0
        assert len(r1.served) + len(r2.served) == 4
    finally:
        router.close()


def test_crash_resubmit_exactly_once_on_fakes(pkg):
    started = threading.Event()
    prompt = [2, 7, 1]
    home, other = home_and_other(pkg, prompt)

    def dying_body(freq):
        started.set()
        reps[home]._up = False
        raise ConnectionError("killed mid-request")

    reps = {home: fake_replica(pkg, home, body=dying_body),
            other: fake_replica(pkg, other)}
    router = mk_router(pkg, [reps["r1"], reps["r2"]]).start()
    try:
        req = router.submit(prompt, deadline_ms=10_000)
        assert started.wait(5)
        res = req.response(timeout=10)
        assert res["rid"] == other
        assert reps[other].served == [req.id]
        assert req.attempts >= 2
        assert router._ledger.stats()["duplicates_suppressed"] == 0
    finally:
        router.close()


def test_prefix_affinity_routes_home_then_falls_back_on_ejection(pkg):
    reps = [fake_replica(pkg, r) for r in ("r1", "r2", "r3")]
    by_id = {r.rid: r for r in reps}
    prompt = [11, 12, 13]
    order = pkg.fleet.rendezvous_order(pkg.fleet.prefix_key(prompt),
                                       sorted(by_id))
    router = mk_router(pkg, reps).start()
    try:
        for _ in range(3):
            req = router.submit(prompt, deadline_ms=10_000)
            assert req.response(timeout=10)["rid"] == order[0]
        for _ in range(3):
            by_id[order[0]].health.note_failure()
        assert by_id[order[0]].health.state == pkg.fleet.EJECTED
        req = router.submit(prompt, deadline_ms=10_000)
        assert req.response(timeout=10)["rid"] == order[1]
    finally:
        router.close()


def test_shedding_429_with_retry_after(pkg):
    router = mk_router(pkg, [fake_replica(pkg, "r1")], shed_depth=2)
    router.submit([1], deadline_ms=10_000)
    router.submit([2], deadline_ms=10_000)
    with pytest.raises(pkg.fleet.FleetBusyError) as ei:
        router.submit([3], deadline_ms=10_000)
    assert ei.value.retry_after_s >= 1.0
    assert isinstance(ei.value, pkg.QueueFullError)


def test_chaos_dispatch_seam_transient_is_retried(pkg):
    r1 = fake_replica(pkg, "r1")
    router = mk_router(pkg, [r1], retry_budget=2).start()
    try:
        before = pkg.fault.stats()["router.dispatch"]["trips"]
        with pkg.fault.inject("router.dispatch", error=OSError, times=1):
            req = router.submit([5, 5], deadline_ms=10_000)
            res = req.response(timeout=10)
        assert res["rid"] == "r1"
        assert pkg.fault.stats()["router.dispatch"]["trips"] == before + 1
        assert req.attempts == 1
    finally:
        router.close()


def test_chaos_dispatch_seam_exhaustion_fails_over(pkg):
    """A trip past the retry budget exhausts the attempt and the failover
    requeue hands the request to the other replica.  The monitor never
    sweeps during the test (its first sweep is 10 minutes away), so no
    probe can heal the home replica before the failover picks its peer:
    the outcome is decided by the dispatch path alone."""
    prompt = [9, 9, 1]
    home, other = home_and_other(pkg, prompt)
    reps = {r: fake_replica(pkg, r) for r in ("r1", "r2")}
    router = mk_router(pkg, [reps["r1"], reps["r2"]], retry_budget=0,
                       dispatchers=2, probe_interval_ms=600_000).start()
    try:
        with pkg.fault.inject("router.dispatch", error=ConnectionError,
                              times=1):
            req = router.submit(prompt, deadline_ms=10_000)
            res = req.response(timeout=10)
        assert res["rid"] == other and req.attempts == 2
        assert reps[home].health.consecutive_failures == 1
        assert reps[home].health.state == pkg.fleet.SUSPECT
        assert reps[other].served == [req.id] and reps[home].served == []
        assert router._ledger.stats()["duplicates_suppressed"] == 0
    finally:
        router.close()


class StubEngine:
    def __init__(self):
        self.closed = 0

    def running(self):
        return not self.closed

    def close(self, drain=True, timeout=0):
        self.closed += 1

    def stats(self):
        return {"queue_depth": 0, "ttft_s": {"p99": None}}


def test_chaos_spawn_seam_retries_then_fleet_heals(pkg):
    calls = []

    def factory(rid, donor):
        calls.append(rid)
        return StubEngine()

    mgr = pkg.fleet.FleetManager(engine_factory=factory, replicas=2,
                                 probe_interval_ms=20)
    router = mk_router(pkg, [])
    mgr.attach_router(router)
    before = pkg.fault.stats()["fleet.spawn"]["trips"]
    with pkg.fault.inject("fleet.spawn", error=OSError, times=1):
        mgr.ensure(2)
    assert len(router.replicas()) == 2
    assert pkg.fault.stats()["fleet.spawn"]["trips"] == before + 1
    assert len(calls) == 2
    assert [r.rid for r in router.replicas()] == ["replica-1", "replica-2"]
    assert [k for _, k, _ in mgr.spawn_times] == ["initial", "initial"]


def test_fleet_knobs_register_and_describe(pkg, monkeypatch):
    e = pkg.env
    assert (e.fleet_replicas(), e.fleet_hedge_ms(), e.fleet_retry_budget(),
            e.fleet_probe_interval_ms(), e.fleet_eject_threshold()) == \
        (2, 50, 2, 250, 3)
    monkeypatch.setenv("MXNET_FLEET_PROBE_INTERVAL_MS", "3")
    monkeypatch.setenv("MXNET_FLEET_REPLICAS", "0")
    monkeypatch.setenv("MXNET_FLEET_HEDGE_MS", "-5")
    assert (e.fleet_probe_interval_ms(), e.fleet_replicas(),
            e.fleet_hedge_ms()) == (10, 1, 0)
    text = e.describe()
    for knob in ("MXNET_FLEET_REPLICAS", "MXNET_FLEET_HEDGE_MS",
                 "MXNET_FLEET_RETRY_BUDGET", "MXNET_FLEET_PROBE_INTERVAL_MS",
                 "MXNET_FLEET_EJECT_THRESHOLD"):
        assert knob in text


def test_fleet_seams_registered(pkg):
    for seam in ("router.dispatch", "router.health_probe", "fleet.spawn",
                 "replica.crash"):
        assert seam in pkg.fault.SEAMS


def test_fleet_exports_the_reference_names():
    assert port_fleet.__all__ == ref_fleet.__all__
    for name in port_fleet.__all__:
        assert hasattr(port_fleet, name), name


_FLEET_MODULES = ("transport", "health", "policy", "router", "manager")


@pytest.mark.parametrize("module", _FLEET_MODULES)
def test_fleet_modules_import_no_tensor_library(module):
    path = pathlib.Path(port_fleet.__file__).parent / f"{module}.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not {"torch", "jax", "numpy"} & set(roots), \
            (path.name, node.lineno)


# -- the lifecycle hooks the fleet calls --------------------------------------
def test_goodput_breach_hooks(pkg):
    lc = pkg.lifecycle
    seen = []

    def hook(ratio, slo, windows):
        seen.append((ratio, slo, windows))

    def bad(ratio, slo, windows):
        raise RuntimeError("observer failed")

    try:
        assert lc.register_goodput_breach_hook(hook) is hook
        lc.register_goodput_breach_hook(hook)       # idempotent
        lc.register_goodput_breach_hook(bad)
        lc.note_goodput_slo_breach(0.5, 0.9, 3)     # bad is logged, skipped
        assert seen == [(0.5, 0.9, 3)]
        lc.unregister_goodput_breach_hook(hook)
        lc.unregister_goodput_breach_hook(hook)     # idempotent
        lc.note_goodput_slo_breach(0.4, 0.9, 4)
        assert seen == [(0.5, 0.9, 3)]
    finally:
        lc.unregister_goodput_breach_hook(hook)
        lc.unregister_goodput_breach_hook(bad)


def test_fleet_queue_slo_breach_is_recorded_not_a_stop(pkg):
    pkg.flight.configure(enabled=True, capacity=64)
    try:
        pkg.lifecycle.note_fleet_queue_slo_breach(40, 32, 1)
        ev = pkg.flight.snapshot_doc()["events"][-1]
        assert {k: ev[k] for k in ("kind", "event", "depth", "threshold",
                                   "shed")} == {
            "kind": "lifecycle", "event": "fleet_queue_slo_breach",
            "depth": 40, "threshold": 32, "shed": 1}
        assert not pkg.lifecycle.stop_requested()
    finally:
        pkg.flight.reset()


def test_router_autoscaler_rides_the_goodput_hook(pkg):
    ups = []
    scaler = pkg.fleet.Autoscaler(scale_up=ups.append, max_replicas=4,
                                  replica_count=lambda: 1, cooldown_s=0.0)
    router = mk_router(pkg, [fake_replica(pkg, "r1")], autoscale=scaler)
    router.start()
    try:
        pkg.lifecycle.note_goodput_slo_breach(0.5, 0.9, 3)
        assert len(ups) == 1 and "goodput" in ups[0]
    finally:
        router.close()
    pkg.lifecycle.note_goodput_slo_breach(0.5, 0.9, 3)   # unhooked by close
    assert len(ups) == 1


# -- the router's HTTP front door ---------------------------------------------
def _http(port, method, path, body=None, raw=None):
    """(status, JSON body or text, Retry-After header) of one call."""
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            status, text, hdr = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        status, text, hdr = e.code, e.read(), e.headers
    try:
        doc = json.loads(text)
    except ValueError:
        doc = text.decode()
    return status, doc, hdr.get("Retry-After")


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def _wait_until(cond, what, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _front_door_session(pkg):
    """The same calls against ``pkg``'s router front door on fake replicas:
    {call: (status, keys of the JSON body, Retry-After)}."""
    tel = pkg.telemetry
    port = tel.start_http_server(0).server_address[1]
    out = {}

    def call(name, *args, **kw):
        status, doc, ra = _http(port, *args, **kw)
        out[name] = (status, sorted(_keys(doc)) if isinstance(doc, dict)
                     else doc, ra)
        return doc

    try:
        router = mk_router(pkg, [fake_replica(pkg, "r1")]).start()
        router.mount_http()
        try:
            doc = call("ok", "POST", "/v1/completions",
                       {"prompt": [1, 2, 3], "max_new_tokens": 4,
                        "deadline_ms": 10_000})
            assert doc["token_ids"] == [1, 2] and doc["fleet"]["attempts"] == 1
            call("get_completions", "GET", "/v1/completions")
            call("bad_json", "POST", "/v1/completions", raw=b"{not json")
            call("no_prompt", "POST", "/v1/completions",
                 {"max_new_tokens": 4})
            call("empty_prompt", "POST", "/v1/completions", {"prompt": []})
            fdoc = call("fleet", "GET", "/v1/fleet")
            assert fdoc["replicas"][0]["health"]["state"] == pkg.fleet.HEALTHY
            rdoc = call("requests", "GET", "/v1/requests")
            assert rdoc["enabled"] and rdoc["traced_requests"] == 1
        finally:
            router.close()
        # an unstarted router: the queue only grows.  The first request
        # waits; at the SLO depth of 1 the second is shed; closing the
        # router drains the first with a shutdown error
        router = mk_router(pkg, [fake_replica(pkg, "r2")], shed_depth=1)
        router.mount_http()
        box = {}
        waiter = threading.Thread(target=lambda: box.update(doc=_http(
            port, "POST", "/v1/completions", {"prompt": [4, 5]})))
        waiter.start()
        try:
            _wait_until(lambda: len(router._queue) == 1, "the queued request")
            call("shed", "POST", "/v1/completions", {"prompt": [6]})
        finally:
            router.close()
            waiter.join(TIMEOUT)
        status, doc, ra = box["doc"]
        out["closed"] = (status, sorted(_keys(doc)) if isinstance(doc, dict)
                         else doc, ra)
    finally:
        tel.stop_http_server()
    return out


def test_router_front_door_matches_reference():
    ref = _front_door_session(PKGS["reference"])
    port = _front_door_session(PKGS["port"])
    # a request drained by the router's close: the reference's queue
    # resolves it with the error in the result's place, so its route fails
    # to encode the answer (500); the port answers 503 with the error
    assert port.pop("closed") == (503, ["error"], None)
    ref.pop("closed")
    assert port == ref
    assert {k: v[0] for k, v in port.items()} == {
        "ok": 200, "get_completions": 405, "bad_json": 400, "no_prompt": 400,
        "empty_prompt": 400, "fleet": 200, "requests": 200, "shed": 429}
    assert port["shed"][2] is not None and int(port["shed"][2]) >= 1
    assert "retry_after_s" in port["shed"][1]


# -- real engines -------------------------------------------------------------
PROMPTS = [np.random.RandomState(i).randint(1, 512, (n,)).astype("int32")
           for i, n in enumerate((5, 9, 3, 12, 7, 14))]
MAX_NEW = 6


@pytest.fixture(scope="module")
def nets():
    ref = ref_llama.llama_tiny()
    ref.initialize()
    ref(nd.zeros((1, 8), dtype="int32"))     # settle deferred shapes
    port = port_llama.llama_tiny(device="cpu")
    port_llama.load_reference_params(
        port, {k: np.asarray(v)
               for k, v in ref_llama.serving_params(ref).items()})
    return ref, port


@pytest.fixture(scope="module")
def ref_tokens(nets):
    """The reference engine's greedy tokens for PROMPTS (one engine for the
    module: its start compiles every signature).  The engine adds a
    ``kind="serving"`` series to the reference's process-wide
    ``mxnet_executable_flops_total``, which a later test in the same
    process (``test_telemetry.py::test_aot_flops_match_cost_analysis_
    source``) reads by position: the series is removed again."""
    from mxnet_tpu import introspection as ref_introspection

    fam = ref_introspection._FLOPS_TOTAL
    before = set(fam._children)
    eng = ref_serving.ServingEngine(nets[0], **ENGINE_KW)
    eng.start()
    try:
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        return [r.result(timeout=300)["token_ids"] for r in reqs]
    finally:
        eng.close()
        for key in set(fam._children) - before:
            del fam._children[key]


@pytest.fixture(scope="module")
def engines(nets):
    e1 = ServingEngine(nets[1], device="cpu", **ENGINE_KW).start()
    e2 = ServingEngine.join_replica(nets[1], e1, device="cpu",
                                    **ENGINE_KW).start()
    yield e1, e2
    for e in (e1, e2):
        e.close(drain=False, timeout=10)


def _check_tokens(nets, ref_tokens, prompt, got):
    i = next(j for j, p in enumerate(PROMPTS) if np.array_equal(p, prompt))
    if got != ref_tokens[i]:         # the reference's logits only when needed
        assert_greedy_match(got, ref_tokens[i],
                            full_logits(nets[0], prompt, ref_tokens[i]))


def _join_count():
    fam = port_telemetry.snapshot()["metrics"][
        "mxnet_serving_join_to_first_token_seconds"]
    return sum(s["count"] for s in fam["samples"])


def test_join_replica_shares_the_donor_weights(nets, engines):
    e1, e2 = engines
    assert set(e2._params) == set(e1._params)
    for k, v in e1._params.items():
        assert e2._params[k] is v and e2._params[k].data_ptr() == v.data_ptr()
    assert e2._kv.k_pool.data_ptr() != e1._kv.k_pool.data_ptr()
    before = {k: v.clone() for k, v in e1._params.items()}
    n0 = _join_count()
    e3 = ServingEngine.join_replica(nets[1], e1, device="cpu",
                                    **ENGINE_KW).start()
    try:
        want = e1.submit(PROMPTS[0], max_new_tokens=4).result(TIMEOUT)
        got = e3.submit(PROMPTS[0], max_new_tokens=4).result(TIMEOUT)
        assert got["token_ids"] == want["token_ids"]
        assert _join_count() == n0 + 1          # the joiner's first token
        e3.submit(PROMPTS[1], max_new_tokens=2).result(TIMEOUT)
        assert _join_count() == n0 + 1          # and only that one
    finally:
        e3.close()
    # closing the recipient frees its pool and nothing of the donor's
    assert e3._kv.k_pool is None and e3._kv.v_pool is None
    assert e3.stats()["kv_pages"]["pool_bytes"] == e1._kv.nbytes()
    with pytest.raises(MXNetError, match="closed"):
        e3.start()
    assert e1.running() and e1._kv.k_pool is not None
    for k, v in e1._params.items():
        assert torch.equal(v, before[k])
    again = e1.submit(PROMPTS[0], max_new_tokens=4).result(TIMEOUT)
    assert again["token_ids"] == want["token_ids"]


def test_join_replica_refuses_another_device_or_model(nets, engines):
    e1, _ = engines
    elsewhere = SimpleNamespace(_device=torch.device("cuda", 1),
                                _cfg=e1._cfg, _params=e1._params)
    with pytest.raises(MXNetError, match="multi-GPU"):
        ServingEngine.join_replica(nets[1], elsewhere, device="cpu",
                                   **ENGINE_KW)
    other = port_llama.LlamaConfig(vocab_size=512, hidden_size=64,
                                   num_layers=1, num_heads=4,
                                   num_kv_heads=2, intermediate_size=128)
    wrong = SimpleNamespace(_device=e1._device, _cfg=other,
                            _params=e1._params)
    with pytest.raises(MXNetError, match="configuration"):
        ServingEngine.join_replica(nets[1], wrong, device="cpu",
                                   **ENGINE_KW)


def _local_router(engines, **kw):
    reps = [port_fleet.LocalReplica(f"r{i + 1}", e, probe_interval_s=0.05)
            for i, e in enumerate(engines)]
    kw.setdefault("probe_interval_ms", 50)
    return reps, mk_router(PKGS["port"], reps, **kw)


def test_local_fleet_gives_the_reference_greedy_tokens(nets, engines,
                                                       ref_tokens):
    homes = {home_and_other(PKGS["port"], p.tolist())[0] for p in PROMPTS}
    assert homes == {"r1", "r2"}           # both replicas get traffic
    reps, router = _local_router(engines)
    router.start()
    try:
        reqs = [router.submit(p, max_new_tokens=MAX_NEW,
                              deadline_ms=60_000) for p in PROMPTS]
        served = set()
        for p, req in zip(PROMPTS, reqs):
            res = req.response(timeout=TIMEOUT)
            _check_tokens(nets, ref_tokens, p, res["token_ids"])
            assert res["finish_reason"] == "length"
            tree = req.trace.to_dict()
            disp = [s for s in tree["tree"]["children"]
                    if s["name"] == "dispatch"]
            assert len(disp) == 1 and disp[0]["attrs"]["kind"] == "primary"
            served.add(disp[0]["attrs"]["replica"])
            grafted = disp[0]["attrs"]["replica_trace"]
            assert grafted["trace_id"] == req.id   # the router's id
            names = {s["name"] for s in grafted["tree"]["children"]}
            assert {"queue_wait", "prefill"} <= names
        assert served == {"r1", "r2"}
        assert router._ledger.stats()["duplicates_suppressed"] == 0
    finally:
        router.close()


def _ok_dispatches(telemetry):
    fam = telemetry.snapshot()["metrics"]["mxnet_fleet_dispatches_total"]
    return sum(s["value"] for s in fam["samples"]
               if s["labels"].get("outcome") == "ok")


def test_replica_crash_resolves_every_request_exactly_once(nets, engines,
                                                          ref_tokens):
    """replica.crash armed before the load: the first dispatch takes its
    replica's handle down, the request fails over, and every request
    resolves exactly once with the reference's tokens."""
    reps, router = _local_router(engines)
    router.start()
    ok0 = _ok_dispatches(port_telemetry)
    trips0 = port_fault.stats()["replica.crash"]["trips"]
    try:
        with port_fault.inject("replica.crash", error=OSError, times=1):
            reqs = [router.submit(p, max_new_tokens=MAX_NEW,
                                  deadline_ms=60_000) for p in PROMPTS]
            results = [r.response(timeout=TIMEOUT) for r in reqs]
        for p, res in zip(PROMPTS, results):
            _check_tokens(nets, ref_tokens, p, res["token_ids"])
        assert port_fault.stats()["replica.crash"]["trips"] == trips0 + 1
        assert sorted(r.alive() for r in reps) == [False, True]
        assert len({r.id for r in reqs}) == len(reqs)
        assert _ok_dispatches(port_telemetry) - ok0 == len(reqs)
        extra = sum(r.attempts for r in reqs) - len(reqs)
        assert extra >= 1
        assert router._ledger.stats()["duplicates_suppressed"] <= extra
        # the crash, and any dispatch that reached the handle as it went
        # dark, failed on the dead replica only
        dead = next(r.rid for r in reps if not r.alive())
        failed = [e["attrs"]["replica"] for r in reqs
                  for e in r.trace.to_dict()["events"]
                  if e["name"] == "dispatch_failed"]
        assert failed and set(failed) == {dead}
        # no manager: the handle died, both engines still run
        assert all(e.running() for e in engines)
    finally:
        router.close()


def test_manager_reaps_a_crashed_replica_and_heals_through_join(nets):
    """The crash seam takes one replica's handle down; the manager drops
    it, closes its engine (the KV pool comes back, the shared weights stay)
    and spawns a replacement through join_replica on the survivor."""
    port = nets[1]
    a = ServingEngine(port, device="cpu", **ENGINE_KW).start()
    b = ServingEngine.join_replica(port, a, device="cpu",
                                   **ENGINE_KW).start()
    ptrs = {k: v.data_ptr() for k, v in a._params.items()}
    spawned = []

    def factory(rid, donor):
        assert donor is b                    # the healthy survivor
        eng = ServingEngine.join_replica(port, donor, device="cpu",
                                         **ENGINE_KW).start()
        spawned.append(eng)
        return eng

    mgr = port_fleet.FleetManager(engine_factory=factory, replicas=2,
                                  probe_interval_ms=50)
    reps, router = _local_router((a, b), manager=mgr)
    mgr.attach_router(router)
    router.start()
    prompt = next(p.tolist() for p in PROMPTS
                  if home_and_other(PKGS["port"], p.tolist())[0] == "r1")
    dead = weakref.ref(a)
    try:
        with port_fault.inject("replica.crash", error=OSError, times=1):
            res = router.submit(prompt, max_new_tokens=4,
                                deadline_ms=60_000).response(TIMEOUT)
        assert len(res["token_ids"]) == 4
        _wait_until(lambda: [r.rid for r in router.replicas()] ==
                    ["r2", "replica-1"], "the replacement")
        assert not a.running() and a._kv.k_pool is None    # reaped
        assert b.running()
        repl = spawned[0]
        assert {k: v.data_ptr() for k, v in repl._params.items()} == ptrs
        assert [k for _, k, _ in mgr.spawn_times] == ["replacement"]
        new_home = next(p.tolist() for p in PROMPTS if home_and_other(
            PKGS["port"], p.tolist(), ("r2", "replica-1"))[0] == "replica-1")
        n0 = _join_count()
        req = router.submit(new_home, max_new_tokens=4, deadline_ms=60_000)
        assert len(req.response(TIMEOUT)["token_ids"]) == 4
        disp = [s for s in req.trace.to_dict()["tree"]["children"]
                if s["name"] == "dispatch"]
        assert disp[0]["attrs"]["replica"] == "replica-1"
        assert _join_count() == n0 + 1
        # nothing of the router keeps the reaped engine
        del a, reps
        gc.collect()
        assert dead() is None
    finally:
        router.close()
        for e in [b] + spawned:
            e.close(drain=False, timeout=10)


def _post_and_stop(port, lifecycle, box):
    try:
        box["completion"] = _http(port, "POST", "/v1/completions",
                                  {"prompt": PROMPTS[2].tolist(),
                                   "max_new_tokens": 4,
                                   "deadline_ms": 60_000})
        box["fleet"] = _http(port, "GET", "/v1/fleet")
    finally:
        lifecycle.request_stop("test stop")


def test_serve_fleet_returns_preempted_after_request_stop(nets, capsys):
    """Local mode on real engines: two replicas (the second joined on the
    first), a completion through the router's HTTP front door, then
    lifecycle.request_stop: serve_fleet drains every replica and returns
    43; the engines' pools are released.  Hedging is off (a completion
    that outlasts the 50 ms hedge floor under a loaded host would
    otherwise be sent to the second replica too: two attempts)."""
    made = []

    def factory(rid, donor):
        # the initial spawns get no donor: the second joins the first
        donor = donor or (made[0] if made else None)
        if donor is None:
            eng = ServingEngine(nets[1], device="cpu", **ENGINE_KW)
        else:
            eng = ServingEngine.join_replica(nets[1], donor, device="cpu",
                                             **ENGINE_KW)
        made.append(eng)
        return eng.start()

    def on_ready(router, port):
        t = threading.Thread(target=_post_and_stop,
                             args=(port, port_lifecycle, box))
        t.start()
        threads.append(t)

    box, threads = {}, []
    port_lifecycle.reset()
    try:
        rc = port_fleet.serve_fleet(engine_factory=factory, replicas=2,
                                    port=0, install_signals=False,
                                    on_ready=on_ready, hedge_ms=600_000)
        for t in threads:
            t.join(TIMEOUT)
    finally:
        port_lifecycle.reset()
        port_telemetry.stop_http_server()
    assert rc == port_lifecycle.EXIT_PREEMPTED
    status, doc, _ = box["completion"]
    assert status == 200 and len(doc["token_ids"]) == 4
    assert doc["fleet"]["attempts"] == 1 and doc["fleet"]["hedges"] == 0
    status, fdoc, _ = box["fleet"]
    assert status == 200 and [r["health"]["state"] for r in
                              fdoc["replicas"]] == ["healthy"] * 2
    assert len(made) == 2 and made[1]._params["lm_head.weight"] is \
        made[0]._params["lm_head.weight"]
    assert all(not e.running() and e._kv.k_pool is None for e in made)
    assert "mxnet_tpu_torch fleet: router up on 127.0.0.1:" in \
        capsys.readouterr().out


def test_reference_serve_fleet_returns_preempted_too(pkg):
    """The same stop contract on stub engines, in both packages."""
    def on_ready(router, port):
        pkg.lifecycle.request_stop("test stop")

    pkg.lifecycle.reset()
    try:
        rc = pkg.fleet.serve_fleet(
            engine_factory=lambda rid, donor: StubEngine(), replicas=2,
            port=0, install_signals=False, on_ready=on_ready)
    finally:
        pkg.lifecycle.reset()
        pkg.telemetry.stop_http_server()
    assert rc == 43 == pkg.lifecycle.EXIT_PREEMPTED


# -- process mode -------------------------------------------------------------
CHILD = r'''
import sys
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon.model_zoo.language import llama
net = llama.init_random_(llama.llama_tiny(device="cpu"), 0)
sys.exit(serving.serve(net, port=0, device="cpu", batch_buckets=[1, 2],
                       prefill_buckets=[8, 16], kv_pages=64, page_size=8,
                       max_batch=2))
'''


def test_process_fleet_survives_a_sigkill():
    """Two CPU children serving llama_tiny (seed 0) behind a router: one is
    SIGKILLed with work in flight; every request resolves exactly once
    with the tokens the same net gives in this process, a cold
    replacement comes up and serves, and a SIGTERM drain makes every
    child exit 43."""
    net = port_llama.init_random_(port_llama.llama_tiny(device="cpu"), 0)
    local = ServingEngine(net, device="cpu", batch_buckets=[1, 2],
                          prefill_buckets=[8, 16], kv_pages=64, page_size=8,
                          max_batch=2).start()
    try:
        want = [local.submit(p, max_new_tokens=40).result(TIMEOUT)
                ["token_ids"] for p in PROMPTS]
    finally:
        local.close()

    def spawn_cmd(rid):
        return [sys.executable, "-c", CHILD], {
            "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}

    mgr = port_fleet.FleetManager(spawn_cmd=spawn_cmd, replicas=2,
                                  probe_interval_ms=50, ready_timeout_s=120)
    router = port_fleet.Router(hedge_ms=600_000, retry_budget=1,
                               probe_interval_ms=50, dispatchers=8,
                               manager=mgr)
    mgr.attach_router(router)
    children = []

    def answered_a_probe(replica, since):
        # a child still slow to answer its first probes (on a loaded host)
        # is SUSPECT and sinks below its peer: the router would not send it
        # the work this test places by prefix affinity
        return replica.health.last_heartbeat > since and \
            replica.health.state == port_health.HEALTHY

    try:
        mgr.ensure(2)
        children = list(router.replicas())
        t_start = time.monotonic()
        router.start()
        _wait_until(lambda: all(answered_a_probe(c, t_start)
                                for c in children), "the first probes")
        victim = children[0]
        reqs = [router.submit(p, max_new_tokens=40, deadline_ms=90_000)
                for p in PROMPTS]
        # freeze the victim with work in flight (an answer already on its
        # way may still land: then let it go on and freeze it again), so
        # that work is still in flight when it dies
        while True:
            _wait_until(lambda: victim.inflight_count() > 0, "victim work")
            os.kill(victim.proc.pid, signal.SIGSTOP)
            time.sleep(0.1)
            if victim.inflight_count() > 0:
                break
            os.kill(victim.proc.pid, signal.SIGCONT)
        victim.kill()
        results = [r.response(timeout=TIMEOUT) for r in reqs]
        assert [r["token_ids"] for r in results] == want
        assert len({r.id for r in reqs}) == len(reqs)
        assert sum(r.resubmits for r in reqs) + \
            sum(r.attempts for r in reqs) > len(reqs)
        _wait_until(lambda: len(router.replicas()) == 2 and any(
            k == "replacement" for _, k, _ in mgr.spawn_times),
            "the replacement")
        assert victim.proc.returncode == -signal.SIGKILL
        repl = [r for r in router.replicas() if r not in children]
        assert len(repl) == 1 and repl[0].rid == "replica-3"
        children.append(repl[0])
        t_repl = time.monotonic()
        _wait_until(lambda: answered_a_probe(repl[0], t_repl),
                    "the replacement's first probe")
        p = next(p.tolist() for p in PROMPTS if home_and_other(
            PKGS["port"], p.tolist(), ("replica-2", "replica-3"))[0]
            == "replica-3")
        req = router.submit(p, max_new_tokens=4, deadline_ms=60_000)
        assert len(req.response(TIMEOUT)["token_ids"]) == 4
        disp = [s for s in req.trace.to_dict()["tree"]["children"]
                if s["name"] == "dispatch"]
        assert disp[0]["attrs"]["replica"] == "replica-3"
        mgr.drain_all(timeout=60)
        assert [c.proc.returncode for c in children[1:]] == [43, 43]
    finally:
        router.close()
        for c in children:
            if c.proc.poll() is None:
                c.proc.kill()
                c.proc.wait(10)
