"""The port's runtime planes (env, fault, telemetry, flight_recorder,
lifecycle, serving/tracing) held against the reference's on the CPU.

Both packages get the same environment variables and the same call
sequence, and must give the same answers: the same accessor values and
warnings, the same parsed fault specs, seam counters and retry schedule,
identical Prometheus text for the families both register, the same step
timeline under a fake clock, the same flight ring and black-box JSON
(timestamps and pids aside), the same lifecycle stop and exit codes, and
the same trace retention.  Every comparison is exact: these planes do no
floating-point work that could round differently.

The planes hold process-wide state; the fixture resets both packages'
planes around every test, and no test counts events in a ring it did not
configure itself.
"""
import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request
import warnings

import pytest

from mxnet_tpu import env as ref_env
from mxnet_tpu import fault as ref_fault
from mxnet_tpu import flight_recorder as ref_flight
from mxnet_tpu import lifecycle as ref_lifecycle
from mxnet_tpu import telemetry as ref_telemetry
from mxnet_tpu.base import MXNetError as RefMXNetError
from mxnet_tpu.serving import tracing as ref_tracing
from mxnet_tpu_torch import env as port_env
from mxnet_tpu_torch import fault as port_fault
from mxnet_tpu_torch import flight_recorder as port_flight
from mxnet_tpu_torch import lifecycle as port_lifecycle
from mxnet_tpu_torch import telemetry as port_telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import tracing as port_tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = {"ref": (ref_env, ref_fault, ref_telemetry, ref_flight,
                ref_lifecycle, ref_tracing),
        "port": (port_env, port_fault, port_telemetry, port_flight,
                 port_lifecycle, port_tracing)}
PLANE_VARS = ("MXNET_FAULT_SPEC", "MXNET_FLIGHT_DIR",
              "MXNET_TELEMETRY_AGG_DIR", "MXNET_GOODPUT_SLO",
              "MXNET_GOODPUT_SLO_WINDOWS", "MXNET_GRACE_PERIOD_S",
              "MXNET_FLIGHT_RECORDER", "MXNET_FLIGHT_RECORDER_CAP")


def _reset_planes():
    for _, fault, telemetry, flight, lifecycle, _ in BOTH.values():
        lifecycle.reset()
        fault.reload_spec()
        fault.reset_stats()
        flight.reset()
        telemetry.reset()


@pytest.fixture(autouse=True)
def clean_planes(monkeypatch):
    for var in PLANE_VARS:
        monkeypatch.delenv(var, raising=False)
    _reset_planes()
    yield
    monkeypatch.undo()
    _reset_planes()


class FakeClock:
    """Stands in for the ``time`` module of a plane: every clock reads the
    same settable value."""

    def __init__(self, t=1000.0):
        self.t = t
        self.slept = []

    def advance(self, dt):
        self.t += dt

    def perf_counter(self):
        return self.t

    def monotonic(self):
        return self.t

    def time(self):
        return self.t

    def sleep(self, dt):
        self.slept.append(dt)


def _both_clocks(monkeypatch, module_name):
    """One FakeClock per package, installed as ``module.time``."""
    clocks = {}
    for side, mods in BOTH.items():
        mod = {"telemetry": mods[2], "fault": mods[1], "flight": mods[3],
               "tracing": mods[5]}[module_name]
        clocks[side] = FakeClock()
        monkeypatch.setattr(mod, "time", clocks[side])
    return clocks


# ---------------------------------------------------------------------------
# (a) env accessors
# ---------------------------------------------------------------------------
ACCESSORS = {
    "serving_max_batch": "MXNET_SERVING_MAX_BATCH",
    "serving_batch_buckets": "MXNET_SERVING_BATCH_BUCKETS",
    "serving_prefill_buckets": "MXNET_SERVING_PREFILL_BUCKETS",
    "serving_queue_bound": "MXNET_SERVING_QUEUE",
    "serving_kv_pages": "MXNET_SERVING_KV_PAGES",
    "serving_page_size": "MXNET_SERVING_PAGE_SIZE",
    "serving_deadline_ms": "MXNET_SERVING_DEADLINE_MS",
    "serving_port": "MXNET_SERVING_PORT",
    "grace_period_s": "MXNET_GRACE_PERIOD_S",
    "flight_recorder_enabled": "MXNET_FLIGHT_RECORDER",
    "flight_recorder_cap": "MXNET_FLIGHT_RECORDER_CAP",
    "flight_dir": "MXNET_FLIGHT_DIR",
    "telemetry_agg_dir": "MXNET_TELEMETRY_AGG_DIR",
    "launcher_rank": "MXNET_WORKER_ID",
    "launcher_world": "MXNET_NUM_WORKERS",
    "goodput_slo": "MXNET_GOODPUT_SLO",
    "goodput_slo_windows": "MXNET_GOODPUT_SLO_WINDOWS",
    "trace_requests": "MXNET_TRACE_REQUESTS",
    "trace_keep_slowest": "MXNET_TRACE_KEEP_SLOWEST",
}
# unset, empty, well-formed, negative, zero, malformed, float, boolean words
VALUES = (None, "", "7", "-3", "0", "abc", "2.5", "1.75e1", "true", "No",
          "on", " 5")


def _call(fn):
    """(value, the warnings' messages) of one accessor call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        value = fn()
    return value, [str(w.message) for w in caught]


@pytest.mark.parametrize("name", sorted(ACCESSORS))
def test_env_accessor_matches_reference(name, monkeypatch):
    var = ACCESSORS[name]
    for value in VALUES:
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
        got = _call(getattr(port_env, name))
        want = _call(getattr(ref_env, name))
        assert got == want, f"{var}={value!r}"


def test_env_fallbacks_and_generic_getters_match_reference(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_AGG_DIR", "/agg")
    monkeypatch.delenv("MXNET_FLIGHT_DIR", raising=False)
    assert port_env.flight_dir() == ref_env.flight_dir() == "/agg"
    for var, alias in (("MXNET_WORKER_ID", "DMLC_WORKER_ID"),
                       ("MXNET_NUM_WORKERS", "DMLC_NUM_WORKER")):
        for first, second in ((None, "3"), ("x", "4"), ("5", "6")):
            for v, value in ((var, first), (alias, second)):
                if value is None:
                    monkeypatch.delenv(v, raising=False)
                else:
                    monkeypatch.setenv(v, value)
            assert (port_env.launcher_rank(), port_env.launcher_world()) \
                == (ref_env.launcher_rank(), ref_env.launcher_world())
    for value in VALUES[1:]:
        monkeypatch.setenv("MXNET_PLANES_PARITY", value)
        for getter, default in (("get_int", 11), ("get_float", 1.5),
                                ("get_bool", True), ("get_str", "d")):
            assert _call(lambda: getattr(port_env, getter)(
                "MXNET_PLANES_PARITY", default)) == _call(
                lambda: getattr(ref_env, getter)("MXNET_PLANES_PARITY",
                                                 default)), (getter, value)


def test_env_describe_names_only_reference_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_QUEUE", "9")
    ref_lines = {line.split("=", 1)[0]: line
                 for line in ref_env.describe().splitlines()}
    port_lines = port_env.describe().splitlines()
    for line in port_lines:
        name = line.split("=", 1)[0]
        assert name in ref_lines, name
        # the same "NAME=value — " head as the reference's line
        assert line.split(" — ")[0] == ref_lines[name].split(" — ")[0]
    assert "MXNET_SERVING_QUEUE=9 — " in port_env.describe()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_apply_env_seeds_and_starts_the_endpoint(monkeypatch):
    from mxnet_tpu_torch import random as port_random

    port = _free_port()
    monkeypatch.setenv("MXNET_SEED", "5")
    monkeypatch.setenv("MXNET_TELEMETRY_PORT", str(port))
    try:
        port_env.apply_env()
        assert port_random._S.seed == 5
        body = _get(port, "/healthz")
        assert body == (200, b"ok\n")
    finally:
        port_telemetry.stop_http_server()
        port_random.seed(0)


# ---------------------------------------------------------------------------
# (b) fault
# ---------------------------------------------------------------------------
SPECS = [
    "serving.admit:fail:2",
    "serving.decode_step:fail:1:TimeoutError, kvstore.push:fail",
    "serving.admit:fial:2",                       # typo'd mode
    "serving.admitt:fail:1",                      # unknown seam
    "serving.admit:fail:x",                       # bad count
    "serving.admit:fail:1:NoSuchError",           # unknown error
    "", ",,", "serving.admit",                    # empty, too short
    "checkpoint.write:fail::OSError",             # empty count -> 1
    "serving.admit:fail:3:MXNetError,serving.admit:fail:1:ValueError",
]


def _plans(parse, spec):
    return {seam: [(p["remaining"], p["error"].__name__, p["message"])
                   for p in plans]
            for seam, plans in parse(spec).items()}


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_reference(spec):
    assert _plans(port_fault._parse_spec, spec) == \
        _plans(ref_fault._parse_spec, spec)


def test_seam_list_is_the_reference_list():
    assert port_fault.SEAMS == ref_fault.SEAMS


def _seam_sequence(fault, mxerror):
    """The same calls against one package; returns what each call did."""
    out = []

    def call(seam):
        try:
            fault.check(seam)
            out.append((seam, "ok"))
        except Exception as e:
            out.append((seam, type(e).__name__, str(e)))

    for _ in range(3):
        call("serving.admit")
    with fault.inject("serving.decode_step", times=1):
        call("serving.decode_step")
        call("serving.decode_step")
    with fault.inject("serving.decode_step", error=TimeoutError, times=5,
                      message="slow"):
        call("serving.decode_step")
    call("serving.decode_step")                   # disarmed on exit
    for bad in ("serving.nope",):
        with pytest.raises(mxerror):
            fault.check(bad)
        with pytest.raises(mxerror):
            with fault.inject(bad):
                pass
    return out, fault.stats()


def test_check_inject_stats_match_reference(monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_SPEC",
                       "serving.admit:fail:2:ConnectionResetError")
    port_fault.reload_spec()
    ref_fault.reload_spec()
    assert _seam_sequence(port_fault, MXNetError) == \
        _seam_sequence(ref_fault, RefMXNetError)


def test_is_transient_matches_reference():
    cases = [OSError("disk"), ConnectionResetError(), TimeoutError(),
             ValueError("x"), RuntimeError("UNAVAILABLE: socket closed"),
             RuntimeError("INVALID_ARGUMENT: bad shape"),
             RuntimeError("Deadline Exceeded"), KeyError("preempted")]
    assert [port_fault.is_transient(e) for e in cases] == \
        [ref_fault.is_transient(e) for e in cases]
    assert not port_fault.is_transient(MXNetError("x"))
    assert not ref_fault.is_transient(RefMXNetError("x"))


def _retry_run(fault, clock, failures, error, **kw):
    """Run call_with_retries over a function that raises ``error``
    ``failures`` times; returns (outcome, attempts, sleeps, retries)."""
    import random

    random.seed(1234)              # the backoff's full jitter
    attempts = []

    def fn():
        attempts.append(len(attempts))
        if len(attempts) <= failures:
            raise error
        return "done"

    try:
        outcome = fault.call_with_retries("kvstore.pull", fn, **kw)
    except Exception as e:
        outcome = (type(e).__name__, str(e).split("(last error")[0])
    return (outcome, len(attempts), list(clock.slept),
            fault.stats()["kvstore.pull"]["retries"])


@pytest.mark.parametrize("failures,error,kw", [
    (2, OSError("flaky"), {}),
    (9, OSError("down"), {}),
    (9, ConnectionResetError(), {"retries": 5, "base_ms": 40}),
    (1, RuntimeError("UNAVAILABLE: peer"), {"base_ms": 0}),
    (1, ValueError("permanent"), {}),
], ids=["recovers", "exhausts", "knobs", "message", "permanent"])
def test_call_with_retries_schedule_matches_reference(failures, error, kw,
                                                      monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_MAX_RETRIES", "3")
    monkeypatch.setenv("MXNET_FAULT_BACKOFF_MS", "100")
    clocks = _both_clocks(monkeypatch, "fault")
    got = _retry_run(port_fault, clocks["port"], failures, error, **kw)
    want = _retry_run(ref_fault, clocks["ref"], failures, error, **kw)
    assert got == want
    if failures == 2:
        assert got[0] == "done" and got[1] == 3 and len(got[2]) == 2


def test_guard_matches_reference():
    for fault in (port_fault, ref_fault):
        fault.guard("kvstore.push")
        with fault.inject("kvstore.push", times=1):
            fault.guard("kvstore.push", base_ms=0)
    assert port_fault.stats()["kvstore.push"] == \
        ref_fault.stats()["kvstore.push"] == \
        {"calls": 3, "trips": 1, "retries": 1}


# ---------------------------------------------------------------------------
# (c) telemetry
# ---------------------------------------------------------------------------
def _blocks(text, names):
    """{family name: its HELP/TYPE/sample lines} for ``names``."""
    out, cur = {}, None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            cur = line.split()[2]
        if cur in names:
            out.setdefault(cur, []).append(line)
    return out


TEST_FAMILIES = ("mxnet_parity_requests_total", "mxnet_parity_depth",
                 "mxnet_parity_seconds", "mxnet_parity_ratio",
                 "mxnet_parity_plain_total")


def _drive_registry(telemetry):
    c = telemetry.counter("mxnet_parity_requests_total", "reqs",
                          labelnames=("outcome", "route"))
    c.labels(outcome="ok", route="/v1").inc()
    c.labels("err", 'a"b\\c\nd').inc(2.5)
    c.labels(outcome="ok", route="/v1").inc(3)
    with pytest.raises(ValueError):
        c.labels("ok").inc()                       # one label of two
    with pytest.raises(ValueError):
        c.labels(outcome="ok", route="x").inc(-1)
    g = telemetry.gauge("mxnet_parity_depth", "depth")
    g.set(7)
    g.inc(2)
    g.dec(0.5)
    h = telemetry.histogram("mxnet_parity_seconds", "latency",
                            labelnames=("phase",))
    for v in (1e-5, 3e-4, 0.01, 0.5, 20.0):
        h.labels(phase="decode").observe(v)
    r = telemetry.histogram("mxnet_parity_ratio", "fill",
                            buckets=[0.5, 0.25, 1.0])
    for v in (0.1, 0.25, 0.9, 1.0, 2.0):
        r.observe(v)
    telemetry.counter("mxnet_parity_plain_total", "plain").inc(4)
    # get-or-create returns the family; another type or label set is refused
    assert telemetry.counter("mxnet_parity_requests_total",
                             labelnames=("outcome", "route")) is c
    with pytest.raises(ValueError):
        telemetry.gauge("mxnet_parity_requests_total")
    with pytest.raises(ValueError):
        telemetry.counter("mxnet_parity_requests_total",
                          labelnames=("outcome",))
    c.remove(outcome="err", route='a"b\\c\nd')
    c.labels(outcome="err", route="z").inc()


def _drop_families(telemetry):
    with telemetry._LOCK:
        for name in TEST_FAMILIES:
            telemetry._FAMILIES.pop(name, None)


def test_registry_operations_render_identically():
    try:
        _drive_registry(port_telemetry)
        _drive_registry(ref_telemetry)
        names = set(TEST_FAMILIES)
        got = _blocks(port_telemetry.render_prometheus(), names)
        want = _blocks(ref_telemetry.render_prometheus(), names)
        assert got == want and set(got) == names
        # the snapshot's view of the same families
        gs, ws = port_telemetry.snapshot(), ref_telemetry.snapshot()
        for name in TEST_FAMILIES:
            assert gs["metrics"][name] == ws["metrics"][name]
    finally:
        _drop_families(port_telemetry)
        _drop_families(ref_telemetry)


def _drive_timeline(telemetry, clock):
    for i in range(4):
        telemetry.step_begin()
        clock.advance(0.25)
        with telemetry.phase("data"):
            clock.advance(0.125)
        with telemetry.phase("forward_backward"):
            clock.advance(0.5)
            with telemetry.phase("collectives"):
                clock.advance(0.0625)
            clock.advance(0.03125)
        with telemetry.phase("checkpoint"):
            clock.advance(0.5 * i)
        telemetry.step_end()
        telemetry.goodput_note("stall", 2.0 * i)
    with telemetry.phase("outside"):
        clock.advance(0.75)
    telemetry.step_begin(step=10)
    clock.advance(1.0)
    telemetry.step_begin()                # finalizes step 10
    telemetry.step_abort()
    return telemetry.timeline()


def test_step_timeline_and_goodput_match_reference(monkeypatch):
    monkeypatch.setenv("MXNET_GOODPUT_SLO", "0.6")
    monkeypatch.setenv("MXNET_GOODPUT_SLO_WINDOWS", "2")
    clocks = _both_clocks(monkeypatch, "telemetry")
    got = _drive_timeline(port_telemetry, clocks["port"])
    want = _drive_timeline(ref_telemetry, clocks["ref"])
    assert got == want and len(got) == 5
    assert abs(sum(got[0]["phases"].values()) - got[0]["wall_s"]) < 1e-12
    # the SLO fired once in each, and not again while it stayed breached
    assert port_telemetry._SLO_BREACHES.value == \
        ref_telemetry._SLO_BREACHES.value == 1
    assert port_telemetry.goodput_summary() == \
        ref_telemetry.goodput_summary()
    names = {"mxnet_step_phase_seconds", "mxnet_step_seconds",
             "mxnet_steps_total", "mxnet_goodput_seconds_total",
             "mxnet_goodput_slo_breaches_total", "mxnet_goodput_ratio"}
    got_text = _blocks(port_telemetry.render_prometheus(), names)
    want_text = _blocks(ref_telemetry.render_prometheus(), names)
    assert got_text == want_text and set(got_text) == names
    gs, ws = port_telemetry.snapshot(), ref_telemetry.snapshot()
    assert set(gs) <= set(ws)
    for key in ("time", "steps", "step_phase_totals", "goodput"):
        assert gs[key] == ws[key], key


def test_trainer_feeds_the_step_timeline_like_the_reference(monkeypatch):
    """Trainer(telemetry=True): its step lands in the open timeline step as
    the ``collectives`` and ``optimizer`` phases, and is counted."""
    import numpy as np

    import mxnet_tpu as rmx
    import mxnet_tpu_torch as pmx

    _both_clocks(monkeypatch, "telemetry")
    x = np.random.RandomState(0).randn(4, 3).astype("float32")
    got = {}
    for side, mx, ctx in (("ref", rmx, None), ("port", pmx, pmx.cpu())):
        telemetry = BOTH[side][2]
        net = mx.gluon.nn.Dense(2, in_units=3)
        net.initialize(ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1}, telemetry=True)
        with mx.autograd.record():
            loss = net(mx.nd.array(x, ctx=ctx)).sum()
        loss.backward()
        with telemetry.step_scope():
            trainer.step(4)
        trainer.step(4)                   # outside a step: phases only
        got[side] = (telemetry.timeline(),
                     telemetry.counter("mxnet_trainer_steps_total").value,
                     _blocks(telemetry.render_prometheus(),
                             {"mxnet_step_phase_seconds"}))
    assert got["port"] == got["ref"]
    timeline, steps, _ = got["port"]
    assert steps == 2 and len(timeline) == 1
    assert set(timeline[0]["phases"]) == {"collectives", "optimizer"}


def test_fault_collector_renders_identically():
    for fault in (port_fault, ref_fault):
        fault.check("serving.admit")
        with fault.inject("serving.decode_step", times=1):
            with pytest.raises(OSError):
                fault.check("serving.decode_step")
    names = {f"mxnet_fault_seam_{m}_total"
             for m in ("calls", "trips", "retries")}
    got = _blocks(port_telemetry.render_prometheus(), names)
    assert got == _blocks(ref_telemetry.render_prometheus(), names)
    assert 'mxnet_fault_seam_trips_total{seam="serving.decode_step"} 1' \
        in got["mxnet_fault_seam_trips_total"]


def _get(port, path, data=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data,
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _drive_http(telemetry):
    def echo(method, path, query, body):
        return 200, "application/json", json.dumps(
            {"method": method, "query": query,
             "body": body.decode()}).encode(), {"X-Extra": "1"}

    def broken(method, path, query, body):
        raise RuntimeError("route bug")

    server = telemetry.start_http_server(0)
    try:
        assert telemetry.start_http_server(0) is server     # idempotent
        port = server.server_address[1]
        telemetry.register_http_route("/v1/echo", echo)
        telemetry.register_http_route("/v1/broken", broken)
        out = [_get(port, "/healthz"), _get(port, "/nowhere"),
               _get(port, "/v1/echo?a=1"),
               _get(port, "/v1/echo", data=b'{"x": 1}'),
               _get(port, "/v1/broken"),
               _get(port, "/nowhere", data=b"")]
        telemetry.unregister_http_route("/v1/echo")
        out.append(_get(port, "/v1/echo")[0])
        status, body = _get(port, "/metrics")
        out.append((status, b"# TYPE mxnet_steps_total counter" in body))
        status, body = _get(port, "/snapshot")
        out.append((status, "metrics" in json.loads(body)))
        return out
    finally:
        telemetry.unregister_http_route("/v1/broken")
        telemetry.stop_http_server()


def test_http_endpoint_matches_reference():
    assert _drive_http(port_telemetry) == _drive_http(ref_telemetry)


# ---------------------------------------------------------------------------
# (d) flight recorder
# ---------------------------------------------------------------------------
_TIME_KEYS = {"t", "t0", "t1", "time"}


def _strip_times(doc):
    if isinstance(doc, dict):
        return {k: _strip_times(v) for k, v in doc.items()
                if k not in _TIME_KEYS}
    if isinstance(doc, list):
        return [_strip_times(v) for v in doc]
    return doc


def _drive_flight(flight, fault, tmp):
    flight.configure(enabled=True, capacity=8, rank=3, world=4)
    flight.record_event("step", event="begin", step=1)
    with flight.collective("allreduce", shape=(4, 2), dtype="float32",
                           axis="dp", generation=2):
        pass
    with pytest.raises(KeyError):
        with flight.collective("all_gather", shape=(8,)):
            raise KeyError("lost peer")
    with fault.inject("serving.admit", times=1):
        with pytest.raises(OSError):
            fault.check("serving.admit")
    for i in range(6):                           # wraps the 8-slot ring
        flight.record_event("lifecycle", event="tick", i=i)
    path = flight.dump_blackbox("serving_step_failure", directory=tmp)
    with open(path) as f:
        dump = json.load(f)
    return (flight.position(), flight.tag_of("reduce", (2, 3), "bf16", 1, 7),
            _strip_times(flight.snapshot_doc()), os.path.basename(path),
            _strip_times(dump))


def test_flight_ring_and_blackbox_match_reference(tmp_path):
    got = _drive_flight(port_flight, port_fault, str(tmp_path / "port"))
    want = _drive_flight(ref_flight, ref_fault, str(tmp_path / "ref"))
    assert got == want
    position, _, doc, name, dump = got
    assert position == 2 and name == "blackbox.rank3.json"
    assert doc["events_recorded"] == 10 and len(doc["events"]) == 8
    assert dump["reason"] == "serving_step_failure"


def test_flight_dump_needs_a_directory_and_an_enabled_ring(tmp_path,
                                                           monkeypatch):
    results = {}
    for side, (_, _, _, flight, _, _) in BOTH.items():
        flight.reset()
        monkeypatch.delenv("MXNET_FLIGHT_DIR", raising=False)
        monkeypatch.delenv("MXNET_TELEMETRY_AGG_DIR", raising=False)
        unconfigured = flight.dump_blackbox("x")
        monkeypatch.setenv("MXNET_TELEMETRY_AGG_DIR", str(tmp_path / side))
        configured = os.path.basename(flight.dump_blackbox("x"))
        flight.configure(enabled=False)
        disabled = flight.dump_blackbox("x", directory=str(tmp_path))
        flight.record_event("step")
        results[side] = (unconfigured, configured, disabled,
                         flight.snapshot_doc()["events_recorded"])
    assert results["port"] == results["ref"] == \
        (None, "blackbox.rank0.json", None, 0)


# ---------------------------------------------------------------------------
# (e) lifecycle
# ---------------------------------------------------------------------------
def _drive_stop(lifecycle, telemetry):
    before = (lifecycle.stop_requested(), lifecycle.stop_reason())
    lifecycle.request_stop("first")
    lifecycle.request_stop("second")              # the first reason wins
    after = (lifecycle.stop_requested(), lifecycle.stop_reason())
    text = _blocks(telemetry.render_prometheus(),
                   {"mxnet_lifecycle_stops_total",
                    "mxnet_lifecycle_stop_requested"})
    lifecycle.reset()
    cleared = (lifecycle.stop_requested(), lifecycle.stop_reason())
    exc = lifecycle.GracefulExit("preempted", step=7)
    return (before, after, text, cleared, str(exc), exc.reason, exc.step,
            lifecycle.EXIT_PREEMPTED, lifecycle.EXIT_FORCED,
            lifecycle.EXIT_STALLED)


def test_stop_flag_and_exit_codes_match_reference():
    got = _drive_stop(port_lifecycle, port_telemetry)
    assert got == _drive_stop(ref_lifecycle, ref_telemetry)
    assert got[1] == (True, "first") and got[7:] == (43, 44, 45)


def test_grace_deadline_arms_and_cancels_like_the_reference(monkeypatch):
    monkeypatch.setenv("MXNET_GRACE_PERIOD_S", "3600")
    for lifecycle in (port_lifecycle, ref_lifecycle):
        lifecycle.request_stop("grace")
        timer = lifecycle._GRACE["timer"]
        assert timer is not None and timer.is_alive()
        lifecycle.GracefulExit("honored")          # disarms the deadline
        assert lifecycle._GRACE["timer"] is None
        timer.join(timeout=5)
        assert not timer.is_alive()


def test_breach_notes_record_flight_events_like_the_reference():
    docs = {}
    for side, (_, _, _, flight, lifecycle, _) in BOTH.items():
        flight.configure(enabled=True, capacity=16)
        lifecycle.note_goodput_slo_breach(0.5, 0.9, 3)
        docs[side] = _strip_times(flight.snapshot_doc())["events"]
    assert docs["port"] == docs["ref"] and len(docs["port"]) == 1


_SIGNAL_SCRIPT = """
import os, signal, sys, time
sys.path.insert(0, {repo!r})
import importlib
lc = importlib.import_module({pkg!r} + ".lifecycle")
assert lc.install_signal_handlers()
os.kill(os.getpid(), signal.SIGTERM)
for _ in range(500):
    if lc.stop_requested():
        break
    time.sleep(0.01)
print("stop", lc.stop_requested(), lc.stop_reason(), flush=True)
os.kill(os.getpid(), signal.SIGTERM)      # the second delivery re-raises
time.sleep(30)
print("survived", flush=True)
"""


def test_second_signal_restores_the_disposition_and_reraises():
    """The one test that sends real signals: in a subprocess of each
    package, with a deadline.  The first SIGTERM requests a stop, the
    second restores the default disposition and kills the process."""
    import signal

    outs = {}
    for pkg in ("mxnet_tpu_torch", "mxnet_tpu"):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-c", _SIGNAL_SCRIPT.format(repo=REPO,
                                                         pkg=pkg)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        outs[pkg] = (proc.returncode, proc.stdout.strip())
    assert outs["mxnet_tpu_torch"] == outs["mxnet_tpu"] == \
        (-signal.SIGTERM, "stop True signal SIGTERM")


def test_install_signal_handlers_off_the_main_thread_is_refused():
    import threading

    got = {}
    for side, lifecycle in (("port", port_lifecycle), ("ref", ref_lifecycle)):
        t = threading.Thread(target=lambda: got.__setitem__(
            side, lifecycle.install_signal_handlers()))
        t.start()
        t.join(timeout=30)
    assert got == {"port": False, "ref": False}


# ---------------------------------------------------------------------------
# (f) request traces
# ---------------------------------------------------------------------------
def _drive_traces(tracing, clock):
    store = tracing.TraceStore(keep_slowest=3, keep_recent=4, keep_errors=2)
    durations = [0.5, 2.0, 0.25, 3.0, 1.0, 0.125, 4.0, 0.75, 1.5, 0.0625]
    for i, dur in enumerate(durations):
        tr = tracing.RequestTrace(100 + i)
        clock.advance(0.01)
        tr.add_span("queue_wait", tr.t0, clock.t, prefills=0)
        sid = tr.add_span("prefill", clock.t, clock.t + dur / 2, tokens=8)
        tr.add_span("sample", clock.t + dur / 2, clock.t + dur / 2,
                    parent=sid)
        if i % 4 == 1:
            tr.event("evicted", cache_len=8)
        if i % 3 == 2:
            tr.event("requeued", reason="admit_fault")
        clock.advance(dur)
        tr.finish("error" if i % 5 == 3 else "length",
                  error=ValueError("boom") if i % 5 == 3 else None)
        tr.finish("ignored")                      # the first outcome wins
        store.add(tr)
    big = tracing.RequestTrace(999)
    for j in range(tracing._MAX_SPANS + 3):
        big.add_span("decode_step", clock.t, clock.t, step=j)
    for j in range(tracing._MAX_EVENTS + 2):
        big.event("tick")
    big.finish("length")
    return (store.count(), _strip_times(store.snapshot()),
            _strip_times(big.to_dict())["dropped_spans"],
            big.to_dict()["dropped_events"],
            [tags for _, tags in store.traces()])


def test_trace_store_retention_matches_reference(monkeypatch):
    clocks = _both_clocks(monkeypatch, "tracing")
    got = _drive_traces(port_tracing, clocks["port"])
    want = _drive_traces(ref_tracing, clocks["ref"])
    assert got == want
    count, snap, dropped_spans, dropped_events, _ = got
    assert count == 10 and dropped_spans == 3 and dropped_events == 2
    assert [r["trace_id"] for r in snap["requests"]][:3] == [106, 103, 101]
