"""The profiler of the port (``mxnet_tpu_torch.profiler``) against the
reference's (``mxnet_tpu.profiler``) on the CPU, host trace only
(``device_trace=False``, the reference's ``jax_trace=False``: the card's
kernels are traced on the card, by ``chip_smoke.py``'s phase 13).

The same op sequence through both profilers gives the same op events (by
name and count), markers, counters and scope rows; a ``continuous_dump``
merge holds each op once in both; the ``dumps()`` rows have the same
names and counts; pause/resume drops the same ops.  ``otherData`` carries
the dispatch counters, the fault seams and the telemetry snapshot; the
port's ``dispatch_stats`` counts ``invoke`` calls per op and
``set_eager_jit(True)`` raises.  Without a card, ``start()`` with the
device trace on raises rather than writing a trace without the card's
kernels.
"""
import collections
import json

import pytest

import mxnet_tpu as rmx
from mxnet_tpu import profiler as rprof
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, profiler, telemetry
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()


def _ops(pkg_nd, ctx):
    """One op sequence: ones, three dots, relu, sqrt, exp, log."""
    kw = {} if ctx is None else {"ctx": ctx}
    a = pkg_nd.ones((8, 8), **kw)
    for _ in range(3):
        b = pkg_nd.dot(a, a)
    pkg_nd.relu(b)
    pkg_nd.sqrt(a)
    pkg_nd.exp(a)
    pkg_nd.log(a).wait_to_read()


def _marks(pkg_prof):
    pkg_prof.Marker(name="epoch_end").mark()
    c = pkg_prof.Counter(name="samples", value=0)
    c.increment(32)
    c += 32
    with pkg_prof.Scope("my_phase"):
        pass


@pytest.fixture
def both(tmp_path):
    files = (str(tmp_path / "ref.json"), str(tmp_path / "port.json"))
    prev = rmx.nd.set_eager_jit(False)
    rprof.set_config(profile_imperative=True, filename=files[0],
                     jax_trace=False)
    profiler.set_config(profile_imperative=True, filename=files[1],
                        device_trace=False)
    yield files
    for p in (rprof, profiler):
        p.stop()
        p.dumps(reset=True)
    rprof.set_config(profile_imperative=False, jax_trace=True)
    profiler.set_config(profile_imperative=False)
    rmx.nd.set_eager_jit(prev)


def _run(pkg_prof, pkg_nd, ctx):
    pkg_prof.start()
    _ops(pkg_nd, ctx)
    _marks(pkg_prof)
    pkg_prof.stop()
    return json.load(open(pkg_prof.dump()))


def _summary(trace):
    evs = trace["traceEvents"]
    ops = collections.Counter(e["name"] for e in evs
                              if e.get("cat") == "operator")
    marks = [e["name"] for e in evs if e.get("ph") == "i"]
    counters = [(e["name"], e["args"]) for e in evs if e.get("ph") == "C"]
    return ops, marks, counters


def _rows(table):
    """{name: count} of the dumps() op rows."""
    rows = {}
    for line in table.splitlines()[2:]:
        parts = line.split()
        if len(parts) >= 7 and parts[1].isdigit():
            rows[parts[0]] = int(parts[1])
        elif not line.strip() or not line[0].isalpha():
            break
    return rows


def test_same_events_markers_counters_and_rows(both):
    ref = _run(rprof, rmx.nd, None)
    port = _run(profiler, nd, CPU)
    rops, rmarks, rcounters = _summary(ref)
    pops, pmarks, pcounters = _summary(port)
    assert pops == rops
    assert pops["dot"] == 3 and pops["scope:my_phase"] == 1
    assert pmarks == rmarks == ["epoch_end"]
    assert pcounters == rcounters
    assert pcounters[-1] == ("samples", {"samples": 64})
    assert all("dur" in e and "ts" in e for e in port["traceEvents"]
               if e.get("cat") == "operator")
    prow, rrow = _rows(profiler.dumps()), _rows(rprof.dumps())
    assert prow == rrow and prow["dot"] == 3
    other = port["otherData"]
    assert set(other) >= {"eager_dispatch_cache", "fault_seams",
                          "telemetry"}
    assert other["eager_dispatch_cache"]["calls"] >= 8


def test_continuous_dump_merges_without_duplicates(tmp_path):
    prev = rmx.nd.set_eager_jit(False)
    names = []
    try:
        for pkg_prof, pkg_nd, ctx, f in (
                (rprof, rmx.nd, None, tmp_path / "r.json"),
                (profiler, nd, CPU, tmp_path / "p.json")):
            kw = {"jax_trace": False} if pkg_prof is rprof else \
                {"device_trace": False}
            pkg_prof.set_config(profile_imperative=True, filename=str(f),
                                continuous_dump=True, **kw)
            pkg_prof.start()
            try:
                pkg_nd.sqrt(pkg_nd.ones((4,), **({} if ctx is None else
                                                {"ctx": ctx})))
                pkg_prof.dump()
                pkg_nd.exp(pkg_nd.ones((4,), **({} if ctx is None else
                                               {"ctx": ctx})))
                pkg_prof.dump()
            finally:
                pkg_prof.stop()
                pkg_prof.dumps(reset=True)
                pkg_prof.set_config(profile_imperative=False, **kw)
            names.append(collections.Counter(
                e["name"] for e in json.load(open(f))["traceEvents"]
                if e.get("cat") == "operator"))
    finally:
        rmx.nd.set_eager_jit(prev)
    assert names[1] == names[0]
    assert names[1]["sqrt"] == names[1]["exp"] == 1


def test_pause_resume_drops_the_same_ops(both):
    for pkg_prof, pkg_nd, ctx in ((rprof, rmx.nd, None),
                                  (profiler, nd, CPU)):
        kw = {} if ctx is None else {"ctx": ctx}
        pkg_prof.start()
        pkg_nd.sqrt(pkg_nd.ones((4,), **kw)).wait_to_read()
        pkg_prof.pause()
        pkg_nd.exp(pkg_nd.ones((4,), **kw)).wait_to_read()
        pkg_prof.resume()
        pkg_nd.log(pkg_nd.ones((4,), **kw)).wait_to_read()
        pkg_prof.stop()
    prow, rrow = _rows(profiler.dumps()), _rows(rprof.dumps())
    assert prow == rrow and "exp" not in prow and "log" in prow


def test_telemetry_steps_and_request_spans_reach_the_trace(both):
    profiler.start()
    telemetry.step_begin()
    with telemetry.phase("data"):
        pass
    telemetry.step_end()
    from mxnet_tpu_torch.serving.tracing import RequestTrace

    tr = RequestTrace(7)
    tr.add_span("prefill", tr.t0, tr.t0 + 1e-3)
    tr.finish("done")
    tr.emit_chrome()
    profiler.stop()
    evs = json.load(open(profiler.dump()))["traceEvents"]
    cats = collections.Counter(e.get("cat") for e in evs)
    assert cats["step"] == 1 and cats["step_phase"] == 1
    assert cats["serving_request"] == 2
    assert {"req7", "req7:prefill"} <= {e["name"] for e in evs}


def test_dispatch_stats_count_invoke_calls():
    nd.reset_dispatch_stats()
    a = nd.ones((3,), ctx=CPU)
    nd.relu(a)
    nd.relu(a)
    st = nd.dispatch_stats(reset=True)
    assert st["per_op"]["relu"]["calls"] == 2
    assert st["calls"] == st["bypasses"] == 3
    assert st["hits"] == st["misses"] == 0 and st["enabled"] is False
    assert nd.dispatch_stats()["calls"] == 0
    assert nd.set_eager_jit(False) is False
    with pytest.raises(MXNetError, match="eagerly"):
        nd.set_eager_jit(True)


def test_device_trace_without_a_card_raises(tmp_path):
    profiler.set_config(profile_all=True, filename=str(tmp_path / "t.json"))
    try:
        with pytest.raises(MXNetError, match="CUDA card"):
            profiler.start()
        assert not profiler._ACTIVE
    finally:
        profiler.set_config()
