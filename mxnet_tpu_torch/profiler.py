"""Profiler: per-op statistics and a Chrome trace with the card's kernels
(counterpart of ``mxnet_tpu/profiler.py``).

- ``start()`` / ``stop()`` also run ``torch.profiler`` with CUDA activity
  (CUPTI), in place of the reference's ``jax.profiler`` trace: at
  ``stop()`` (and at every ``dump()`` of a running session) its device
  events (kernels, copies) join the trace under their own process row
  (``pid`` 1, one ``tid`` per stream), named as the card ran them, so
  every launch of ``flash_attn_fwd``'s kernel shows with its device time.
  Their times are put on the profiler's clock through a marker range and
  a one-element kernel launched when the session starts.  A session
  opens with a lead-in of ``_LEAD_IN`` tiny kernels, synchronised, before
  the marker: once a process has run profiler sessions, CUPTI drops the
  first few device events of each new one (seen on an H100 with torch
  2.11, more of them as the process ages), and the lead-in takes that
  loss; a session that kept none of it may have lost its own events and
  raises.  A card on which CUPTI records
  nothing makes ``start()`` raise (a probe session first): the profiler
  never writes a trace that lacks device events it was asked for.  ``set_config(device_trace=False)`` profiles the host
  alone (the CPU's runs; the reference's ``jax_trace=False``).
- Op events come from the ``invoke`` seam: while ``profile_imperative``
  (or ``profile_all``) is set, each imperative op is timed with a sync of
  its output's card, the trade the reference's profiler makes (not inside
  a CUDA-graph capture, where a sync is illegal).
- ``dump()`` writes a Chrome ``traceEvents`` JSON (op spans, step and
  request spans from ``telemetry`` and ``serving``, markers as instant
  events, counters as counter events, the device's kernels);
  ``continuous_dump`` makes each dump drain the buffer and merge into the
  file.  ``otherData`` carries the dispatch counters, ``fault_seams`` and
  the ``telemetry`` snapshot.  ``dumps()`` returns the aggregate per-op
  table, the device kernels' table and the fault seams.
"""
from __future__ import annotations

import json
import os
import threading
import time

from .base import MXNetError

__all__ = ["set_config", "start", "stop", "dump", "dumps", "pause", "resume",
           "Task", "Frame", "Event", "Marker", "Counter", "Domain", "Scope"]

_CONFIG = {"filename": "profile.json", "profile_all": False,
           "profile_imperative": False, "dir": None, "device_trace": True,
           "continuous_dump": False}
_ACTIVE = False
_PAUSED = False
_LOCK = threading.Lock()
_EVENTS = []    # chrome trace events
_AGG = {}       # opname -> [count, total_s, min_s, max_s]
_KERNELS = {}   # device kernel name -> [count, total_us]
_T0 = None
_DUMPED_ONCE = False  # continuous_dump: later dumps merge into the file
# the running torch.profiler session: {"prof", "t_mark", "paused": [(t0,
# t1 or None), ...]} on the profiler's clock
_DEVICE = {"session": None}
_MARK = "mxnet_profiler_t0"
_DEVICE_PID = 1
_LEAD_IN = 256      # kernels that open a session (see the module doc)


def set_config(profile_all=False, profile_symbolic=False,
               profile_imperative=False, profile_memory=False,
               profile_api=False, filename="profile.json",
               continuous_dump=False, device_trace=True, **kwargs):
    """The reference's knobs; ``device_trace`` (the reference's
    ``jax_trace``, accepted under that name too) traces the card's kernels
    with ``torch.profiler``."""
    global _DUMPED_ONCE
    if "jax_trace" in kwargs:
        device_trace = kwargs.pop("jax_trace")
    _CONFIG.update(profile_all=profile_all, filename=filename,
                   profile_imperative=profile_imperative or profile_all,
                   device_trace=bool(device_trace),
                   continuous_dump=bool(continuous_dump))
    _CONFIG["dir"] = os.path.dirname(os.path.abspath(filename)) or "."
    _DUMPED_ONCE = False


def _record_op(opname, t0, t1):
    with _LOCK:
        _EVENTS.append({"name": opname, "ph": "X", "pid": 0,
                        "tid": threading.get_ident() % 1000,
                        "ts": (t0 - _T0) * 1e6, "dur": (t1 - t0) * 1e6,
                        "cat": "operator"})
        agg = _AGG.get(opname)
        dt = t1 - t0
        if agg is None:
            _AGG[opname] = [1, dt, dt, dt]
        else:
            agg[0] += 1
            agg[1] += dt
            agg[2] = min(agg[2], dt)
            agg[3] = max(agg[3], dt)


def _recording():
    return _T0 is not None and _ACTIVE and not _PAUSED


def _instant(name, cat):
    if not _recording():
        return
    with _LOCK:
        _EVENTS.append({"name": name, "ph": "i", "pid": 0, "s": "g",
                        "tid": threading.get_ident() % 1000,
                        "ts": (time.perf_counter() - _T0) * 1e6, "cat": cat})


def _record_span(name, t0, t1, cat="step_phase", tid=1000, args=None):
    """A step-phase, compile or request span into the Chrome trace (its own
    ``tid`` row, so it does not interleave with op events).  ``t0``/``t1``
    are perf_counter values, the clock of ``_T0``; ``args`` (JSON-able)
    lands on the event as it is."""
    if not _recording():
        return
    ev = {"name": name, "ph": "X", "pid": 0, "tid": tid,
          "ts": (t0 - _T0) * 1e6, "dur": (t1 - t0) * 1e6, "cat": cat}
    if args:
        ev["args"] = dict(args)
    with _LOCK:
        _EVENTS.append(ev)


def _counter(name, value):
    if not _recording():
        return
    with _LOCK:
        _EVENTS.append({"name": name, "ph": "C", "pid": 0,
                        "ts": (time.perf_counter() - _T0) * 1e6,
                        "args": {name: value}})


# --------------------------------------------------------------------------
# the device trace (torch.profiler over CUPTI)
# --------------------------------------------------------------------------
def _device_events(prof):
    """The session's kernels and copies on the card (a kernel shorter
    than the trace's microsecond has a zero-length range and counts)."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.events()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.name != _MARK]


def _lead_in():
    import torch

    t = torch.zeros(1, device="cuda")
    for _ in range(_LEAD_IN):
        t.add_(1)
    torch.cuda.synchronize()


def _mark_kernel():
    """The marker range and one tiny kernel inside it: the range puts the
    trace's clock on ours, the kernel is a device event every session
    holds, so an empty device trace means CUPTI recorded nothing."""
    import torch

    with torch.profiler.record_function(_MARK):
        t = time.perf_counter()
        torch.ones(1, device="cuda").add_(1)
    return t


def _probe_cupti():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _lead_in()
    if not _device_events(prof):
        raise MXNetError(
            "profiler.start(): torch.profiler recorded no device event on "
            "the card (CUPTI did not start); no trace is written without "
            "the card's kernels (set_config(device_trace=False) profiles "
            "the host alone)")


def _start_device_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise MXNetError(
            "profiler.start(): device_trace traces the card's kernels and "
            "needs a CUDA card; set_config(device_trace=False) profiles "
            "the host alone")
    _probe_cupti()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    _lead_in()
    _DEVICE["session"] = {"prof": prof, "t_mark": _mark_kernel(),
                          "paused": []}


def _collect_device_trace():
    """Stop the running torch.profiler session and move its device events
    into the trace (none from a paused interval).  Raises if the session
    holds no device event: CUPTI stopped recording."""
    import torch

    sess, _DEVICE["session"] = _DEVICE["session"], None
    if sess is None:
        return 0
    torch.cuda.synchronize()
    sess["prof"].stop()
    prof = sess["prof"]
    mark = next((ev for ev in prof.events() if ev.name == _MARK and
                 ev.device_type.name == "CPU"), None)
    device = _device_events(prof)
    # the lead-in ran (synchronised) before the marker's range began
    lead = sum(ev.time_range.start < mark.time_range.start
               for ev in device) if mark is not None else 0
    if not lead:
        raise MXNetError("profiler: CUPTI kept none of the session's "
                         f"{_LEAD_IN} lead-in kernels, so it may have "
                         "dropped the session's own device events; no "
                         "trace is written without them")
    device = [ev for ev in device
              if ev.time_range.start >= mark.time_range.start]
    # trace microseconds -> microseconds since _T0
    shift = (sess["t_mark"] - _T0) * 1e6 - mark.time_range.start
    paused = [((a - _T0) * 1e6, ((b if b is not None else time.perf_counter())
                                 - _T0) * 1e6) for a, b in sess["paused"]]
    n = 0
    with _LOCK:
        for ev in device:
            ts = ev.time_range.start + shift
            if any(a <= ts < b for a, b in paused):
                continue
            dur = ev.time_range.end - ev.time_range.start
            _EVENTS.append({"name": ev.name, "ph": "X", "pid": _DEVICE_PID,
                            "tid": int(getattr(ev, "device_index", 0) or 0),
                            "ts": ts, "dur": dur, "cat": "kernel"})
            agg = _KERNELS.setdefault(ev.name, [0, 0.0])
            agg[0] += 1
            agg[1] += dur
            n += 1
    return n


def start():
    """Start profiling: the op events of the ``invoke`` seam (when
    ``profile_imperative``), the spans of telemetry and serving, and with
    ``device_trace`` the card's kernels."""
    global _ACTIVE, _T0, _PAUSED, _DUMPED_ONCE
    from .ndarray.ndarray import _PROFILE

    if _ACTIVE:
        return
    _T0 = time.perf_counter()
    _PAUSED = False
    _DUMPED_ONCE = False  # a new session never merges into an old file
    if _CONFIG["device_trace"]:
        _start_device_trace()
    if _CONFIG.get("profile_imperative") or _CONFIG.get("profile_all"):
        _PROFILE["record"] = _record_op
        _PROFILE["on"] = True
    _ACTIVE = True


def stop():
    global _ACTIVE
    from .ndarray.ndarray import _PROFILE

    if not _ACTIVE:
        return
    _PROFILE["on"] = False
    _PROFILE["record"] = None
    _ACTIVE = False
    _collect_device_trace()


def pause():
    global _PAUSED
    from .ndarray.ndarray import _PROFILE

    if _ACTIVE and not _PAUSED and _DEVICE["session"] is not None:
        _DEVICE["session"]["paused"].append([time.perf_counter(), None])
    _PAUSED = True
    _PROFILE["on"] = False


def resume():
    global _PAUSED
    from .ndarray.ndarray import _PROFILE

    if not _ACTIVE:  # resume without a prior start() is a no-op
        return
    if _PAUSED and _DEVICE["session"] is not None and \
            _DEVICE["session"]["paused"]:
        _DEVICE["session"]["paused"][-1][1] = time.perf_counter()
    _PAUSED = False
    if _CONFIG.get("profile_imperative") or _CONFIG.get("profile_all"):
        _PROFILE["record"] = _record_op
        _PROFILE["on"] = True


def dump(finished=True, profile_process="worker", drain=None):
    """Write the Chrome traceEvents file (chrome://tracing, Perfetto).  A
    running session's device events are collected first (its
    torch.profiler session restarts).

    ``drain=True`` removes the written events from the buffer, so a later
    dump never writes them again.  Under ``set_config(continuous_dump=
    True)`` draining is implied and each dump merges its increment into
    the existing file: one growing trace without duplicates."""
    global _DUMPED_ONCE
    from . import fault as _fault
    from . import telemetry as _telemetry
    from .ndarray import dispatch_cache as _dc

    if _ACTIVE and _DEVICE["session"] is not None:
        paused = _PAUSED
        _collect_device_trace()
        _start_device_trace()
        if paused:
            _DEVICE["session"]["paused"].append([time.perf_counter(), None])
    if _CONFIG["continuous_dump"]:
        # the merge base is everything drained so far; events left in the
        # buffer while merging would be written twice
        drain = True
    elif drain is None:
        drain = False
    dstats = _dc.stats()
    with _LOCK:
        events = list(_EVENTS)
        if drain:
            _EVENTS.clear()
    if _CONFIG["continuous_dump"] and _DUMPED_ONCE and \
            os.path.exists(_CONFIG["filename"]):
        try:
            with open(_CONFIG["filename"]) as f:
                prior = json.load(f).get("traceEvents", [])
            events = prior + events
        except (OSError, ValueError):
            pass  # an unreadable prior dump: write this increment alone
    meta = [{"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "host"}}]
    if any(e.get("pid") == _DEVICE_PID for e in events):
        meta.append({"name": "process_name", "ph": "M", "pid": _DEVICE_PID,
                     "args": {"name": "device"}})
    events = [e for e in events if e.get("ph") != "M"]
    with open(_CONFIG["filename"], "w") as f:
        json.dump({"traceEvents": meta + events,
                   "displayTimeUnit": "ms",
                   "otherData": {
                       "device_trace": "torch.profiler (CUPTI): pid 1"
                       if _CONFIG["device_trace"] else "off",
                       "eager_dispatch_cache": {
                           k: dstats[k] for k in
                           ("enabled", "hits", "misses", "evictions",
                            "bypasses", "size", "capacity", "calls")},
                       "fault_seams": _fault.stats(),
                       "telemetry": _telemetry.snapshot()}}, f)
    _DUMPED_ONCE = True
    return _CONFIG["filename"]


def dumps(reset=False):
    """The aggregate per-op table (reference: profiler.dumps) with each
    op's dispatch count beside it, the device kernels' table and the
    fault seams.

    The Calls column is the dispatch counter's (every ``invoke`` since
    ``mx.nd.reset_dispatch_stats()``, profiling on or off), so it is not
    bounded by Total Count, which counts only while profiling, and
    ``reset=True`` does not clear it."""
    from . import fault as _fault
    from .ndarray import dispatch_cache as _dc

    dstats = _dc.stats()
    per_op = dstats["per_op"]
    with _LOCK:
        rows = [(name, a[0], a[1] * 1e3, a[2] * 1e3, a[3] * 1e3,
                 a[1] / a[0] * 1e3) for name, a in sorted(_AGG.items())]
        kernels = sorted(_KERNELS.items(), key=lambda kv: -kv[1][1])
        if reset:
            _AGG.clear()
            _EVENTS.clear()
            _KERNELS.clear()
    lines = ["Profile Statistics:",
             f"{'Name':<32}{'Total Count':>12}{'Total(ms)':>12}"
             f"{'Min(ms)':>10}{'Max(ms)':>10}{'Avg(ms)':>10}{'Calls':>8}"]
    for name, cnt, tot, mn, mx, avg in rows:
        calls = per_op.get(name, {}).get("calls", 0)
        lines.append(f"{name:<32}{cnt:>12}{tot:>12.3f}{mn:>10.3f}"
                     f"{mx:>10.3f}{avg:>10.3f}{calls:>8}")
    lines.append(
        f"Eager dispatch: calls={dstats['calls']} (every op runs eagerly: "
        "no jit cache, so no hits or misses; cumulative since "
        "reset_dispatch_stats; not scoped to profiling)")
    if kernels:
        lines.append(f"Device kernels:{'':<17}{'Count':>12}"
                     f"{'Total(ms)':>12}{'Avg(ms)':>10}")
        for name, (cnt, tot_us) in kernels:
            lines.append(f"  {name[:60]:<60}{cnt:>8}{tot_us / 1e3:>12.3f}"
                         f"{tot_us / cnt / 1e3:>10.4f}")
    # failure-domain counters: which seams saw traffic, trips and retries,
    # cumulative since fault.reset_stats()
    fstats = _fault.stats()
    lines.append(f"Fault seams:{'':<20}{'Calls':>12}{'Trips':>10}"
                 f"{'Retries':>10}")
    for seam in _fault.SEAMS:
        c = fstats[seam]
        lines.append(f"  {seam:<30}{c['calls']:>12}{c['trips']:>10}"
                     f"{c['retries']:>10}")
    return "\n".join(lines)


class Domain:
    def __init__(self, name):
        self.name = name


class _Scope:
    """A named range: a ``torch.profiler.record_function`` range (on the
    card's timeline too) and a ``scope:<name>`` row of the op table."""

    def __init__(self, name):
        self.name = name
        self._ctx = None
        self._t0 = None

    def start(self):
        import torch

        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None
        if self._t0 is not None and _recording():
            _record_op(f"scope:{self.name}", self._t0, time.perf_counter())
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()
        return False


class Task(_Scope):
    def __init__(self, domain=None, name="task"):
        super().__init__(name)


class Frame(_Scope):
    def __init__(self, domain=None, name="frame"):
        super().__init__(name)


class Event(_Scope):
    def __init__(self, name="event"):
        super().__init__(name)


class Marker:
    """Instant event in the trace (reference: profiler.Marker.mark)."""

    def __init__(self, domain=None, name="marker"):
        self.name = name

    def mark(self, scope="process"):
        _instant(self.name, "marker")


class Counter:
    """Named counter recorded into the trace (reference:
    profiler.Counter)."""

    def __init__(self, domain=None, name="counter", value=0):
        self.name = name
        self.value = value
        _counter(self.name, value)

    def set_value(self, value):
        self.value = value
        _counter(self.name, value)

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


Scope = _Scope
