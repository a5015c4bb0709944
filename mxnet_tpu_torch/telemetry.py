"""Runtime telemetry: the metrics registry, the step timeline, the goodput
ledger and the Prometheus/JSON/HTTP exporters (counterpart of
``mxnet_tpu/telemetry.py``, as far as the serving engine, the lifecycle
and the flight recorder use it).

- **Metrics registry**: process-wide, thread-safe Counter / Gauge /
  Histogram families with labels; get-or-create by name, and a second
  registration with another type or label set is refused.  Subsystems
  that keep their own counters (fault seams) are scraped through
  collectors at export time.
- **Step timeline**: ``step_begin()`` / ``phase(name)`` / ``step_end()``
  attribute each step's wall time to phases, innermost phase wins, so the
  phases of a step sum to its wall time.  Completed steps land in a
  bounded ring (``MXNET_TELEMETRY_TIMELINE_STEPS``, default 256).
- **Step heartbeat**: ``heartbeat()`` / ``last_heartbeat()``, beaten by
  ``step_begin`` / ``step_end``, ``lifecycle.check_stop`` and the
  checkpoint writer (read by the stall watchdog, which waits for the
  lifecycle plane's ``Watchdog``).
- **Goodput ledger** with the SLO alert (``MXNET_GOODPUT_SLO``), whose
  breach is a lifecycle event.
- **Exporters**: ``render_prometheus()``, ``snapshot()`` and a background
  HTTP endpoint (``start_http_server(port)`` or ``MXNET_TELEMETRY_PORT``)
  serving ``/metrics``, ``/snapshot`` and ``/healthz``, on which the
  serving engine mounts its routes (``register_http_route``).

- **Compile events**: ``compile_event()`` / ``compile_events()``, a bounded
  ring (``MXNET_TELEMETRY_COMPILE_EVENTS``, default 512) of the cached
  forwards a hybridized block builds (its CUDA-graph captures, the port's
  counterpart of the reference's jit traces), with their cause and
  seconds.

Not ported yet: the dispatch-cache collector (the port has no eager jit
cache), the snapshot's graph section, the Chrome-trace spans (the
profiler plane) and the cross-rank aggregation tick (``_agg_tick``, which
``check_stop`` calls in the reference: it comes with ``telemetry_agg``).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

from . import env as _env

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
           "exponential_buckets", "register_collector", "snapshot",
           "render_prometheus", "start_http_server", "stop_http_server",
           "register_http_route", "unregister_http_route",
           "step_begin", "step_end", "step_abort", "step_scope", "phase",
           "maybe_phase", "timeline", "heartbeat", "last_heartbeat",
           "goodput_note", "goodput_summary", "compile_event",
           "compile_events", "reset"]

_LOCK = threading.RLock()
_FAMILIES: dict = {}        # name -> _Family
_COLLECTORS: list = []      # zero-arg callables -> [family dict, ...]

# default duration buckets: 100µs .. ~13s, exponential
_TIME_BUCKETS = None  # filled after exponential_buckets is defined


def exponential_buckets(start, factor, count):
    """``count`` bucket upper bounds growing geometrically from ``start``
    (Prometheus-style; +Inf is implicit)."""
    out = []
    b = float(start)
    for _ in range(count):
        out.append(b)
        b *= factor
    return out


_TIME_BUCKETS = exponential_buckets(1e-4, 2.0, 18)


# --------------------------------------------------------------------------
# metric primitives
# --------------------------------------------------------------------------
class _Child:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0


class Counter(_Child):
    """Monotonic counter (family child)."""

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with _LOCK:
            self._value += amount

    @property
    def value(self):
        return self._value


class Gauge(_Child):
    """Settable value (family child)."""

    def set(self, value):
        with _LOCK:
            self._value = float(value)

    def inc(self, amount=1.0):
        with _LOCK:
            self._value += amount

    def dec(self, amount=1.0):
        with _LOCK:
            self._value -= amount

    @property
    def value(self):
        return self._value


class Histogram:
    """Histogram with cumulative-at-export buckets (family child)."""

    __slots__ = ("_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets=None):
        bs = sorted(float(b) for b in (buckets or _TIME_BUCKETS))
        self._buckets = bs
        self._counts = [0] * len(bs)
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        v = float(value)
        with _LOCK:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self._buckets):
                if v <= b:
                    self._counts[i] += 1
                    break

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def cumulative(self):
        """[(upper_bound, cumulative_count), ...] ending with +Inf."""
        out = []
        acc = 0
        with _LOCK:
            for b, c in zip(self._buckets, self._counts):
                acc += c
                out.append((b, acc))
            out.append((float("inf"), self._count))
        return out


class _Family:
    """A named metric family with fixed label names; children per label
    value tuple.  Unlabeled families proxy their single ``()`` child."""

    def __init__(self, name, help, mtype, labelnames=(), buckets=None):
        self.name = name
        self.help = help
        self.type = mtype
        self.labelnames = tuple(labelnames)
        self._buckets = buckets
        self._children: dict = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        if self.type == "counter":
            return Counter()
        if self.type == "gauge":
            return Gauge()
        return Histogram(self._buckets)

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass labels positionally or by name")
            values = tuple(str(kw[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}")
        with _LOCK:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
            return child

    # unlabeled convenience proxies
    def inc(self, amount=1.0):
        self._children[()].inc(amount)

    def set(self, value):
        self._children[()].set(value)

    def dec(self, amount=1.0):
        self._children[()].dec(amount)

    def observe(self, value):
        self._children[()].observe(value)

    @property
    def value(self):
        return self._children[()].value

    @property
    def count(self):
        return self._children[()].count

    @property
    def sum(self):
        return self._children[()].sum

    def cumulative(self):
        return self._children[()].cumulative()

    def remove(self, *values, **kw):
        """Drop one labeled child (stale-series cleanup — e.g. a
        re-published sharding plan's obsolete per-param rows; no-op when
        the label set was never created)."""
        if kw:
            if values:
                raise ValueError("pass labels positionally or by name")
            values = tuple(str(kw[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        with _LOCK:
            self._children.pop(values, None)

    def children(self):
        with _LOCK:
            return list(self._children.items())


def _get_or_create(name, help, mtype, labelnames=(), buckets=None):
    with _LOCK:
        fam = _FAMILIES.get(name)
        if fam is not None:
            if fam.type != mtype or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered with a different "
                    f"type/labels ({fam.type}{fam.labelnames} vs "
                    f"{mtype}{tuple(labelnames)})")
            return fam
        fam = _Family(name, help, mtype, labelnames, buckets)
        _FAMILIES[name] = fam
        return fam


def counter(name, help="", labelnames=()):
    """Get-or-create a Counter family."""
    return _get_or_create(name, help, "counter", labelnames)


def gauge(name, help="", labelnames=()):
    """Get-or-create a Gauge family."""
    return _get_or_create(name, help, "gauge", labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    """Get-or-create a Histogram family (default: exponential duration
    buckets 100µs..13s)."""
    return _get_or_create(name, help, "histogram", labelnames, buckets)


def register_collector(fn):
    """Register a zero-arg callable run at export time returning a list of
    ``{"name", "type", "help", "samples": [(labels_dict, value), ...]}``
    dicts — the scrape-time bridge for subsystems that keep their own
    counters (fault seams) so their hot paths never pay a
    second lock."""
    with _LOCK:
        _COLLECTORS.append(fn)
    return fn


# --------------------------------------------------------------------------
# step timeline
# --------------------------------------------------------------------------
_TIMELINE_CAP = max(1, _env.get_int("MXNET_TELEMETRY_TIMELINE_STEPS", 256))
_STEPS: deque = deque(maxlen=_TIMELINE_CAP)
_CUR = None          # active step: {"step", "t0", "wall0", "phases", "stack"}
_STEP_SEQ = [0]

_PHASE_HIST = histogram(
    "mxnet_step_phase_seconds",
    "per-step time attributed to each phase (exclusive of nested phases)",
    labelnames=("phase",))
_STEP_HIST = histogram("mxnet_step_seconds", "training step wall time")
_STEPS_TOTAL = counter("mxnet_steps_total", "completed timeline steps")

# goodput ledger: wall time classified into what the job was DOING.
# "productive" accrues automatically from the step timeline (step wall
# minus any in-step checkpoint phase); the non-productive buckets are
# noted by the lifecycle/recovery seams that own them (checkpoint
# saves, restart downtime, resharding transfers, stalls, rewinds).
# The ratio gauge is computed at export time by a collector so
# recording stays one counter add.
_GOODPUT = counter(
    "mxnet_goodput_seconds_total",
    "wall time by goodput bucket (productive = step wall minus in-step "
    "checkpoint time; checkpoint/restart/reshard/stall/rewind noted by "
    "their owning seams)", labelnames=("bucket",))


def goodput_note(bucket, seconds):
    """Charge ``seconds`` of wall time to a goodput ``bucket``
    (``checkpoint`` / ``restart`` / ``reshard`` / ``stall`` /
    ``rewind`` / caller-defined).  ``productive`` accrues automatically
    from the step timeline — loops never call this themselves."""
    if seconds > 0:
        _GOODPUT.labels(bucket=str(bucket)).inc(float(seconds))


def goodput_summary():
    """``{"buckets": {...seconds...}, "tracked_s", "productive_ratio"}``
    — productive wall time over everything the ledger has classified
    (``productive_ratio`` is None until anything was tracked)."""
    buckets = {}
    for values, child in _GOODPUT.children():
        buckets[values[0]] = child.value
    total = sum(buckets.values())
    prod = buckets.get("productive", 0.0)
    return {"buckets": buckets, "tracked_s": total,
            "productive_ratio": (prod / total) if total > 0 else None}


def _goodput_collector():
    s = goodput_summary()
    if s["productive_ratio"] is None:
        return []
    return [{"name": "mxnet_goodput_ratio", "type": "gauge",
             "help": "productive wall time over all ledger-classified "
                     "time (goodput)",
             "samples": [({}, s["productive_ratio"])]}]


def _flight_note(kind, **fields):
    """Context event into the flight-recorder ring (step boundaries) —
    lazy and failure-tolerant; a disabled recorder costs one module-dict
    lookup and a bool read."""
    try:
        from . import flight_recorder as _flight

        _flight.record_event(kind, **fields)
    except Exception:
        pass


# -- goodput SLO alerting ----------------------------------------------------
# a WINDOW is one completed timeline step: at each step_end the DELTA
# of the goodput ledger since the previous step is classified, and
# MXNET_GOODPUT_SLO_WINDOWS consecutive windows below MXNET_GOODPUT_SLO
# fire one alert (lifecycle event + counter + flight-recorder entry).
# The alert re-arms only after a window back at/above the SLO, so a
# sustained degradation fires once, not every step.
_SLO_BREACHES = counter(
    "mxnet_goodput_slo_breaches_total",
    "goodput-SLO alerts: productive ratio below MXNET_GOODPUT_SLO for "
    "MXNET_GOODPUT_SLO_WINDOWS consecutive windows")
_SLO_STATE = {"last": None, "below": 0, "fired": False}


def _goodput_slo_tick():
    slo = _env.goodput_slo()
    if slo <= 0:
        return
    s = goodput_summary()
    cur = (s["tracked_s"], s["buckets"].get("productive", 0.0))
    last = _SLO_STATE["last"]
    _SLO_STATE["last"] = cur
    if last is None:
        return
    d_total = cur[0] - last[0]
    d_prod = cur[1] - last[1]
    if d_total <= 0:
        return          # nothing classified since the last boundary
    ratio = d_prod / d_total
    if ratio >= slo:
        _SLO_STATE["below"] = 0
        _SLO_STATE["fired"] = False
        return
    _SLO_STATE["below"] += 1
    if _SLO_STATE["fired"] or \
            _SLO_STATE["below"] < _env.goodput_slo_windows():
        return
    _SLO_STATE["fired"] = True
    _SLO_BREACHES.inc()
    try:
        from . import lifecycle as _lc

        _lc.note_goodput_slo_breach(ratio, slo, _SLO_STATE["below"])
    except Exception:   # alerting must never break a step boundary
        pass


# the monotonic time of the last step-boundary activity, or None
_HEARTBEAT = [None]


def heartbeat():
    """Mark step-boundary liveness: one monotonic read and a store."""
    _HEARTBEAT[0] = time.monotonic()


def last_heartbeat():
    """Monotonic time of the last heartbeat, or None."""
    return _HEARTBEAT[0]


def step_begin(step=None):
    """Open a timeline step.  An unfinished previous step is finalized
    first (robustness beats strictness in a training loop)."""
    global _CUR
    heartbeat()
    with _LOCK:
        if _CUR is not None:
            _finalize_locked(time.perf_counter())
        if step is None:
            step = _STEP_SEQ[0]
        step = int(step)
        _STEP_SEQ[0] = step + 1
        _CUR = {"step": step, "t0": time.perf_counter(),
                "wall0": time.time(), "phases": {}, "stack": []}
    # return the local, not _CUR["step"]: a concurrent step_end/abort may
    # have nulled _CUR the instant the lock dropped
    _flight_note("step", event="begin", step=step)
    return step


def _finalize_locked(now):
    """Complete the active step (lock held).  Returns the record."""
    global _CUR
    cur = _CUR
    _CUR = None
    if cur is None:
        return None
    stack = cur["stack"]
    if stack:
        # only the innermost frame has unclaimed elapsed time: every outer
        # frame was charged (and left paused) when its inner frame entered
        name, t = stack[-1]
        cur["phases"][name] = cur["phases"].get(name, 0.0) + (now - t)
        del stack[:]
    wall = now - cur["t0"]
    phases = cur["phases"]
    other = wall - sum(phases.values())
    if other > 1e-9:
        phases["other"] = other
    rec = {"step": cur["step"], "time": cur["wall0"],
           "wall_s": wall, "phases": dict(phases)}
    _STEPS.append(rec)
    for pname, dt in phases.items():
        _PHASE_HIST.labels(phase=pname).observe(dt)
    _STEP_HIST.observe(wall)
    _STEPS_TOTAL.inc()
    # goodput: a step is productive time EXCEPT what it spent inside a
    # checkpoint save (that phase is charged to the checkpoint bucket by
    # the save path itself — charging it here too would double-count)
    prod = wall - phases.get("checkpoint", 0.0)
    if prod > 0:
        _GOODPUT.labels(bucket="productive").inc(prod)
    return rec


def step_end():
    """Close the active step; returns its record (phase durations sum to
    the step wall time — unattributed time lands in ``other``)."""
    heartbeat()
    with _LOCK:
        rec = _finalize_locked(time.perf_counter())
    if rec is not None:
        _flight_note("step", event="end", step=rec["step"],
                     wall_s=rec["wall_s"])
    _goodput_slo_tick()
    return rec


def step_abort():
    """Discard the active step without recording (e.g. the data phase hit
    StopIteration — there is no step)."""
    global _CUR
    with _LOCK:
        _CUR = None


class _PhaseScope:
    __slots__ = ("name", "_t0")

    def __init__(self, name):
        self.name = name
        self._t0 = None

    def __enter__(self):
        now = time.perf_counter()
        self._t0 = now
        with _LOCK:
            cur = _CUR
            if cur is not None:
                stack = cur["stack"]
                if stack:
                    # pause the outer phase: charge it up to now
                    oname, ot = stack[-1]
                    cur["phases"][oname] = \
                        cur["phases"].get(oname, 0.0) + (now - ot)
                    stack[-1][1] = now
                stack.append([self.name, now])
        return self

    def __exit__(self, *exc):
        now = time.perf_counter()
        with _LOCK:
            cur = _CUR
            if cur is not None and cur["stack"] \
                    and cur["stack"][-1][0] == self.name:
                _, t = cur["stack"].pop()
                cur["phases"][self.name] = \
                    cur["phases"].get(self.name, 0.0) + (now - t)
                if cur["stack"]:
                    cur["stack"][-1][1] = now  # outer phase resumes
            elif cur is None:
                # phase outside a step: still observable in the histogram
                _PHASE_HIST.labels(phase=self.name).observe(now - self._t0)
        return False


def phase(name):
    """Context manager attributing its (exclusive) duration to ``name`` in
    the active step; outside a step it records straight to the phase
    histogram."""
    return _PhaseScope(name)


class _NullScope:
    """Reusable no-op context for call sites with an opt-in telemetry flag
    (Trainer/Estimator): the disabled path pays one attribute read."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SCOPE = _NullScope()


def maybe_phase(enabled, name):
    """``phase(name)`` when ``enabled``, else a shared no-op scope."""
    return _PhaseScope(name) if enabled else _NULL_SCOPE


class _StepScope:
    def __init__(self, step):
        self._step = step

    def __enter__(self):
        return step_begin(self._step)

    def __exit__(self, *exc):
        step_end()
        return False


def step_scope(step=None):
    """``with telemetry.step_scope(): ...`` — begin/end a timeline step."""
    return _StepScope(step)


def timeline():
    """Completed step records, oldest first (bounded ring)."""
    with _LOCK:
        return [dict(r, phases=dict(r["phases"])) for r in _STEPS]


# --------------------------------------------------------------------------
# built-in collectors: fault seams and goodput (scraped, not mirrored)
# --------------------------------------------------------------------------
def _fault_collector():
    from . import fault as _fault

    s = _fault.stats()
    out = []
    for metric, help in (("calls", "seam traversals"),
                         ("trips", "injected/observed seam failures"),
                         ("retries", "transient-error retries")):
        out.append({
            "name": f"mxnet_fault_seam_{metric}_total", "type": "counter",
            "help": help,
            "samples": [({"seam": seam}, c[metric])
                        for seam, c in sorted(s.items())]})
    return out


register_collector(_fault_collector)
register_collector(_goodput_collector)


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------
def _collected_families():
    with _LOCK:
        collectors = list(_COLLECTORS)
    out = []
    for fn in collectors:
        try:
            out.extend(fn())
        except Exception:   # a broken collector must not kill the scrape
            continue
    return out


def _escape_label(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v):
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def render_prometheus():
    """Prometheus text exposition (version 0.0.4) of every registered
    family plus collector output."""
    lines = []
    with _LOCK:
        families = list(_FAMILIES.values())
    for fam in families:
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for values, child in fam.children():
            labels = dict(zip(fam.labelnames, values))
            if fam.type == "histogram":
                for le, cum in child.cumulative():
                    bl = dict(labels)
                    bl["le"] = _fmt_value(le)
                    lines.append(f"{fam.name}_bucket{_fmt_labels(bl)} {cum}")
                lines.append(f"{fam.name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(child.sum)}")
                lines.append(f"{fam.name}_count{_fmt_labels(labels)} "
                             f"{child.count}")
            else:
                lines.append(f"{fam.name}{_fmt_labels(labels)} "
                             f"{_fmt_value(child.value)}")
    for fd in _collected_families():
        lines.append(f"# HELP {fd['name']} {fd.get('help', '')}")
        lines.append(f"# TYPE {fd['name']} {fd['type']}")
        for labels, value in fd["samples"]:
            lines.append(f"{fd['name']}{_fmt_labels(labels)} "
                         f"{_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def snapshot():
    """JSON-able snapshot: every metric family (registered + collected),
    the step timeline and the goodput summary (the reference's compile
    and graph sections are not ported)."""
    metrics = {}
    with _LOCK:
        families = list(_FAMILIES.values())
    for fam in families:
        samples = []
        for values, child in fam.children():
            labels = dict(zip(fam.labelnames, values))
            if fam.type == "histogram":
                samples.append({
                    "labels": labels,
                    "buckets": {_fmt_value(le): cum
                                for le, cum in child.cumulative()},
                    "sum": child.sum, "count": child.count})
            else:
                samples.append({"labels": labels, "value": child.value})
        metrics[fam.name] = {"type": fam.type, "help": fam.help,
                             "samples": samples}
    for fd in _collected_families():
        metrics[fd["name"]] = {
            "type": fd["type"], "help": fd.get("help", ""),
            "samples": [{"labels": labels, "value": value}
                        for labels, value in fd["samples"]]}
    steps = timeline()
    phase_totals: dict = {}
    for rec in steps:
        for pname, dt in rec["phases"].items():
            phase_totals[pname] = phase_totals.get(pname, 0.0) + dt
    return {
        "time": time.time(),
        "metrics": metrics,
        "steps": steps,
        "step_phase_totals": phase_totals,
        "goodput": goodput_summary(),
    }


def reset():
    """Zero every registered family and clear the timeline (test
    isolation; collectors' sources have their own reset_stats)."""
    global _CUR
    with _LOCK:
        for fam in _FAMILIES.values():
            for values in list(fam._children):
                fam._children[values] = fam._new_child()
            if not fam.labelnames:
                fam._children.setdefault((), fam._new_child())
        _STEPS.clear()
        _COMPILE_EVENTS.clear()
        _CUR = None
        _STEP_SEQ[0] = 0
        _SLO_STATE.update(last=None, below=0, fired=False)


# --------------------------------------------------------------------------
# compile events: the cached forwards of hybridized blocks
# --------------------------------------------------------------------------
_COMPILE_CAP = max(1, _env.get_int("MXNET_TELEMETRY_COMPILE_EVENTS", 512))
_COMPILE_EVENTS: deque = deque(maxlen=_COMPILE_CAP)
_COMPILES_TOTAL = counter(
    "mxnet_compile_events_total",
    "cached forwards built by kind (block) and cause",
    labelnames=("kind", "cause"))
_COMPILE_HIST = histogram(
    "mxnet_compile_seconds",
    "seconds to build a cached forward (warm-up and CUDA-graph capture)",
    labelnames=("kind",))


def compile_event(kind, name, elapsed_s, cause, **extra):
    """Record one cached forward built.  ``kind``: ``block`` (a hybridized
    Gluon block's cache entry); ``cause``: ``new_block`` (its first entry)
    or ``new_signature`` (another input signature, train or record mode,
    AMP target, or an invalidated cache); ``extra`` (``graph=
    "cuda_graph"`` or ``"functional"``) lands on the record as is."""
    with _LOCK:
        _COMPILE_EVENTS.append(dict({"kind": kind, "name": name,
                                     "elapsed_s": float(elapsed_s),
                                     "cause": cause, "time": time.time()},
                                    **extra))
    _COMPILES_TOTAL.labels(kind=kind, cause=cause).inc()
    _COMPILE_HIST.labels(kind=kind).observe(elapsed_s)
    _flight_note("compile", name=str(name), compile_kind=str(kind),
                 cause=str(cause), elapsed_s=float(elapsed_s))


def compile_events():
    """The recorded compile events, oldest first."""
    with _LOCK:
        return [dict(e) for e in _COMPILE_EVENTS]


# --------------------------------------------------------------------------
# HTTP endpoint (opt-in: MXNET_TELEMETRY_PORT or start_http_server)
# --------------------------------------------------------------------------
_HTTP_SERVER = None
_HTTP_THREAD = None
_HTTP_ROUTES: dict = {}   # path -> handler(method, path, query, body_bytes)


def register_http_route(path, handler):
    """Mount an application route on the telemetry endpoint.

    ``handler(method, path, query, body_bytes) -> (status, content_type,
    body_bytes[, headers_dict])`` is called for GET and POST requests
    whose path matches exactly; the optional 4th element carries extra
    response headers (the fleet router's 429 Retry-After rides it).
    This is how the serving plane (:mod:`mxnet_tpu_torch.serving`)
    exposes its inference API beside ``/metrics`` — one 127.0.0.1 server
    per process, one port to scrape and to query.  Routes registered
    after the server started are live immediately (the handler resolves
    them per request).  Built-in paths (``/metrics``, ``/snapshot``,
    ``/healthz``) cannot be shadowed."""
    with _LOCK:
        _HTTP_ROUTES[path] = handler


def unregister_http_route(path):
    """Remove a mounted route (idempotent)."""
    with _LOCK:
        _HTTP_ROUTES.pop(path, None)


def _dispatch_route(method, path, query, body):
    with _LOCK:
        handler = _HTTP_ROUTES.get(path)
    if handler is None:
        return None
    try:
        return handler(method, path, query, body)
    except Exception as e:   # a broken app route must not kill the server
        return (500, "text/plain",
                f"route {path} failed: {e!r}\n".encode())


def start_http_server(port=None, addr="127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text), ``/snapshot`` (JSON), and
    ``/healthz`` on a daemon thread.  ``port=0`` picks a free port; the
    bound port is on the returned server (``server_address[1]``).
    Idempotent: a second call returns the running server."""
    global _HTTP_SERVER, _HTTP_THREAD
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if port is None:
        port = _env.get_int("MXNET_TELEMETRY_PORT", 0)

    class _Handler(BaseHTTPRequestHandler):
        def _reply(self, status, ctype, body, headers=None):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path in ("/metrics", "/"):
                self._reply(200, "text/plain; version=0.0.4; charset=utf-8",
                            render_prometheus().encode())
            elif path in ("/snapshot", "/json"):
                self._reply(200, "application/json",
                            json.dumps(snapshot()).encode())
            elif path == "/healthz":
                self._reply(200, "text/plain", b"ok\n")
            else:
                out = _dispatch_route("GET", path, query, b"")
                if out is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self._reply(*out)

        def do_POST(self):
            path, _, query = self.path.partition("?")
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            out = _dispatch_route("POST", path, query, body)
            if out is None:
                self.send_response(404)
                self.end_headers()
                return
            self._reply(*out)

        def log_message(self, *a):   # no per-scrape stderr spam
            pass

    # check-and-create under one lock section: two racing callers must not
    # each bind a server (the loser's socket/thread would leak unreachable)
    with _LOCK:
        if _HTTP_SERVER is not None:
            return _HTTP_SERVER
        server = ThreadingHTTPServer((addr, int(port)), _Handler)
        server.daemon_threads = True
        thread = threading.Thread(target=server.serve_forever,
                                  name="mxnet-telemetry-http", daemon=True)
        thread.start()
        _HTTP_SERVER, _HTTP_THREAD = server, thread
        return server


def stop_http_server():
    """Shut the background endpoint down (idempotent)."""
    global _HTTP_SERVER, _HTTP_THREAD
    with _LOCK:
        server, thread = _HTTP_SERVER, _HTTP_THREAD
        _HTTP_SERVER = _HTTP_THREAD = None
    if server is not None:
        server.shutdown()
        server.server_close()
    if thread is not None:
        thread.join(timeout=5)
