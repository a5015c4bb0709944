"""Per-request serving traces: a span tree per request with tail-based
retention (counterpart of ``mxnet_tpu/serving/tracing.py``).

Each request records its residency chain, **queue wait -> prefill ->
per-decode-step -> sample -> finish**, plus the events that explain
anomalies (eviction, requeue, deadline expiry), as a nestable span tree.
Recording is a host-side ``perf_counter`` read and a list append; a trace
is written by one thread at a time (the submitter before admission, the
engine loop after), so it takes no lock.  ``MXNET_TRACE_REQUESTS=0``
turns recording off.

Retention is tail-based: :class:`TraceStore` keeps the
``MXNET_TRACE_KEEP_SLOWEST`` slowest completed requests, every error /
evicted / expired one (a bounded ring), and a ring of recent completions.
The engine serves ``store.snapshot()`` at ``/v1/requests``.

A finished trace is also merged into the profiler's Chrome trace
(``RequestTrace.emit_chrome``, category ``serving_request``, one row per
request) whenever the profiler runs.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque

from .. import env as _env

__all__ = ["RequestTrace", "TraceStore"]

# spans/events per trace are bounded: a 32k-token generation (or a
# request requeue-churning behind a full pool for minutes) must not
# grow an unbounded list — past the cap, entries count, not accumulate
_MAX_SPANS = 1024
_MAX_EVENTS = 256


class RequestTrace:
    """One request's span tree + event list.

    Spans are ``[span_id, name, t0, t1, parent_id, attrs]`` on the
    perf_counter clock (the profiler's clock, so Chrome export aligns);
    ``span_id`` 0 is the implicit root covering submit → finish.
    Writers: exactly one thread at any moment (submitter, then the
    engine loop), so appends need no lock."""

    __slots__ = ("trace_id", "t0", "wall0", "spans", "events", "outcome",
                 "t_end", "dropped_spans", "dropped_events", "evicted",
                 "error", "last_enqueue_t", "_next_id")

    def __init__(self, trace_id):
        self.trace_id = trace_id
        self.t0 = time.perf_counter()
        # the engine bumps this on every (re-)enqueue so each
        # queue_wait span measures ITS wait, not time since submit
        self.last_enqueue_t = self.t0
        self.wall0 = time.time()
        self.spans: list = []
        self.events: list = []
        self.outcome = None
        self.t_end = None
        self.dropped_spans = 0
        self.dropped_events = 0
        self.evicted = False
        self.error = None
        self._next_id = itertools.count(1)

    # -- recording ---------------------------------------------------------
    def add_span(self, name, t0, t1, parent=0, **attrs):
        """Record a completed span; returns its id (parent for
        children).  Past the per-trace cap spans are counted, not
        kept — the tree stays bounded for any generation length."""
        if len(self.spans) >= _MAX_SPANS:
            self.dropped_spans += 1
            return 0
        sid = next(self._next_id)
        self.spans.append([sid, str(name), float(t0), float(t1),
                           int(parent), attrs or None])
        return sid

    def event(self, name, **attrs):
        """Record an instant event (eviction, requeue, deadline...).
        Bounded like spans — but the retention-relevant flags still
        update past the cap."""
        if name == "evicted":
            self.evicted = True
        if len(self.events) >= _MAX_EVENTS:
            self.dropped_events += 1
            return
        self.events.append([time.perf_counter(), str(name),
                            attrs or None])

    def finish(self, outcome, error=None):
        """Close the root span (idempotent — first outcome wins)."""
        if self.t_end is not None:
            return
        self.t_end = time.perf_counter()
        self.outcome = str(outcome)
        self.error = error

    def emit_chrome(self):
        """Merge this trace's spans into the profiler's Chrome trace (a
        no-op unless it runs).  Each request gets its own tid row, so
        concurrent requests do not interleave."""
        from .. import profiler as _prof

        tid = 2000 + (self.trace_id % 997)
        _prof._record_span(f"req{self.trace_id}", self.t0,
                           self.t_end or time.perf_counter(),
                           cat="serving_request", tid=tid,
                           args={"trace_id": self.trace_id,
                                 "outcome": self.outcome})
        for sid, name, t0, t1, parent, attrs in self.spans:
            _prof._record_span(f"req{self.trace_id}:{name}", t0, t1,
                               cat="serving_request", tid=tid, args=attrs)

    # -- views -------------------------------------------------------------
    @property
    def duration_s(self):
        return ((self.t_end if self.t_end is not None
                 else time.perf_counter()) - self.t0)

    def to_dict(self):
        """JSON-able nested span tree (children under their parents,
        times relative to submit in seconds)."""
        nodes = {0: {"name": "request", "t0": 0.0,
                     "dur_s": round(self.duration_s, 6), "children": []}}
        for sid, name, t0, t1, parent, attrs in self.spans:
            node = {"name": name, "t0": round(t0 - self.t0, 6),
                    "dur_s": round(t1 - t0, 6), "children": []}
            if attrs:
                node["attrs"] = attrs
            nodes[sid] = node
        for sid, name, t0, t1, parent, attrs in self.spans:
            nodes.get(parent, nodes[0])["children"].append(nodes[sid])
        return {
            "trace_id": self.trace_id,
            "time": self.wall0,
            "outcome": self.outcome,
            "error": repr(self.error) if self.error is not None else None,
            "duration_s": round(self.duration_s, 6),
            "evicted": self.evicted,
            "dropped_spans": self.dropped_spans,
            "dropped_events": self.dropped_events,
            "events": [{"t": round(t - self.t0, 6), "name": n,
                        **({"attrs": a} if a else {})}
                       for t, n, a in self.events],
            "tree": nodes[0],
        }


class TraceStore:
    """Completed-trace retention with a tail bias.

    Three overlapping buckets (deduped by trace id at export):

    - ``slowest`` — min-heap of the N slowest completed traces
      (``keep_slowest``, default ``MXNET_TRACE_KEEP_SLOWEST``): the
      p99 outlier is ALWAYS here, no matter how much healthy traffic
      followed it.
    - ``errors`` — every error / evicted / expired trace (bounded
      ring: anomalies are rare, but a misbehaving client must not
      evict the history of a real incident).
    - ``recent`` — plain ring of latest completions (the healthy
      baseline an outlier is diffed against)."""

    def __init__(self, keep_slowest=None, keep_recent=64,
                 keep_errors=64):
        self._n_slow = int(keep_slowest if keep_slowest is not None
                           else _env.trace_keep_slowest())
        self._slow: list = []            # min-heap of (dur, seq, trace)
        self._seq = itertools.count()
        self._recent: deque = deque(maxlen=int(keep_recent))
        self._errors: deque = deque(maxlen=int(keep_errors))
        self._lock = threading.Lock()
        self._added = 0

    def add(self, trace):
        """File one finished trace (engine loop / submitter thread)."""
        with self._lock:
            self._added += 1
            self._recent.append(trace)
            if trace.error is not None or trace.evicted:
                self._errors.append(trace)
            item = (trace.duration_s, next(self._seq), trace)
            if len(self._slow) < self._n_slow:
                heapq.heappush(self._slow, item)
            elif item[0] > self._slow[0][0]:
                heapq.heapreplace(self._slow, item)

    def count(self):
        """Total traces ever filed (cheap — stats()/dashboards poll
        this; the full span-tree dump is :meth:`snapshot`)."""
        with self._lock:
            return self._added

    def traces(self):
        """Retained traces, deduped, slowest-first, each tagged with
        the retention buckets that kept it."""
        with self._lock:
            tagged = {}
            for dur, _, tr in self._slow:
                tagged.setdefault(id(tr), [tr, set()])[1].add("slowest")
            for tr in self._errors:
                tagged.setdefault(id(tr), [tr, set()])[1].add("errors")
            for tr in self._recent:
                tagged.setdefault(id(tr), [tr, set()])[1].add("recent")
        out = [(tr, sorted(tags)) for tr, tags in tagged.values()]
        out.sort(key=lambda p: -p[0].duration_s)
        return out

    def snapshot(self):
        """JSON-able store dump (the ``/v1/requests`` payload)."""
        items = []
        for tr, tags in self.traces():
            d = tr.to_dict()
            d["retained_by"] = tags
            items.append(d)
        with self._lock:
            added = self._added
        return {
            "traced_requests": added,
            "retention": {"keep_slowest": self._n_slow,
                          "recent_ring": self._recent.maxlen,
                          "error_ring": self._errors.maxlen},
            "requests": items,
        }

    def clear(self):
        with self._lock:
            self._slow = []
            self._recent.clear()
            self._errors.clear()
            self._added = 0
