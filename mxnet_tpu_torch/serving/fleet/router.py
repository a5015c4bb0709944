"""The fleet router: reliable dispatch over N serving replicas (counterpart
of ``mxnet_tpu/serving/fleet/router.py``).

One router fronts N :class:`~mxnet_tpu_torch.serving.ServingEngine`
replicas, in this process (:class:`LocalReplica`) or in their own
processes (``manager.ProcessReplica``, over HTTP).  The router is host-side
control plane only: no tensor library, no device work.  What it adds over
a bare replica:

- **reliable dispatch**: every router-to-replica request carries the
  fleet request id and an absolute deadline; transient transport failures
  retry under ``MXNET_FLEET_RETRY_BUDGET`` (the fault plane's full-jitter
  policy), and a replica that fails mid-request gets the request failed
  over to a peer through the fair-share queue;
- **hedging**: a request still unanswered after the observed ~p99
  dispatch latency (floored by ``MXNET_FLEET_HEDGE_MS``) gets ONE
  duplicate on the next replica of its affinity order; the first
  completion claims the :class:`IdempotencyLedger` and the loser's result
  is dropped, so a completion is never delivered twice;
- **prefix affinity**: requests hash by prompt prefix
  (:func:`policy.rendezvous_order`); an ejection falls back to the next
  rank of the same order;
- **failure recovery**: the health monitor sees a dead replica at its
  first sweep after the death; its in-flight requests are popped and
  resubmitted to the survivors at the front of the queue, each at most
  once per death (the atomic ``try_requeue`` transition, and an attempt
  whose entry the death path popped does not requeue again);
- **graceful degradation**: per-tenant fair-share admission, and
  deadline-aware shedding: when the fleet-wide queue breaches the SLO
  depth (or the projected wait exceeds the caller's deadline), submit
  fails as a 429 with a Retry-After.

Chaos seams on every path: ``router.dispatch`` (transport funnel),
``router.health_probe`` (monitor), ``replica.crash`` (the local replica's
request path), ``fleet.spawn`` (manager).

Each finished request trace is merged into the profiler's Chrome trace
(``emit_chrome``) whenever the profiler runs.
"""
from __future__ import annotations

import itertools
import json
import logging
import threading
import time

from ... import env as _env
from ... import fault as _fault
from ... import lifecycle as _lifecycle
from ... import telemetry as _telemetry
from ...base import MXNetError
from ..scheduler import DeadlineExceededError, QueueFullError
from ..tracing import RequestTrace, TraceStore
from . import transport as _transport
from .health import EJECTED, HEALTHY, PROBING, SUSPECT, HealthMonitor, \
    ReplicaHealth
from .policy import Autoscaler, FairShareQueue, HedgePolicy, \
    SheddingPolicy, prefix_key, rendezvous_order

__all__ = ["FleetRequest", "FleetBusyError", "IdempotencyLedger",
           "ReplicaHandle", "LocalReplica", "Router"]

_LOGGER = logging.getLogger(__name__)

# -- metric families (README "Metric catalog" has the rows) ----------------
_C_DISPATCH = _telemetry.counter(
    "mxnet_fleet_dispatches_total",
    "router→replica dispatch attempts by outcome",
    labelnames=("outcome",))
_C_HEDGES = _telemetry.counter(
    "mxnet_fleet_hedges_total",
    "hedged duplicate requests by outcome (won = the hedge delivered)",
    labelnames=("outcome",))
_C_RESUBMITS = _telemetry.counter(
    "mxnet_fleet_resubmits_total",
    "in-flight requests resubmitted to survivors after a replica death")
_C_DUP = _telemetry.counter(
    "mxnet_fleet_duplicates_suppressed_total",
    "late/duplicate completions dropped by the idempotency ledger")
_C_SHED = _telemetry.counter(
    "mxnet_fleet_shed_total",
    "requests 429'd by deadline-aware shedding (Retry-After attached)")
_G_REPLICAS = _telemetry.gauge(
    "mxnet_fleet_replicas", "fleet replicas by health state",
    labelnames=("state",))
_G_FLEET_QUEUE = _telemetry.gauge(
    "mxnet_fleet_queue_depth",
    "requests waiting in the router's fair-share queue")
_H_DISPATCH = _telemetry.histogram(
    "mxnet_fleet_dispatch_seconds",
    "router→replica round-trip latency (successful dispatches; feeds "
    "the hedge-delay p99)")

_RID = itertools.count(1)


class FleetBusyError(QueueFullError):
    """Fleet-wide backpressure (HTTP 429): the queue SLO is breached
    or the projected wait exceeds the request's deadline.  Carries the
    drain-rate-derived ``retry_after_s``."""

    def __init__(self, message, retry_after_s):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class FleetRequest:
    """One request as the ROUTER sees it: payload + deadline + a
    three-state lifecycle (queued → inflight → done) whose transitions
    are atomic — that atomicity is what makes crash resubmission
    exactly-once (the death handler and a concurrently-failing
    dispatch thread both try ``try_requeue``; one wins)."""

    __slots__ = ("id", "tenant", "prompt", "max_new_tokens",
                 "temperature", "eos_id", "deadline", "submitted",
                 "affinity", "state", "result", "error", "attempts",
                 "hedges", "resubmits", "trace", "on_resolve", "_done",
                 "_state_lock", "finished_t")

    def __init__(self, prompt, tenant="default", max_new_tokens=16,
                 temperature=0.0, eos_id=None, deadline_ms=30_000):
        self.id = next(_RID)
        self.tenant = str(tenant)
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise MXNetError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        now = time.monotonic()
        self.submitted = now
        # EVERY fleet request has a deadline: an unbounded dispatch
        # would wedge a dispatcher thread on a dead replica forever
        self.deadline = now + max(1, int(deadline_ms)) / 1e3
        self.affinity = prefix_key(self.prompt)
        self.state = "queued"
        self.result = None
        self.error = None
        self.attempts = 0
        self.hedges = 0
        self.resubmits = 0
        self.trace = None
        self.on_resolve = None
        self.finished_t = None
        self._done = threading.Event()
        self._state_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def try_inflight(self):
        with self._state_lock:
            if self.state == "queued":
                self.state = "inflight"
                return True
            return False

    def try_requeue(self):
        """Atomically move inflight → queued (crash resubmission /
        dispatch failover).  Exactly one of the racing callers — the
        death handler popping the replica's in-flight set, or the
        dispatch thread seeing the connection die — wins."""
        with self._state_lock:
            if self.state == "inflight":
                self.state = "queued"
                return True
            return False

    def resolve(self, result=None, error=None):
        with self._state_lock:
            if self.state == "done":
                return False
            self.state = "done"
        self.result = result
        self.error = error
        self.finished_t = time.monotonic()
        hook = self.on_resolve
        if hook is not None:
            try:
                hook(self)
            except Exception:   # tracing must never fail a request
                pass
        self._done.set()
        return True

    def done(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        return self._done.wait(timeout)

    def expired(self, now=None):
        return (now if now is not None else time.monotonic()) > \
            self.deadline

    def remaining_s(self, now=None):
        return self.deadline - (now if now is not None
                                else time.monotonic())

    def response(self, timeout=None):
        """Block for the completion dict (raises the stored error)."""
        if not self.wait(timeout):
            raise MXNetError(f"fleet request {self.id}: no result "
                             f"within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class IdempotencyLedger:
    """At-most-once completion delivery, keyed on the fleet request
    id.  The FIRST ``claim(rid)`` wins the right to resolve the
    request; hedged duplicates, late responses from a replica that
    was presumed dead, and the router's own deadline path all lose
    and drop their result.  Bounded: oldest claims are pruned past
    ``cap`` (a claim only matters while its request can still race)."""

    def __init__(self, cap=8192):
        self._cap = int(cap)
        self._claimed: dict = {}      # rid -> insertion order
        self._order: list = []
        self._lock = threading.Lock()
        self.duplicates = 0

    def claim(self, rid):
        with self._lock:
            if rid in self._claimed:
                self.duplicates += 1
                return False
            self._claimed[rid] = True
            self._order.append(rid)
            while len(self._order) > self._cap:
                self._claimed.pop(self._order.pop(0), None)
            return True

    def stats(self):
        with self._lock:
            return {"claimed": len(self._claimed),
                    "duplicates_suppressed": self.duplicates}


class ReplicaHandle:
    """Base replica handle: identity, health record, and the
    in-flight map the crash-resubmission path drains.  Subclasses
    implement the transport (:class:`LocalReplica` in-process,
    ``manager.ProcessReplica`` over HTTP)."""

    def __init__(self, rid, eject_threshold=3, probe_interval_s=0.25):
        self.rid = str(rid)
        self.health = ReplicaHealth(
            eject_threshold=eject_threshold,
            cooldown_s=max(0.25, 2 * probe_interval_s))
        self._inflight: dict = {}     # attempt key -> request
        self._keys = itertools.count()
        self._if_lock = threading.Lock()

    def track(self, req):
        """Register one attempt of ``req`` in flight here; returns the
        attempt's key (a request may have two attempts on one replica: a
        stale one and its failover)."""
        with self._if_lock:
            key = next(self._keys)
            self._inflight[key] = req
        return key

    def untrack(self, key):
        """End an attempt; False when the death path already popped it
        (and so owns the request's resubmission)."""
        with self._if_lock:
            return self._inflight.pop(key, None) is not None

    def drain_inflight(self):
        """Pop EVERYTHING in flight (death path).  Popping, not copying,
        is what bounds resubmission: each request leaves this replica's
        map exactly once per death."""
        with self._if_lock:
            reqs = list({id(r): r for r in self._inflight.values()}
                        .values())
            self._inflight.clear()
        return reqs

    def inflight_count(self):
        with self._if_lock:
            return len(self._inflight)

    # subclass surface ----------------------------------------------------
    def alive(self):
        raise NotImplementedError

    def probe(self):
        raise NotImplementedError

    def submit(self, freq, retries=0):
        raise NotImplementedError

    def shutdown(self, drain=True, timeout=30):
        raise NotImplementedError

    def snapshot(self):
        return {"rid": self.rid, "alive": self.alive(),
                "inflight": self.inflight_count(),
                "health": self.health.snapshot()}


class LocalReplica(ReplicaHandle):
    """In-process replica: wraps a started :class:`ServingEngine` (one card
    holds several, their weights shared through
    ``ServingEngine.join_replica``).  The ``replica.crash`` chaos seam
    lives on its request path: an armed trip takes the handle dark
    mid-request, and the in-flight work is recovered by the same
    detect-and-resubmit machinery a SIGKILL exercises."""

    def __init__(self, rid, engine, **kw):
        super().__init__(rid, **kw)
        self._engine = engine
        self._alive = True

    @property
    def engine(self):
        return self._engine

    def alive(self):
        return self._alive and self._engine.running()

    def kill(self):
        """Simulated SIGKILL: the handle goes dark instantly; requests
        blocked inside resolve with an abort error, and closing the
        engine frees its KV pool (the weights it shares stay with the
        other replicas)."""
        self._alive = False
        try:
            self._engine.close(drain=False, timeout=5)
        except Exception:
            pass

    def probe(self):
        return _transport.call_local(
            self._probe_body, deadline=time.monotonic() + 1.0,
            seam="router.health_probe")

    def _probe_body(self):
        if not self.alive():
            raise ConnectionError(f"replica {self.rid} is down")
        return self._engine.stats()

    def submit(self, freq, retries=0):
        return _transport.call_local(
            self._submit_body, freq, deadline=freq.deadline,
            seam="router.dispatch", retries=retries)

    def _submit_body(self, freq):
        # the replica-side crash point: an armed trip takes the whole
        # replica down mid-request, exactly like a SIGKILL would —
        # the handle goes dark and the error surfaces as a transport
        # failure for the dispatch path to absorb
        try:
            _fault.check("replica.crash")
        except BaseException as e:
            self._alive = False
            raise ConnectionError(
                f"replica {self.rid} crashed mid-request ({e!r})") from e
        if not self.alive():
            raise ConnectionError(f"replica {self.rid} is down")
        req = self._engine.submit(
            freq.prompt, max_new_tokens=freq.max_new_tokens,
            temperature=freq.temperature, eos_id=freq.eos_id,
            deadline_ms=max(1, int(freq.remaining_s() * 1e3)),
            trace_id=freq.id)
        res = req.result(timeout=max(0.001, freq.remaining_s()))
        if req.trace is not None:
            res["trace"] = req.trace.to_dict()
        return res

    def shutdown(self, drain=True, timeout=30):
        self._alive = False
        try:
            self._engine.close(drain=drain, timeout=timeout)
        except Exception:
            pass


class Router:
    """The dispatch plane.  ``replicas`` is the initial handle list
    (the manager adds/removes live).  ``start()`` spins up the health
    monitor and ``dispatchers`` worker threads; ``submit()`` is the
    front door (`mount_http()` exposes it as ``/v1/completions``)."""

    def __init__(self, replicas=(), *, hedge_ms=None, retry_budget=None,
                 probe_interval_ms=None, queue_bound=256,
                 tenant_bound=64, shed_depth=None, tenant_weights=None,
                 default_deadline_ms=30_000, dispatchers=None,
                 manager=None, autoscale=None, trace_requests=None):
        self._replicas: list = list(replicas)
        self._rep_lock = threading.Lock()
        self._manager = manager
        self._retry_budget = retry_budget if retry_budget is not None \
            else _env.fleet_retry_budget()
        self._probe_interval_s = (
            probe_interval_ms if probe_interval_ms is not None
            else _env.fleet_probe_interval_ms()) / 1e3
        self._default_deadline_ms = int(default_deadline_ms)
        self._queue = FairShareQueue(queue_bound, tenant_bound,
                                     weights=tenant_weights)
        self._hedge = HedgePolicy(
            floor_ms=hedge_ms if hedge_ms is not None
            else _env.fleet_hedge_ms())
        self._ledger = IdempotencyLedger()
        self._shed = SheddingPolicy(
            slo_depth=shed_depth if shed_depth is not None
            else max(8, int(queue_bound) // 2))
        self._shed_episode = 0        # 429s in the current breach episode
        self._autoscaler = autoscale
        self._monitor = HealthMonitor(
            self.replicas, interval_s=self._probe_interval_s,
            on_dead=self._on_replica_dead, on_sweep=self._after_sweep)
        self._trace_enabled = bool(
            trace_requests if trace_requests is not None
            else _env.trace_requests())
        self._traces = TraceStore()
        self._n_dispatchers = int(dispatchers) if dispatchers else \
            max(2, 2 * max(1, len(self._replicas)))
        self._threads: list = []
        self._stop_evt = threading.Event()
        self._mounted: list = []

    # -- replica set -------------------------------------------------------
    def replicas(self):
        with self._rep_lock:
            return list(self._replicas)

    def add_replica(self, handle):
        with self._rep_lock:
            self._replicas.append(handle)

    def remove_replica(self, handle):
        with self._rep_lock:
            if handle in self._replicas:
                self._replicas.remove(handle)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._threads:
            return self
        self._stop_evt.clear()
        self._monitor.start()
        for i in range(self._n_dispatchers):
            t = threading.Thread(target=self._dispatch_loop,
                                 name=f"mxnet-fleet-dispatch-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        if self._autoscaler is not None:
            _lifecycle.register_goodput_breach_hook(
                self._autoscaler.note_goodput_breach)
        return self

    def close(self, drain=True, timeout=30):
        self._stop_evt.set()
        self._monitor.stop()
        if self._autoscaler is not None:
            _lifecycle.unregister_goodput_breach_hook(
                self._autoscaler.note_goodput_breach)
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []
        n = self._queue.drain(lambda r: MXNetError(
            f"fleet request {r.id} rejected: router shutting down"))
        for _ in range(n):
            _C_DISPATCH.labels(outcome="shutdown").inc()
        self.unmount_http()

    # -- front door --------------------------------------------------------
    def submit(self, prompt, tenant="default", max_new_tokens=16,
               temperature=0.0, eos_id=None, deadline_ms=None):
        """Admit one request into the fair-share queue.  Raises
        :class:`FleetBusyError` (429 + Retry-After) when the fleet
        queue breaches the SLO depth or the projected wait already
        exceeds the caller's deadline — shedding at admission, where
        the caller can still go elsewhere."""
        if self._stop_evt.is_set():
            raise MXNetError("fleet router is shutting down")
        deadline_ms = deadline_ms if deadline_ms is not None \
            else self._default_deadline_ms
        depth = len(self._queue)
        shed_reason = None
        if self._shed.should_shed(depth):
            shed_reason = f"fleet queue depth {depth} breaches the " \
                f"SLO ({self._shed.slo_depth})"
        else:
            rate = self._shed.drain_rate()
            if rate and depth / rate > deadline_ms / 1e3:
                shed_reason = (
                    f"projected wait {depth / rate:.1f}s exceeds the "
                    f"{deadline_ms / 1e3:.1f}s deadline")
        if shed_reason is not None:
            ra = self._shed.retry_after_s(depth)
            _C_SHED.inc()
            self._note_shed(depth)
            raise FleetBusyError(f"shed: {shed_reason}; retry after "
                                 f"{ra:.0f}s", retry_after_s=ra)
        req = FleetRequest(prompt, tenant=tenant,
                           max_new_tokens=max_new_tokens,
                           temperature=temperature, eos_id=eos_id,
                           deadline_ms=deadline_ms)
        if self._trace_enabled:
            req.trace = RequestTrace(req.id)
            req.trace.event("submitted", tenant=req.tenant,
                            prompt_len=len(req.prompt),
                            affinity=req.affinity)
            req.on_resolve = self._trace_finished
        self._queue.put(req, tenant=req.tenant)
        _G_FLEET_QUEUE.set(len(self._queue))
        return req

    def _note_shed(self, depth):
        # one lifecycle alert per breach EPISODE, not per shed request
        self._shed_episode += 1
        if self._shed_episode == 1:
            _lifecycle.note_fleet_queue_slo_breach(
                depth, self._shed.slo_depth, self._shed_episode)
        if self._autoscaler is not None:
            self._autoscaler.note_queue_breach(depth)

    # -- dispatch ----------------------------------------------------------
    def _dispatch_loop(self):
        while not self._stop_evt.is_set():
            req = self._queue.pop_ready(
                is_expired=lambda r: r.expired(),
                on_expire=self._expire)
            if req is None:
                self._queue.wait_nonempty(0.02)
                continue
            try:
                self._dispatch_one(req)
            except Exception as e:
                _LOGGER.exception("dispatch failed for request %s",
                                  req.id)
                if self._ledger.claim(req.id):
                    req.resolve(error=MXNetError(
                        f"fleet request {req.id} failed in dispatch: "
                        f"{e!r}"))
                    _C_DISPATCH.labels(outcome="error").inc()
            _G_FLEET_QUEUE.set(len(self._queue))

    def _expire(self, req):
        if self._ledger.claim(req.id):
            if req.trace is not None:
                req.trace.event("deadline_expired", where="fleet_queue")
            req.resolve(error=DeadlineExceededError(
                f"fleet request {req.id} expired after "
                f"{time.monotonic() - req.submitted:.3f}s in queue"))
            _C_DISPATCH.labels(outcome="expired").inc()

    def _pick_order(self, req):
        """Affinity-ordered dispatchable replicas: rendezvous rank of
        the prompt-prefix key, ejected/dead replicas filtered — the
        fallback when the warm home is ejected is simply the next
        rank, and it is the SAME for every request sharing the key."""
        reps = {r.rid: r for r in self.replicas()}
        order = rendezvous_order(req.affinity, sorted(reps))
        live = [reps[rid] for rid in order
                if reps[rid].alive() and reps[rid].health.dispatchable()]
        # SUSPECT replicas (overloaded or freshly failing) sink below
        # every non-suspect peer — stably, so rendezvous rank still
        # decides within each class
        return sorted(live, key=lambda r: r.health.state == SUSPECT)

    def _dispatch_one(self, req):
        tr = req.trace
        if tr is not None:
            tr.add_span("queue_wait", tr.last_enqueue_t,
                        time.perf_counter(), tenant=req.tenant)
        order = self._pick_order(req)
        if not order:
            if req.expired():
                self._expire(req)
                return
            # nothing dispatchable right now (all ejected / mid-spawn):
            # brief pause, then back to the FRONT — age order holds
            time.sleep(min(0.05, max(0.0, req.remaining_s())))
            if tr is not None:
                tr.event("requeued", reason="no dispatchable replica")
                tr.last_enqueue_t = time.perf_counter()
            self._queue.requeue(req, tenant=req.tenant)
            return
        if not req.try_inflight():
            return      # resolved while queued (expiry race)
        primary = order[0]
        t = threading.Thread(
            target=self._attempt, args=(req, primary, "primary"),
            name=f"mxnet-fleet-attempt-{req.id}", daemon=True)
        t.start()
        # the hedge window: wait ~p99; a healthy dispatch finishes
        # well inside it and no duplicate is ever sent
        hedged = False
        delay = min(self._hedge.delay_s(), max(0.0, req.remaining_s()))
        if not req.wait(delay) and not req.expired() \
                and req.state == "inflight" and len(order) > 1:
            req.hedges += 1
            hedged = True
            if tr is not None:
                tr.event("hedged", replica=order[1].rid,
                         after_s=round(delay, 4))
            self._attempt(req, order[1], "hedge")
        # ride out the deadline; a failed attempt may have requeued
        # the request (state back to "queued"), in which case another
        # dispatcher owns it from here
        while not req.done() and req.state == "inflight":
            if req.expired():
                if self._ledger.claim(req.id):
                    req.resolve(error=DeadlineExceededError(
                        f"fleet request {req.id} missed its deadline "
                        f"in dispatch (attempts={req.attempts}, "
                        f"hedged={hedged})"))
                    _C_DISPATCH.labels(outcome="expired").inc()
                break
            req.wait(0.02)

    def _attempt(self, req, replica, kind):
        """One router→replica try (primary or hedge).  Success claims
        the ledger; failure feeds the health breaker and — atomically,
        at most once — requeues the request for failover."""
        h = replica.health
        if not h.try_acquire_probe():
            # half-open budget exhausted: treat like a miss, failover
            if not req.done() and req.try_requeue():
                self._requeue_front(req, "probe budget")
            return
        key = replica.track(req)
        req.attempts += 1
        t0 = time.perf_counter()
        try:
            res = replica.submit(req, retries=self._retry_budget)
        except BaseException as e:
            owned = replica.untrack(key)
            h.release_probe()
            h.note_failure(reason=f"{kind}: {type(e).__name__}")
            _C_DISPATCH.labels(outcome="failed").inc()
            if kind == "hedge":
                _C_HEDGES.labels(outcome="failed").inc()
            if req.trace is not None:
                req.trace.event("dispatch_failed", replica=replica.rid,
                                kind=kind, error=repr(e)[:160])
            # an attempt the death path popped is resubmitted there: this
            # one must not requeue the request a second time
            if owned and not req.done() and req.try_requeue():
                self._requeue_front(req, f"dispatch failure on "
                                    f"{replica.rid}")
            return
        replica.untrack(key)
        h.release_probe()
        h.note_success()
        dt = time.perf_counter() - t0
        self._hedge.observe(dt)
        _H_DISPATCH.observe(dt)
        self._shed.note_completion()
        self._shed_episode = 0
        if self._ledger.claim(req.id):
            if req.trace is not None:
                attrs = {"replica": replica.rid, "kind": kind}
                rep_tree = res.pop("trace", None) if \
                    isinstance(res, dict) else None
                if rep_tree is not None:
                    # cross-process graft: the replica's span tree rides
                    # the dispatch span (its clock is the REPLICA's
                    # perf_counter — honest attachment, not a rebase)
                    attrs["replica_trace"] = rep_tree
                req.trace.add_span("dispatch", t0, time.perf_counter(),
                                   **attrs)
            req.resolve(result=res)
            _C_DISPATCH.labels(outcome="ok").inc()
            if kind == "hedge":
                _C_HEDGES.labels(outcome="won").inc()
        else:
            if isinstance(res, dict):
                res.pop("trace", None)
            _C_DUP.inc()
            if kind == "hedge":
                _C_HEDGES.labels(outcome="lost").inc()

    def _requeue_front(self, req, reason):
        if req.trace is not None:
            req.trace.event("requeued", reason=reason)
            req.trace.last_enqueue_t = time.perf_counter()
        self._queue.requeue(req, tenant=req.tenant)

    # -- failure recovery --------------------------------------------------
    def _on_replica_dead(self, replica):
        """Health monitor verdict: the replica is gone.  Pop its
        in-flight map and resubmit every unresolved request to the
        survivors — exactly once each (the pop removes it from this
        replica forever; ``try_requeue`` arbitrates against the racing
        dispatch thread)."""
        victims = replica.drain_inflight()
        n = 0
        for req in victims:
            if req.done():
                continue
            if req.try_requeue():
                n += 1
                req.resubmits += 1
                _C_RESUBMITS.inc()
                if req.trace is not None:
                    req.trace.event("resubmit_after_crash",
                                    replica=replica.rid)
                    req.trace.last_enqueue_t = time.perf_counter()
                self._queue.requeue(req, tenant=req.tenant)
        _LOGGER.warning(
            "fleet: replica %s dead; resubmitted %d in-flight "
            "request(s) to survivors", replica.rid, n)
        if self._manager is not None:
            self._manager.on_replica_dead(replica)

    # -- bookkeeping (health-monitor sweep cadence) ------------------------
    def _after_sweep(self):
        counts = {HEALTHY: 0, SUSPECT: 0, EJECTED: 0, PROBING: 0}
        for r in self.replicas():
            counts[r.health.state] = counts.get(r.health.state, 0) + 1
        for state, n in counts.items():
            _G_REPLICAS.labels(state=state).set(n)
        _G_FLEET_QUEUE.set(len(self._queue))
        if self._autoscaler is not None:
            self._autoscaler.note_tick(len(self._queue))

    # -- tracing -----------------------------------------------------------
    def _trace_finished(self, req):
        tr = req.trace
        if tr is None:
            return
        err = req.error
        if err is None:
            outcome = "done"
        elif isinstance(err, DeadlineExceededError):
            outcome = "expired"
        else:
            outcome = "error"
        tr.finish(outcome, error=err)
        self._traces.add(tr)
        tr.emit_chrome()

    # -- observability -----------------------------------------------------
    def stats(self):
        reps = self.replicas()
        return {
            "replicas": [r.snapshot() for r in reps],
            "queue_depth": len(self._queue),
            "queue_by_tenant": self._queue.depths(),
            "hedge_delay_s": round(self._hedge.delay_s(), 4),
            "retry_budget": self._retry_budget,
            "shed": {"slo_depth": self._shed.slo_depth,
                     "drain_rate": self._shed.drain_rate()},
            "ledger": self._ledger.stats(),
            "request_traces": {"enabled": self._trace_enabled,
                               "traced": self._traces.count()},
        }

    # -- HTTP plane --------------------------------------------------------
    def mount_http(self, prefix="/v1"):
        """Mount the fleet front door beside /metrics: POST
        ``{prefix}/completions`` (the same body schema a single
        replica serves, plus ``tenant``), GET ``{prefix}/fleet``
        (health/queue snapshot), GET ``{prefix}/requests`` (router
        trace store — each trace carries the grafted replica tree)."""
        comp, flt = prefix + "/completions", prefix + "/fleet"
        reqs = prefix + "/requests"
        _telemetry.register_http_route(comp, self._http_completions)
        _telemetry.register_http_route(flt, self._http_fleet)
        _telemetry.register_http_route(reqs, self._http_requests)
        self._mounted = [comp, flt, reqs]
        return self

    def unmount_http(self):
        for path in self._mounted:
            _telemetry.unregister_http_route(path)
        self._mounted = []

    def _http_fleet(self, method, path, query, body):
        return 200, "application/json", json.dumps(self.stats()).encode()

    def _http_requests(self, method, path, query, body):
        doc = self._traces.snapshot()
        doc["enabled"] = self._trace_enabled
        return 200, "application/json", json.dumps(doc).encode()

    def _http_completions(self, method, path, query, body):
        if method != "POST":
            return 405, "application/json", b'{"error": "POST only"}'
        try:
            data = json.loads(body or b"{}")
            prompt = data["prompt"]
        except (ValueError, KeyError) as e:
            return 400, "application/json", json.dumps(
                {"error": f"bad request: {e!r}"}).encode()
        try:
            req = self.submit(
                prompt, tenant=str(data.get("tenant", "default")),
                max_new_tokens=int(data.get("max_new_tokens", 16)),
                temperature=float(data.get("temperature", 0.0)),
                eos_id=data.get("eos_id"),
                deadline_ms=data.get("deadline_ms"))
        except FleetBusyError as e:
            return (429, "application/json",
                    json.dumps({"error": str(e),
                                "retry_after_s": e.retry_after_s}
                               ).encode(),
                    {"Retry-After": max(1, int(e.retry_after_s))})
        except QueueFullError as e:
            return (429, "application/json",
                    json.dumps({"error": str(e)}).encode(),
                    {"Retry-After": 1})
        except MXNetError as e:
            return 400, "application/json", json.dumps(
                {"error": str(e)}).encode()
        try:
            res = req.response(timeout=req.remaining_s() + 1.0)
        except DeadlineExceededError as e:
            return 408, "application/json", json.dumps(
                {"error": str(e)}).encode()
        except MXNetError as e:
            return 503, "application/json", json.dumps(
                {"error": str(e)}).encode()
        out = dict(res) if isinstance(res, dict) else {"result": res}
        out["fleet"] = {"request_id": req.id, "attempts": req.attempts,
                        "hedges": req.hedges,
                        "resubmits": req.resubmits}
        return 200, "application/json", json.dumps(out).encode()
