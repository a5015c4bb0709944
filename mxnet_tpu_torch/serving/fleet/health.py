"""Per-replica health: the HEALTHY -> SUSPECT -> EJECTED -> PROBING state
machine and the monitor thread that drives it (counterpart of
``mxnet_tpu/serving/fleet/health.py``).

The router never asks a replica at dispatch time whether it is healthy:
that would put a round trip on the request path.  Each replica carries a
:class:`ReplicaHealth` record, fed by three signals, and dispatch only
reads it:

- **dispatch outcomes**: every router-to-replica send reports success or
  failure; ``eject_threshold`` consecutive failures trip the circuit
  breaker (EJECTED);
- **heartbeats**: the :class:`HealthMonitor` polls each replica's stats
  through the ``router.health_probe`` seam every
  ``MXNET_FLEET_PROBE_INTERVAL_MS``; a failed probe counts like a failed
  dispatch, and the queue-depth / TTFT-p99 gauges it carries mark an
  overloaded but live replica SUSPECT (deprioritized, not ejected);
- **liveness**: a dead replica (a SIGKILLed process, a closed engine)
  fails its ``alive()`` check, so the first sweep after its death sees it.

Re-admission is half-open: after a cooldown (doubling per consecutive
ejection, reset by a full recovery) the replica moves to PROBING, where at
most ``probe_budget`` live requests may be in flight at once
(:meth:`ReplicaHealth.try_acquire_probe`); ``probe_successes`` consecutive
wins restore HEALTHY, any failure re-ejects with a longer cooldown.

No tensor library here; the clock is injectable so tests step the
transitions deterministically.
"""
from __future__ import annotations

import logging
import threading
import time

__all__ = ["HEALTHY", "SUSPECT", "EJECTED", "PROBING", "ReplicaHealth",
           "HealthMonitor"]

HEALTHY = "healthy"
SUSPECT = "suspect"
EJECTED = "ejected"
PROBING = "probing"

_LOGGER = logging.getLogger(__name__)


class ReplicaHealth:
    """One replica's health record (thread-safe; all signal sources —
    dispatcher threads, the monitor, the hedge path — write here)."""

    def __init__(self, eject_threshold=3, cooldown_s=0.5,
                 max_cooldown_s=30.0, probe_budget=2, probe_successes=2,
                 clock=time.monotonic):
        self.eject_threshold = max(1, int(eject_threshold))
        self.base_cooldown_s = float(cooldown_s)
        self.max_cooldown_s = float(max_cooldown_s)
        self.probe_budget = max(1, int(probe_budget))
        self.probe_successes = max(1, int(probe_successes))
        self._clock = clock
        self._lock = threading.Lock()
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.ejections = 0            # consecutive (resets on recovery)
        self.ejected_at = None
        self.last_heartbeat = clock()
        self.queue_depth = None
        self.ttft_p99 = None
        self._probe_ok = 0
        self._probe_inflight = 0
        self.transitions: list = []   # (t, from, to, reason) ring

    # -- transitions -------------------------------------------------------
    def _move(self, to, reason):
        if self.state == to:
            return
        self.transitions.append((self._clock(), self.state, to, reason))
        del self.transitions[:-64]
        _LOGGER.info("replica health: %s -> %s (%s)", self.state, to,
                     reason)
        self.state = to

    def note_success(self):
        """A dispatch or probe completed: SUSPECT recovers, PROBING
        counts toward the half-open quota."""
        with self._lock:
            self.consecutive_failures = 0
            if self.state == SUSPECT:
                self._move(HEALTHY, "success")
            elif self.state == PROBING:
                self._probe_ok += 1
                if self._probe_ok >= self.probe_successes:
                    self.ejections = 0
                    self._move(HEALTHY, f"{self._probe_ok} probe wins")

    def note_failure(self, reason="dispatch"):
        """A dispatch or probe failed.  Failure streaks trip the
        breaker; ANY failure while half-open re-ejects (with a doubled
        cooldown — the replica just proved it is not ready)."""
        with self._lock:
            self.consecutive_failures += 1
            if self.state == PROBING:
                self._eject(f"probe failure ({reason})")
            elif self.state in (HEALTHY, SUSPECT):
                if self.consecutive_failures >= self.eject_threshold:
                    self._eject(f"{self.consecutive_failures} consecutive "
                                f"failures ({reason})")
                else:
                    self._move(SUSPECT, reason)

    def note_suspect(self, reason):
        """Soft signal (overload gauges): deprioritize without counting
        toward ejection — the replica is alive, just slow."""
        with self._lock:
            if self.state == HEALTHY:
                self._move(SUSPECT, reason)

    def _eject(self, reason):
        # caller holds the lock
        self.ejections += 1
        self.ejected_at = self._clock()
        self._probe_ok = 0
        self._probe_inflight = 0
        self._move(EJECTED, reason)

    def note_heartbeat(self, queue_depth=None, ttft_p99=None):
        """A successful probe's payload: liveness stamp + load gauges
        (the monitor feeds these from /v1/serving stats)."""
        with self._lock:
            self.last_heartbeat = self._clock()
            if queue_depth is not None:
                self.queue_depth = int(queue_depth)
            if ttft_p99 is not None:
                self.ttft_p99 = float(ttft_p99)

    def cooldown_s(self):
        """Current ejection cooldown: doubles per consecutive ejection
        up to the cap (the same growth shape as the fault.py backoff,
        deterministic here — probes are already bounded traffic)."""
        n = max(0, self.ejections - 1)
        return min(self.base_cooldown_s * (2 ** n), self.max_cooldown_s)

    def tick(self):
        """Clock-driven transition: EJECTED → PROBING once the cooldown
        elapses.  Called by the monitor each probe interval."""
        with self._lock:
            if self.state == EJECTED and self.ejected_at is not None \
                    and self._clock() - self.ejected_at >= \
                    self.cooldown_s():
                self._probe_ok = 0
                self._probe_inflight = 0
                self._move(PROBING, f"cooldown {self.cooldown_s():.2f}s "
                           "elapsed")

    # -- dispatch gating ---------------------------------------------------
    def dispatchable(self):
        """May the router send this replica live traffic right now?
        HEALTHY/SUSPECT: yes.  PROBING: only within the probe budget
        (the caller must pair with try_acquire_probe).  EJECTED: no."""
        with self._lock:
            return self.state in (HEALTHY, SUSPECT) or (
                self.state == PROBING
                and self._probe_inflight < self.probe_budget)

    def try_acquire_probe(self):
        """Claim one slot of half-open probe traffic (True = granted).
        HEALTHY/SUSPECT replicas grant unconditionally — only PROBING
        meters."""
        with self._lock:
            if self.state in (HEALTHY, SUSPECT):
                return True
            if self.state == PROBING and \
                    self._probe_inflight < self.probe_budget:
                self._probe_inflight += 1
                return True
            return False

    def release_probe(self):
        with self._lock:
            if self._probe_inflight > 0:
                self._probe_inflight -= 1

    def snapshot(self):
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "ejections": self.ejections,
                "cooldown_s": self.cooldown_s(),
                "queue_depth": self.queue_depth,
                "ttft_p99": self.ttft_p99,
                "last_heartbeat_age_s": round(
                    self._clock() - self.last_heartbeat, 3),
            }


class HealthMonitor:
    """The probe thread: every ``interval_s`` it (a) checks each
    replica's process liveness, (b) GETs its stats through the
    ``router.health_probe`` seam, (c) feeds the health record, and
    (d) fires ``on_dead(replica)`` exactly once when a replica is gone
    (probe failed AND the process/flag says dead) so the router can
    resubmit its in-flight work and the manager can spawn a
    replacement.

    ``suspect_queue_depth`` / ``suspect_ttft_p99_s`` turn the
    heartbeat gauges into soft SUSPECT signals (overloaded ≠ broken).
    """

    def __init__(self, replicas, interval_s=0.25, on_dead=None,
                 on_sweep=None, suspect_queue_depth=32,
                 suspect_ttft_p99_s=None):
        self._replicas = replicas          # callable -> iterable of handles
        self.interval_s = float(interval_s)
        self._on_dead = on_dead
        self._on_sweep = on_sweep          # post-sweep bookkeeping hook
        self.suspect_queue_depth = suspect_queue_depth
        self.suspect_ttft_p99_s = suspect_ttft_p99_s
        self._stop = threading.Event()
        self._thread = None
        self._dead_fired: set = set()

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="mxnet-fleet-health", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def poll_once(self):
        """One probe sweep (the thread loop body; tests call it
        directly for deterministic stepping)."""
        for replica in list(self._replicas()):
            h = replica.health
            h.tick()
            if not replica.alive():
                h.note_failure(reason="process dead")
                self._fire_dead(replica)
                continue
            try:
                stats = replica.probe()
            except BaseException as e:
                h.note_failure(reason=f"probe: {e!r}")
                if not replica.alive():
                    self._fire_dead(replica)
                continue
            qd = stats.get("queue_depth") if stats else None
            p99 = ((stats.get("ttft_s") or {}).get("p99")
                   if stats else None)
            h.note_heartbeat(queue_depth=qd, ttft_p99=p99)
            h.note_success()
            if qd is not None and self.suspect_queue_depth and \
                    qd >= self.suspect_queue_depth:
                h.note_suspect(f"queue depth {qd}")
            if p99 is not None and self.suspect_ttft_p99_s and \
                    p99 >= self.suspect_ttft_p99_s:
                h.note_suspect(f"ttft p99 {p99:.3f}s")
        if self._on_sweep is not None:
            try:
                self._on_sweep()
            except Exception:
                _LOGGER.exception("health monitor on_sweep hook failed")

    def _fire_dead(self, replica):
        if id(replica) in self._dead_fired:
            return
        self._dead_fired.add(id(replica))
        _LOGGER.warning("fleet: replica %s detected dead", replica.rid)
        if self._on_dead is not None:
            try:
                self._on_dead(replica)
            except Exception:
                _LOGGER.exception("on_dead handler failed for %s",
                                  replica.rid)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:
                _LOGGER.exception("health monitor sweep failed")
