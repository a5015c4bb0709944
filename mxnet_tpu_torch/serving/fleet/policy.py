"""Router policy: fair-share admission, hedging, prefix affinity,
deadline-aware shedding and SLO-driven scaling (counterpart of
``mxnet_tpu/serving/fleet/policy.py``).

Host-side data structures only (no tensor library, no sockets:
``transport.py`` owns the wire), each unit-testable with an injected
clock:

- :class:`FairShareQueue`: deficit round robin across per-tenant FIFOs,
  with per-tenant and global bounds (the global bound is the backpressure
  signal the shedding policy watches);
- :class:`HedgePolicy`: the observed dispatch-latency tail becomes the
  hedge trigger (``MXNET_FLEET_HEDGE_MS`` floors the delay);
- :func:`rendezvous_order`: highest-random-weight hashing of the
  prompt-prefix key over replica ids, so shared-prompt traffic lands on
  the replica whose KV cache is warm, and an ejection falls back along the
  same order (blake2b through ``hashlib``: the same order as the
  reference's, bit for bit);
- :class:`SheddingPolicy`: admit or 429 from the fleet-wide queue depth
  against the SLO, with a Retry-After from the observed drain rate;
- :class:`Autoscaler`: debounced scale-up/down triggers (queue-SLO
  breaches, lifecycle goodput breaches, sustained idleness) into the
  manager's hooks.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque

from ..scheduler import QueueFullError

__all__ = ["FairShareQueue", "HedgePolicy", "prefix_key",
           "rendezvous_order", "SheddingPolicy", "Autoscaler"]


class FairShareQueue:
    """Deficit-round-robin admission across per-tenant FIFOs.

    Each tenant gets a deque and a deficit counter topped up by
    ``quantum × weight`` per service round; a request costs 1.  With
    equal weights this is strict round-robin between active tenants —
    a tenant submitting 1000 requests interleaves 1:1 with a tenant
    submitting 2, which is exactly the fairness ``AdmissionQueue``'s
    single FIFO cannot give.  ``requeue`` (crash resubmission /
    eviction) is bound-exempt and goes to the tenant's FRONT: that
    work was already admitted once."""

    def __init__(self, bound=256, tenant_bound=64, weights=None):
        self._bound = int(bound)
        self._tenant_bound = int(tenant_bound)
        self._weights = dict(weights or {})
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: OrderedDict = OrderedDict()   # tenant -> deque
        self._deficit: dict = {}
        self._total = 0

    def __len__(self):
        with self._lock:
            return self._total

    def depths(self):
        with self._lock:
            return {t: len(q) for t, q in self._queues.items()}

    def put(self, req, tenant="default"):
        with self._lock:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._deficit[tenant] = 0
            if self._total >= self._bound:
                raise QueueFullError(
                    f"fleet queue full ({self._bound} waiting)")
            if len(q) >= self._tenant_bound:
                raise QueueFullError(
                    f"tenant {tenant!r} queue full "
                    f"({self._tenant_bound} waiting)")
            q.append(req)
            self._total += 1
            self._cond.notify()

    def requeue(self, req, tenant="default"):
        """Front-of-line, bound-exempt re-admission (resubmit after a
        replica death, or a failed dispatch worth another pass)."""
        with self._lock:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._deficit[tenant] = 0
            q.appendleft(req)
            self._total += 1
            self._cond.notify()

    def pop_ready(self, is_expired=None, on_expire=None):
        """Next request in DRR order; entries failing ``is_expired``
        are handed to ``on_expire`` (outside the lock — the callback
        resolves futures and touches metrics) and skipped.  None when
        empty."""
        expired: list = []
        out = None
        with self._lock:
            while self._total > 0:
                req, _tenant = self._pop_drr()
                if req is None:
                    break
                if is_expired is not None and is_expired(req):
                    expired.append(req)
                    continue
                out = req
                break
        if on_expire is not None:
            for req in expired:
                on_expire(req)
        return out

    def _pop_drr(self):
        # caller holds the lock.  One full rotation visits every
        # non-empty tenant, topping deficits up by quantum×weight; the
        # first tenant whose deficit covers a cost-1 pop serves.
        for _ in range(2 * max(1, len(self._queues))):
            if not self._queues:
                return None, None
            tenant, q = next(iter(self._queues.items()))
            self._queues.move_to_end(tenant)
            if not q:
                continue
            self._deficit[tenant] += self._weights.get(tenant, 1)
            if self._deficit[tenant] >= 1:
                self._deficit[tenant] -= 1
                self._total -= 1
                return q.popleft(), tenant
        return None, None

    def wait_nonempty(self, timeout):
        with self._lock:
            if self._total:
                return True
            return self._cond.wait(timeout)

    def drain(self, error_factory):
        """Shutdown: resolve everything waiting with a clean error.  The
        error goes in by keyword: ``FleetRequest.resolve(result, error)``
        takes the result first (the reference passes the error there, so
        its waiting callers get the exception object back as a result)."""
        with self._lock:
            items = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            self._total = 0
        for req in items:
            req.resolve(error=error_factory(req))
        return len(items)


class HedgePolicy:
    """p99-derived hedge trigger over a trailing dispatch-latency
    window.  Below ``min_samples`` observations the delay is the floor
    alone (an empty window must not hedge every request at 0ms)."""

    def __init__(self, floor_ms=50, window=512, min_samples=16):
        self.floor_s = max(0, int(floor_ms)) / 1e3
        self.min_samples = int(min_samples)
        self._lats: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()

    def observe(self, dt_s):
        with self._lock:
            self._lats.append(float(dt_s))

    def delay_s(self):
        with self._lock:
            lats = sorted(self._lats)
        if len(lats) < self.min_samples:
            return self.floor_s
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
        return max(self.floor_s, p99)


def prefix_key(token_ids, k=16):
    """Affinity key for a prompt: digest of its first ``k`` tokens.
    Requests sharing a prompt prefix (system prompts, few-shot
    preambles) map to the same key, hence the same warm replica."""
    head = ",".join(str(int(t)) for t in list(token_ids)[:k])
    return hashlib.blake2b(head.encode(), digest_size=8).hexdigest()


def rendezvous_order(key, replica_ids):
    """Highest-random-weight ordering of ``replica_ids`` for ``key``:
    position 0 is the affinity home, position 1 the fallback when the
    home is ejected, and so on.  Removing one replica never reorders
    the others' relative ranks — traffic from a dead replica spreads
    without remapping everyone else's warm caches."""
    def score(rid):
        return hashlib.blake2b(f"{key}|{rid}".encode(),
                               digest_size=8).digest()

    return sorted(replica_ids, key=score, reverse=True)


class SheddingPolicy:
    """Deadline-aware admission gate on the FLEET-wide queue.

    Above ``slo_depth`` waiting requests the router stops admitting
    and answers 429 with a Retry-After derived from the observed drain
    rate (completions/s over a trailing window): an honest "come back
    when the backlog you see now has drained", clamped to
    [1, ``max_retry_after_s``]."""

    def __init__(self, slo_depth=128, window=128,
                 max_retry_after_s=30.0, clock=time.monotonic):
        self.slo_depth = int(slo_depth)
        self.max_retry_after_s = float(max_retry_after_s)
        self._clock = clock
        self._done_t: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()

    def note_completion(self):
        with self._lock:
            self._done_t.append(self._clock())

    def drain_rate(self):
        """Completions/s over the trailing window (None = no data)."""
        with self._lock:
            ts = list(self._done_t)
        if len(ts) < 2 or ts[-1] <= ts[0]:
            return None
        return (len(ts) - 1) / (ts[-1] - ts[0])

    def should_shed(self, queue_depth):
        return self.slo_depth > 0 and queue_depth >= self.slo_depth

    def retry_after_s(self, queue_depth):
        rate = self.drain_rate()
        if not rate:
            return 1.0
        return min(self.max_retry_after_s,
                   max(1.0, queue_depth / rate))


class Autoscaler:
    """Debounced scale-up/down decisions wired to the manager's hooks.

    Triggers:
    - ``note_queue_breach()`` — the shedding gate tripped (fleet queue
      over the SLO): scale up.
    - ``note_goodput_breach(ratio, slo, windows)`` — the lifecycle
      goodput-SLO alert (register via
      ``lifecycle.register_goodput_breach_hook``): scale up.
    - ``note_tick(queue_depth)`` — called each monitor sweep; after
      ``idle_ticks`` consecutive sweeps with an empty queue, scale
      down (the hook SIGTERM-drains one replica; never below
      ``min_replicas``).

    ``cooldown_s`` separates consecutive actions in either direction —
    a spawn takes seconds to warm, and reacting again before it lands
    just thrashes."""

    def __init__(self, scale_up=None, scale_down=None, min_replicas=1,
                 max_replicas=8, replica_count=None, cooldown_s=5.0,
                 idle_ticks=40, clock=time.monotonic):
        self._up = scale_up
        self._down = scale_down
        self._count = replica_count or (lambda: 0)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown_s = float(cooldown_s)
        self.idle_ticks = int(idle_ticks)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_action_t = None
        self._idle = 0
        self.actions: list = []       # (t, "up"/"down", reason) ring

    def _ready(self):
        return self._last_action_t is None or \
            self._clock() - self._last_action_t >= self.cooldown_s

    def _act(self, direction, reason, hook):
        with self._lock:
            if not self._ready():
                return False
            n = self._count()
            if direction == "up" and n >= self.max_replicas:
                return False
            if direction == "down" and n <= self.min_replicas:
                return False
            self._last_action_t = self._clock()
            self._idle = 0
            self.actions.append((self._last_action_t, direction, reason))
            del self.actions[:-64]
        if hook is not None:
            hook(reason)
        return True

    def note_queue_breach(self, depth=None):
        return self._act("up", f"queue SLO breach (depth {depth})",
                         self._up)

    def note_goodput_breach(self, ratio, slo, windows):
        return self._act(
            "up", f"goodput breach ({ratio:.3f} < {slo:.3f})", self._up)

    def note_tick(self, queue_depth):
        with self._lock:
            self._idle = self._idle + 1 if queue_depth == 0 else 0
            idle = self._idle
        if idle >= self.idle_ticks:
            return self._act("down", f"idle for {idle} sweeps",
                             self._down)
        return False
