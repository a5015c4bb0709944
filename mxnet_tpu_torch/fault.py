"""Deterministic fault injection and the transient-error retry policy
(counterpart of ``mxnet_tpu/fault.py``, ported whole).

Each seam is a named check-point called on a real code path; the seam
list is the reference's (``SEAMS``), so one ``MXNET_FAULT_SPEC`` parses the
same in both packages, even where the port has not reached the seam's code
path yet.  The seams the port's code calls today:

==========================  =================================================
``serving.admit``           serving-engine request admission (a tripped
                            admit requeues the request; nothing is lost)
``serving.decode_step``     serving-engine batched decode step, checked
                            BEFORE any KV/sequence mutation (the loop
                            absorbs the failure and retries the step)
``router.dispatch``         fleet router -> replica send (transport funnel;
                            retried under the fleet's retry budget, then
                            failed over to another replica)
``router.health_probe``     fleet health probe (a trip counts as a failed
                            probe in the replica's health record)
``fleet.spawn``             fleet manager replica spawn (retried)
``replica.crash``           a local replica's request path: a trip takes
                            the replica down mid-request
==========================  =================================================

Arming faults:

- env spec (``MXNET_FAULT_SPEC=serving.admit:fail:2`` fails the first 2
  calls with OSError; comma-separate entries; an optional 4th field names
  the exception class, ``serving.decode_step:fail:1:TimeoutError``);
- in code::

      with fault.inject("serving.decode_step", error=OSError, times=1):
          ...   # the next decode step trips, the loop retries it

``fault.stats()`` returns per-seam ``{"calls", "trips", "retries"}``
counters; ``telemetry`` exports them as ``mxnet_fault_seam_*_total``.  A
trip is also an event in the flight recorder's ring.

Retry policy: ``call_with_retries(seam, fn, ...)`` retries *transient*
errors (OSError and the "unavailable" family, matched by message) with
exponential backoff and full jitter, bounded by ``MXNET_FAULT_MAX_RETRIES``
(default 3) and seeded at ``MXNET_FAULT_BACKOFF_MS`` (default 100);
exhaustion raises ``MXNetError`` naming the seam and the knobs.
"""
from __future__ import annotations

import contextlib
import logging
import random as _random
import threading
import time

from . import env
from .base import MXNetError

__all__ = ["SEAMS", "check", "guard", "inject", "stats", "reset_stats",
           "reload_spec", "call_with_retries", "is_transient",
           "max_retries", "backoff_ms", "backoff_delay"]

SEAMS = ("checkpoint.write", "checkpoint.fsync", "checkpoint.publish",
         "dataloader.worker", "kvstore.push", "kvstore.pull",
         "collectives.allreduce", "distributed.init",
         "lifecycle.sigterm", "watchdog.stall",
         "serving.admit", "serving.decode_step", "resharding.transfer",
         "router.dispatch", "router.health_probe", "fleet.spawn",
         "replica.crash", "guard.check", "guard.rewind", "guard.canary")

_LOGGER = logging.getLogger(__name__)
_LOCK = threading.Lock()

# seam -> list of armed plans, consumed front-first.  A plan is a dict
# {"remaining": int, "error": type, "message": str}; env-spec plans and
# inject() plans share the list (inject pushes, env spec seeds).
_PLANS: dict = {}
_STATS = {s: {"calls": 0, "trips": 0, "retries": 0} for s in SEAMS}
_SPEC_LOADED = False

_ERROR_NAMES = {
    "OSError": OSError, "IOError": OSError, "ConnectionError":
    ConnectionError, "ConnectionResetError": ConnectionResetError,
    "TimeoutError": TimeoutError, "RuntimeError": RuntimeError,
    "ValueError": ValueError, "MXNetError": MXNetError,
}


def max_retries():
    """Bounded retry budget for transient errors
    (MXNET_FAULT_MAX_RETRIES, default 3)."""
    return max(0, env.get_int("MXNET_FAULT_MAX_RETRIES", 3))


def backoff_ms():
    """First-retry backoff in milliseconds; doubles per retry with full
    jitter (MXNET_FAULT_BACKOFF_MS, default 100)."""
    return max(0, env.get_int("MXNET_FAULT_BACKOFF_MS", 100))


def _parse_spec(spec):
    """``seam:mode:times[:Error][,...]`` -> {seam: [plan, ...]}.

    Unknown seams/modes/error names warn and are skipped — a typo'd spec
    must not silently disable the run's intended chaos NOR crash it."""
    plans: dict = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2 or parts[0] not in SEAMS or parts[1] != "fail":
            _LOGGER.warning("MXNET_FAULT_SPEC entry %r ignored (want "
                            "<seam>:fail[:times[:Error]] with seam in %s)",
                            entry, "/".join(SEAMS))
            continue
        try:
            times = int(parts[2]) if len(parts) > 2 and parts[2] else 1
        except ValueError:
            _LOGGER.warning("MXNET_FAULT_SPEC entry %r ignored (bad count)",
                            entry)
            continue
        error = _ERROR_NAMES.get(parts[3]) if len(parts) > 3 else OSError
        if error is None:
            _LOGGER.warning("MXNET_FAULT_SPEC entry %r ignored (unknown "
                            "error %r; known: %s)", entry, parts[3],
                            "/".join(sorted(_ERROR_NAMES)))
            continue
        plans.setdefault(parts[0], []).append(
            {"remaining": times, "error": error,
             "message": f"injected fault ({entry})"})
    return plans


def _ensure_spec_loaded():
    global _SPEC_LOADED
    if _SPEC_LOADED:
        return
    with _LOCK:
        if _SPEC_LOADED:
            return
        spec = env.get_str("MXNET_FAULT_SPEC")
        if spec:
            for seam, plans in _parse_spec(spec).items():
                _PLANS.setdefault(seam, []).extend(plans)
        _SPEC_LOADED = True


def reload_spec():
    """Drop all armed plans (env + inject) and re-read MXNET_FAULT_SPEC.
    Tests use this after monkeypatching the env var."""
    global _SPEC_LOADED
    with _LOCK:
        _PLANS.clear()
        _SPEC_LOADED = False
    _ensure_spec_loaded()


def check(seam):
    """The seam hook: called on the real code path.  Counts the call and
    raises the armed error while a plan has trips remaining."""
    if seam not in _STATS:
        raise MXNetError(f"unknown fault seam {seam!r}; known: "
                         f"{', '.join(SEAMS)}")
    _ensure_spec_loaded()
    with _LOCK:
        _STATS[seam]["calls"] += 1
        plans = _PLANS.get(seam)
        while plans:
            if plans[0]["remaining"] <= 0:
                plans.pop(0)
                continue
            plans[0]["remaining"] -= 1
            _STATS[seam]["trips"] += 1
            plan = plans[0]
            break
        else:
            return
    _flight_trip(seam, plan["message"])
    raise plan["error"](plan["message"])


def _flight_trip(seam, message):
    """Seam trip → flight-recorder context event (lazy + tolerant: the
    recorder is observability, a broken import must not change what the
    seam raises)."""
    try:
        from . import flight_recorder as _flight

        _flight.record_event("fault", seam=seam, message=str(message))
    except Exception:
        pass


@contextlib.contextmanager
def inject(seam, error=OSError, times=1, message=None):
    """Arm ``seam`` to raise ``error`` for the next ``times`` calls
    (within this process).  Disarms on exit even if untripped."""
    if seam not in _STATS:
        raise MXNetError(f"unknown fault seam {seam!r}; known: "
                         f"{', '.join(SEAMS)}")
    plan = {"remaining": times, "error": error,
            "message": message or f"injected fault at {seam}"}
    with _LOCK:
        _PLANS.setdefault(seam, []).append(plan)
    try:
        yield plan
    finally:
        with _LOCK:
            plans = _PLANS.get(seam, [])
            if plan in plans:
                plans.remove(plan)


def stats():
    """Per-seam counters: ``{seam: {"calls", "trips", "retries"}}``."""
    with _LOCK:
        return {s: dict(c) for s, c in _STATS.items()}


def reset_stats():
    with _LOCK:
        for c in _STATS.values():
            c.update(calls=0, trips=0, retries=0)


# -- transient-error retry policy ------------------------------------------
_TRANSIENT_MARKERS = ("unavailable", "deadline exceeded", "deadline_exceeded",
                      "connection reset", "connection refused",
                      "failed to connect", "socket closed", "broken pipe",
                      "preempt")


def is_transient(exc):
    """Errors worth retrying: host/network OSErrors and the "unavailable"
    family, matched by MESSAGE (a runtime error class that also wraps
    permanent failures carries its status only in the text).  MXNetError
    is never transient: it is this layer's own verdict."""
    if isinstance(exc, MXNetError):
        return False
    if isinstance(exc, (OSError, ConnectionError, TimeoutError)):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSIENT_MARKERS)


def backoff_delay(attempt, base_ms):
    """Delay in seconds for retry/restart number ``attempt`` (0-based):
    exponential with FULL jitter (uniform in [0, cap], cap doubling from
    ``base_ms`` up to 30s) — thundering herds of restarting workers must
    not re-synchronize on the coordinator.  Shared by the seam retries
    here and by the reference's checkpoint restart pacing."""
    cap = min(base_ms * (2 ** attempt), 30_000) / 1000.0
    return _random.uniform(0.0, cap) if cap > 0 else 0.0


def _sleep_backoff(seam, attempt, base_ms, logger, exc):
    delay = backoff_delay(attempt, base_ms)
    # the repr, not the exception: a handler that keeps records would keep
    # its traceback, and through it the frames' objects (a fleet replica
    # and its engine)
    (logger or _LOGGER).warning(
        "%s: transient failure (%s), retry %d in %.3fs",
        seam, repr(exc), attempt + 1, delay)
    if delay > 0:
        time.sleep(delay)


def call_with_retries(seam, fn, *args, retries=None, base_ms=None,
                      logger=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` through seam ``seam`` with bounded
    retries of transient errors (is_transient); injection at the seam is
    part of the retried region, so an armed transient fault is absorbed
    exactly like a real one.  Exhaustion raises MXNetError naming the
    seam; non-transient errors propagate immediately."""
    attempt = 0
    while True:
        try:
            check(seam)
            return fn(*args, **kwargs)
        except BaseException as e:
            if not is_transient(e):
                raise
            # knobs resolve lazily, on the FIRST failure: the happy path
            # (every production call with no fault) pays no environ reads
            if retries is None:
                retries = max_retries()
            if base_ms is None:
                base_ms = backoff_ms()
            if attempt >= retries:
                raise MXNetError(
                    f"{seam}: giving up after {retries} retries "
                    f"(last error: {e!r}); tune MXNET_FAULT_MAX_RETRIES / "
                    f"MXNET_FAULT_BACKOFF_MS") from e
            with _LOCK:
                _STATS[seam]["retries"] += 1
            _sleep_backoff(seam, attempt, base_ms, logger, e)
            attempt += 1


def _noop():
    return None


def guard(seam, **kwargs):
    """Pure seam guard: no payload function, just the injection point run
    under the retry policy.  Code paths whose real transport retry lives
    at a lower layer (e.g. kvstore push/pull over the collectives seam)
    use this so the harness can still trip and exercise them.

    Sits on hot paths (every kvstore push/pull), so the disarmed case is
    just a counter bump — no retry scaffolding, no environ reads."""
    _ensure_spec_loaded()
    if not _PLANS.get(seam):
        if seam not in _STATS:
            raise MXNetError(f"unknown fault seam {seam!r}; known: "
                             f"{', '.join(SEAMS)}")
        with _LOCK:
            _STATS[seam]["calls"] += 1
        return
    call_with_retries(seam, _noop, **kwargs)
