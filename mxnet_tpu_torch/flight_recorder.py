"""Flight recorder: a per-rank ring of collective calls and context
events, with black-box dumps (counterpart of ``mxnet_tpu/flight_recorder.py``,
ported whole).

- **Always-on preallocated ring** (``MXNET_FLIGHT_RECORDER``, default on;
  ``MXNET_FLIGHT_RECORDER_CAP`` slots, default 4096).  Recording is one
  short lock section and one dict build, all on the host.
- **Collective ledger**: :func:`collective` stamps a call site with a
  monotonic per-rank sequence number and a digest-stable tag of
  ``(op, shape, dtype, axis, generation)``, with separate entry and exit
  stamps; ``mxnet_collective_ledger_position`` exports the position.
  (The port's multi-card collectives are not written yet; the ledger is
  here for them.)
- **Context events** ride the same ring: step boundaries, fault-seam
  trips, lifecycle transitions (stop requests, SLO breaches, a serving
  loop that keeps failing).
- **Black-box dumps**: on an abnormal event each rank atomically writes
  its ring as ``blackbox.rank<N>.json`` into ``MXNET_FLIGHT_DIR`` (default
  ``MXNET_TELEMETRY_AGG_DIR``).  Never a collective: each rank dumps
  alone, and the files are merged offline.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time

from . import env as _env
from . import telemetry as _telemetry

__all__ = ["enabled", "configure", "collective", "record_event",
           "position", "snapshot_doc", "dump_blackbox", "reset",
           "BLACKBOX_PREFIX"]

BLACKBOX_PREFIX = "blackbox.rank"

_LOCK = threading.Lock()
_STATE = {
    "enabled": None,      # None = resolve from env on first use
    "cap": None,
    "rank": None,
    "world": None,
}
_RING: list = []          # preallocated slots, written at _POS % cap
_POS = [0]                # total events ever recorded
_SEQ = [0]                # collective sequence counter (monotonic)

_POSITION = _telemetry.gauge(
    "mxnet_collective_ledger_position",
    "monotonic per-rank collective sequence number (flight recorder); "
    "cross-rank skew of this gauge is a pre-hang signal")
_DUMPS = _telemetry.counter(
    "mxnet_flight_dumps_total",
    "black-box ring dumps written, by abnormal-exit reason",
    labelnames=("reason",))


def _ensure():
    """Resolve config lazily (lock held by callers or benign to race:
    worst case two threads build the same ring)."""
    if _STATE["enabled"] is None:
        with _LOCK:
            if _STATE["enabled"] is None:
                _STATE["cap"] = _env.flight_recorder_cap()
                _STATE["rank"] = _env.launcher_rank()
                _STATE["world"] = _env.launcher_world()
                del _RING[:]
                _RING.extend([None] * _STATE["cap"])
                # set "enabled" LAST: it is the lock-free fast-path gate
                _STATE["enabled"] = _env.flight_recorder_enabled()
    return _STATE["enabled"]


def enabled():
    """Whether the recorder is on (``MXNET_FLIGHT_RECORDER``, default
    1; resolved once — :func:`reset` re-reads the env)."""
    return _ensure()


def configure(enabled=None, capacity=None, rank=None, world=None):
    """Explicit (re)configuration — tests and embedders; production
    config comes from the env knobs.  Clears the ring."""
    with _LOCK:
        _STATE["enabled"] = _env.flight_recorder_enabled() \
            if enabled is None else bool(enabled)
        _STATE["cap"] = max(8, int(capacity)) if capacity is not None \
            else _env.flight_recorder_cap()
        _STATE["rank"] = _env.launcher_rank() if rank is None else int(rank)
        _STATE["world"] = _env.launcher_world() if world is None \
            else int(world)
        del _RING[:]
        _RING.extend([None] * _STATE["cap"])
        _POS[0] = 0
        _SEQ[0] = 0
    return dict(_STATE)


def reset():
    """Drop all state; next use re-resolves from the environment
    (test isolation, bench A/B arms)."""
    with _LOCK:
        _STATE.update(enabled=None, cap=None, rank=None, world=None)
        del _RING[:]
        _POS[0] = 0
        _SEQ[0] = 0


def _append_locked(entry):
    _RING[_POS[0] % _STATE["cap"]] = entry
    _POS[0] += 1


def record_event(kind, **fields):
    """Append one context event (``step`` / ``fault`` / ``compile`` /
    ``lifecycle`` / caller-defined) to the ring.  Disabled = one dict
    read."""
    if not _ensure():
        return
    entry = dict(fields)
    entry["kind"] = str(kind)
    entry["t"] = time.perf_counter()
    with _LOCK:
        _append_locked(entry)


def tag_of(op, shape=None, dtype=None, axis=None, generation=None):
    """The digest-stable collective tag: a readable string plus a short
    sha256 digest of the same fields, identical on every rank that makes
    the same collective (the offline merge aligns ranks by it)."""
    parts = [str(op)]
    if shape is not None:
        parts.append("x".join(str(int(d)) for d in tuple(shape)))
    if dtype is not None:
        parts.append(str(dtype))
    if axis is not None:
        parts.append(str(axis))
    if generation is not None:
        parts.append(f"g{generation}")
    tag = ":".join(parts)
    digest = hashlib.sha256(tag.encode()).hexdigest()[:12]
    return tag, digest


class _Collective:
    """One stamped collective: enter allocates the sequence number and
    the ring entry; exit stamps completion (or the error)."""

    __slots__ = ("_entry",)

    def __init__(self, op, shape, dtype, axis, generation):
        tag, digest = tag_of(op, shape, dtype, axis, generation)
        entry = {"kind": "collective", "op": str(op), "tag": tag,
                 "digest": digest, "t0": time.perf_counter()}
        if generation is not None:
            entry["gen"] = str(generation)
        with _LOCK:
            _SEQ[0] += 1
            entry["seq"] = _SEQ[0]
            _append_locked(entry)
        self._entry = entry
        _POSITION.set(entry["seq"])

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # exit mutates the entry in place (if the ring wrapped past it
        # the dict is simply no longer referenced) — under _LOCK: the
        # watchdog thread's snapshot_doc may be copying this very dict
        # while the main thread exits a collective, and inserting a key
        # mid-iteration would raise, silently costing the black box
        t1 = time.perf_counter()
        err = repr(exc)[:200] if exc is not None else None
        with _LOCK:
            self._entry["t1"] = t1
            if err is not None:
                self._entry["error"] = err
        return False


class _NullCollective:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCollective()


def collective(op, shape=None, dtype=None, axis=None, generation=None):
    """Context manager stamping one collective call: enter records the
    next per-rank sequence number + the tag digest, exit records
    completion.  Wrap the *Python call point* — the call that
    dispatches the collective (see the module docstring for the async
    exit-stamp semantics).  Disabled = a shared no-op scope."""
    if not _ensure():
        return _NULL
    return _Collective(op, shape, dtype, axis, generation)


def position():
    """The current collective sequence number (0 before any stamp)."""
    return _SEQ[0]


def snapshot_doc():
    """The ring as a JSON-able document (in record order, oldest
    first): rank/world identity, ledger position, and every retained
    event.  Pure read — safe from any thread, including the watchdog's
    while the main thread is wedged."""
    _ensure()
    with _LOCK:
        pos, cap = _POS[0], _STATE["cap"]
        if pos <= cap:
            events = [dict(e) for e in _RING[:pos]]
        else:
            cut = pos % cap
            events = [dict(e) for e in _RING[cut:] + _RING[:cut]]
        return {
            "format": 1,
            "rank": _STATE["rank"],
            "world": _STATE["world"],
            "enabled": bool(_STATE["enabled"]),
            "capacity": cap,
            "events_recorded": pos,
            "position": _SEQ[0],
            "events": events,
        }


def _dump_dir(directory):
    if directory:
        return directory
    return _env.flight_dir()


def dump_blackbox(reason, directory=None):
    """Atomically write this rank's ring as ``blackbox.rank<N>.json``
    (tmp + rename — a reader never sees a torn file; the newest
    abnormal event wins).  Called on abnormal exits only; **never a
    collective** — each rank dumps alone, the merge happens offline.

    Returns the path, or None when the recorder is disabled or no dump
    directory is configured (``directory`` argument >
    ``MXNET_FLIGHT_DIR`` > ``MXNET_TELEMETRY_AGG_DIR``).  Never
    raises: the dump is the last act of a dying process and must not
    mask the original failure."""
    if not _ensure():
        return None
    directory = _dump_dir(directory)
    if not directory:
        return None
    try:
        doc = snapshot_doc()
        doc["reason"] = str(reason)
        doc["time"] = time.time()
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp_blackbox_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, default=str)
            path = os.path.join(
                directory, f"{BLACKBOX_PREFIX}{doc['rank']}.json")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except Exception:
        return None
    _DUMPS.labels(reason=str(reason)).inc()
    return path
