"""Graceful shutdown: the stop flag, the signal handlers, the grace
deadline and the exit codes (counterpart of ``mxnet_tpu/lifecycle.py``, as
far as ``serving.serve`` and the serving engine use it).

``install_signal_handlers()`` (SIGTERM/SIGINT) or a programmatic
``request_stop(reason)`` sets a process-wide stop flag.  The serving
engine's loop polls it (``stop_requested()``): it stops admitting, lets the
in-flight sequences finish, rejects the queued requests, and ``serve()``
returns :data:`EXIT_PREEMPTED`, so a supervisor can tell "preempted clean"
from "crashed".  A second delivery of the signal restores the previous
disposition and re-raises it, for an operator who wants out now.  A
configured ``MXNET_GRACE_PERIOD_S`` arms a deadline at the stop request:
if the process has not finished when it expires, it dumps the flight
recorder and force-exits with :data:`EXIT_FORCED`.

Not ported yet: ``check_stop``'s cross-rank agreement (it needs the
port's collectives), the stall ``Watchdog``, the training-state capture,
``elastic_resharder``, and the goodput-breach hooks and the fleet
queue-SLO note (their caller is the fleet router).
"""
from __future__ import annotations

import logging
import os
import threading
import time

from . import env as _env
from . import flight_recorder as _flight
from . import telemetry

__all__ = ["GracefulExit", "EXIT_PREEMPTED", "EXIT_FORCED", "EXIT_STALLED",
           "request_stop", "stop_requested", "stop_reason",
           "install_signal_handlers", "uninstall_signal_handlers",
           "cancel_grace_deadline", "note_goodput_slo_breach", "reset"]

_LOGGER = logging.getLogger(__name__)
# REENTRANT: the signal handler runs ON the main thread between bytecodes,
# so it can interrupt a critical section this module itself holds (a
# second SIGTERM while the first handler is inside its locked section); a
# plain Lock would deadlock the process right when it is trying to stop
_LOCK = threading.RLock()

# exit-status contract with the external supervisor: distinct codes so
# "preempted clean" is never confused with "crashed"
EXIT_PREEMPTED = 43   # stop honored, clean exit
EXIT_FORCED = 44      # MXNET_GRACE_PERIOD_S expired, stop not honored
EXIT_STALLED = 45     # watchdog abort (the watchdog is not ported yet)

_STOP = {"requested": False, "reason": None, "time": None}
_HANDLERS = {"installed": False, "prev": {}, "deliveries": 0}

_STOPS_TOTAL = telemetry.counter(
    "mxnet_lifecycle_stops_total", "stop requests (signals + programmatic)")
_STOP_GAUGE = telemetry.gauge(
    "mxnet_lifecycle_stop_requested", "1 while a stop is pending")


class GracefulExit(Exception):
    """Raised by a loop that honored a stop.  Constructing it disarms the
    grace deadline: the stop was honored, so a caller that catches it and
    lives on is not force-exited later."""

    def __init__(self, reason="preempted", step=None):
        self.reason = reason
        self.step = step
        at = f" at step {step}" if step is not None else ""
        super().__init__(f"graceful preemption exit{at}: {reason}")
        _flight.record_event("lifecycle", event="graceful_exit",
                             reason=str(reason), step=step)
        cancel_grace_deadline()


# --------------------------------------------------------------------------
# stop flag
# --------------------------------------------------------------------------
def request_stop(reason="programmatic"):
    """Ask the running loops to stop.  Safe from signal handlers and any
    thread; idempotent (the first reason wins)."""
    with _LOCK:
        if _STOP["requested"]:
            return
        _STOP["requested"] = True
        _STOP["reason"] = str(reason)
        _STOP["time"] = time.time()
    _STOPS_TOTAL.inc()
    _STOP_GAUGE.set(1)
    _flight.record_event("lifecycle", event="stop_requested",
                         reason=str(reason))
    # every stop (signal or programmatic) gets the same wall-time bound:
    # no-op when MXNET_GRACE_PERIOD_S is unset
    _arm_grace_deadline()
    _LOGGER.warning("stop requested (%s); loops will stop at their next "
                    "boundary", reason)


def stop_requested():
    """True once a stop was requested (signal or programmatic)."""
    return _STOP["requested"]


def stop_reason():
    return _STOP["reason"]


# --------------------------------------------------------------------------
# signal handlers + grace period
# --------------------------------------------------------------------------
def _on_signal(signum, frame):
    import signal as _signal

    with _LOCK:
        _HANDLERS["deliveries"] += 1
        repeat = _HANDLERS["deliveries"] > 1
    if repeat:
        # second delivery: the operator (or scheduler) wants out NOW —
        # restore the previous disposition and re-deliver
        uninstall_signal_handlers()
        os.kill(os.getpid(), signum)
        return
    try:
        name = _signal.Signals(signum).name
    except ValueError:  # pragma: no cover
        name = str(signum)
    request_stop(f"signal {name}")   # arms the grace deadline too


def _grace_expired(grace_s):
    _LOGGER.critical(
        "grace period of %.1fs expired before the stop was honored; "
        "force-exiting (status %d)", grace_s, EXIT_FORCED)
    # the forced exit is an abnormal end: the ring is the only record of
    # where the process was when the deadline landed
    _flight.record_event("lifecycle", event="grace_deadline_expired",
                         grace_s=grace_s)
    _flight.dump_blackbox("grace_deadline_forced_exit")
    logging.shutdown()
    os._exit(EXIT_FORCED)


_GRACE = {"timer": None}


def _arm_grace_deadline():
    grace = _env.grace_period_s()
    if grace <= 0:
        return
    t = threading.Timer(grace, _grace_expired, args=(grace,))
    t.daemon = True
    with _LOCK:
        _GRACE["timer"] = t
    t.start()


def cancel_grace_deadline():
    """Disarm the force-exit deadline (idempotent)."""
    with _LOCK:
        t, _GRACE["timer"] = _GRACE["timer"], None
    if t is not None:
        t.cancel()


def install_signal_handlers(signals=None):
    """Install graceful-stop handlers (default SIGTERM + SIGINT): the first
    delivery requests a stop (and arms the ``MXNET_GRACE_PERIOD_S``
    deadline), a second restores the previous disposition and re-raises.
    Idempotent; main thread only (the signal module's rule): elsewhere it
    logs and returns False."""
    import signal as _signal

    sigs = tuple(signals or (_signal.SIGTERM, _signal.SIGINT))
    with _LOCK:
        if _HANDLERS["installed"]:
            return True
    try:
        prev = {}
        for s in sigs:
            prev[s] = _signal.signal(s, _on_signal)
    except ValueError:  # not the main thread
        _LOGGER.warning("install_signal_handlers: not on the main thread; "
                        "stop signals will not be caught here")
        return False
    with _LOCK:
        _HANDLERS["installed"] = True
        _HANDLERS["prev"] = prev
        _HANDLERS["deliveries"] = 0
    return True


def uninstall_signal_handlers():
    """Restore the dispositions ``install_signal_handlers`` replaced."""
    import signal as _signal

    with _LOCK:
        prev = _HANDLERS["prev"]
        _HANDLERS["installed"] = False
        _HANDLERS["prev"] = {}
    for s, h in prev.items():
        try:
            _signal.signal(s, h)
        except ValueError:  # pragma: no cover - non-main thread
            pass


def reset():
    """Clear the stop flag and the handler bookkeeping (test isolation)."""
    uninstall_signal_handlers()
    cancel_grace_deadline()
    with _LOCK:
        _STOP.update(requested=False, reason=None, time=None)
        _HANDLERS["deliveries"] = 0
    _STOP_GAUGE.set(0)


# --------------------------------------------------------------------------
# alerts: logged and recorded, deliberately NOT stops
# --------------------------------------------------------------------------
def note_goodput_slo_breach(ratio, slo, windows):
    """The goodput-SLO alert (``telemetry`` calls it when the productive
    ratio stayed below ``MXNET_GOODPUT_SLO`` for
    ``MXNET_GOODPUT_SLO_WINDOWS`` consecutive windows): logged and
    recorded in the flight ring.  An operator page, not a stop."""
    _LOGGER.warning(
        "goodput SLO breach: productive ratio %.3f below SLO %.3f for "
        "%d consecutive windows (mxnet_goodput_slo_breaches_total "
        "incremented)", ratio, slo, windows)
    _flight.record_event("lifecycle", event="goodput_slo_breach",
                         ratio=float(ratio), slo=float(slo),
                         windows=int(windows))
