"""Graceful shutdown: the stop flag, the signal handlers, the grace
deadline, the exit codes, the training loop's step-boundary poll and the
exact-resume train state (counterpart of ``mxnet_tpu/lifecycle.py``).

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

Alerts are logged and recorded in the flight ring, never stops: the
goodput-SLO breach (observers subscribe with
``register_goodput_breach_hook``; the serving fleet's autoscaler is the
one in the package) and the fleet's queue-SLO breach.

A training loop calls ``check_stop()`` at every step boundary: it beats
the telemetry heartbeat, turns an armed ``lifecycle.sigterm`` fault seam
into a stop request, and returns True once a stop is pending.  On a stop
the loop publishes a final synchronous checkpoint
(``publish_final_checkpoint``, with ``capture_train_state``'s RNG, loss
scaler and update count) and raises ``GracefulExit``; the relaunched job
restores it (``CheckpointManager.restore`` + ``restore_train_state``) and
continues bit for bit.

The stall :class:`Watchdog` (``MXNET_WATCHDOG_TIMEOUT_S``, started at
import when set) is fed by the heartbeats the step loops beat
(``telemetry.step_begin``/``step_end``, ``check_stop``, the checkpoint
writer): a deadline without one dumps the black box and a diagnosis file
and exits with :data:`EXIT_STALLED`.  ``check_stop`` also ticks the
cross-rank telemetry aggregation (``telemetry_agg``).

With more than one process and agreement on (``coordinate_stops``,
turned on by ``parallel.distributed.init``), ``check_stop`` agrees on the
stop through a one-scalar all-reduce every ``MXNET_STOP_SYNC_EVERY``-th
call.  ``elastic_resharder`` waits for the next multi-GPU slice (ROADMAP A6:
resharding with the elastic restore).
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback

from . import env as _env
from . import fault
from . import flight_recorder as _flight
from . import telemetry
from .base import world_size

__all__ = ["GracefulExit", "EXIT_PREEMPTED", "EXIT_FORCED", "EXIT_STALLED",
           "request_stop", "stop_requested", "stop_reason",
           "install_signal_handlers", "uninstall_signal_handlers",
           "cancel_grace_deadline", "note_goodput_slo_breach",
           "register_goodput_breach_hook", "unregister_goodput_breach_hook",
           "note_fleet_queue_slo_breach", "note_ledger_skew",
           "coordinate_stops", "check_stop", "publish_final_checkpoint",
           "capture_train_state", "restore_train_state", "Watchdog",
           "start_watchdog", "stop_watchdog", "reset"]

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
EXIT_STALLED = 45     # watchdog abort: no heartbeat within the deadline

_STOP = {"requested": False, "reason": None, "time": None}
_HANDLERS = {"installed": False, "prev": {}, "deliveries": 0}
# cross-process stop agreement: on/off
_SYNC = {"enabled": False, "calls": 0, "agreed": False}

_STOPS_TOTAL = telemetry.counter(
    "mxnet_lifecycle_stops_total", "stop requests (signals + programmatic)")
_STALLS_TOTAL = telemetry.counter(
    "mxnet_watchdog_stalls_total",
    "stall-watchdog fires (no heartbeat within MXNET_WATCHDOG_TIMEOUT_S, "
    "or the watchdog.stall seam)")
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


def coordinate_stops(enabled=True):
    """Turn on per-step agreement across processes: every ``check_stop()``
    of a multi-process job agrees on the stop through a one-scalar
    all-reduce.  Turned on by ``parallel.distributed.init``; one process
    never pays a collective either way."""
    _SYNC["enabled"] = bool(enabled)


def check_stop(sync=None):
    """The step-boundary poll: True when the loop should stop.

    Beats the telemetry heartbeat (a loop that polls is not stalled).  The
    fault seam ``lifecycle.sigterm``: an armed fault here counts as a
    delivered preemption signal, so the stop path is testable without a
    real SIGTERM.  ``sync`` overrides :func:`coordinate_stops`.

    The agreement: with more than one process and coordination on, every
    ``MXNET_STOP_SYNC_EVERY``-th call is one scalar all-reduce
    (``parallel.collectives.allreduce_any``), so every process sees the
    stop at the same step.  The stride counts calls, never the local
    flag, so every process must call ``check_stop`` once per step
    boundary; an off-stride call returns the last agreed verdict (never
    the local flag, which would let one rank leave alone)."""
    telemetry.heartbeat()
    # the cross-rank aggregation rides this step boundary too (host-side
    # file IO only, never a collective)
    telemetry._agg_tick()
    try:
        fault.check("lifecycle.sigterm")
    except Exception as e:
        request_stop(f"fault-injected preemption ({e})")
    local = _STOP["requested"]
    if sync is None:
        sync = _SYNC["enabled"]
    if sync and world_size() > 1:
        with _LOCK:
            _SYNC["calls"] += 1
            due = _SYNC["calls"] % _env.stop_sync_every() == 0
        if not due:
            return _SYNC["agreed"]
        from .parallel.collectives import allreduce_any

        agreed = allreduce_any(local)
        _SYNC["agreed"] = agreed
        if agreed and not local:
            request_stop("stop agreed from a peer process")
        return agreed
    return local


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
        _SYNC.update(enabled=False, calls=0, agreed=False)
    _STOP_GAUGE.set(0)


# --------------------------------------------------------------------------
# alerts: logged and recorded, deliberately NOT stops
# --------------------------------------------------------------------------
def note_goodput_slo_breach(ratio, slo, windows):
    """The goodput-SLO alert (``telemetry`` calls it when the productive
    ratio stayed below ``MXNET_GOODPUT_SLO`` for
    ``MXNET_GOODPUT_SLO_WINDOWS`` consecutive windows): logged, recorded
    in the flight ring, and handed to every registered breach hook (one
    that raises is logged and skipped).  An operator page, not a stop."""
    _LOGGER.warning(
        "goodput SLO breach: productive ratio %.3f below SLO %.3f for "
        "%d consecutive windows (mxnet_goodput_slo_breaches_total "
        "incremented)", ratio, slo, windows)
    _flight.record_event("lifecycle", event="goodput_slo_breach",
                         ratio=float(ratio), slo=float(slo),
                         windows=int(windows))
    for hook in list(_GOODPUT_HOOKS):
        try:
            hook(ratio, slo, windows)
        except Exception:   # an observer must not break the alert path
            _LOGGER.exception("goodput-breach hook %r failed", hook)


# breach observers (the fleet autoscaler wires scale-up here); hooks run
# on the alerting thread and must be cheap
_GOODPUT_HOOKS: list = []


def register_goodput_breach_hook(fn):
    """Subscribe ``fn(ratio, slo, windows)`` to goodput-SLO breach alerts
    (idempotent); returns ``fn``."""
    if fn not in _GOODPUT_HOOKS:
        _GOODPUT_HOOKS.append(fn)
    return fn


def unregister_goodput_breach_hook(fn):
    """Remove a breach hook (idempotent)."""
    if fn in _GOODPUT_HOOKS:
        _GOODPUT_HOOKS.remove(fn)


def note_fleet_queue_slo_breach(depth, threshold, shed):
    """The fleet-wide queue-SLO breach (the router's deadline-aware
    shedding tripped): logged and recorded in the flight ring, as the
    goodput breach, not a stop.  ``shed`` counts the requests answered 429
    in this episode."""
    _LOGGER.warning(
        "fleet queue SLO breach: fleet-wide depth %d above threshold %d "
        "— shedding with Retry-After (%d shed this episode)",
        depth, threshold, shed)
    _flight.record_event("lifecycle", event="fleet_queue_slo_breach",
                         depth=int(depth), threshold=int(threshold),
                         shed=int(shed))


def note_ledger_skew(skew, threshold, windows, laggards):
    """The ledger-skew pre-hang alert (``telemetry_agg`` calls it when the
    cross-rank collective-ledger spread stayed above
    ``MXNET_LEDGER_SKEW_THRESHOLD`` for ``MXNET_LEDGER_SKEW_WINDOWS``
    merges): some rank stopped issuing collectives while its peers run
    ahead.  Logged and recorded in the flight ring, not a stop."""
    _LOGGER.warning(
        "collective-ledger skew alert: cross-rank position spread %d "
        "above threshold %d for %d consecutive merges; lagging "
        "rank(s) %s (mxnet_ledger_skew_alerts_total incremented)",
        skew, threshold, windows, list(laggards))
    _flight.record_event("lifecycle", event="ledger_skew_alert",
                         skew=int(skew), threshold=int(threshold),
                         windows=int(windows),
                         laggards=[int(r) for r in laggards])


# --------------------------------------------------------------------------
# exact-resume training state
# --------------------------------------------------------------------------
def publish_final_checkpoint(manager, step, net=None, trainer=None,
                             train_state=None):
    """The stop path's save: a synchronous checkpoint at ``step`` (an async
    write could still be staging when the grace period ends).  Honours
    ``MXNET_PREEMPTION_CHECKPOINT`` (default on); returns the checkpoint
    directory, or None when disabled."""
    if not _env.preemption_checkpoint_default():
        _LOGGER.warning("MXNET_PREEMPTION_CHECKPOINT=0: exiting WITHOUT a "
                        "final checkpoint (step %s)", step)
        return None
    return manager.save(step, net, trainer, train_state=train_state,
                        async_=False)


def capture_train_state(step=None, dataloader=None, scaler=None,
                        trainer=None, extra=None, guard=None):
    """What an exact resume needs beyond the weights and the optimizer
    states, as a JSON-able dict for ``CheckpointManager.save(...,
    train_state=...)``: the random state of every device's generator
    (``random.get_state``: dropout's masks on the card come from it), a
    data loader's position (``dataloader.state_dict()``), the loss
    scaler's scale and clean-step counter, the Trainer's update count (a
    cross-check of the pickled optimizer's) and JSON-able ``extra``.
    Capture at a step boundary, on the training thread.  A ``guard``'s
    window and ladder (``Guard.state_dict``) ride along, so a resumed run
    classifies its next step as the original would have."""
    from . import random as _random

    st = {"format": 1, "rng": _random.get_state()}
    if step is not None:
        st["step"] = int(step)
    if dataloader is not None:
        sd = getattr(dataloader, "state_dict", None)
        if sd is not None:
            st["dataloader"] = sd()
    if scaler is not None:
        st["loss_scaler"] = scaler.state_dict()
    if trainer is not None:
        st["trainer"] = {"num_update": int(trainer.step_count)}
    if guard is not None:
        st["guard"] = guard.state_dict()
    if extra:
        st["extra"] = extra
    return st


def restore_train_state(state, dataloader=None, scaler=None, guard=None):
    """Re-apply a :func:`capture_train_state` dict: the random state
    always, the data loader's position, the loss scaler's and the guard's
    state when passed.  Returns the recorded step (or None)."""
    if not state:
        return None
    from . import random as _random

    if "rng" in state:
        _random.set_state(state["rng"])
    if dataloader is not None and state.get("dataloader") is not None:
        dataloader.load_state_dict(state["dataloader"])
    if scaler is not None and state.get("loss_scaler") is not None:
        scaler.load_state_dict(state["loss_scaler"])
    if guard is not None and state.get("guard") is not None:
        guard.load_state_dict(state["guard"])
    return state.get("step")


# --------------------------------------------------------------------------
# stall watchdog
# --------------------------------------------------------------------------
class Watchdog:
    """A daemon thread that enforces a per-step deadline on the telemetry
    heartbeat (``step_begin``/``step_end``, ``check_stop`` and the
    checkpoint writer beat it).

    On expiry: the flight recorder's black box (``blackbox.rank<N>.json``
    in ``MXNET_FLIGHT_DIR``, else the dump directory), a diagnosis file
    (every thread's stack, the telemetry snapshot, the ring), a count in
    ``mxnet_watchdog_stalls_total``, and with ``abort`` (default
    ``MXNET_WATCHDOG_ABORT``, on) an exit with :data:`EXIT_STALLED`, so
    the supervisor restarts from the last valid checkpoint.  A wedged
    kernel or collective cannot be unwedged from inside the process; the
    exit is the recovery and the files are the diagnosis.  With
    ``abort=False`` it fires once per stall (again only after the
    heartbeat moved).

    It does not fire before the first heartbeat within 10 deadlines (a
    first step builds kernels and captures graphs), nor while a stop is
    pending with a ``MXNET_GRACE_PERIOD_S`` deadline armed (that deadline
    owns the exit; the final synchronous checkpoint may outlast a step).

    Fault seam ``watchdog.stall``: an armed fault makes the next poll
    fire as an expired deadline (in the windows above too)."""

    def __init__(self, timeout_s=None, abort=None, dump_dir=None,
                 poll_s=None, logger=None):
        if timeout_s is None:
            timeout_s = _env.watchdog_timeout_s()
        self.timeout_s = float(timeout_s)
        if abort is None:
            abort = _env.get_bool("MXNET_WATCHDOG_ABORT", True)
        self.abort = bool(abort)
        self.dump_dir = dump_dir or _env.get_str("MXNET_WATCHDOG_DIR") or "."
        self.poll_s = float(poll_s) if poll_s else \
            max(0.05, min(self.timeout_s / 4.0, 1.0))
        self.logger = logger or _LOGGER
        self.last_dump = None
        self.last_blackbox = None
        self.stall_count = 0
        self._stop_evt = threading.Event()
        self._thread = None
        self._started = None
        self._fired_base = None   # the heartbeat the last fire was for

    def start(self):
        """Start polling; a no-op (returns self) when the timeout is 0."""
        if self.timeout_s <= 0:
            self.logger.info("watchdog disabled "
                             "(MXNET_WATCHDOG_TIMEOUT_S unset/0)")
            return self
        if self._thread is not None:
            return self
        self._started = time.monotonic()
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="mxnet-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        t = self._thread
        self._thread = None
        if t is not None:
            self._stop_evt.set()
            t.join(timeout=5)

    def poll(self):
        """One poll: fires, and returns True, when the deadline expired or
        the seam is armed.  The thread calls it every ``poll_s``."""
        injected = None
        try:
            fault.check("watchdog.stall")
        except Exception as e:
            injected = e
        last = telemetry.last_heartbeat()
        if self._started is None:
            self._started = time.monotonic()
        base = last if last is not None else self._started
        age = time.monotonic() - base
        if injected is None:
            if _STOP["requested"] and _GRACE["timer"] is not None:
                return False
            limit = self.timeout_s if last is not None \
                else self.timeout_s * 10.0
            if age <= limit or base == self._fired_base:
                return False
            # only a real fire spends the one-shot of its stall: a chaos
            # fire must not mask a genuine stall before the next beat
            self._fired_base = base
        self._fire(age, injected)
        return True

    def _run(self):
        while not self._stop_evt.wait(self.poll_s):
            self.poll()

    def _fire(self, age, injected):
        self.stall_count += 1
        _STALLS_TOTAL.inc()
        if injected is None:
            # the heartbeat gap is wall time the job lost to the stall
            telemetry.goodput_note("stall", age)
        cause = f"injected fault ({injected})" if injected is not None \
            else (f"no step heartbeat for {age:.1f}s "
                  f"(deadline {self.timeout_s:.1f}s)")
        _flight.record_event("lifecycle", event="watchdog_stall",
                             cause=cause, age_s=float(age))
        # the black box first (the abort below never returns), into this
        # watchdog's directory when no flight directory is configured
        self.last_blackbox = _flight.dump_blackbox(
            "watchdog_stall", directory=_env.flight_dir() or self.dump_dir)
        try:
            path = self._write_dump(age, cause)
            self.last_dump = path
        except Exception as e:  # the dump must never kill the watchdog
            path = None
            self.logger.error("watchdog: failed to write diagnosis "
                              "file: %r", e)
        self.logger.critical(
            "watchdog stall: %s; diagnosis %s%s", cause, path,
            f"; aborting with status {EXIT_STALLED}" if self.abort else "")
        if self.abort:
            logging.shutdown()
            os._exit(EXIT_STALLED)

    @staticmethod
    def _thread_stacks():
        names = {t.ident: t.name for t in threading.enumerate()}
        return {f"{names.get(tid, 'unknown')} (tid={tid})":
                traceback.format_stack(frame)
                for tid, frame in sys._current_frames().items()}

    def _write_dump(self, age, cause):
        """One JSON diagnosis file a stall: what stalled (every thread's
        stack) and the job's state (the telemetry snapshot, the ring)."""
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(
            self.dump_dir,
            f"mxnet_watchdog_stall_{os.getpid()}_{self.stall_count}.json")
        doc = {"time": time.time(), "pid": os.getpid(), "cause": cause,
               "timeout_s": self.timeout_s, "heartbeat_age_s": age,
               "stacks": self._thread_stacks(),
               "telemetry": telemetry.snapshot(),
               "flight_recorder": _flight.snapshot_doc(),
               "blackbox": self.last_blackbox}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        os.replace(tmp, path)
        return path


_WATCHDOG = [None]


def start_watchdog(timeout_s=None, **kwargs):
    """Start (or return) the process-wide watchdog (``env.apply_env``
    starts it when ``MXNET_WATCHDOG_TIMEOUT_S`` is set)."""
    with _LOCK:
        if _WATCHDOG[0] is None:
            _WATCHDOG[0] = Watchdog(timeout_s=timeout_s, **kwargs)
        wd = _WATCHDOG[0]
    return wd.start()


def stop_watchdog():
    with _LOCK:
        wd, _WATCHDOG[0] = _WATCHDOG[0], None
    if wd is not None:
        wd.stop()
