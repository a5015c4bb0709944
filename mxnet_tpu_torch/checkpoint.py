"""Checkpoint and resume with failure recovery (counterpart of
``mxnet_tpu/checkpoint.py``).

- ``CheckpointManager``: step-indexed directories, published atomically
  (written to a ``.tmp_step_*`` staging directory, fsynced, marked
  ``COMMITTED``, renamed into place: a half-written checkpoint is never
  visible), per-file sha256 sums in ``meta.json`` verified on restore (a
  bit-flipped, truncated or missing file skips its step, and the restore
  falls back to the newest valid older one), bounded retention,
  ``latest_valid_step()`` for resume, and the sweep of staging
  directories a crash left behind.  ``save(async_=True)`` blocks only for
  the device-to-host snapshot (every parameter copied to pinned host
  memory in one pass, the optimizer states likewise) and writes the files
  on a background thread.  The files are ``model.params``
  (``save_parameters``), ``trainer.states`` (``save_states``) and
  ``train_state.json``: either package reads the other's directory.
- ``run_with_recovery``: reruns a training function from the latest valid
  checkpoint after a failure, with exponential backoff and full jitter,
  and a restart budget that resets whenever a checkpoint was published
  between failures.  A ``lifecycle.GracefulExit`` is a clean preempted
  exit, never a restart.

Fault seams ``checkpoint.write``, ``checkpoint.fsync`` and
``checkpoint.publish`` (:mod:`.fault`).  Telemetry: the save, snapshot and
restore histograms, the save, restore and restart counters, and the
in-flight gauge.

A job of several processes has one writer: every process calls ``save``
at the same point of its loop, the trainer's states are taken on every
process (a ZeRO payload is gathered from all of them), process 0 alone
writes and publishes, and every process meets in a barrier at publish, so
no process runs past a checkpoint that does not exist yet.  Each file is
hashed as it is written (no read-back); ``last_save_timing`` holds the
write and fsync seconds of the newest publish apart.  A failure from
the numerical-integrity guard (``guard.GuardRewind``,
``guard.NumericalDivergence``) is a rewind: its downtime goes to the
``rewind`` goodput bucket, every other failure's to ``restart``.  Not
ported yet: ``resharder=`` (live resharding, with the second multi-GPU
slice; anything but None raises) and the ``compile_cache`` beside the
checkpoints.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import tempfile
import threading
import time

from . import env as _env
from . import fault
from . import flight_recorder as _flight
from . import telemetry
from .base import MXNetError, world_size

__all__ = ["CheckpointManager", "run_with_recovery"]

_SAVE_HIST = telemetry.histogram(
    "mxnet_checkpoint_save_seconds", "checkpoint save duration (publish)")
_RESTORE_HIST = telemetry.histogram(
    "mxnet_checkpoint_restore_seconds", "checkpoint restore duration")
_SAVES_TOTAL = telemetry.counter(
    "mxnet_checkpoint_saves_total", "published checkpoints")
_RESTORES_TOTAL = telemetry.counter(
    "mxnet_checkpoint_restores_total", "completed checkpoint restores")
_RESTARTS_TOTAL = telemetry.counter(
    "mxnet_recovery_restarts_total", "run_with_recovery restarts")
_INFLIGHT = telemetry.gauge(
    "mxnet_checkpoint_inflight",
    "1 while an async checkpoint write is staging/publishing in background")
_SNAPSHOT_HIST = telemetry.histogram(
    "mxnet_checkpoint_snapshot_seconds",
    "blocking device->host snapshot portion of an async save")

_LOGGER = logging.getLogger(__name__)

_TMP_PREFIX = ".tmp_step_"
# files without a checksum: meta.json holds the sums, COMMITTED is the mark
_UNSUMMED = ("meta.json", "COMMITTED")


def _fsync_file(path):
    # a long synchronous save (the stop path's) is progress, not a stall
    telemetry.heartbeat()
    fault.check("checkpoint.fsync")
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _stat_sig(path):
    """(size, mtime_ns), or None when missing: the change detector of the
    verify() verdict cache."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_size, st.st_mtime_ns)


class _HashingWriter:
    """A binary file that hashes (sha256) and counts what is written to
    it, so a checkpoint's sums need no read-back."""

    def __init__(self, path):
        self._f = open(path, "wb")
        self._h = hashlib.sha256()
        self.size = 0

    def write(self, data):
        self._h.update(data)
        self.size += len(data)
        return self._f.write(data)

    def close(self):
        self._f.close()

    def hexdigest(self):
        return self._h.hexdigest()


def _rank():
    from .parallel.collectives import rank

    return rank()


def _barrier():
    from .parallel.collectives import barrier

    barrier()


class CheckpointManager:
    """Atomic, step-indexed checkpoints of a Gluon net and its Trainer::

        mgr = CheckpointManager(dir, max_to_keep=3)
        start = mgr.restore(net, trainer)  # 0 if none yet
        for step in range(start, n):
            ...train...
            mgr.save(step + 1, net, trainer)
    """

    def __init__(self, directory, max_to_keep=5, logger=None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.logger = logger or _LOGGER
        # verify() cache: step -> {file: (size, mtime_ns)} when it last
        # hashed clean
        self._valid_steps = {}
        # steps that verified clean but failed to load: latest_valid_step
        # skips them, or a restart's start step would disagree with the
        # weights restore() falls back to
        self._load_failed = set()
        # at most one background write in flight; the next save(),
        # close() or restore() joins it first
        self._pending = None
        self._pending_step = None
        self._pending_error = None
        os.makedirs(directory, exist_ok=True)
        # only the writing process sweeps, so that a peer constructing its
        # manager never deletes the writer's live staging directory
        if self._launcher_rank() == 0:
            self._gc_orphaned_tmp()

    @staticmethod
    def _launcher_rank():
        """This process's rank from the launcher's environment, then from
        ``torch.distributed``; -1 for a job of several processes whose
        rank cannot be proven (the callers fail closed)."""
        for var in ("MXNET_WORKER_ID", "DMLC_WORKER_ID"):
            v = os.environ.get(var)
            if v:
                try:
                    return int(v)
                except ValueError:
                    return -1
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
        if _env.launcher_world() > 1:
            return -1
        return 0

    def _gc_orphaned_tmp(self):
        """Remove the ``.tmp_step_*`` staging directories a crash mid-save
        left (never published, so always safe to delete)."""
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.startswith(_TMP_PREFIX) and os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
                self.logger.warning(
                    "removed orphaned checkpoint staging dir %s "
                    "(crash mid-save)", path)

    # -- discovery ---------------------------------------------------------
    def _step_dir(self, step):
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, "COMMITTED")):
                out.append(int(name[len("step_"):]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_valid_step(self):
        """The newest step that passes verification and has not failed a
        load: the step ``restore()`` serves.  Resume from this, not from
        ``latest_step()``, which may name a corrupt checkpoint."""
        self._join_pending(raise_=False)
        for s in reversed(self.all_steps()):
            if s not in self._load_failed and self.verify(s) is None:
                return s
        return None

    def verify(self, step):
        """None when checkpoint ``step`` matches the sums in its
        meta.json, else the first problem found.  A clean verdict is
        cached against each file's (size, mtime_ns); any change re-hashes,
        and failures are never cached."""
        d = self._step_dir(step)
        cached = self._valid_steps.get(step)
        if cached is not None:
            if all(_stat_sig(os.path.join(d, n)) == sig
                   for n, sig in cached.items()):
                return None
            del self._valid_steps[step]
        if not os.path.exists(os.path.join(d, "COMMITTED")):
            return f"{d}: no COMMITTED marker"
        try:
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            return f"{d}/meta.json unreadable: {e}"
        for name, want in (meta.get("files") or {}).items():
            path = os.path.join(d, name)
            if not os.path.exists(path):
                return f"{path}: missing"
            if os.path.getsize(path) != want["size"]:
                return (f"{path}: size {os.path.getsize(path)} != recorded "
                        f"{want['size']} (truncated?)")
            if _sha256(path) != want["sha256"]:
                return f"{path}: sha256 mismatch (corrupt)"
        self._valid_steps[step] = {
            name: _stat_sig(os.path.join(d, name))
            for name in (meta.get("files") or {})}
        return None

    # -- save / restore ----------------------------------------------------
    def _write_step(self, step, writers, extra):
        """Stage, checksum, fsync and publish checkpoint ``step`` (the same
        for the sync and async paths): ``writers`` maps each payload file
        name to a function that writes it to a file object, which hashes
        the bytes as they pass."""
        final = self._step_dir(step)
        telemetry.heartbeat()
        tmp = tempfile.mkdtemp(prefix=f"{_TMP_PREFIX}{step}_",
                               dir=self.directory)
        try:
            fault.check("checkpoint.write")
            t0 = time.perf_counter()
            sums = {}
            for name, write in writers.items():
                f = _HashingWriter(os.path.join(tmp, name))
                try:
                    write(f)
                finally:
                    f.close()
                sums[name] = {"sha256": f.hexdigest(), "size": f.size}
            t_write = time.perf_counter() - t0
            telemetry.heartbeat()
            meta = {"step": int(step), "time": time.time()}
            if extra:
                meta["extra"] = extra
            meta["files"] = sums
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            # every file reaches the disk before the commit marker exists,
            # and the marker and the entries before the publish rename
            t0 = time.perf_counter()
            for name in os.listdir(tmp):
                _fsync_file(os.path.join(tmp, name))
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("1")
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            t_fsync = time.perf_counter() - t0
            fault.check("checkpoint.publish")
            if os.path.exists(final):
                shutil.rmtree(final)
            self._valid_steps.pop(step, None)
            self._load_failed.discard(step)
            os.rename(tmp, final)
            _fsync_dir(self.directory)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.last_save_timing = {
            "write_s": t_write, "fsync_s": t_fsync,
            "bytes": sum(v["size"] for v in sums.values())}
        self._gc()
        return final

    def save(self, step, net=None, trainer=None, extra=None, async_=None,
             train_state=None):
        """Publish checkpoint ``step`` atomically; returns its directory.

        ``train_state`` (JSON-able, normally from
        ``lifecycle.capture_train_state``) is written as
        ``train_state.json``, summed like every payload file, and read back
        with :meth:`read_train_state`.

        ``async_=True`` (default: ``MXNET_CHECKPOINT_ASYNC``) blocks only
        for the device-to-host snapshot; the files, the fsyncs and the
        publish run on a background thread with the same seams and sums.
        The next ``save``, ``close()`` or ``restore()`` joins it, and a
        failed background write surfaces there (its step was never
        published).  Credit progress from ``latest_valid_step()``."""
        if async_ is None:
            async_ = _env.checkpoint_async_default()
        # a failed background write surfaces here in one process; with
        # several only the writer has one, and raising there alone would
        # strand the others in the barrier below: log it instead
        self._join_pending(raise_=world_size() == 1)
        primary = _rank() == 0
        final = self._step_dir(step)
        t0 = time.perf_counter()
        # serialised now in both paths: the caller may change its dicts
        # (the RNG state, a loader's position) right after
        ts_blob = None if train_state is None else \
            json.dumps(train_state).encode()
        if not async_:
            with telemetry.phase("checkpoint"):
                try:
                    # every process takes the states (a ZeRO payload is
                    # gathered from all of them); process 0 writes
                    writers = self._payload_writers(net, trainer, ts_blob,
                                                    primary, snapshot=False)
                    if primary:
                        self._write_step(step, writers, extra)
                finally:
                    # every process reaches the barrier, even when the
                    # writer failed, or the others wait in it forever
                    _barrier()
            dt = time.perf_counter() - t0
            _SAVE_HIST.observe(dt)
            # a synchronous save blocks training for all of its time
            telemetry.goodput_note("checkpoint", dt)
            _SAVES_TOTAL.inc()
            return final
        with telemetry.phase("checkpoint"):
            try:
                writers = self._payload_writers(net, trainer, ts_blob,
                                                primary, snapshot=True)
            finally:
                # the barrier runs on the caller's thread, in program
                # order with the training collectives: the agreed event
                # is "snapshot taken everywhere"; the publish is the
                # writer's alone
                _barrier()
        dt_snap = time.perf_counter() - t0
        _SNAPSHOT_HIST.observe(dt_snap)
        # an async save blocks only for the snapshot; the write overlaps
        # training and is not charged
        telemetry.goodput_note("checkpoint", dt_snap)
        if not primary:
            return final

        self._pending_step = step
        self._pending_error = None
        _INFLIGHT.set(1)

        def task():
            try:
                # no telemetry.phase: the step timeline is the main
                # thread's
                self._write_step(step, writers, extra)
                _SAVE_HIST.observe(time.perf_counter() - t0)
                _SAVES_TOTAL.inc()
            except BaseException as e:
                self._pending_error = e
            finally:
                _INFLIGHT.set(0)

        self._pending = threading.Thread(
            target=task, name=f"mxnet-ckpt-save-{step}", daemon=True)
        self._pending.start()
        return final

    def _payload_writers(self, net, trainer, ts_blob, primary, snapshot):
        """{file name: writer of a file object} of what ``save`` writes.
        The trainer's states blob is taken on every process; the rest
        only on the writer.  ``snapshot`` copies the parameters to pinned
        host memory now (one pass, one synchronisation), the blocking
        half of an async save; otherwise they are read when written."""
        from .ndarray.serialization import host_copies, save as _save

        blob = trainer._states_blob() if trainer is not None else None
        if not primary:
            return {}
        writers = {}
        if net is not None:
            params = net._collect_params_with_prefix()
            if snapshot:
                data = dict(zip(params, host_copies(
                    [p.data()._data for p in params.values()])))
            else:
                data = {k: v.data() for k, v in params.items()}
            writers["model.params"] = lambda f, _d=data: _save(f, _d)
        if blob is not None:
            writers["trainer.states"] = lambda f, _b=blob: f.write(_b)
        if ts_blob is not None:
            writers["train_state.json"] = lambda f, _b=ts_blob: f.write(_b)
        return writers

    def _join_pending(self, raise_=True):
        """Wait for the background write, if any; re-raise its failure,
        or with ``raise_=False`` log it (its step was never published)."""
        t = self._pending
        if t is not None:
            t.join()
            self._pending = None
        err, self._pending_error = self._pending_error, None
        if err is None:
            return
        if raise_:
            raise MXNetError(
                f"async checkpoint write for step {self._pending_step} "
                f"failed: {err!r}") from err
        self.logger.warning(
            "async checkpoint write for step %s failed (%r); that step "
            "was never published", self._pending_step, err)

    def close(self):
        """Join the background write; raises if it failed."""
        self._join_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._join_pending(raise_=exc[0] is None)
        return False

    def restore(self, net=None, trainer=None, step=None, ctx=None):
        """Load the newest valid checkpoint, or exactly ``step``; returns
        the step loaded, or 0 when there is none.

        Without ``step``, a checkpoint that fails verification or whose
        load raises is skipped with a warning and the next older one is
        tried.  An explicit ``step`` is strict: missing or invalid
        raises."""
        self._join_pending(raise_=False)
        t0 = time.perf_counter()
        if step is not None:
            if step not in self.all_steps():
                raise MXNetError(
                    f"checkpoint {self._step_dir(step)} is not committed")
            problem = self.verify(step)
            if problem is not None:
                raise MXNetError(
                    f"checkpoint step {step} requested explicitly but "
                    f"failed verification: {problem}")
            self._load(step, net, trainer, ctx)
            _RESTORE_HIST.observe(time.perf_counter() - t0)
            _RESTORES_TOTAL.inc()
            return step
        for s in reversed(self.all_steps()):
            if s in self._load_failed:
                continue
            problem = self.verify(s)
            if problem is not None:
                self.logger.warning(
                    "checkpoint step %d failed verification (%s); "
                    "falling back to an older step", s, problem)
                continue
            try:
                self._load(s, net, trainer, ctx)
            except Exception as e:
                self._load_failed.add(s)
                self.logger.warning(
                    "checkpoint step %d failed to load (%r); "
                    "falling back to an older step", s, e)
                continue
            _RESTORE_HIST.observe(time.perf_counter() - t0)
            _RESTORES_TOTAL.inc()
            return s
        return 0

    def _load(self, step, net, trainer, ctx):
        d = self._step_dir(step)
        if net is not None:
            net.load_parameters(os.path.join(d, "model.params"), ctx=ctx)
        if trainer is not None:
            tpath = os.path.join(d, "trainer.states")
            if os.path.exists(tpath):
                trainer.load_states(tpath)

    def read_meta(self, step):
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)

    def read_train_state(self, step):
        """The ``train_state`` saved with ``step``, or None.  Hand it to
        ``lifecycle.restore_train_state`` after ``restore()``."""
        path = os.path.join(self._step_dir(step), "train_state.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            self._valid_steps.pop(s, None)
            self._load_failed.discard(s)


def run_with_recovery(train_fn, manager, max_restarts=3,
                      should_retry=None, logger=None, backoff_ms=None,
                      resharder=None):
    """Run ``train_fn(start_step, manager)`` to completion, rerunning it
    from the latest valid checkpoint after a retryable failure.

    - ``should_retry(exc) -> bool`` filters failures (default: everything
      but KeyboardInterrupt).
    - Restarts back off exponentially with full jitter (seed
      ``backoff_ms``, default ``MXNET_FAULT_BACKOFF_MS``).
    - The budget (``max_restarts``) counts consecutive failures at one
      checkpoint step: a newer valid step since the previous failure
      resets it, so a job that keeps advancing survives any number of
      preemptions.
    - A ``lifecycle.GracefulExit`` is a clean preempted exit: its final
      checkpoint is published, so the supervisor joins any background
      write and re-raises it without counting a restart (the caller exits
      with ``lifecycle.EXIT_PREEMPTED`` and the relaunch resumes).
    - Each failure dumps the flight recorder's black box first.
    - A failure of the numerical-integrity guard (``guard.GuardRewind``:
      a persistent anomaly on a loop that cannot skip;
      ``guard.NumericalDivergence``) is a rewind: its downtime (failure to
      the next attempt) is charged to the ``rewind`` goodput bucket, not
      ``restart``.

    Returns train_fn's result."""
    from .lifecycle import GracefulExit

    if resharder is not None:
        raise MXNetError("run_with_recovery(resharder=): live resharding "
                         "comes with the second multi-GPU slice (ROADMAP "
                         "A6)")
    log = logger or _LOGGER
    if backoff_ms is None:
        backoff_ms = fault.backoff_ms()
    progress = manager.latest_valid_step
    restarts = 0
    last_step = progress() or 0
    fail_t = None      # goodput: failure -> next attempt downtime
    fail_bucket = "restart"   # or "rewind" for the guard's failures
    while True:
        start = progress() or 0
        if fail_t is not None:
            # time lost to wrong values (a guard rewind) is told apart from
            # time lost to a lost process
            telemetry.goodput_note(fail_bucket, time.perf_counter() - fail_t)
            fail_t, fail_bucket = None, "restart"
        try:
            result = train_fn(start, manager)
            # a final async save may still be staging; a failed one
            # raises here and re-enters the retry loop
            manager._join_pending()
            return result
        except KeyboardInterrupt:
            raise
        except GracefulExit as e:
            manager._join_pending()
            log.info("preempted-clean exit (%s); latest valid step %s",
                     e, progress())
            raise
        except Exception as e:
            if should_retry is not None and not should_retry(e):
                raise
            fail_t = time.perf_counter()
            from . import guard as _guard

            divergence = isinstance(e, _guard.NumericalDivergence)
            if divergence or isinstance(e, _guard.GuardRewind):
                fail_bucket = "rewind"
            _flight.record_event("lifecycle", event="train_failure",
                                 error=repr(e)[:200])
            _flight.dump_blackbox("numerical_divergence" if divergence
                                  else "run_with_recovery_failure")
            # a background write from before the failure may publish the
            # step that resets the budget
            manager._join_pending(raise_=False)
            step_now = progress() or 0
            if step_now > last_step:
                log.info("progress advanced to step %s between failures; "
                         "restart budget reset", step_now)
                restarts = 0
            last_step = step_now
            restarts += 1
            _RESTARTS_TOTAL.inc()
            _flight.record_event("lifecycle", event="restart",
                                 attempt=restarts, step=step_now)
            if restarts > max_restarts:
                _flight.dump_blackbox("restart_budget_exhausted")
                raise MXNetError(
                    f"training failed after {max_restarts} restarts "
                    f"without progress (stuck at step {step_now}; last "
                    f"error: {e!r})") from e
            delay = fault.backoff_delay(restarts - 1, backoff_ms)
            log.warning("restart %d/%d from step %s in %.3fs after: %r",
                        restarts, max_restarts, step_now, delay, e)
            if delay > 0:
                time.sleep(delay)
