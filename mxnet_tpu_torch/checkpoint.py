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

One process only.  A job of several processes (one writer, a barrier at
publish) waits for the port's collectives: the manager raises when
``torch.distributed`` runs more than one process, and ``_launcher_rank``
only decides which process sweeps staging directories.  Not ported yet:
``resharder=`` (live resharding, with the multi-GPU slice; anything but
None raises), the ``compile_cache`` beside the checkpoints and the guard's
``rewind`` bucket (with the other runtime planes: until then every
failure counts as a restart).
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


def _single_process(what):
    if world_size() > 1:
        raise MXNetError(f"CheckpointManager.{what}: checkpoints of a job of "
                         f"several processes wait for the port's "
                         f"collectives (one writer, a barrier at publish)")


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
    def _write_step(self, step, write_payloads, extra):
        """Stage, checksum, fsync and publish checkpoint ``step`` (the same
        for the sync and async paths): ``write_payloads(tmp_dir)`` writes
        the payload files."""
        final = self._step_dir(step)
        telemetry.heartbeat()
        tmp = tempfile.mkdtemp(prefix=f"{_TMP_PREFIX}{step}_",
                               dir=self.directory)
        try:
            fault.check("checkpoint.write")
            write_payloads(tmp)
            telemetry.heartbeat()
            meta = {"step": int(step), "time": time.time()}
            if extra:
                meta["extra"] = extra
            meta["files"] = {
                name: {"sha256": _sha256(os.path.join(tmp, name)),
                       "size": os.path.getsize(os.path.join(tmp, name))}
                for name in os.listdir(tmp) if name not in _UNSUMMED}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            # every file reaches the disk before the commit marker exists,
            # and the marker and the entries before the publish rename
            for name in os.listdir(tmp):
                _fsync_file(os.path.join(tmp, name))
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("1")
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
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
        _single_process("save")
        if async_ is None:
            async_ = _env.checkpoint_async_default()
        self._join_pending()
        t0 = time.perf_counter()
        # serialised now in both paths: the caller may change its dicts
        # (the RNG state, a loader's position) right after
        ts_blob = None if train_state is None else \
            json.dumps(train_state).encode()
        if not async_:
            def write_payloads(tmp):
                if net is not None:
                    net.save_parameters(os.path.join(tmp, "model.params"))
                if trainer is not None:
                    trainer.save_states(os.path.join(tmp, "trainer.states"))
                if ts_blob is not None:
                    with open(os.path.join(tmp, "train_state.json"),
                              "wb") as f:
                        f.write(ts_blob)

            with telemetry.phase("checkpoint"):
                final = self._write_step(step, write_payloads, extra)
            dt = time.perf_counter() - t0
            _SAVE_HIST.observe(dt)
            # a synchronous save blocks training for all of its time
            telemetry.goodput_note("checkpoint", dt)
            _SAVES_TOTAL.inc()
            return final
        with telemetry.phase("checkpoint"):
            writers = self._snapshot_payloads(net, trainer)
            if ts_blob is not None:
                def write_ts(path, _blob=ts_blob):
                    with open(path, "wb") as f:
                        f.write(_blob)

                writers["train_state.json"] = write_ts
        dt_snap = time.perf_counter() - t0
        _SNAPSHOT_HIST.observe(dt_snap)
        # an async save blocks only for the snapshot; the write overlaps
        # training and is not charged
        telemetry.goodput_note("checkpoint", dt_snap)

        def write_payloads(tmp):
            for name, write in writers.items():
                write(os.path.join(tmp, name))

        self._pending_step = step
        self._pending_error = None
        _INFLIGHT.set(1)

        def task():
            try:
                # no telemetry.phase: the step timeline is the main
                # thread's
                self._write_step(step, write_payloads, extra)
                _SAVE_HIST.observe(time.perf_counter() - t0)
                _SAVES_TOTAL.inc()
            except BaseException as e:
                self._pending_error = e
            finally:
                _INFLIGHT.set(0)

        self._pending = threading.Thread(
            target=task, name=f"mxnet-ckpt-save-{step}", daemon=True)
        self._pending.start()
        return self._step_dir(step)

    def _snapshot_payloads(self, net, trainer):
        """Host copies of everything save() writes, as {file name: writer
        of a path}: the blocking half of an async save.  The parameters
        are copied to pinned host memory in one pass, with one
        synchronisation (``host_copies``); so are the optimizer states
        inside ``trainer._states_blob()``."""
        from .ndarray.serialization import host_copies, save as _save

        writers = {}
        if net is not None:
            params = net._collect_params_with_prefix()
            snap = dict(zip(params, host_copies(
                [p.data()._data for p in params.values()])))

            def write_params(path, _snap=snap):
                _save(path, _snap)

            writers["model.params"] = write_params
        if trainer is not None:
            blob = trainer._states_blob()

            def write_states(path, _blob=blob):
                with open(path, "wb") as f:
                    f.write(_blob)

            writers["trainer.states"] = write_states
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
        _single_process("restore")
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

    Returns train_fn's result."""
    from .lifecycle import GracefulExit

    if resharder is not None:
        raise MXNetError("run_with_recovery(resharder=): live resharding "
                         "waits for the port of the multi-GPU slice")
    log = logger or _LOGGER
    if backoff_ms is None:
        backoff_ms = fault.backoff_ms()
    progress = manager.latest_valid_step
    restarts = 0
    last_step = progress() or 0
    fail_t = None      # goodput: failure -> next attempt downtime
    while True:
        start = progress() or 0
        if fail_t is not None:
            telemetry.goodput_note("restart", time.perf_counter() - fail_t)
            fail_t = None
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
            _flight.record_event("lifecycle", event="train_failure",
                                 error=repr(e)[:200])
            _flight.dump_blackbox("run_with_recovery_failure")
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
