"""The ``MXNET_*`` environment knobs the port reads (counterpart of
``mxnet_tpu/env.py``: the same names, defaults and parsing of malformed
values, for the knobs of the planes the port has).

Wired vars:

- ``MXNET_SEED``: seeds the global RNG at import (``random.seed``).
- ``MXNET_FAULT_SPEC``: deterministic fault injection,
  ``<seam>:fail[:times[:Error]]``, comma-separated; see
  :mod:`mxnet_tpu_torch.fault`.  Read lazily at the first seam check.
- ``MXNET_FAULT_MAX_RETRIES``: retry budget for transient errors
  (default 3).
- ``MXNET_FAULT_BACKOFF_MS``: first-retry backoff seed in ms (doubles per
  retry, full jitter, 30 s cap; default 100).
- ``MXNET_TELEMETRY_PORT``: opt-in HTTP telemetry endpoint (``/metrics``,
  ``/snapshot``, ``/healthz``) on 127.0.0.1:<port>, started at import;
  unset/0 = no server.
- ``MXNET_TELEMETRY_TIMELINE_STEPS``: step-timeline ring capacity
  (default 256).
- ``MXNET_TELEMETRY_AGG_DIR``: the shared directory of the cross-rank
  snapshot files (``telemetry_agg``), and the fallback of
  ``MXNET_FLIGHT_DIR``.
- ``MXNET_TELEMETRY_AGG_EVERY``: publish/merge the snapshots every N-th
  step-boundary tick (default 0 = off).
- ``MXNET_TELEMETRY_AGG_TRANSPORT``: ``file`` (the shared directory,
  default) or ``kv`` (the launcher's ``torch.distributed`` TCPStore).
- ``MXNET_LEDGER_SKEW_THRESHOLD``, ``MXNET_LEDGER_SKEW_WINDOWS``: the
  cross-rank ledger-skew alert (default 0 = off; 3 merges).
- ``MXNET_PROFILER_AUTOSTART``: start ``profiler`` with profile_all at
  import.
- ``MXNET_DEVICE_PEAK_FLOPS``: per-device peak FLOP/s for the MFU gauge
  (default 0 = the device-name table of ``introspection``).
- ``MXNET_TUNE``: replay stored tuning winners (default 0);
  ``MXNET_TUNE_DB_DIR``: the tuning DB's directory.
- ``MXNET_FLASH_BLOCK_Q``, ``MXNET_FLASH_BLOCK_KV``: pin the
  flash-attention kernel's query and key tiles (``tuning`` knobs).
- ``MXNET_GUARD`` and ``MXNET_GUARD_*``: the numerical-integrity guard
  (``guard.py``): window, spike thresholds, skip, rewind, sync stride,
  checksum and canary.
- ``MXNET_WATCHDOG_TIMEOUT_S``: the stall watchdog's per-step deadline
  (default 0 = off; started at import when set), ``MXNET_WATCHDOG_ABORT``
  (default 1) and ``MXNET_WATCHDOG_DIR`` (its diagnosis files).
- ``MXNET_FLIGHT_RECORDER``: the flight-recorder ring (default 1).
- ``MXNET_FLIGHT_RECORDER_CAP``: its capacity in events (default 4096).
- ``MXNET_FLIGHT_DIR``: directory for ``blackbox.rank<N>.json`` dumps
  (default ``MXNET_TELEMETRY_AGG_DIR``; neither set = no dumps).
- ``MXNET_WORKER_ID`` / ``DMLC_WORKER_ID`` / ``RANK``,
  ``MXNET_NUM_WORKERS`` / ``DMLC_NUM_WORKER`` / ``WORLD_SIZE``: launcher
  rank and world size.
- ``MXNET_GOODPUT_SLO``, ``MXNET_GOODPUT_SLO_WINDOWS``: goodput-ratio SLO
  alerting (default 0 = off; 3 windows).
- ``MXNET_TRACE_REQUESTS``: per-request serving traces (default 1).
- ``MXNET_TRACE_KEEP_SLOWEST``: slowest-N traces always kept (default 16).
- ``MXNET_GRACE_PERIOD_S``: seconds between a stop request and a forced
  exit (default 0 = none).
- ``MXNET_SERVING_PORT``: default port of ``serving.serve`` (0 = free).
- ``MXNET_SERVING_MAX_BATCH``, ``MXNET_SERVING_BATCH_BUCKETS``,
  ``MXNET_SERVING_PREFILL_BUCKETS``, ``MXNET_SERVING_QUEUE``,
  ``MXNET_SERVING_KV_PAGES``, ``MXNET_SERVING_PAGE_SIZE``,
  ``MXNET_SERVING_DEADLINE_MS``: the serving engine's grids and bounds.
- ``MXNET_FLEET_REPLICAS``: serving-fleet replica count behind the router
  (default 2; ``serving.fleet.serve_fleet``).
- ``MXNET_FLEET_HEDGE_MS``: floor in ms of the hedged-duplicate delay
  (default 50; the delay is max(this, the observed p99 dispatch latency)).
- ``MXNET_FLEET_RETRY_BUDGET``: per-request transient-retry budget of a
  router-to-replica dispatch (default 2).
- ``MXNET_FLEET_PROBE_INTERVAL_MS``: the router's health-probe period in
  ms (default 250, at least 10).
- ``MXNET_FLEET_EJECT_THRESHOLD``: consecutive dispatch/probe failures
  before the circuit breaker ejects a replica (default 3).
- ``MXNET_PREEMPTION_CHECKPOINT``: a graceful stop publishes a final
  synchronous checkpoint (default 1; ``lifecycle.
  publish_final_checkpoint``).
- ``MXNET_CHECKPOINT_ASYNC``: ``CheckpointManager.save``'s default
  ``async_`` (default 0).
- ``MXNET_PREFETCH_BUFFER``: ``PrefetchIterator``'s depth (default 2; 0 =
  staged on the caller's thread).
- ``MXNET_CPU_WORKER_NTHREADS``: ``io.ImageRecordIter``'s decode-pool
  width (default 4).
- ``MXNET_MP_START_METHOD``: the DataLoader's process-worker start method
  (default spawn; forkserver or fork on request).

- ``MXNET_ZERO``: ZeRO-1 optimizer-state sharding on the bucketed
  gradient path (default 0; ``parallel.zero``).
- ``MXNET_ALLREDUCE_BUCKET_MB``: the fused-allreduce bucket cap in MiB
  (default 32; 0 = per-key collectives; a ``tuning`` knob).
- ``MXNET_KVSTORE_BIGARRAY_BOUND``: elements above which a kvstore value
  gets its own collective (default 1000000).
- ``MXNET_STOP_SYNC_EVERY``: the cross-process stop agreement of
  ``lifecycle.check_stop`` every N-th call (default 1).
- ``MXNET_LIFECYCLE_SIGNALS``: ``parallel.distributed.init`` installs the
  graceful-stop signal handlers (default 1).
- ``MXNET_PLANNER_MESH``: default mesh of the sharding planner (``auto``
  or an explicit ``dp=4,tp=2`` spec; ``parallel.planner``).
- ``MXNET_PLANNER_HBM_GB``: per-device memory budget in GiB of the
  planner's auto mesh selection (default: the first CUDA card's memory,
  16.0 without a card).
- ``MXNET_PLANNER_PIPELINE_IN_JIT``: the reference's pipeline-layout flag,
  carried by the plan; both values run the same pipeline here (default 0).
- ``MXNET_PLANNER_REPORT``: print the planner's ``visualize_sharding``
  report whenever a plan is computed (default 0).

The knobs of planes not ported yet (graph, compile cache) wait for their
code.
"""
from __future__ import annotations

import os
import warnings

__all__ = ["get_str", "get_int", "get_bool", "get_float",
           "serving_max_batch", "serving_batch_buckets",
           "serving_prefill_buckets", "serving_queue_bound",
           "serving_kv_pages", "serving_page_size", "serving_deadline_ms",
           "serving_port", "grace_period_s", "flight_recorder_enabled",
           "flight_recorder_cap", "flight_dir", "telemetry_agg_dir",
           "launcher_rank", "launcher_world", "goodput_slo",
           "goodput_slo_windows", "trace_requests", "trace_keep_slowest",
           "fleet_replicas", "fleet_hedge_ms", "fleet_retry_budget",
           "fleet_probe_interval_ms", "fleet_eject_threshold",
           "preemption_checkpoint_default",
           "checkpoint_async_default", "prefetch_buffer",
           "cpu_worker_nthreads", "telemetry_agg_every",
           "telemetry_agg_transport", "ledger_skew_threshold",
           "ledger_skew_windows", "tune_enabled", "tune_db_dir",
           "guard_enabled", "guard_window", "guard_loss_spike",
           "guard_grad_spike", "guard_skip", "guard_rewind_after",
           "guard_sync_every", "guard_checksum", "guard_canary_every",
           "device_peak_flops_override", "watchdog_timeout_s",
           "zero_enabled", "allreduce_bucket_mb", "kvstore_bigarray_bound",
           "stop_sync_every", "planner_mesh", "planner_hbm_gb",
           "planner_pipeline_in_jit", "planner_report", "describe",
           "apply_env"]


def get_str(name, default=None):
    return os.environ.get(name, default)


def get_int(name, default=0):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        warnings.warn(f"{name}={v!r} is not an integer; using {default}",
                      stacklevel=2)
        return default


def get_bool(name, default=False):
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


def get_float(name, default=0.0):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        warnings.warn(f"{name}={v!r} is not a number; using {default}",
                      stacklevel=2)
        return default


def serving_max_batch():
    """Decode-batch admission cap (MXNET_SERVING_MAX_BATCH, default 8)."""
    return max(1, get_int("MXNET_SERVING_MAX_BATCH", 8))


def serving_batch_buckets():
    """Decode batch-size buckets (MXNET_SERVING_BATCH_BUCKETS, default
    "1,2,4,8")."""
    return get_str("MXNET_SERVING_BATCH_BUCKETS", "1,2,4,8")


def serving_prefill_buckets():
    """Prompt-length buckets (MXNET_SERVING_PREFILL_BUCKETS, default
    "32,64,128")."""
    return get_str("MXNET_SERVING_PREFILL_BUCKETS", "32,64,128")


def serving_queue_bound():
    """Admission-queue bound (MXNET_SERVING_QUEUE, default 64)."""
    return max(1, get_int("MXNET_SERVING_QUEUE", 64))


def serving_kv_pages():
    """KV-cache pool pages (MXNET_SERVING_KV_PAGES, default 512; page 0 is
    the reserved scratch page)."""
    return max(2, get_int("MXNET_SERVING_KV_PAGES", 512))


def serving_page_size():
    """Tokens per KV-cache page (MXNET_SERVING_PAGE_SIZE, default 16)."""
    return max(1, get_int("MXNET_SERVING_PAGE_SIZE", 16))


def serving_deadline_ms():
    """Default per-request deadline in ms (MXNET_SERVING_DEADLINE_MS,
    default 0 = none)."""
    return max(0, get_int("MXNET_SERVING_DEADLINE_MS", 0))


def serving_port():
    """Default port of serving.serve's HTTP endpoint (MXNET_SERVING_PORT,
    default 0 = pick a free port)."""
    return max(0, get_int("MXNET_SERVING_PORT", 0))


def grace_period_s():
    """Stop-request -> forced-exit deadline (MXNET_GRACE_PERIOD_S, default
    0 = no forced exit)."""
    return max(0.0, get_float("MXNET_GRACE_PERIOD_S", 0.0))


def preemption_checkpoint_default():
    """Whether a graceful preemption stop publishes a final synchronous
    checkpoint (MXNET_PREEMPTION_CHECKPOINT, default on)."""
    return get_bool("MXNET_PREEMPTION_CHECKPOINT", True)


def checkpoint_async_default():
    """Default for CheckpointManager.save(async_=None)
    (MXNET_CHECKPOINT_ASYNC, default off)."""
    return get_bool("MXNET_CHECKPOINT_ASYNC", False)


def cpu_worker_nthreads():
    """Default worker-pool width of the data path's decode and augment
    stages (MXNET_CPU_WORKER_NTHREADS, default 4)."""
    return max(1, get_int("MXNET_CPU_WORKER_NTHREADS", 4))


def prefetch_buffer():
    """Device-prefetch queue depth (MXNET_PREFETCH_BUFFER, default 2; 0
    disables the background prefetch pipeline)."""
    return max(0, get_int("MXNET_PREFETCH_BUFFER", 2))


def launcher_rank():
    """Launcher-provided rank (MXNET_WORKER_ID / DMLC_WORKER_ID, or the
    torch launcher's RANK; default 0), read from the environment alone,
    so that it is known before any process group exists."""
    for name in ("MXNET_WORKER_ID", "DMLC_WORKER_ID", "RANK"):
        v = os.environ.get(name)
        if v:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def launcher_world():
    """Launcher-provided world size (MXNET_NUM_WORKERS / DMLC_NUM_WORKER,
    or the torch launcher's WORLD_SIZE; default 1)."""
    for name in ("MXNET_NUM_WORKERS", "DMLC_NUM_WORKER", "WORLD_SIZE"):
        v = os.environ.get(name)
        if v:
            try:
                return max(1, int(v))
            except ValueError:
                pass
    return 1


def telemetry_agg_dir():
    """Shared directory of the per-rank snapshot files the cross-rank
    aggregator gathers (MXNET_TELEMETRY_AGG_DIR; required for
    aggregation, and the fallback of :func:`flight_dir`)."""
    return get_str("MXNET_TELEMETRY_AGG_DIR")


def telemetry_agg_every():
    """Cross-rank aggregation stride in step-boundary ticks
    (MXNET_TELEMETRY_AGG_EVERY, default 0 = off)."""
    return max(0, get_int("MXNET_TELEMETRY_AGG_EVERY", 0))


def telemetry_agg_transport():
    """Snapshot-gather transport: ``file`` (the shared directory, default)
    or ``kv`` (the launcher's torch.distributed store;
    MXNET_TELEMETRY_AGG_TRANSPORT).  Black-box dumps are always files."""
    v = (get_str("MXNET_TELEMETRY_AGG_TRANSPORT", "file") or
         "file").strip().lower()
    return v if v in ("file", "kv") else "file"


def ledger_skew_threshold():
    """Cross-rank collective-ledger spread that arms the pre-hang alert
    (MXNET_LEDGER_SKEW_THRESHOLD, default 0 = off)."""
    return max(0, get_int("MXNET_LEDGER_SKEW_THRESHOLD", 0))


def ledger_skew_windows():
    """Consecutive above-threshold merges before the ledger-skew alert
    fires (MXNET_LEDGER_SKEW_WINDOWS, default 3)."""
    return max(1, get_int("MXNET_LEDGER_SKEW_WINDOWS", 3))


def tune_enabled():
    """Replay stored tuning winners (MXNET_TUNE, default off; the warm
    path never searches)."""
    return get_bool("MXNET_TUNE", False)


def tune_db_dir():
    """Directory of the persistent tuning DB (MXNET_TUNE_DB_DIR)."""
    return get_str("MXNET_TUNE_DB_DIR")


def guard_enabled():
    """The numerical-integrity guard's master gate (MXNET_GUARD,
    default 0)."""
    return get_bool("MXNET_GUARD", False)


def guard_window():
    """The guard's trailing robust window in steps (MXNET_GUARD_WINDOW,
    default 64, at least 8)."""
    return max(8, get_int("MXNET_GUARD_WINDOW", 64))


def guard_loss_spike():
    """Robust-z threshold of a loss spike (MXNET_GUARD_LOSS_SPIKE,
    default 10.0; <= 0 disables the sentinel)."""
    return get_float("MXNET_GUARD_LOSS_SPIKE", 10.0)


def guard_grad_spike():
    """Robust-z threshold of a gradient-norm anomaly
    (MXNET_GUARD_GRAD_SPIKE, default 10.0; <= 0 disables it)."""
    return get_float("MXNET_GUARD_GRAD_SPIKE", 10.0)


def guard_skip():
    """Zero the update on an anomalous verdict (MXNET_GUARD_SKIP,
    default 1; 0 = observe only)."""
    return get_bool("MXNET_GUARD_SKIP", True)


def guard_rewind_after():
    """Anomalies within the window before the ladder rewinds to the
    latest valid checkpoint (MXNET_GUARD_REWIND_AFTER, default 0 =
    off)."""
    return max(0, get_int("MXNET_GUARD_REWIND_AFTER", 0))


def guard_sync_every():
    """Take the guard's host read every N-th check
    (MXNET_GUARD_SYNC_EVERY, default 1)."""
    return max(1, get_int("MXNET_GUARD_SYNC_EVERY", 1))


def guard_checksum():
    """Stamp per-bucket checksums into the flight recorder
    (MXNET_GUARD_CHECKSUM, default 0)."""
    return get_bool("MXNET_GUARD_CHECKSUM", False)


def guard_canary_every():
    """Canary recompute every N guarded steps (MXNET_GUARD_CANARY_EVERY,
    default 0 = off)."""
    return max(0, get_int("MXNET_GUARD_CANARY_EVERY", 0))


def device_peak_flops_override():
    """Per-device peak FLOP/s for the MFU gauge
    (MXNET_DEVICE_PEAK_FLOPS, default 0 = the device-name table)."""
    return max(0.0, get_float("MXNET_DEVICE_PEAK_FLOPS", 0.0))


def watchdog_timeout_s():
    """The stall watchdog's per-step deadline in seconds
    (MXNET_WATCHDOG_TIMEOUT_S, default 0 = off)."""
    return max(0.0, get_float("MXNET_WATCHDOG_TIMEOUT_S", 0.0))


def flight_recorder_enabled():
    """Flight-recorder gate (MXNET_FLIGHT_RECORDER, default on)."""
    return get_bool("MXNET_FLIGHT_RECORDER", True)


def flight_recorder_cap():
    """Flight-recorder ring capacity in events (MXNET_FLIGHT_RECORDER_CAP,
    default 4096, at least 8)."""
    return max(8, get_int("MXNET_FLIGHT_RECORDER_CAP", 4096))


def flight_dir():
    """Directory for black-box dumps (MXNET_FLIGHT_DIR, default
    MXNET_TELEMETRY_AGG_DIR; None when neither is set: no dumps)."""
    return get_str("MXNET_FLIGHT_DIR") or telemetry_agg_dir()


def goodput_slo():
    """Goodput-ratio SLO in [0, 1] (MXNET_GOODPUT_SLO, default 0 = off)."""
    return min(1.0, max(0.0, get_float("MXNET_GOODPUT_SLO", 0.0)))


def goodput_slo_windows():
    """Consecutive below-SLO windows before the alert fires
    (MXNET_GOODPUT_SLO_WINDOWS, default 3)."""
    return max(1, get_int("MXNET_GOODPUT_SLO_WINDOWS", 3))


def trace_requests():
    """Per-request serving traces (MXNET_TRACE_REQUESTS, default on)."""
    return get_bool("MXNET_TRACE_REQUESTS", True)


def trace_keep_slowest():
    """How many of the slowest completed request traces are always kept
    (MXNET_TRACE_KEEP_SLOWEST, default 16)."""
    return max(1, get_int("MXNET_TRACE_KEEP_SLOWEST", 16))


def fleet_replicas():
    """Serving-fleet replica count behind the router
    (MXNET_FLEET_REPLICAS, default 2; serving/fleet)."""
    return max(1, get_int("MXNET_FLEET_REPLICAS", 2))


def fleet_hedge_ms():
    """Hedged-duplicate delay floor in ms (MXNET_FLEET_HEDGE_MS,
    default 50; the router hedges at max(floor, observed p99))."""
    return max(0, get_int("MXNET_FLEET_HEDGE_MS", 50))


def fleet_retry_budget():
    """Per-request transient-retry budget for router-to-replica dispatch
    (MXNET_FLEET_RETRY_BUDGET, default 2)."""
    return max(0, get_int("MXNET_FLEET_RETRY_BUDGET", 2))


def fleet_probe_interval_ms():
    """Router health-probe period in ms (MXNET_FLEET_PROBE_INTERVAL_MS,
    default 250)."""
    return max(10, get_int("MXNET_FLEET_PROBE_INTERVAL_MS", 250))


def fleet_eject_threshold():
    """Consecutive dispatch/probe failures before the circuit breaker
    ejects a replica (MXNET_FLEET_EJECT_THRESHOLD, default 3)."""
    return max(1, get_int("MXNET_FLEET_EJECT_THRESHOLD", 3))


def zero_enabled():
    """ZeRO-1 optimizer-state sharding on the bucketed gradient path
    (MXNET_ZERO, default off; parallel/zero.py)."""
    return get_bool("MXNET_ZERO", False)


def allreduce_bucket_mb():
    """Fused-allreduce gradient-bucket cap in MiB
    (MXNET_ALLREDUCE_BUCKET_MB, default 32; 0 disables fusion)."""
    return max(0, get_int("MXNET_ALLREDUCE_BUCKET_MB", 32))


def kvstore_bigarray_bound():
    """Elements above which a kvstore value gets its own collective
    (MXNET_KVSTORE_BIGARRAY_BOUND, default 1e6)."""
    return get_int("MXNET_KVSTORE_BIGARRAY_BOUND", 1000000)


def stop_sync_every():
    """The cross-process stop agreement runs every N-th check_stop() call
    (MXNET_STOP_SYNC_EVERY, default 1)."""
    return max(1, get_int("MXNET_STOP_SYNC_EVERY", 1))


def planner_mesh():
    """Default mesh of PlannerConfig(mesh=None): "auto" or an explicit
    "dp=4,tp=2"-style spec (MXNET_PLANNER_MESH, default auto)."""
    return get_str("MXNET_PLANNER_MESH", "auto")


def planner_hbm_gb():
    """Per-device memory budget in GiB of the planner's auto mesh
    selection (MXNET_PLANNER_HBM_GB).  Unset (or not positive): the first
    CUDA card's memory (``total_memory``), so every rank of one machine
    type plans against the same number; 16.0, the reference's default,
    where there is no card."""
    v = get_float("MXNET_PLANNER_HBM_GB", 0.0)
    if v > 0:
        return v
    import torch

    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.total_memory / float(1 << 30)
    return 16.0


def planner_pipeline_in_jit():
    """The reference's stage-layout flag of the pipeline
    (MXNET_PLANNER_PIPELINE_IN_JIT, default 0).  The plan carries it; the
    port's pipeline holds each stage on its own rank either way."""
    return get_bool("MXNET_PLANNER_PIPELINE_IN_JIT", False)


def planner_report():
    """Print the visualize_sharding report whenever a plan is computed
    (MXNET_PLANNER_REPORT, default 0)."""
    return get_bool("MXNET_PLANNER_REPORT", False)


_WIRED = (
    ("MXNET_SEED", "global RNG seed at import (random.seed)"),
    ("MXNET_FAULT_SPEC", "deterministic fault injection spec "
     "(<seam>:fail[:times[:Error]], comma-separated; mxnet_tpu_torch.fault)"),
    ("MXNET_FAULT_MAX_RETRIES", "transient-error retry budget (default 3)"),
    ("MXNET_FAULT_BACKOFF_MS", "retry backoff seed in ms (default 100; "
     "doubles per retry, full jitter)"),
    ("MXNET_TELEMETRY_PORT", "opt-in HTTP telemetry endpoint (/metrics "
     "Prometheus, /snapshot JSON; unset/0 = off)"),
    ("MXNET_TELEMETRY_TIMELINE_STEPS", "step-timeline ring capacity "
     "(default 256)"),
    ("MXNET_TELEMETRY_AGG_DIR", "shared directory of the cross-rank "
     "snapshot files; fallback directory of the black-box dumps"),
    ("MXNET_TELEMETRY_AGG_EVERY", "cross-rank aggregation stride in "
     "step-boundary ticks (default 0 = off)"),
    ("MXNET_TELEMETRY_AGG_TRANSPORT", "snapshot gather: file (default) or "
     "kv (the launcher's torch.distributed store)"),
    ("MXNET_LEDGER_SKEW_THRESHOLD", "ledger-skew pre-hang alert threshold "
     "(default 0 = off)"),
    ("MXNET_LEDGER_SKEW_WINDOWS", "consecutive merges before the ledger-"
     "skew alert (default 3)"),
    ("MXNET_PROFILER_AUTOSTART", "start the profiler at import"),
    ("MXNET_DEVICE_PEAK_FLOPS", "per-device peak FLOP/s for the MFU gauge "
     "(default 0 = the device-name table)"),
    ("MXNET_TUNE", "replay stored tuning winners (default 0)"),
    ("MXNET_TUNE_DB_DIR", "directory of the persistent tuning DB"),
    ("MXNET_FLASH_BLOCK_Q", "flash-attention query tile (tuning knob)"),
    ("MXNET_FLASH_BLOCK_KV", "flash-attention key tile (tuning knob)"),
    ("MXNET_GUARD", "numerical-integrity guard (default 0)"),
    ("MXNET_GUARD_WINDOW", "guard robust window in steps (default 64)"),
    ("MXNET_GUARD_LOSS_SPIKE", "loss-spike robust-z threshold (default 10)"),
    ("MXNET_GUARD_GRAD_SPIKE", "grad-norm robust-z threshold (default 10)"),
    ("MXNET_GUARD_SKIP", "skip the update on an anomaly (default 1)"),
    ("MXNET_GUARD_REWIND_AFTER", "anomalies in the window before a rewind "
     "(default 0 = off)"),
    ("MXNET_GUARD_SYNC_EVERY", "guard host read every N-th check "
     "(default 1)"),
    ("MXNET_GUARD_CHECKSUM", "per-bucket checksum stamps (default 0)"),
    ("MXNET_GUARD_CANARY_EVERY", "canary recompute stride (default 0)"),
    ("MXNET_WATCHDOG_TIMEOUT_S", "stall watchdog deadline in seconds "
     "(default 0 = off)"),
    ("MXNET_WATCHDOG_ABORT", "a tripped watchdog exits with status 45 "
     "(default 1)"),
    ("MXNET_WATCHDOG_DIR", "directory of the watchdog's diagnosis files"),
    ("MXNET_FLIGHT_RECORDER", "flight-recorder ring (default 1)"),
    ("MXNET_FLIGHT_RECORDER_CAP", "flight-recorder ring capacity in events "
     "(default 4096)"),
    ("MXNET_FLIGHT_DIR", "directory for blackbox.rank<N>.json dumps "
     "(default = MXNET_TELEMETRY_AGG_DIR; neither set = no dumps)"),
    ("MXNET_GOODPUT_SLO", "goodput-ratio SLO (default 0 = alerting off)"),
    ("MXNET_GOODPUT_SLO_WINDOWS", "consecutive below-SLO windows before "
     "the goodput alert fires (default 3)"),
    ("MXNET_TRACE_REQUESTS", "per-request serving span traces (default 1)"),
    ("MXNET_TRACE_KEEP_SLOWEST", "slowest-N request traces always retained "
     "(default 16)"),
    ("MXNET_GRACE_PERIOD_S", "stop-request -> forced-exit deadline "
     "(default 0 = none)"),
    ("MXNET_PREEMPTION_CHECKPOINT", "a graceful stop publishes a final "
     "synchronous checkpoint (default 1)"),
    ("MXNET_CHECKPOINT_ASYNC", "CheckpointManager.save's default async_ "
     "(default 0)"),
    ("MXNET_PREFETCH_BUFFER", "PrefetchIterator depth (default 2; 0 = "
     "synchronous staging)"),
    ("MXNET_CPU_WORKER_NTHREADS", "ImageRecordIter decode-pool width "
     "(default 4)"),
    ("MXNET_MP_START_METHOD", "DataLoader process-worker start method "
     "(default spawn)"),
    ("MXNET_SERVING_PORT", "serving.serve HTTP endpoint port (default 0 = "
     "pick free; routes mount beside /metrics)"),
    ("MXNET_SERVING_MAX_BATCH", "serving decode-batch admission cap "
     "(default 8)"),
    ("MXNET_SERVING_BATCH_BUCKETS", "decode batch-size buckets (default "
     "1,2,4,8)"),
    ("MXNET_SERVING_PREFILL_BUCKETS", "prompt-length prefill buckets "
     "(default 32,64,128)"),
    ("MXNET_SERVING_QUEUE", "serving admission-queue bound (default 64; "
     "full = clean 429 rejection)"),
    ("MXNET_SERVING_KV_PAGES", "KV-cache pool pages (default 512; page 0 "
     "reserved as scratch)"),
    ("MXNET_SERVING_PAGE_SIZE", "tokens per KV-cache page (default 16)"),
    ("MXNET_SERVING_DEADLINE_MS", "default per-request serving deadline in "
     "ms (default 0 = none)"),
    ("MXNET_FLEET_REPLICAS", "serving-fleet replica count behind the router "
     "(default 2; serving/fleet)"),
    ("MXNET_FLEET_HEDGE_MS", "hedged-duplicate delay floor in ms (default "
     "50; effective delay = max(floor, observed p99))"),
    ("MXNET_FLEET_RETRY_BUDGET", "per-request transient-retry budget for "
     "router-to-replica dispatch (default 2)"),
    ("MXNET_FLEET_PROBE_INTERVAL_MS", "router health-probe period in ms "
     "(default 250)"),
    ("MXNET_FLEET_EJECT_THRESHOLD", "consecutive failures before the "
     "circuit breaker ejects a replica (default 3)"),
    ("MXNET_ZERO", "ZeRO-1 sharded optimizer state (default 0)"),
    ("MXNET_ALLREDUCE_BUCKET_MB", "fused-allreduce bucket cap in MiB "
     "(default 32; 0 = per-key)"),
    ("MXNET_KVSTORE_BIGARRAY_BOUND", "elements above which a kvstore "
     "value gets its own collective (default 1000000)"),
    ("MXNET_STOP_SYNC_EVERY", "stop-agreement stride of check_stop "
     "(default 1)"),
    ("MXNET_LIFECYCLE_SIGNALS", "distributed.init installs the stop "
     "signal handlers (default 1)"),
    ("MXNET_COORDINATOR_ADDRESS", "host:port of process 0 (alias "
     "DMLC_PS_ROOT_URI + DMLC_PS_ROOT_PORT)"),
    ("MXNET_NUM_WORKERS", "launcher world size (alias DMLC_NUM_WORKER; "
     "default 1)"),
    ("MXNET_WORKER_ID", "launcher rank (alias DMLC_WORKER_ID)"),
    ("MXNET_PLANNER_MESH", "default planner mesh: auto or "
     "\"dp=4,tp=2\"-style spec (parallel/planner)"),
    ("MXNET_PLANNER_HBM_GB", "per-device memory budget in GiB of the "
     "planner's auto mesh (default: the card's memory)"),
    ("MXNET_PLANNER_PIPELINE_IN_JIT", "the plan's pipeline-layout flag "
     "(default 0)"),
    ("MXNET_PLANNER_REPORT", "print the plan report when a plan is "
     "computed (default 0)"),
)


def describe():
    """One line per knob the port reads: its current value and what it
    maps to."""
    return "\n".join(f"{name}={os.environ.get(name, '<unset>')} — {what}"
                     for name, what in _WIRED)


def apply_env():
    """Apply the import-time knobs (called once from
    ``mxnet_tpu_torch/__init__``): MXNET_SEED, MXNET_TELEMETRY_PORT,
    MXNET_PROFILER_AUTOSTART and MXNET_WATCHDOG_TIMEOUT_S."""
    seed = os.environ.get("MXNET_SEED")
    if seed:
        from . import random as _random

        _random.seed(int(seed))
    port = get_int("MXNET_TELEMETRY_PORT", 0)
    if port > 0:
        from . import telemetry

        try:
            telemetry.start_http_server(port)
        except OSError as e:
            # another process on this host (a parent, a peer rank) holds
            # the port: recording still works, only the endpoint is missing
            warnings.warn(
                f"MXNET_TELEMETRY_PORT={port}: endpoint not started ({e}); "
                "another process on this host likely holds the port",
                stacklevel=2)
    if get_bool("MXNET_PROFILER_AUTOSTART"):
        from . import profiler

        profiler.set_config(profile_all=True)
        profiler.start()
    if watchdog_timeout_s() > 0:
        from . import lifecycle

        lifecycle.start_watchdog()
