"""Online MFU accounting: FLOPs counted once per signature meet the wall
clock (counterpart of ``mxnet_tpu/introspection.py``).

The reference reads each executable's FLOPs from XLA's cost model when it
compiles it.  PyTorch compiles nothing, so the port counts them once per
signature by running that first call under :func:`counting`
(``torch.utils.flop_counter.FlopCounterMode``, which counts the products:
mm, addmm, bmm, convolutions, SDPA, and here ``mv``): the first call of a
``TrainStep`` signature, the capture of a hybridized block's CUDA graph
(``gluon/_cached_op.py``, its forward and its backward apart), and the
first prefill, decode and sample of each serving bucket.  Every later
call, a replayed CUDA graph included, only adds the stored count on the
host (:func:`account_flops`): no device work, no host read.

The counter cannot see ``flash_attn_fwd`` (a ``ctypes`` launch inside an
``autograd.Function``), and it would count the blockwise backward's
products without knowing them for attention.  So the attention op runs
both uncounted and reports its own forward and backward FLOPs while a
count is active (:func:`report_flops`, under the key ``attention``): 4·D
per (query, key) pair and head forward, 10·D backward (the score
recompute and the four gradient products), over all Lq × Lk pairs (as
the library's SDPA formula counts, causal or not).

Two gauges follow from the trailing window and a per-device peak
registry keyed by ``torch.cuda.get_device_name()``:

- ``mxnet_model_flops_utilization``: accounted FLOPs over ``elapsed ×
  peak × device_count`` for the trailing window.  Created lazily: where
  the peak is unknown (the CPU, a card the table lacks, no
  ``MXNET_DEVICE_PEAK_FLOPS``) the gauge is absent, never present and
  wrong.
- ``mxnet_executable_flops_total{kind}``: the accounted FLOPs by consumer
  (``train_step``, ``hybrid_forward``, ``hybrid_backward``,
  ``serving_prefill``, ``serving_decode``, ``serving_sample``).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

from . import env as _env
from . import telemetry as _telemetry

__all__ = ["device_peak_flops", "flops_of", "counting", "report_flops",
           "counting_active", "uncounted", "count_passes", "account_flops",
           "utilization", "window_stats", "reset"]

# dense bf16 peak FLOP/s by torch.cuda.get_device_name() (the H100 SXM's
# is bench.py's figure; MXNET_DEVICE_PEAK_FLOPS overrides)
_PEAKS = {"NVIDIA H100 80GB HBM3": 989e12,
          "NVIDIA H100 PCIe": 756e12,
          "NVIDIA A100-SXM4-80GB": 312e12,
          "NVIDIA A100-SXM4-40GB": 312e12}

_LOCK = threading.Lock()
_WINDOW: deque = deque(maxlen=512)    # (perf_counter t, flops)
_WINDOW_SUM = [0.0]                   # running sum (no O(window) scans)
_MFU_GAUGE = None                     # created lazily on a first valid value
_DEVICES = [None]                     # cached device count
_KIND_PEAK = [False]                  # cached device-name table lookup
_ACTIVE: list = []                    # the counts running now
_PASSES = [0]                         # counts taken since reset()

_FLOPS_TOTAL = _telemetry.counter(
    "mxnet_executable_flops_total",
    "FLOPs dispatched, counted once per signature, by consumer",
    labelnames=("kind",))


def device_peak_flops():
    """Per-device peak FLOP/s: ``MXNET_DEVICE_PEAK_FLOPS`` when set (read
    at every call), else the table entry of the first card's name, else
    None (unknown: the MFU gauge stays absent)."""
    override = _env.device_peak_flops_override()
    if override > 0:
        return override
    if _KIND_PEAK[0] is False:
        peak = None
        try:
            import torch

            if torch.cuda.is_available():
                peak = _PEAKS.get(torch.cuda.get_device_name(0))
        except Exception:
            peak = None
        _KIND_PEAK[0] = peak
    return _KIND_PEAK[0]


def _device_count():
    if _DEVICES[0] is None:
        try:
            import torch

            _DEVICES[0] = max(1, torch.cuda.device_count())
        except Exception:
            _DEVICES[0] = 1
    return _DEVICES[0]


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
    return 2 * a_shape[0] * a_shape[1]


@contextlib.contextmanager
def counting():
    """Count the FLOPs of what runs inside: yields a dict whose ``flops``
    (products + reports), ``products`` and ``reported`` ({key: FLOPs}) are
    filled in at exit (``so_far()`` reads the count inside).  Backward
    passes run inside count too (autograd's threads carry the mode)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    try:
        mode = FlopCounterMode(display=False,
                               custom_mapping={torch.ops.aten.mv: _mv_flop})
    except TypeError:     # a FlopCounterMode without custom formulas
        mode = FlopCounterMode(display=False)
    rec = {"flops": None, "products": None, "reported": {},
           "thread": threading.get_ident()}
    # the count so far, for a caller that splits one pass (a graph's
    # forward and backward captures)
    rec["so_far"] = lambda: float(mode.get_total_flops()) + \
        sum(rec["reported"].values())
    with _LOCK:
        _ACTIVE.append(rec)
        _PASSES[0] += 1
    try:
        with mode:
            yield rec
    finally:
        with _LOCK:
            _ACTIVE.remove(rec)
    rec["products"] = float(mode.get_total_flops())
    rec["flops"] = rec["products"] + sum(rec["reported"].values())


def counting_active():
    """Whether a count runs (the attention op then runs uncounted and
    reports)."""
    return bool(_ACTIVE)


@contextlib.contextmanager
def uncounted():
    """Run the inside without the FLOP counter (the attention op, which
    reports its FLOPs itself); a no-op when no count runs."""
    if not _ACTIVE:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


def report_flops(flops, key="attention"):
    """Add ``flops`` under ``key`` to the counts of this thread (to every
    running count from a thread that owns none: autograd's backward
    threads)."""
    me = threading.get_ident()
    with _LOCK:
        recs = [r for r in _ACTIVE if r["thread"] == me] or list(_ACTIVE)
        for rec in recs:
            rec["reported"][key] = rec["reported"].get(key, 0.0) + \
                float(flops)


def flops_of(fn, *args, **kwargs):
    """FLOPs of one call ``fn(*args, **kwargs)`` (its result dropped), or
    None when it did no counted work."""
    with counting() as rec:
        fn(*args, **kwargs)
    return rec["flops"] or None


def count_passes():
    """How many counts ran since :func:`reset` (one per signature)."""
    return _PASSES[0]


def account_flops(flops, kind="train_step"):
    """Record one dispatched call's FLOPs: host-side only (a float add, a
    deque append, the gauge's arithmetic).  A None or 0 count is a
    no-op."""
    if not flops:
        return
    now = time.perf_counter()
    _FLOPS_TOTAL.labels(kind=kind).inc(float(flops))
    with _LOCK:
        if len(_WINDOW) == _WINDOW.maxlen:
            # about to evict the oldest entry: keep the running sum exact
            _WINDOW_SUM[0] -= _WINDOW[0][1]
        _WINDOW.append((now, float(flops)))
        _WINDOW_SUM[0] += float(flops)
    _update_gauge(now)


def utilization(now=None):
    """Model FLOPs utilization over the trailing window: accounted FLOPs /
    (elapsed × peak × device count).  None when the peak is unknown or
    fewer than two events are in the window."""
    peak = device_peak_flops()
    if not peak:
        return None
    if now is None:
        now = time.perf_counter()
    with _LOCK:
        if len(_WINDOW) < 2:
            return None
        t0 = _WINDOW[0][0]
        total = _WINDOW_SUM[0]
    dt = now - t0
    if dt <= 0:
        return None
    return total / (dt * peak * _device_count())


def _update_gauge(now):
    global _MFU_GAUGE
    util = utilization(now)
    if util is None:
        return
    if _MFU_GAUGE is None:
        # lazy registration is the fallback contract: with no peak the
        # family never exists, so a scrape sees no data, not a made-up 0
        _MFU_GAUGE = _telemetry.gauge(
            "mxnet_model_flops_utilization",
            "dispatched FLOPs over elapsed x peak x device count "
            "(trailing window; absent when the peak is unknown)")
    _MFU_GAUGE.set(util)


def window_stats():
    """``{"events", "flops", "span_s", "peak", "devices"}`` of the trailing
    window."""
    now = time.perf_counter()
    with _LOCK:
        events = len(_WINDOW)
        total = _WINDOW_SUM[0]
        span = (now - _WINDOW[0][0]) if _WINDOW else 0.0
    return {"events": events, "flops": total, "span_s": span,
            "peak": device_peak_flops(), "devices": _device_count()}


def reset():
    """Clear the window and the pass count (test isolation, timed runs).
    The lazily created gauge family stays registered (telemetry families
    are process-wide); ``telemetry.reset()`` zeroes its value."""
    with _LOCK:
        _WINDOW.clear()
        _WINDOW_SUM[0] = 0.0
        _PASSES[0] = 0
    _DEVICES[0] = None
    _KIND_PEAK[0] = False
