"""Gradient bucketing (counterpart of ``mxnet_tpu/parallel/bucketing.py``):
deterministic coalescing of many small allreduce payloads into few
size-capped fused ones.  The plan, its signature, ``shard_layout`` and the
counters are the reference's; ``pack``/``unpack`` work on flat torch
tensors.

Reference analog: the dist kvstore's bigarray split (SURVEY.md §4.4 —
``MXNET_KVSTORE_BIGARRAY_BOUND`` decides per-key vs server-sharded traffic)
and PyTorch DDP's gradient buckets (PAPERS.md): K per-parameter collectives
become ``ceil(total_bytes / cap)`` fused ones, so per-collective launch
latency stops dominating when parameters are small.

Determinism contract: bucket assignment is a **pure function of the ordered
``(key, shape, dtype)`` entry list and the byte cap** — no hashing, no
wall-clock, no dict iteration order.  Every process of an SPMD job walks its
parameters in the same construction order, therefore computes the *same*
buckets and issues the *same* collective sequence; the assignment doubles as
part of the collective contract the same way NCCL ring order does in the
reference.  Plans are computed once and cached against the entry-list
signature, so steady-state steps pay two tuple compares, not a re-plan.

Buckets are dtype-segregated (a flat buffer has one dtype; mixing would
silently upcast) and size-capped at ``MXNET_ALLREDUCE_BUCKET_MB`` (default
32 MiB; ``0`` disables fusion entirely).  A single value larger than the cap
gets its own bucket — it is already big enough to saturate the interconnect.
Row-sparse and host-promoted keys never enter a bucket (their payload is
rows, not a stable flat span); callers route them per-key and count them via
:func:`record_bypass`.
"""
from __future__ import annotations

import numpy as _np

from .. import env as _env
from .. import telemetry as _telemetry

__all__ = ["bucket_cap_bytes", "Bucket", "BucketPlan", "assign_buckets",
           "Bucketer", "pack", "unpack", "record_fused", "record_bypass",
           "shard_layout", "float_kind"]

_BUCKETS_TOTAL = _telemetry.counter(
    "mxnet_allreduce_buckets_total",
    "fused (bucketed) gradient collectives issued")
_BUCKET_BYTES = _telemetry.counter(
    "mxnet_allreduce_bucket_bytes_total",
    "flat-buffer bytes moved through fused collectives (counted once per "
    "bucket, never per member)")
_BUCKET_COUNT = _telemetry.gauge(
    "mxnet_allreduce_bucket_count",
    "buckets in the current (most recently planned) assignment")
_BYPASS_TOTAL = _telemetry.counter(
    "mxnet_allreduce_bucket_bypass_total",
    "values routed per-key around the buckets (sparse/host-promoted/"
    "oversized-disabled)")


def bucket_cap_bytes():
    """Fused-bucket size cap in bytes — resolved through the tuning
    funnel (``MXNET_ALLREDUCE_BUCKET_MB`` pin > ``MXNET_TUNE=1``
    stored winner > default 32 MiB; 0 disables fusion).  Import is
    lazy so the tuning tier stays optional on this hot-ish path; with
    tuning off the funnel is an env read, exactly what
    ``_env.allreduce_bucket_mb`` was."""
    try:
        from .. import tuning as _tuning

        return max(0, int(_tuning.resolve("allreduce_bucket_mb"))) << 20
    except Exception:  # pragma: no cover - a broken tuning DB
        return _env.allreduce_bucket_mb() << 20


class Bucket:
    """One flat-buffer assignment: members share a dtype; their ravel'd
    payloads occupy consecutive ``[offset, offset+size)`` spans."""

    __slots__ = ("index", "dtype", "keys", "shapes", "sizes", "offsets",
                 "nbytes")

    def __init__(self, index, dtype):
        self.index = index
        self.dtype = dtype
        self.keys = []
        self.shapes = []
        self.sizes = []
        self.offsets = []
        self.nbytes = 0

    def add(self, key, shape, size, nbytes):
        self.offsets.append(sum(self.sizes))
        self.keys.append(key)
        self.shapes.append(tuple(shape))
        self.sizes.append(int(size))
        self.nbytes += int(nbytes)

    @property
    def fused(self):
        """Whether packing actually coalesces anything (>1 member)."""
        return len(self.keys) > 1

    @property
    def size(self):
        """Total flat elements across members."""
        return sum(self.sizes)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Bucket(#{self.index} dtype={self.dtype} "
                f"n={len(self.keys)} bytes={self.nbytes})")


class BucketPlan:
    """Immutable assignment of an ordered entry list into buckets."""

    def __init__(self, signature, buckets):
        self.signature = signature
        self.buckets = buckets
        self.by_key = {}
        for b in buckets:
            for k, off, size in zip(b.keys, b.offsets, b.sizes):
                self.by_key[k] = (b.index, off, size)


def _entry_signature(entries, cap_bytes):
    return (int(cap_bytes),
            tuple((k, tuple(s), str(d)) for k, s, d in entries))


def _itemsize(dtype):
    """Bytes per element of a dtype name ("float32", "torch.bfloat16",
    "bfloat16"; numpy has no bfloat16)."""
    name = str(dtype).replace("torch.", "")
    if name == "bfloat16":
        return 2
    return _np.dtype(name).itemsize


def assign_buckets(entries, cap_bytes=None):
    """Assign ordered ``(key, shape, dtype)`` entries to dtype-segregated,
    size-capped buckets.  Pure and deterministic: same entries + cap →
    identical plan, across processes and restarts."""
    if cap_bytes is None:
        cap_bytes = bucket_cap_bytes()
    buckets = []
    open_by_dtype = {}
    for key, shape, dtype in entries:
        dtype = str(dtype)
        size = int(_np.prod(shape)) if len(tuple(shape)) else 1
        nbytes = size * _itemsize(dtype)
        if nbytes > cap_bytes:
            # already interconnect-saturating: dedicated bucket, and the
            # open one stays open for the next small value
            b = Bucket(len(buckets), dtype)
            buckets.append(b)
            b.add(key, shape, size, nbytes)
            continue
        b = open_by_dtype.get(dtype)
        if b is None or b.nbytes + nbytes > cap_bytes:
            b = Bucket(len(buckets), dtype)
            buckets.append(b)
            open_by_dtype[dtype] = b
        b.add(key, shape, size, nbytes)
    return BucketPlan(_entry_signature(entries, cap_bytes), buckets)


class Bucketer:
    """Plan cache: recomputes only when the entry signature (or cap)
    changes, so the steady-state step pays a tuple compare."""

    def __init__(self, cap_bytes=None):
        self._cap = cap_bytes
        self._plan = None
        # bumped on every replan; deterministic across SPMD processes
        # (replans are driven by the same model state on every peer).
        # Callers that derive kvstore keys / compression-residual keys
        # from a bucket MUST include this, so state keyed per bucket
        # (e.g. error-feedback residuals) never leaks across plans with
        # different bucket composition.
        self.generation = 0

    def plan_for(self, entries):
        cap = self._cap if self._cap is not None else bucket_cap_bytes()
        sig = _entry_signature(entries, cap)
        if self._plan is None or self._plan.signature != sig:
            self._plan = assign_buckets(entries, cap)
            self.generation += 1
            _BUCKET_COUNT.set(len(self._plan.buckets))
        return self._plan


def float_kind(dtype):
    """True for float-family dtypes — the buckets ZeRO can shard (an
    integer bucket has no meaningful optimizer update)."""
    name = str(dtype).replace("torch.", "")
    return name == "bfloat16" or _np.dtype(name).kind == "f"


def shard_layout(size, dp):
    """ZeRO shard layout for a flat buffer of ``size`` elements over
    ``dp`` ranks: ``(padded_size, shard_size, pad)`` with ``padded_size``
    the smallest dp-divisible size ≥ ``size``.  Deterministic and pure —
    the reduce-scatter/all-gather pair and the persistent sharded
    optimizer state both key off this layout, so it must be identical on
    every peer (and is recomputed, never stored, so a checkpoint can be
    restored onto a different dp)."""
    dp = max(1, int(dp))
    pad = (-int(size)) % dp
    padded = int(size) + pad
    return padded, padded // dp, pad


def pack(values):
    """Concatenate tensors into one flat buffer (members of a bucket, in
    bucket order; a lone member is a flat view, not a copy)."""
    import torch

    if len(values) == 1:
        return values[0].reshape(-1)
    return torch.cat([v.reshape(-1) for v in values])


def unpack(bucket, flat):
    """Slice a (reduced) flat buffer back into per-member arrays."""
    out = []
    for off, size, shape in zip(bucket.offsets, bucket.sizes, bucket.shapes):
        out.append(flat[off:off + size].reshape(shape))
    return out


def record_fused(nbytes):
    """Count one fused collective of ``nbytes`` flat-buffer bytes.  Called
    exactly once per bucket at the site that issues the collective — NOT
    per member — so byte telemetry never double-reports under bucketing."""
    _BUCKETS_TOTAL.inc()
    _BUCKET_BYTES.inc(nbytes)


def record_bypass(n=1):
    """Count values that skipped the buckets (sparse/host-promoted keys)."""
    _BYPASS_TOTAL.inc(n)
