"""Declarative registry of tunable performance knobs (counterpart of
``mxnet_tpu/tuning/knobs.py``: the same names, types, env vars, scorer
families, grids and defaults, except the flash-attention tiles).

A search starts from a declared space of legal configurations (TVM's
schedule template, arXiv:1802.04799) and only then measures it.  Every
tunable registers its name, value type, legal grid, the ``MXNET_*`` env
var it subsumes, and which live gauge family scores it (training arms:
step time / MFU; serving arms: tokens/s + p99 TTFT).

The flash-attention tiles differ from the reference's: its grids are MXU
lane tiles (128, 256, 512) of the TPU kernel; the port's are the query
and key tiles the Hopper kernel is built at for D = 64 and 128, 64 or 128
(``csrc/flash_attn_fwd.cu``).  The default, 128, is the tile of those
head dims; D = 32 and 256 keep their one tile (see
``ops/flash_attention.py``).  ``allreduce_bucket_mb`` and
``graph_fuse_cap`` are registered with their grids; their consumers come
with the multi-GPU and graph slices.

The registry is **ordered and closed**: knobs register at import in
source order and :func:`all_knobs` walks them in that order, so two
processes enumerating the search space visit candidates identically —
the same determinism contract bucket assignment already carries
(parallel/bucketing.py).

A knob does NOT read its env var here beyond parsing: precedence
(trial > env pin > tuned winner > default) lives in
``tuning.resolve`` — this module only says what exists and what is
legal.
"""
from __future__ import annotations

__all__ = ["Knob", "register_knob", "get_knob", "all_knobs",
           "knob_names"]


class Knob:
    """One tunable dimension: identity, legality, and how to apply it.

    ``grid`` is the declared legal candidate list, in search order
    (deterministic across processes — never derived from a dict or a
    hash).  ``default`` must be a member of the value space but need
    not sit in the grid; the search driver always prepends it so the
    baseline is measured under the same budget as every candidate.
    ``kind`` routes the knob to a scorer family: ``training`` (step
    time / MFU) or ``serving`` (tokens/s + p99 TTFT).
    """

    __slots__ = ("name", "env_var", "type", "default", "grid", "kind",
                 "description", "apply")

    def __init__(self, name, env_var, type, default, grid, kind,
                 description, apply=None):
        self.name = str(name)
        self.env_var = str(env_var)
        self.type = type
        self.default = default
        self.grid = tuple(grid)
        self.kind = str(kind)
        self.description = str(description)
        # apply hook: how a SEARCH TRIAL takes effect.  The default
        # (None) routes through tuning's trial-override table, which
        # every consumer read site consults via tuning.resolve — no
        # env mutation, so a crashed search never leaves a poisoned
        # process environment behind.
        self.apply = apply

    def parse(self, raw):
        """Parse an env-var/DB string into the knob's value type;
        garbage degrades to the default (the env.get_int contract —
        a typo'd override must never crash a step)."""
        if raw is None:
            return self.default
        if self.type is str:
            return str(raw)
        try:
            return self.type(raw)
        except (TypeError, ValueError):
            import warnings

            warnings.warn(
                f"{self.env_var}={raw!r} is not a valid "
                f"{self.type.__name__} for knob {self.name!r}; using "
                f"default {self.default!r}", stacklevel=2)
            return self.default

    def validate(self, value):
        """Whether ``value`` is inside the declared legal space (grid
        member or the default).  The warm path checks this before
        applying a DB winner: a stale entry from an older grid must
        degrade to the default, never apply an illegal value."""
        return value == self.default or value in self.grid

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Knob({self.name!r}, env={self.env_var}, "
                f"default={self.default!r}, grid={self.grid!r}, "
                f"kind={self.kind})")


_REGISTRY: dict = {}      # name -> Knob, insertion-ordered


def register_knob(knob):
    """Add a knob to the registry (idempotent per name: re-registering
    the same name replaces — module reloads in tests)."""
    _REGISTRY[knob.name] = knob
    return knob


def get_knob(name):
    """The registered :class:`Knob`, or raise KeyError with the legal
    names (a typo'd knob name must fail loudly — unlike a typo'd VALUE,
    which degrades)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown tuning knob {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def all_knobs():
    """Every registered knob, in registration (= search) order."""
    return list(_REGISTRY.values())


def knob_names():
    return list(_REGISTRY)


# --------------------------------------------------------------------------
# the initial population: the hand-picked constants the ROADMAP names
# as the first search dimensions.  Grids stay small on purpose — grid +
# successive halving is exhaustive over them, and every candidate costs
# a real measurement.
# --------------------------------------------------------------------------
register_knob(Knob(
    "allreduce_bucket_mb", "MXNET_ALLREDUCE_BUCKET_MB", int, 32,
    (0, 1, 4, 8, 16, 32, 64, 128), "training",
    "fused-allreduce gradient-bucket cap in MiB (0 = per-key "
    "collectives; parallel/bucketing.py)"))
register_knob(Knob(
    "graph_fuse_cap", "MXNET_GRAPH_FUSE_CAP", int, 16,
    (0, 4, 8, 16, 32, 64), "training",
    "max ops per fused elementwise chain (< 2 disables the pass; "
    "graph/passes.py)"))
register_knob(Knob(
    "flash_block_q", "MXNET_FLASH_BLOCK_Q", int, 128,
    (64, 128), "training",
    "flash-attention forward query tile: 64 or 128 rows, one or two "
    "consumer warpgroups (csrc/flash_attn_fwd.cu; ops/flash_attention.py)"))
register_knob(Knob(
    "flash_block_kv", "MXNET_FLASH_BLOCK_KV", int, 128,
    (64, 128), "training",
    "flash-attention forward key tile: 64 or 128 keys "
    "(csrc/flash_attn_fwd.cu; ops/flash_attention.py)"))
register_knob(Knob(
    "prefetch_buffer", "MXNET_PREFETCH_BUFFER", int, 2,
    (0, 1, 2, 4, 8), "training",
    "device-prefetch queue depth (0 = serial staging; "
    "gluon/data/prefetcher.py)"))
register_knob(Knob(
    "serving_batch_buckets", "MXNET_SERVING_BATCH_BUCKETS", str,
    "1,2,4,8",
    ("1,2,4,8", "1,4,8", "1,2,4,8,16"), "serving",
    "decode batch-size buckets the serving engine AOT-compiles "
    "(serving/engine.py)"))
register_knob(Knob(
    "serving_prefill_buckets", "MXNET_SERVING_PREFILL_BUCKETS", str,
    "32,64,128",
    ("32,64,128", "16,32,64,128", "64,128", "32,128"), "serving",
    "prompt-length prefill buckets (prompts right-pad up; "
    "serving/engine.py)"))
register_knob(Knob(
    "serving_page_size", "MXNET_SERVING_PAGE_SIZE", int, 16,
    (8, 16, 32), "serving",
    "tokens per KV-cache page (serving/kvcache.py)"))
