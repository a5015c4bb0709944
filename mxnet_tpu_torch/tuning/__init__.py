"""Search-based autotuning: one resolve funnel over every performance
knob, a grid + successive-halving search driver and a persistent
per-signature winner DB (counterpart of ``mxnet_tpu/tuning``).

- template: :mod:`.knobs`, the declared tunables (name, type, legal grid,
  subsumed env var, scorer family);
- search: :mod:`.search`, grid + successive halving with a deterministic
  candidate schedule;
- persistence: :mod:`.db`, winners on disk keyed by signature, plan
  digest, device name and the torch/CUDA fingerprint, sha256-verified,
  published atomically, a corrupt entry a silent miss.

Every consumer resolves its value through ONE funnel::

    value = tuning.resolve("flash_block_q", signature=sig)

The port's consumers: ``prefetch_buffer`` (``gluon/data/prefetcher.py``),
``serving_batch_buckets``, ``serving_prefill_buckets`` and
``serving_page_size`` (``serving/engine.py``), ``flash_block_q`` and
``flash_block_kv`` (``ops/flash_attention.py``).

Precedence, strictly: an active **search trial** override > an
**explicit env pin** (never overridden) > a **stored winner** (only when
``MXNET_TUNE=1``: the warm path replays, it never explores) > the
**default**.  With ``MXNET_TUNE`` unset the funnel never touches the DB.

Telemetry: ``mxnet_tuning_trials_total{knob}`` (search measurements),
``mxnet_tuning_db_{hits,misses,stores}_total`` (DB traffic) and
``mxnet_tuning_chosen_value{knob}`` (the value each knob resolved to;
string-grid knobs export their grid index).
"""
from __future__ import annotations

import contextlib
import os
import threading

from .. import env as _env
from .. import telemetry as _telemetry
from . import db as _dbmod
from .db import TuningDB, default_db, device_kind, resolve_db
from .knobs import Knob, all_knobs, get_knob, knob_names, register_knob
from .search import schedule, successive_halving, tune_knob

__all__ = ["Knob", "TuningDB", "all_knobs", "default_db",
           "device_kind", "effective_config", "enabled", "get_knob",
           "knob_names", "register_knob", "reset", "resolve",
           "resolve_db", "resolve_info", "schedule",
           "successive_halving", "trial_override", "tune_knob"]

_CHOSEN = _telemetry.gauge(
    "mxnet_tuning_chosen_value",
    "the value each knob resolved to through the tuning funnel "
    "(string-grid knobs export their grid index; env pins and tuned "
    "winners both land here — the source rides the bench stamp)",
    labelnames=("knob",))

_LOCK = threading.Lock()
# name -> value, set only inside a search trial (tune_knob);
# consulted first by resolve() so trials measure the candidate without
# mutating the process environment
_TRIAL: dict = {}
# (name, signature, plan_digest, db_dir) -> winner value; the warm
# path's per-process memo so steady-state resolve() costs a dict probe,
# not a file read + sha256 per step
_WINNERS: dict = {}


def enabled():
    """Whether the warm replay path may consult the DB
    (``MXNET_TUNE``, default off — online exploration NEVER happens
    here regardless; only ``tune_knob`` searches)."""
    return _env.tune_enabled()


@contextlib.contextmanager
def trial_override(name, value):
    """Apply a candidate value for the duration of one search trial.
    Every consumer read site sees it through :func:`resolve`; nothing
    escapes the ``with`` — a crashed trial cannot poison the process
    (no env mutation, restore is unconditional)."""
    knob = get_knob(name)
    if knob.apply is not None:
        knob.apply(value)
    with _LOCK:
        prev = _TRIAL.get(name, _TRIAL)
        _TRIAL[name] = value
    try:
        yield value
    finally:
        with _LOCK:
            if prev is _TRIAL:
                _TRIAL.pop(name, None)
            else:
                _TRIAL[name] = prev
        if knob.apply is not None:
            knob.apply(None)


def _gauge_value(knob, value):
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    try:
        return float(knob.grid.index(value))
    except ValueError:
        return -1.0


def resolve_info(name, signature=None, plan_digest=None, db=None):
    """``(value, source)`` for one knob — source is ``trial``, ``env``
    (pinned), ``tuned``, or ``default``.  See the module docstring for
    the precedence contract."""
    knob = get_knob(name)
    with _LOCK:
        if name in _TRIAL:
            return _TRIAL[name], "trial"
    raw = os.environ.get(knob.env_var)
    if raw not in (None, ""):
        value = knob.parse(raw)
        _CHOSEN.labels(knob=name).set(_gauge_value(knob, value))
        return value, "env"
    if enabled():
        d = resolve_db(db)
        if d is not None:
            memo = (name, signature, plan_digest, d.directory)
            with _LOCK:
                if memo in _WINNERS:
                    return _WINNERS[memo], "tuned"
            value = d.get_winner(knob, signature, plan_digest)
            if value is not None:
                with _LOCK:
                    _WINNERS[memo] = value
                _CHOSEN.labels(knob=name).set(_gauge_value(knob, value))
                return value, "tuned"
    return knob.default, "default"


def resolve(name, signature=None, plan_digest=None, db=None):
    """The value a consumer should use for ``name`` — the one funnel
    every read site goes through (see ``resolve_info`` for the
    provenance-carrying variant the bench stamps use)."""
    return resolve_info(name, signature, plan_digest, db)[0]


def effective_config(names=None, signature=None, plan_digest=None):
    """``{knob: {"value", "source"}}`` for every (or the named) knobs —
    the configuration stamp a benchmark records in each result block
    so A/B arms can never silently run different configs."""
    out = {}
    for name in (names if names is not None else knob_names()):
        value, source = resolve_info(name, signature, plan_digest)
        out[name] = {"value": value, "source": source}
    return out


def reset():
    """Drop trial overrides + the winner memo (test isolation; the
    on-disk DB is untouched)."""
    global _WINNERS
    with _LOCK:
        _TRIAL.clear()
        _WINNERS = {}
    _dbmod._DEFAULT = None
    _dbmod._DEFAULT_DIR = None
