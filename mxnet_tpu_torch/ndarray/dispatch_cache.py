"""Dispatch counters of the imperative seam (counterpart of
``mxnet_tpu/ndarray/dispatch_cache.py``'s surface).

The reference compiles every ``invoke`` call into a cached ``jax.jit``
executable and counts hits, misses, evictions and bypasses.  PyTorch runs
each op eagerly, so the port has no executable to cache: it counts
``invoke``'s calls, in all and per op, and reports them under the
reference's keys (every call is an eager dispatch: a ``bypass`` of a cache
that does not exist; ``hits``, ``misses`` and ``evictions`` stay 0).
``mx.nd.dispatch_stats()`` returns them, and the profiler's ``dumps()``
table and ``dump()``'s ``otherData`` read them.
"""
from __future__ import annotations

import threading

from ..base import MXNetError

__all__ = ["set_enabled", "count", "stats", "reset_stats"]

_LOCK = threading.Lock()
_CALLS = {"total": 0}
_PER_OP: dict = {}          # opname -> calls


def set_enabled(flag):
    """``set_eager_jit(True)`` raises: the port dispatches every op
    eagerly.  ``False`` is what the port does; returns the previous
    setting (always False)."""
    if flag:
        raise MXNetError("set_eager_jit(True): the port dispatches every "
                         "op eagerly through PyTorch; it has no jit cache "
                         "to turn on")
    return False


def count(opname):
    """One ``invoke`` call of ``opname``."""
    with _LOCK:
        _CALLS["total"] += 1
        _PER_OP[opname] = _PER_OP.get(opname, 0) + 1


def stats():
    """The counters under the reference's keys, with ``calls`` beside
    them."""
    with _LOCK:
        total = _CALLS["total"]
        per_op = {name: {"calls": n, "hits": 0, "misses": 0, "bypasses": n}
                  for name, n in sorted(_PER_OP.items())}
    return {"enabled": False, "size": 0, "capacity": 0, "hits": 0,
            "misses": 0, "evictions": 0, "bypasses": total, "calls": total,
            "blocklisted": [], "trace_failures": {}, "per_op": per_op}


def reset_stats():
    with _LOCK:
        _CALLS["total"] = 0
        _PER_OP.clear()
