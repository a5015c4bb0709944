"""The ``MXNET_SERVING_*`` knobs the serving engine reads (counterpart of
``mxnet_tpu/env.py``'s serving accessors: same names, same defaults)."""
from __future__ import annotations

import os
import warnings

__all__ = ["serving_max_batch", "serving_batch_buckets",
           "serving_prefill_buckets", "serving_queue_bound",
           "serving_kv_pages", "serving_page_size", "serving_deadline_ms"]


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
