"""Inference serving for the port: the continuous-batching engine over a
paged KV cache."""
from __future__ import annotations

from .engine import ServingEngine
from .kvcache import PagedKVCache, pages_for
from .scheduler import (AdmissionQueue, DeadlineExceededError,
                        QueueFullError, Request, bucket_for, parse_buckets)

__all__ = ["ServingEngine", "PagedKVCache", "pages_for", "Request",
           "AdmissionQueue", "QueueFullError", "DeadlineExceededError",
           "bucket_for", "parse_buckets"]
