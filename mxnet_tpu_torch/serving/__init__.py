"""Inference serving for the port: the continuous-batching engine over a
paged KV cache, its HTTP routes, the blocking ``serve()`` entry point, and
the serving fleet (:mod:`.fleet`: a router over engine replicas)."""
from __future__ import annotations

from . import fleet
from .engine import ServingEngine, serve
from .kvcache import PagedKVCache, pages_for
from .scheduler import (AdmissionQueue, DeadlineExceededError,
                        QueueFullError, Request, bucket_for, parse_buckets)

__all__ = ["ServingEngine", "serve", "fleet", "PagedKVCache", "pages_for",
           "Request", "AdmissionQueue", "QueueFullError",
           "DeadlineExceededError", "bucket_for", "parse_buckets"]
