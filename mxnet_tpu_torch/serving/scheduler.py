"""Continuous-batching scheduler: requests, the bounded admission queue,
and bucket arithmetic (counterpart of ``mxnet_tpu/serving/scheduler.py``).

The engine runs one loop over two interleaved phases: prefill (admit a
waiting request, run its prompt through the full-context forward, seed its
KV pages) and decode (one token for every active sequence as one batched
step).  This module is the host-side half; nothing here touches a device.
"""
from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from ..base import MXNetError

__all__ = ["Request", "QueueFullError", "DeadlineExceededError",
           "AdmissionQueue", "bucket_for", "parse_buckets"]


class QueueFullError(MXNetError):
    """Admission queue at its bound: raised at submit time, never later."""


class DeadlineExceededError(MXNetError):
    """The request's deadline expired before it produced a result."""


def parse_buckets(spec, what="bucket"):
    """``"1,2,4,8"`` -> sorted unique positive ints."""
    try:
        vals = sorted({int(tok) for tok in str(spec).split(",") if
                       tok.strip()})
    except ValueError:
        raise MXNetError(f"bad {what} spec {spec!r}: comma-separated "
                         "positive integers expected") from None
    if not vals or vals[0] <= 0:
        raise MXNetError(f"bad {what} spec {spec!r}: positive integers "
                         "expected")
    return vals


def bucket_for(n, buckets):
    """Smallest bucket >= n, or None when n exceeds every bucket."""
    for b in buckets:
        if n <= b:
            return b
    return None


_REQ_IDS = itertools.count(1)


class Request:
    """One generation request and its completion future.

    ``prompt`` is a 1-D array of token ids.  ``temperature`` 0 is greedy
    argmax; > 0 samples, draw ``i`` from a generator seeded with
    ``(seed, i)``, so a sampled sequence is a function of the request alone,
    not of batch composition or eviction.  ``deadline`` (monotonic seconds)
    bounds queueing plus generation.  The engine fills ``tokens`` (generated
    ids only) and resolves the request; callers block in :meth:`result`."""

    __slots__ = ("id", "prompt", "max_new_tokens", "temperature", "eos_id",
                 "deadline", "submitted", "first_token_t", "finished_t",
                 "tokens", "error", "_done", "prefills", "seed",
                 "finish_reason")

    def __init__(self, prompt, max_new_tokens=16, temperature=0.0,
                 eos_id=None, deadline_ms=None, seed=0):
        self.id = next(_REQ_IDS)
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise MXNetError("empty prompt")
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens <= 0:
            raise MXNetError("max_new_tokens must be positive")
        self.temperature = float(temperature)
        self.eos_id = eos_id
        now = time.monotonic()
        self.submitted = now
        self.deadline = now + deadline_ms / 1e3 if deadline_ms else None
        self.first_token_t = None
        self.finished_t = None
        self.tokens: list = []
        self.error = None
        self._done = threading.Event()
        self.prefills = 0     # > 1: the sequence was evicted + re-prefilled
        self.seed = int(seed)
        self.finish_reason = None   # "stop" (eos) | "length" (caps)

    def full_ids(self):
        """Prompt plus everything generated so far: the prefill input of a
        post-eviction continuation."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, dtype=np.int32)])

    # -- engine side -------------------------------------------------------
    def resolve(self, error=None):
        self.error = error
        self.finished_t = time.monotonic()
        self._done.set()

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline

    # -- caller side -------------------------------------------------------
    def result(self, timeout=None):
        """Block for the completion dict (raises the request's error)."""
        if not self._done.wait(timeout):
            raise MXNetError(f"request {self.id}: no result within "
                             f"{timeout}s")
        if self.error is not None:
            raise self.error
        ttft = (self.first_token_t - self.submitted) \
            if self.first_token_t else None
        return {
            "request_id": self.id,
            "prompt_len": int(self.prompt.size),
            "token_ids": list(self.tokens),
            "finish_reason": self.finish_reason,
            "ttft_s": ttft,
            "latency_s": self.finished_t - self.submitted,
            "prefills": self.prefills,
        }


class AdmissionQueue:
    """Bounded FIFO with deadline expiry.

    ``put`` raises :class:`QueueFullError` at the bound.  ``requeue``
    (eviction re-admission) is exempt from the bound: the engine already
    accepted that work."""

    def __init__(self, bound):
        self._bound = int(bound)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items: list = []

    def __len__(self):
        with self._lock:
            return len(self._items)

    def put(self, req):
        with self._lock:
            if len(self._items) >= self._bound:
                raise QueueFullError(
                    f"serving queue full ({self._bound} waiting); retry "
                    "with backoff or raise MXNET_SERVING_QUEUE")
            self._items.append(req)
            self._cond.notify()

    def requeue(self, req):
        """Put an evicted sequence's request back at the FRONT."""
        with self._lock:
            self._items.insert(0, req)
            self._cond.notify()

    def pop_ready(self):
        """Next request that has not expired (expired ones resolve with
        DeadlineExceededError and are skipped).  None when empty."""
        now = time.monotonic()
        with self._lock:
            while self._items:
                req = self._items.pop(0)
                if req.expired(now):
                    req.resolve(DeadlineExceededError(
                        f"request {req.id} expired after "
                        f"{now - req.submitted:.3f}s in queue"))
                    continue
                return req
            return None

    def wait_nonempty(self, timeout):
        """Block until an item is (probably) available or timeout."""
        with self._lock:
            if self._items:
                return True
            return self._cond.wait(timeout)

    def drain(self, error_factory):
        """Resolve every waiting request with ``error_factory(req)``."""
        with self._lock:
            items, self._items = self._items, []
        for req in items:
            req.resolve(error_factory(req))
        return len(items)
