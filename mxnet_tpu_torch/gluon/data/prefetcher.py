"""Device prefetch: keep the next N batches in flight to the card
(counterpart of ``mxnet_tpu/gluon/data/prefetcher.py``).

A background thread pulls batches from the source iterator, stages each
array in pinned host memory and copies it to the card with
``non_blocking=True`` on a side CUDA stream, then records an event.  The
consumer's stream waits on that event before it uses the batch, and every
staged tensor is ``record_stream``-ed on the consumer's stream, so the
caching allocator does not hand its memory out again while the step still
reads it.  The copies ride the copy engine while the previous step
computes.

Depth is the ``prefetch_buffer`` tuning knob (``MXNET_PREFETCH_BUFFER``,
default 2: one batch in transfer, one ready); ``0`` stages each batch on the caller's thread and stream, with no
pipeline.  An error in the source (or in staging) is raised to the
consumer at its next batch, never swallowed.  ``close()`` (also run by a
finalizer when the iterator is dropped) stops and joins the thread and
drops the batches still queued.  A CPU target (``device="cpu"``, as the
tests run) stages on the CPU with no streams.
"""
from __future__ import annotations

import queue
import threading
import time as _time
import weakref

import numpy as _np
import torch

from ... import telemetry as _telemetry
from ...base import MXNetError
from ...context import resolve_device
from ...ndarray.ndarray import NDArray

__all__ = ["PrefetchIterator", "device_put_batch"]

_HITS = _telemetry.counter(
    "mxnet_prefetch_hits_total",
    "batch requests served from a ready (already prefetched) batch")
_MISSES = _telemetry.counter(
    "mxnet_prefetch_misses_total",
    "batch requests that had to wait on the prefetch pipeline")
_DEPTH = _telemetry.gauge(
    "mxnet_prefetch_depth",
    "batches staged and ready (of the most recently active prefetcher)")
_WAIT = _telemetry.histogram(
    "mxnet_prefetch_wait_seconds",
    "time the consumer blocked waiting for a prefetched batch")

_ITEM, _END, _ERR = 0, 1, 2


def device_put_batch(batch, device=None):
    """Stage one batch on ``device`` (default: the first CUDA card),
    keeping its structure: tuples and lists are walked, NDArray, torch
    and numpy leaves become NDArrays on the device, anything else passes
    through.  A host tensor bound for the card is pinned first and copied
    without blocking, on the current stream."""
    device = resolve_device(device)

    def put(leaf):
        if isinstance(leaf, (tuple, list)):
            return type(leaf)(put(x) for x in leaf)
        if isinstance(leaf, NDArray):
            t = leaf._data
        elif isinstance(leaf, torch.Tensor):
            t = leaf
        elif isinstance(leaf, _np.ndarray):
            t = torch.from_numpy(leaf)
        else:
            return leaf
        t = t.detach()
        if device.type == "cuda" and not t.is_cuda:
            if not t.is_pinned():
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        elif t.device != device:
            t = t.to(device)
        return NDArray._wrap(t)

    return put(batch)


def _tensors(batch):
    if isinstance(batch, (tuple, list)):
        for x in batch:
            yield from _tensors(x)
    elif isinstance(batch, NDArray):
        yield batch._data


def _drain(q):
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def _finalize(stop, q, thread):
    # module-level, so the finalizer keeps no reference to the iterator;
    # the drain unblocks a producer waiting in put()
    stop.set()
    _drain(q)
    if thread is not None and thread.is_alive():
        thread.join(timeout=5)


class PrefetchIterator:
    """Wrap a batch iterator with an N-deep device-prefetch pipeline::

        it = PrefetchIterator(iter(batches))
        for x, y in it:
            loss = step(x, y)      # x, y already on the card
        it.close()                 # or rely on the finalizer
    """

    def __init__(self, source, depth=None, device=None, stage_fn=None):
        if depth is None:
            from ... import tuning as _tuning

            depth = _tuning.resolve("prefetch_buffer")
        self._depth = max(0, int(depth))
        self._device = resolve_device(device)
        self._stage = stage_fn or (
            lambda b: device_put_batch(b, self._device))
        self._source = iter(source)
        self._error = None
        self._done = False
        if self._depth == 0:
            self._q = self._thread = self._stop = self._finalizer = None
            return
        self._side = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" else None
        self._q = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._producer, name="mxnet-prefetch", daemon=True)
        self._finalizer = weakref.finalize(
            self, _finalize, self._stop, self._q, self._thread)
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _put(self, msg):
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _stage_on_side(self, item):
        """(the staged batch, the event its copies complete at)."""
        if self._side is None:
            return self._stage(item), None
        with torch.cuda.stream(self._side):
            staged = self._stage(item)
            event = torch.cuda.Event()
            event.record(self._side)
        return staged, event

    def _producer(self):
        try:
            for item in self._source:
                if not self._put((_ITEM, self._stage_on_side(item))):
                    return
            self._put((_END, None))
        except BaseException as e:
            self._error = e   # visible even if the sentinel put is raced
            self._put((_ERR, e))

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        return self

    def _hand_over(self, staged, event):
        """Make the consumer's stream wait for the copies, and tie each
        tensor's memory to that stream."""
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _tensors(staged):
                if t.is_cuda:
                    t.record_stream(stream)
        return staged

    def __next__(self):
        if self._done:
            raise StopIteration
        if self._q is None:  # depth 0: staged here, on this stream
            try:
                return self._stage(next(self._source))
            except StopIteration:
                self._done = True
                raise
        t0 = _time.perf_counter()
        hit = not self._q.empty()
        while True:
            try:
                kind, val = self._q.get(timeout=0.2)
                break
            except queue.Empty:
                if self._thread is not None and not self._thread.is_alive():
                    self._done = True
                    if self._error is not None:
                        raise self._error
                    raise MXNetError(
                        "prefetch thread died without delivering a batch "
                        "or an error")
        _WAIT.observe(_time.perf_counter() - t0)
        _DEPTH.set(self._q.qsize())
        if kind == _ITEM:
            (_HITS if hit else _MISSES).inc()
            return self._hand_over(*val)
        self._done = True
        if kind == _ERR:
            raise val
        raise StopIteration

    def close(self):
        """Stop the thread and drop the queued batches.  Idempotent."""
        self._done = True
        if self._finalizer is not None:
            self._finalizer()
        self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
