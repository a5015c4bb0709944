"""DataLoader with background prefetch (counterpart of
``mxnet_tpu/gluon/data/dataloader.py``; MXNet's
``python/mxnet/gluon/data/dataloader.py``).

Three ways to make a batch: on the consumer's thread (``num_workers=0``),
on a thread pool (the default for ``num_workers > 0``: numpy decode
releases the GIL in its hot paths), or on PROCESS workers
(``thread_pool=False``, for GIL-bound Python transforms).  Process workers
never initialise CUDA: they start with ``spawn`` (``MXNET_MP_START_METHOD``
may say ``forkserver`` or ``fork``; a parent that holds a CUDA context
cannot fork safely), see no card (``CUDA_VISIBLE_DEVICES`` is empty in
them, so a dataset that reaches for the card fails loudly instead of
opening a second context), and hand numpy batches back by pickle; the
parent puts them on the device.

Batches land on the context current where the loader is iterated
(``current_context()``, the first card unless a ``with mx.cpu():`` scope
says otherwise); thread-pool workers make theirs under that same context.
``pin_memory=True`` stages a batch bound for the card from pinned host
memory, and ``prefetch_to_device`` overlaps that copy with the training
step through ``PrefetchIterator``.

``state_dict``/``load_state_dict`` give the exact-resume position that
``lifecycle.capture_train_state(dataloader=)`` records, in the reference's
format: a state either package wrote restores the other's loader.
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor

import numpy as _np
import torch

from ... import telemetry
from ...base import MXNetError
from ...context import Context, current_context
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]

_BATCH_WAIT = telemetry.histogram(
    "mxnet_dataloader_batch_wait_seconds",
    "time the consumer waited for the next batch")
_BATCHES_TOTAL = telemetry.counter(
    "mxnet_dataloader_batches_total", "batches yielded")
_WORKERS_GAUGE = telemetry.gauge(
    "mxnet_dataloader_workers",
    "live process-pool workers (of the most recently active loader)")
_WORKER_DEATHS = telemetry.counter(
    "mxnet_dataloader_worker_deaths_total",
    "abnormal process-worker deaths detected mid-epoch")


def default_batchify_fn(data):
    """Stack samples into a batch of NDArrays on the current context
    (tuples of fields batch field by field)."""
    from ...ndarray.ndarray import NDArray, array

    if isinstance(data[0], NDArray):
        return array(_np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(d)) for d in zip(*data))
    return array(_np.asarray(data))


def default_mp_batchify_fn(data):
    """Stack samples into a NUMPY batch: the worker processes' batchify
    (they touch no device; the parent converts)."""
    if isinstance(data[0], tuple):
        return tuple(default_mp_batchify_fn(list(d)) for d in zip(*data))
    if hasattr(data[0], "asnumpy"):
        return _np.stack([d.asnumpy() for d in data])
    return _np.asarray(data)


_worker_dataset = None


def _hide_cards():
    """Make every card invisible to this process's CUDA runtime, which
    reads ``CUDA_VISIBLE_DEVICES`` when it first initialises."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _worker_initializer(path):
    global _worker_dataset
    _hide_cards()
    with open(path, "rb") as f:
        _worker_dataset = pickle.load(f)


def _terminate_pool(pool, stops=(), path=None):
    # unblock any active epoch's gated() generator FIRST: the pool's
    # task-handler thread sits inside it, and terminate() joins that
    # thread; without the stop signal the join deadlocks
    for s in list(stops):
        s.set()
    pool.terminate()
    pool.join()
    if path is not None:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


class _WorkerFn:
    """Picklable per-batch task: dataset[i] for the batch + batchify."""

    def __init__(self, batchify_fn):
        self._fn = batchify_fn

    def __call__(self, batch):
        from ... import fault

        # armed through MXNET_FAULT_SPEC, which reaches spawned children;
        # an in-process inject() plan does not cross into them
        fault.check("dataloader.worker")
        out = self._fn([_worker_dataset[i] for i in batch])
        if torch.cuda.is_initialized():
            raise MXNetError(
                f"DataLoader worker pid={os.getpid()} initialised CUDA; "
                "workers must hand back numpy or CPU tensors")
        return out


def _host_tensor(a):
    """A numpy array as a CPU tensor with ``nd.array``'s dtypes (float64
    -> float32, int64 -> int32), sharing its memory where no cast is
    needed."""
    t = torch.from_numpy(_np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    elif t.dtype == torch.int64:
        t = t.to(torch.int32)
    return t


def _to_nd(out, ctx, pin):
    """A batch (numpy, tensor or NDArray leaves in tuples) as NDArrays on
    ``ctx``; a batch bound for the card is copied from pinned host memory,
    without blocking, when ``pin``."""
    from ...ndarray.ndarray import NDArray

    if isinstance(out, tuple):
        return tuple(_to_nd(o, ctx, pin) for o in out)
    if isinstance(out, NDArray):
        t = out._data
    elif isinstance(out, torch.Tensor):
        t = out
    elif isinstance(out, _np.ndarray):
        t = _host_tensor(out)
    else:
        return out
    device = ctx.device
    if t.device != device:
        if device.type == "cuda" and pin and not t.is_cuda:
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
    elif isinstance(out, NDArray):
        return out
    elif isinstance(out, _np.ndarray) and \
            t.data_ptr() == out.__array_interface__["data"][0]:
        t = t.clone()   # the NDArray owns its memory, as nd.array's does
    return NDArray._wrap(t.detach())


class DataLoader:
    """Load ``dataset`` in batches: ``batch_size``/``shuffle``/``sampler``/
    ``last_batch`` build a ``BatchSampler`` unless ``batch_sampler`` is
    given; ``batchify_fn`` stacks a batch's samples; ``num_workers``
    threads (``thread_pool=True``) or processes make batches ahead, up to
    ``prefetch`` of them (default 2 per worker).

    ``prefetch_to_device``: ``True`` overlaps the copy of the next batches
    to the current context's device with the training step
    (``PrefetchIterator``, depth ``MXNET_PREFETCH_BUFFER``, default 2; 0
    stages inline); a Context or ``torch.device`` names the device.
    ``pin_memory`` stages batches bound for the card from pinned host
    memory."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True, prefetch_to_device=None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._pin_memory = pin_memory
        self._thread_pool = thread_pool
        self._prefetch = max(0, prefetch or 2 * max(num_workers, 1))
        self._prefetch_to_device = prefetch_to_device
        self._proc_pool = None          # persistent process pool (a spawn
        self._proc_pool_method = None   # costs an interpreter per worker)
        self._pool_file = None          # the pickled dataset it reads
        self._pool_finalizer = None
        self._active_stops = set()      # stop events of live epoch iters
        # exact-resume position: the live epoch, the batches the CONSUMER
        # received from it, the batch-sampler state at that epoch's start,
        # and a pending resume point the next __iter__ applies
        self._epoch = -1
        self._batches_served = 0
        self._epoch_start_state = None
        self._skip_next = 0
        self._resume = None

    def __len__(self):
        return len(self._batch_sampler)

    def state_dict(self):
        """Resume point for :meth:`load_state_dict`: the live epoch, how
        many batches the consumer already received from it, and the
        batch-sampler state as of the epoch start (shuffle seed + epoch +
        rollover carry).  Capture at a step boundary; one active iterator
        per loader (the training loop's)."""
        if self._resume is not None:
            # captured before an __iter__ consumed the armed resume point
            return dict(self._resume)
        return {"epoch": max(self._epoch, 0),
                "batch": self._batches_served,
                "sampler": self._epoch_start_state}

    def load_state_dict(self, state):
        """Arm the next ``__iter__`` to resume at ``state``: the sampler
        regenerates the recorded epoch's index sequence and the first
        ``state["batch"]`` batches are skipped without decoding (only
        index lists are consumed; ``dataset[i]`` is never called for
        them)."""
        self._resume = dict(state or {})

    def _begin_epoch(self):
        """Apply epoch numbering (and any armed resume point) before the
        underlying iterator is built."""
        resume, self._resume = self._resume, None
        if resume is not None:
            self._epoch = int(resume.get("epoch") or 0)
            self._skip_next = int(resume.get("batch") or 0)
            sd = resume.get("sampler")
            if sd is not None and hasattr(self._batch_sampler,
                                          "load_state_dict"):
                self._batch_sampler.load_state_dict(sd)
            elif self._skip_next:
                # the count can be skipped but not the order: a sampler
                # that reshuffles would repeat or lose samples
                import warnings

                warnings.warn(
                    "DataLoader resume: the batch sampler "
                    + ("recorded no state (no state_dict())"
                       if sd is None else
                       "cannot restore its recorded state "
                       "(no load_state_dict())")
                    + f"; skipping {self._skip_next} batches of a "
                    "potentially DIFFERENT order: the resumed sequence "
                    "is only bit-identical for deterministic samplers",
                    stacklevel=3)
        else:
            self._epoch += 1
            self._skip_next = 0
        se = getattr(self._batch_sampler, "set_epoch", None)
        if se is not None:
            se(self._epoch)
        self._epoch_start_state = self._batch_sampler.state_dict() \
            if hasattr(self._batch_sampler, "state_dict") else None
        # skipped batches were already consumed by the interrupted run
        self._batches_served = self._skip_next

    def _epoch_batches(self):
        """Index-batches of the current epoch, the resume skip applied on
        index lists only."""
        it = iter(self._batch_sampler)
        skip, self._skip_next = self._skip_next, 0
        for _ in range(skip):
            if next(it, None) is None:
                return
        yield from it

    def _target(self):
        """(the context batches land on, the prefetch device or None)."""
        ctx = current_context()
        pf = self._prefetch_to_device
        if not pf:
            return ctx, None
        if pf is True:
            return ctx, ctx.device
        return ctx, pf.device if isinstance(pf, Context) else \
            torch.device(pf)

    def __iter__(self):
        # the batch wait (consumer asks -> batch ready) is the stall the
        # training loop feels; the device prefetcher sits inside it
        self._begin_epoch()
        ctx, pf_device = self._target()
        # with a device prefetcher, batches stay on the host until it
        # stages them (from pinned memory: it pins what it copies)
        it = self._iter_impl(Context("cpu") if pf_device is not None
                             else ctx)
        pf = None
        if pf_device is not None:
            from .prefetcher import PrefetchIterator

            pf = it = PrefetchIterator(it, device=pf_device)
        try:
            while True:
                t0 = _time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                _BATCH_WAIT.observe(_time.perf_counter() - t0)
                _BATCHES_TOTAL.inc()
                self._batches_served += 1
                yield batch
        finally:
            # on exhaustion, break and GC alike: a dead worker's error must
            # not strand the prefetch thread
            if pf is not None:
                pf.close()

    def _iter_impl(self, ctx):
        # with pin_memory, a batch bound for the card is made on the host
        # and copied from pinned memory
        pin = self._pin_memory and ctx.device.type == "cuda"
        make = Context("cpu") if pin else ctx
        if self._num_workers == 0:
            for batch in self._epoch_batches():
                yield self._load(batch, make, ctx, pin)
            return
        if self._thread_pool:
            yield from self._threaded_iter(make, ctx, pin)
        else:
            yield from self._process_iter(ctx, pin)

    def _load(self, batch, make, ctx, pin):
        """One batch, batchified under the context ``make`` (on any
        thread), then put on ``ctx``."""
        with make:
            out = self._batchify_fn([self._dataset[i] for i in batch])
        return _to_nd(out, ctx, True) if pin else out

    def _process_iter(self, ctx, pin):
        """Process workers (reference: _MultiWorkerIter): numpy batches by
        pickle, NDArrays made here.  The pool persists across epochs;
        workers snapshot the dataset once, at pool creation, so build a new
        DataLoader for a changed dataset.  The dataset and batchify must
        pickle (no lambdas), and a script that iterates at top level needs
        an ``if __name__ == "__main__":`` guard, as with any spawn."""
        import multiprocessing as mp

        fn = self._batchify_fn
        if fn is default_batchify_fn:
            fn = default_mp_batchify_fn
        pool = self._get_proc_pool()
        # bound the work in flight: imap's feeder would otherwise queue the
        # whole epoch; the stop event frees the feeder if the consumer
        # abandons the epoch
        sem = threading.BoundedSemaphore(self._num_workers + self._prefetch)
        stop = threading.Event()
        # registered so close() can unblock gated() for an abandoned epoch
        self._active_stops.add(stop)

        def gated():
            for b in self._epoch_batches():
                while not sem.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                yield b

        # the Pool replaces a dead worker silently, but the batch it held
        # never completes; polling the ORIGINAL processes' exit codes sees
        # the death (a worker never exits on its own while the pool lives)
        workers = list(pool._pool)
        it = pool.imap(_WorkerFn(fn), gated())
        idx = 0
        try:
            while True:
                try:
                    out = it.next(timeout=0.2)
                except StopIteration:
                    break
                except mp.TimeoutError:
                    dead = [p for p in workers if p.exitcode is not None]
                    _WORKERS_GAUGE.set(len(workers) - len(dead))
                    if dead:
                        _WORKER_DEATHS.inc(len(dead))
                        # the lost batch makes the pool's bookkeeping
                        # unknowable: discard it (stop first: the teardown
                        # joins the task-handler thread inside gated())
                        stop.set()
                        self._abandon_proc_pool()
                        raise MXNetError(
                            "DataLoader process worker(s) died while "
                            f"computing batch {idx}: "
                            + ", ".join(f"pid={p.pid} exitcode={p.exitcode}"
                                        for p in dead)
                            + " (killed by the OOM killer or a signal?); "
                            "the worker pool was recycled: re-iterate to "
                            "respawn workers")
                    continue
                except MXNetError:
                    raise
                except Exception as e:
                    # the worker's failure, pickled back: name the batch
                    raise MXNetError(
                        f"DataLoader worker failed on batch {idx}: "
                        f"{type(e).__name__}: {e}") from e
                sem.release()
                yield _to_nd(out, ctx, pin)
                idx += 1
        finally:
            stop.set()
            self._active_stops.discard(stop)

    def _get_proc_pool(self):
        import multiprocessing as mp
        import weakref

        method = os.environ.get("MXNET_MP_START_METHOD") or "spawn"
        if self._proc_pool is not None and self._proc_pool_method == method:
            return self._proc_pool
        self._shutdown_proc_pool()
        ctx = mp.get_context(method)
        # the dataset goes to the workers through a file, pickled once: as
        # an initializer argument it would ride each worker's start pipe,
        # which the pool writes one worker after another and a spawned
        # child reads only after importing the main module, so the workers
        # would start in turn instead of together
        fd, path = tempfile.mkstemp(prefix="mxnet-dataloader-",
                                    suffix=".pkl")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(self._dataset, f, protocol=pickle.HIGHEST_PROTOCOL)
        # the children inherit the environment at their start: no card
        # is visible to them (the initializer says so again, for workers a
        # forkserver or the pool's maintenance thread starts later)
        prev = os.environ.get("CUDA_VISIBLE_DEVICES")
        _hide_cards()
        try:
            pool = ctx.Pool(self._num_workers,
                            initializer=_worker_initializer,
                            initargs=(path,))
        except BaseException:
            os.unlink(path)
            raise
        finally:
            if prev is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = prev
        self._proc_pool = pool
        self._proc_pool_method = method
        self._pool_file = path
        _WORKERS_GAUGE.set(self._num_workers)
        # terminate the workers (and remove the file) when the loader is
        # collected or at exit; the finalizer holds the stop events, not
        # the loader, so that a teardown with a live epoch does not
        # deadlock on its join
        self._pool_finalizer = weakref.finalize(
            self, _terminate_pool, pool, self._active_stops, path)
        return pool

    def _shutdown_proc_pool(self):
        for s in list(self._active_stops):
            s.set()   # see _terminate_pool: unblock gated() before join
        if self._pool_finalizer is not None:
            self._pool_finalizer()  # terminates + joins, idempotent
            self._pool_finalizer = None
        if self._proc_pool is not None:
            _WORKERS_GAUGE.set(0)
        self._proc_pool = None
        self._proc_pool_method = None
        self._pool_file = None

    def _abandon_proc_pool(self):
        """Discard a pool poisoned by a worker's death: a SIGKILLed child
        may have died holding a queue lock, so an orderly terminate+join
        could deadlock.  Kill the children and run the blocking teardown
        on a daemon thread; the iterator raises at once."""
        pool = self._proc_pool
        if pool is None:
            return
        if self._pool_finalizer is not None:
            self._pool_finalizer.detach()
            self._pool_finalizer = None
        path, self._pool_file = self._pool_file, None
        self._proc_pool = None
        self._proc_pool_method = None
        _WORKERS_GAUGE.set(0)
        for p in list(pool._pool):
            try:
                p.kill()
            except Exception:  # already reaped
                pass
        threading.Thread(target=_terminate_pool, args=(pool, (), path),
                         daemon=True).start()

    def close(self):
        """Release the worker processes now instead of at GC or exit.  The
        loader stays usable: the next process-worker epoch starts a fresh
        pool.  Also a context manager: ``with DataLoader(...) as dl:``."""
        self._shutdown_proc_pool()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _threaded_iter(self, make, ctx, pin):
        pool = ThreadPoolExecutor(max_workers=self._num_workers)
        batches = list(self._epoch_batches())

        def load(batch):
            return self._load(batch, make, ctx, pin)

        try:
            futures = queue.Queue()
            it = iter(batches)
            primed = 0
            for batch in it:
                futures.put(pool.submit(load, batch))
                primed += 1
                if primed >= self._prefetch:
                    break
            while not futures.empty():
                f = futures.get()
                try:
                    futures.put(pool.submit(load, next(it)))
                except StopIteration:
                    pass
                yield f.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
