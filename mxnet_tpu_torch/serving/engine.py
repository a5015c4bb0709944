"""Serving engine: continuous batching over a paged KV cache (counterpart of
``mxnet_tpu/serving/engine.py``, the core of ``ServingEngine``).

One engine owns one model's frozen weights and a
:class:`~mxnet_tpu_torch.serving.kvcache.PagedKVCache`, and runs one loop
thread.  One iteration is one engine step:

1. **admit** — pop waiting requests (deadline-expired ones resolve with a
   clean error), allocate KV pages, run the prompt (right-padded to a
   prefill bucket) through the full-context forward, whose attention is the
   flash-attention kernel on the card, scatter every layer's k/v into the
   request's pages, and sample the first token.
2. **decode** — one batched single-token step for every active sequence,
   padded to a batch bucket: rows at arbitrary positions share one step,
   new k/v is scattered into each row's pages, each row's context is
   gathered back from its page table, the logits are sampled (greedy or
   seeded temperature), and the ONE host sync of the step fetches the
   tokens.
3. **retire** — finished sequences (max tokens / EOS / context cap) free
   their pages and resolve their futures.

PyTorch runs eagerly, so the reference's jitted prefill/decode/sample
executables are plain functions here (``_prefill_body``, ``_decode_body``,
``_sample_body``); the scatter into pages and the gather of
``pool[layer][table]`` happen in place on the pool tensors.

Around the loop, as in the reference: the telemetry metric families
(``mxnet_serving_*``), per-request span traces (``serving/tracing.py``),
the fault seams ``serving.admit`` and ``serving.decode_step``, the
lifecycle stop poll, ``stats()``, the HTTP routes mounted beside
``/metrics`` and :func:`serve`.  A SIGTERM (or ``close(drain=True)``)
stops admission, lets in-flight sequences finish, rejects queued work with
a clean error, and :func:`serve` returns ``lifecycle.EXIT_PREEMPTED``.

Replica handoff: :meth:`ServingEngine.join_replica` builds a second engine
on a running donor's weights (the same tensors on the same card, no copy)
with a KV pool of its own; the serving fleet (``serving/fleet``) puts a
router in front of such replicas.  Closing an engine frees its KV pool at
once and leaves the weights to whoever else holds them.  The reference's
FLOP accounting (the introspection plane) is not ported yet.
"""
from __future__ import annotations

import json
import logging
import operator
import secrets
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import _kernels
from .. import env as _env
from .. import fault as _fault
from .. import flight_recorder as _flight
from .. import lifecycle
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import resolve_device
from ..gluon.model_zoo.language.llama import (LlamaForCausalLM, _dense_nb,
                                              _prefill_trunk, decode_apply,
                                              serving_params)
from .kvcache import PagedKVCache, pages_for
from .scheduler import (AdmissionQueue, DeadlineExceededError,
                        QueueFullError, Request, bucket_for, parse_buckets)
from .tracing import RequestTrace, TraceStore

__all__ = ["ServingEngine", "serve"]

_LOGGER = logging.getLogger(__name__)


# -- metric families (the reference's; registered once, always recording) --
_G_QUEUE = _telemetry.gauge(
    "mxnet_serving_queue_depth", "requests waiting for admission")
_G_ACTIVE = _telemetry.gauge(
    "mxnet_serving_active_sequences", "sequences in the decode batch")
_H_OCCUPANCY = _telemetry.histogram(
    "mxnet_serving_batch_occupancy",
    "decode-batch fill ratio (active rows / padded bucket rows)",
    buckets=[0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0])
_H_PHASE = _telemetry.histogram(
    "mxnet_serving_phase_seconds",
    "serving step time by phase (prefill includes the first-token "
    "sample; decode includes sampling + the per-step token fetch)",
    labelnames=("phase",))
_H_LATENCY = _telemetry.histogram(
    "mxnet_serving_request_seconds", "request latency, submit -> done")
_H_TTFT = _telemetry.histogram(
    "mxnet_serving_ttft_seconds", "time to first token")
_C_TOKENS = _telemetry.counter(
    "mxnet_serving_tokens_total", "tokens processed",
    labelnames=("kind",))
_C_REQS = _telemetry.counter(
    "mxnet_serving_requests_total", "finished requests by outcome",
    labelnames=("outcome",))
_C_EVICT = _telemetry.counter(
    "mxnet_serving_evictions_total",
    "sequences evicted from the KV pool back to the queue")
_G_PAGES = _telemetry.gauge(
    "mxnet_serving_kv_pages", "KV-cache pool pages",
    labelnames=("state",))
_G_TOKS_S = _telemetry.gauge(
    "mxnet_serving_tokens_per_s",
    "generated tokens/s over the trailing window")
_G_TOKS_CHIP = _telemetry.gauge(
    "mxnet_tokens_per_s_per_chip",
    "generated tokens/s per device over the trailing window (the "
    "serving half of online utilization accounting)")
# observed by the replica handoff (join_replica)
_H_JOIN = _telemetry.histogram(
    "mxnet_serving_join_to_first_token_seconds",
    "replica handoff: wall time from joining (params donated by a "
    "running engine) to this replica's first generated token")
_C_STEP_FAIL = _telemetry.counter(
    "mxnet_serving_step_failures_total",
    "engine-loop steps that raised and were absorbed (incl. injected "
    "serving.decode_step faults) — the loop retries, state untorn")


# one engine loop at a time runs a step on a device: PyTorch releases the
# GIL around every op, so two replicas' loops in one process would hand it
# back and forth at each of a step's hundreds of launches, and decode far
# slower in all than taking turns (PERF.md, the serving fleet).  A loop
# holds its device's turn for a whole step.
_TURNS: dict = {}
_TURNS_LOCK = threading.Lock()


def _device_turn(device):
    with _TURNS_LOCK:
        return _TURNS.setdefault(str(device), threading.Lock())


def _draw_seed(seed, step):
    """Generator seed of draw ``step`` of a request seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step])
               .generate_state(1, np.uint64)[0])


class _Seq:
    """One active sequence: its request plus cache bookkeeping.

    ``cache_len`` counts tokens whose k/v live in the pool; the next decode
    step feeds ``last_token`` at position ``cache_len``."""

    __slots__ = ("req", "cache_len", "last_token")

    def __init__(self, req, cache_len, last_token):
        self.req = req
        self.cache_len = cache_len
        self.last_token = last_token


class ServingEngine:
    """Continuous-batching inference engine for the llama model zoo.

    ``net`` is a (dense) ``LlamaForCausalLM``; its parameters are served
    as they are (frozen-weights semantics: a served model does not train).
    ``device=None`` means the first CUDA card; the net must live on the
    engine's device.  Bucket grids default from the ``MXNET_SERVING_*``
    knobs (``env.py``); ``trace_requests`` defaults from
    ``MXNET_TRACE_REQUESTS``.  ``name`` labels the engine in ``stats()``.
    ``params_from`` (a running engine) donates its weights instead of
    ``serving_params(net)``: see :meth:`join_replica`."""

    # consecutive step failures before the loop stops retrying and fails
    # the in-flight work (~2.5 s at the 0.05 s per-failure backoff)
    _MAX_CONSEC_STEP_FAILURES = 50

    def __init__(self, net, *, batch_buckets=None, prefill_buckets=None,
                 kv_pages=None, page_size=None, queue_bound=None,
                 max_batch=None, deadline_ms=None, name=None,
                 trace_requests=None, device=None, params_from=None):
        if not isinstance(net, LlamaForCausalLM):
            raise MXNetError("ServingEngine serves the model-zoo llama "
                             f"family, got {type(net).__name__}")
        cfg = net.config
        if cfg.num_experts > 0:
            raise MXNetError("incremental decode does not support MoE "
                             "FFNs yet (prefill/decode_apply contract)")
        self._device = resolve_device(device)
        if net.device != self._device:
            raise MXNetError(f"the net lives on {net.device}, the engine "
                             f"on {self._device}: move the net first")
        self._cfg = cfg
        self._name = name or "llama"
        # replica handoff (join_replica): the donor's frozen params ARE
        # this engine's weights, the same tensors, never read again from
        # the net; the join-to-first-token clock starts here
        self._join_t0 = None
        if params_from is None:
            self._params = dict(serving_params(net))
        else:
            if params_from._device != self._device:
                raise MXNetError(
                    f"join_replica: the donor serves on "
                    f"{params_from._device}, this engine on {self._device}; "
                    "donating weights across devices needs the multi-GPU "
                    "plane, which is not ported yet")
            if vars(params_from._cfg) != vars(cfg):
                raise MXNetError("join_replica: the donor serves another "
                                 "model configuration than this net's")
            self._params = dict(params_from._params)
            self._join_t0 = time.monotonic()
        self._batch_buckets = list(batch_buckets) if batch_buckets else \
            parse_buckets(_env.serving_batch_buckets(), "batch bucket")
        self._prefill_buckets = list(prefill_buckets) if prefill_buckets \
            else parse_buckets(_env.serving_prefill_buckets(),
                               "prefill bucket")
        self._page_size = int(page_size or _env.serving_page_size())
        pages = int(kv_pages or _env.serving_kv_pages())
        self._max_batch = int(max_batch or _env.serving_max_batch())
        if self._max_batch > max(self._batch_buckets):
            raise MXNetError(
                f"max_batch {self._max_batch} exceeds the largest batch "
                f"bucket {max(self._batch_buckets)}")
        self._deadline_ms = deadline_ms if deadline_ms is not None else \
            _env.serving_deadline_ms()
        self._kv = PagedKVCache(cfg.num_layers, cfg.num_kv_heads,
                                cfg.head_dim, pages, self._page_size,
                                dtype=net.dtype, device=self._device)
        self._turn = _device_turn(self._device)
        # longest context a sequence can reach: the model's window and the
        # pool minus scratch both cap it
        self._ctx_cap = min(cfg.max_seq_len, (pages - 1) * self._page_size)
        self._page_buckets = self._make_page_buckets()
        if max(self._prefill_buckets) > self._ctx_cap:
            raise MXNetError(
                f"prefill bucket {max(self._prefill_buckets)} exceeds the "
                f"context cap {self._ctx_cap} (max_seq_len / KV pool)")
        self._queue = AdmissionQueue(
            queue_bound or _env.serving_queue_bound(),
            on_expire=lambda r: _C_REQS.labels(outcome="expired").inc())
        self._active: list = []
        self._n_chips = 1                      # one card per engine
        self._trace_enabled = bool(
            trace_requests if trace_requests is not None
            else _env.trace_requests())
        self._traces = TraceStore()
        self._lock = threading.Lock()   # guards the latency/TTFT deques
        self._stop_evt = threading.Event()     # close() requested
        self._drain = True                     # finish in-flight on stop
        self._drained = False                  # loop ran its final drain
        self._thread = None
        self._warm = False
        self._warmed: list = []                # signatures the warm-up ran
        self._latencies: deque = deque(maxlen=2048)
        self._ttfts: deque = deque(maxlen=2048)
        self._tok_window: deque = deque(maxlen=64)   # (t, n_generated)
        self._mounted: list = []

    # -- bucket grids ------------------------------------------------------
    def _make_page_buckets(self):
        cap = pages_for(self._ctx_cap, self._page_size)
        out, b = [], 1
        while b < cap:
            out.append(b)
            b *= 2
        out.append(cap)
        return out

    # -- step bodies -------------------------------------------------------
    def _prefill_body(self, ids_full, Lb, table):
        """Prefill one prompt right-padded to ``Lb``: every layer's k/v is
        scattered into the pages of ``table`` in place (pad positions go to
        scratch page 0).  Returns the logits (V,) at the last real
        position."""
        cfg, ps, dev = self._cfg, self._page_size, self._device
        L = int(ids_full.size)
        ids = np.zeros((1, Lb), dtype=np.int64)
        ids[0, :L] = ids_full
        pids = np.zeros(Lb, dtype=np.int64)
        pids[:L] = np.asarray(table)[np.arange(L) // ps]
        pids = torch.as_tensor(pids, device=dev)
        offs = torch.arange(Lb, device=dev) % ps
        kp, vp = self._kv.k_pool, self._kv.v_pool

        def kv_sink(i, k, v):                   # k/v (1, Hkv, Lb, hd)
            kp[i][pids, :, offs] = k[0].transpose(0, 1)
            vp[i][pids, :, offs] = v[0].transpose(0, 1)

        x = _prefill_trunk(self._params, cfg, torch.as_tensor(ids, device=dev),
                           kv_sink)
        return _dense_nb(x[0, L - 1], self._params["lm_head.weight"])

    def _decode_body(self, ids, pos, table):
        """One batched decode step: ids/pos (B,), table (B, P) on the
        device; padded rows point at scratch.  Returns logits (B, V)."""
        cfg, ps = self._cfg, self._page_size
        B, P = table.shape
        Hkv, hd = cfg.num_kv_heads, cfg.head_dim
        rows = torch.arange(B, device=self._device)
        pids = table[rows, pos // ps]
        offs = pos % ps
        kp, vp = self._kv.k_pool, self._kv.v_pool

        def kv_join(layer, k_new, v_new):       # k/v_new (B, Hkv, 1, hd)
            kp[layer][pids, :, offs] = k_new[:, :, 0]
            vp[layer][pids, :, offs] = v_new[:, :, 0]
            K = kp[layer][table].permute(0, 2, 1, 3, 4) \
                .reshape(B, Hkv, P * ps, hd)
            V = vp[layer][table].permute(0, 2, 1, 3, 4) \
                .reshape(B, Hkv, P * ps, hd)
            return K, V, pos + 1

        return decode_apply(self._params, cfg, ids, pos, kv_join)

    @staticmethod
    def _sample_body(logits, reqs):
        """Tokens (B,) on the device.  Greedy rows: argmax.  Temperature
        rows: Gumbel-max over logits / t with noise from a generator seeded
        by (request seed, draw index), so a sampled sequence depends on its
        request alone, not on batch composition or eviction."""
        toks = logits.argmax(dim=-1)
        for row, req in enumerate(reqs):
            if req.temperature <= 0:
                continue
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(_draw_seed(req.seed, len(req.tokens)))
            u = torch.rand(logits.shape[-1], generator=gen,
                           device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            toks[row] = (logits[row].float() / req.temperature
                         + gumbel).argmax()
        return toks

    # -- replica handoff ---------------------------------------------------
    @classmethod
    def join_replica(cls, net, donor, **kw):
        """A new engine whose frozen params are DONATED by the running
        ``donor``: the same tensors on the same card (no copy, no second
        ``serving_params(net)``), with a KV pool of its own.  ``net``
        gives the configuration and must be the donor's model; ``kw`` go
        to the constructor.  The donor keeps serving throughout (served
        params are never written).  The join-to-first-token clock
        (``mxnet_serving_join_to_first_token_seconds``) starts here and
        stops at this replica's first generated token.

        ``device=None`` resolves as for any engine; a device other than
        the donor's raises MXNetError (cross-device transfer, and the
        reference's ``plan=``, wait for the multi-GPU plane; its
        ``compile_cache=`` waits for CUDA-graph capture)."""
        return cls(net, params_from=donor, **kw)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Build the kernels (on the card), warm up, and start the loop
        thread.  A closed engine does not start again."""
        if self._thread is not None:
            return self
        if self._stop_evt.is_set():
            raise MXNetError("serving engine is closed; build a new one")
        if self._device.type == "cuda":
            _kernels.build_all()
        with self._turn:
            self._warmup()
        self._warm = True
        self._thread = threading.Thread(target=self._run_loop,
                                        name="mxnet-serving-engine",
                                        daemon=True)
        self._thread.start()
        return self

    def _warmup(self):
        """Run one prefill at the smallest bucket and one decode step at the
        smallest batch bucket, every write landing in scratch page 0: the
        eager counterpart of the reference's AOT warmup.  The first request
        then does not pay the one-time costs (library handles, lazily
        loaded device code) in its time to first token."""
        with torch.no_grad():
            lb = self._prefill_buckets[0]
            self._prefill_body(np.zeros(1, dtype=np.int32), lb, [0])
            b = self._batch_buckets[0]
            zeros = torch.zeros(b, dtype=torch.long, device=self._device)
            self._decode_body(zeros, zeros, zeros[:, None]).argmax(-1) \
                .tolist()
        self._warmed = [("prefill", lb), ("decode", b, 1)]

    def close(self, drain=True, timeout=60):
        """Stop the loop: with ``drain`` in-flight sequences finish and
        queued requests get a clean shutdown error; without, everything
        resolves with the shutdown error immediately.  Then the KV pool
        is released, whoever still holds this engine (the weights stay
        with the net and the engines that share them)."""
        self._drain = bool(drain)
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise MXNetError(
                    f"serving engine loop did not stop within {timeout}s "
                    "(drain still in progress; call close() again or "
                    "close(drain=False) to abort in-flight work)")
            self._thread = None
        self.unmount_http()
        self._kv.release()

    def running(self):
        t = self._thread
        return t is not None and t.is_alive()

    def join(self, timeout=None):
        """Block until the loop thread exits (the stop-drain path)."""
        t = self._thread
        if t is not None:
            t.join(timeout)

    # -- request surface ---------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, temperature=0.0,
               eos_id=None, deadline_ms=None, trace_id=None, seed=None):
        """Enqueue a generation request; returns the Request future.
        ``trace_id`` names the request's trace (default: its id).  ``seed``
        fixes the temperature draws (default: a fresh random seed).
        Raises QueueFullError at the admission bound and MXNetError when
        the server is shutting down or the prompt cannot fit."""
        if self._stop_evt.is_set():
            raise MXNetError("serving engine is shutting down")
        if not self._warm:
            raise MXNetError("serving engine not started; call start()")
        if seed is None:
            seed = secrets.randbits(63)
        else:
            try:
                seed = operator.index(seed)
            except TypeError:
                raise MXNetError(
                    f"seed must be an integer, got {seed!r}") from None
            if seed < 0:
                raise MXNetError("seed must be non-negative")
        req = Request(prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_id=eos_id,
                      deadline_ms=deadline_ms if deadline_ms is not None
                      else (self._deadline_ms or None), seed=seed)
        if self._trace_enabled:
            req.trace = RequestTrace(
                int(trace_id) if trace_id is not None else req.id)
            req.trace.event("submitted", prompt_len=int(req.prompt.size),
                            max_new_tokens=req.max_new_tokens)
            req.on_resolve = self._trace_finished
        L = int(req.prompt.size)
        if bucket_for(L, self._prefill_buckets) is None:
            raise MXNetError(
                f"prompt length {L} exceeds the largest prefill bucket "
                f"{max(self._prefill_buckets)}")
        if pages_for(L, self._page_size) > self._kv.pages - 1:
            raise MXNetError(
                f"prompt length {L} can never fit the KV pool "
                f"({self._kv.pages - 1} allocatable pages)")
        self._queue.put(req)
        _G_QUEUE.set(len(self._queue))
        if self._drained:
            # raced past the stop check while the loop ran its final queue
            # drain: nobody will pop this request, so reject it now
            self._queue.drain(lambda r: MXNetError(
                f"request {r.id} rejected: server shutting down"))
            raise MXNetError("serving engine is shutting down")
        return req

    # -- the loop ----------------------------------------------------------
    def _run_loop(self):
        consec_fail = 0
        with torch.no_grad():
            while True:
                if lifecycle.stop_requested():
                    self._stop_evt.set()
                if self._stop_evt.is_set():
                    if not self._drain:
                        self._abort_active()
                    if not self._active:
                        break
                try:
                    with self._turn:
                        did_work = self._step()
                    consec_fail = 0
                except Exception as e:
                    # a step must never kill the loop thread: the fault
                    # seams raise before any KV or sequence state changes,
                    # so the step retries; each failure is counted and backs
                    # off, and a persistent one resolves the in-flight work
                    # with the error instead of hanging its callers
                    _C_STEP_FAIL.inc()
                    consec_fail += 1
                    # log the repr: a handler that keeps records would keep
                    # the exception, and through its traceback the engine
                    err = repr(e)
                    if consec_fail <= 3 or consec_fail % 10 == 0:
                        _LOGGER.warning(
                            "serving engine step failed (%s); retrying "
                            "(%d consecutive)", err, consec_fail)
                    if consec_fail >= self._MAX_CONSEC_STEP_FAILURES:
                        _LOGGER.critical(
                            "serving engine step failed %d times in a row "
                            "(%s); failing the in-flight work",
                            consec_fail, err)
                        # an abnormal event: dump the ring so the
                        # post-mortem shows what preceded it
                        _flight.record_event(
                            "lifecycle", event="serving_step_failure",
                            consecutive=consec_fail, error=err[:200])
                        _flight.dump_blackbox("serving_step_failure")
                        self._fail_active(e)
                        consec_fail = 0
                    self._stop_evt.wait(0.05)
                    continue
                if not did_work and not self._stop_evt.is_set():
                    self._queue.wait_nonempty(0.02)
        # flag BEFORE the final drain: a submit() racing past the stop
        # check either lands before this drain or sees the flag
        self._drained = True
        n = self._queue.drain(lambda r: MXNetError(
            f"request {r.id} rejected: server shutting down"))
        # these never ran (in-flight work finished with its own outcome):
        # a drain_rejected request is safe to resubmit elsewhere
        for _ in range(n):
            _C_REQS.labels(outcome="drain_rejected").inc()
        self._publish_gauges()

    def _timed(self, phase, fn, *args):
        """``fn(*args)``, its wall time observed in
        ``mxnet_serving_phase_seconds``: each phase ends in a host sync, so
        it includes the device time of the work it dispatched."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            _H_PHASE.labels(phase=phase).observe(time.perf_counter() - t0)

    def _step(self):
        did = False
        while (not self._stop_evt.is_set()
               and len(self._active) < self._max_batch):
            req = self._queue.pop_ready()
            if req is None:
                break
            try:
                admitted = self._timed("prefill", self._admit, req)
            except Exception as e:
                # the request left the queue: resolve it with the error so
                # its caller sees the failure, then let the loop count it
                self._kv.free(req.id)
                req.resolve(MXNetError(
                    f"request {req.id} failed in prefill: {e!r}"))
                _C_REQS.labels(outcome="error").inc()
                raise
            did = True
            if not admitted:
                break    # pool full or admission tripped: stop admitting
        if self._active:
            self._timed("decode", self._decode_step)
            did = True
        self._publish_gauges()
        return did

    def _publish_gauges(self):
        _G_QUEUE.set(len(self._queue))
        _G_ACTIVE.set(len(self._active))
        _G_PAGES.labels(state="free").set(self._kv.pages_free)
        _G_PAGES.labels(state="used").set(self._kv.pages_used)
        win = list(self._tok_window)           # the loop thread's own
        if len(win) >= 2:
            dt = win[-1][0] - win[0][0]
            toks = sum(n for _, n in win[1:])
            if dt > 0:
                _G_TOKS_S.set(toks / dt)
                _G_TOKS_CHIP.set(toks / dt / self._n_chips)

    def _admit(self, req):
        """Prefill one request (or its post-eviction continuation).
        Returns False when it cannot be admitted right now (requeued)."""
        tr = req.trace
        try:
            # a tripped admission loses nothing: the request returns to the
            # queue front and the next iteration retries it
            _fault.check("serving.admit")
        except Exception as e:
            _LOGGER.warning("serving.admit fault for request %s (%s); "
                            "requeued", req.id, repr(e))
            if tr is not None:
                tr.event("requeued", reason="admit_fault")
                tr.last_enqueue_t = time.perf_counter()
            self._queue.requeue(req)
            return False
        if req.expired():
            if tr is not None:
                tr.event("deadline_expired", where="prefill")
            _C_REQS.labels(outcome="expired").inc()
            req.resolve(DeadlineExceededError(
                f"request {req.id} expired before prefill"))
            return True
        ids_full = req.full_ids()
        L = int(ids_full.size)
        if L >= self._ctx_cap or \
                bucket_for(L, self._prefill_buckets) is None:
            # an evicted continuation can outgrow the prefill grid: finish
            # with what it has rather than error a half-served request
            if req.tokens:
                self._finish(req, "length")
            else:
                _C_REQS.labels(outcome="rejected").inc()
                req.resolve(MXNetError(
                    f"request {req.id}: prompt length {L} exceeds the "
                    f"serving context cap {self._ctx_cap}"))
            return True
        # admission never evicts (two sequences that cannot coexist would
        # ping-pong); eviction is reserved for growth in _decode_step
        if not self._kv.alloc(req.id, L):
            if tr is not None:
                tr.event("requeued", reason="pool_full")
                tr.last_enqueue_t = time.perf_counter()
            self._queue.requeue(req)
            return False
        Lb = bucket_for(L, self._prefill_buckets)
        t_pre = time.perf_counter()
        if tr is not None:
            tr.add_span("queue_wait", tr.last_enqueue_t, t_pre,
                        prefills=req.prefills)
        last_logits = self._prefill_body(ids_full, Lb, self._kv.table(req.id))
        req.prefills += 1
        if req.prefills == 1:
            _C_TOKENS.labels(kind="prompt").inc(L)
        t_sm = time.perf_counter()
        pid = tr.add_span("prefill", t_pre, t_sm, tokens=L, bucket=Lb) \
            if tr is not None else 0
        tok = self._sample(last_logits[None], [req])[0]
        if tr is not None:
            # the host clock: the prefill is dispatched asynchronously on
            # the card, and the sample's token fetch is where it lands
            tr.add_span("sample", t_sm, time.perf_counter(), parent=pid)
        if req.first_token_t is None:
            req.first_token_t = time.monotonic()
            _H_TTFT.observe(req.first_token_t - req.submitted)
            with self._lock:
                self._ttfts.append(req.first_token_t - req.submitted)
            if self._join_t0 is not None:
                # the handoff's clock: join -> this replica's first token
                _H_JOIN.observe(req.first_token_t - self._join_t0)
                self._join_t0 = None
        req.tokens.append(tok)
        _C_TOKENS.labels(kind="generated").inc()
        if self._is_finished(req, tok, L):
            self._kv.free(req.id)
            self._finish(req, "stop" if tok == req.eos_id else "length")
            return True
        self._active.append(_Seq(req, L, tok))
        return True

    def _evictable(self, seq):
        """A sequence may be evicted only if its continuation can
        re-prefill later (never silently truncated)."""
        n = int(seq.req.full_ids().size)
        return n < self._ctx_cap and \
            bucket_for(n, self._prefill_buckets) is not None

    def _youngest_evictable(self, exclude=None):
        for seq in reversed(self._active):
            if seq is not exclude and self._evictable(seq):
                return seq
        return None

    def _evict(self, seq):
        """Return a sequence's pages and requeue its continuation."""
        self._active.remove(seq)
        self._kv.free(seq.req.id)
        tr = seq.req.trace
        if tr is not None:
            tr.event("evicted", cache_len=seq.cache_len,
                     generated=len(seq.req.tokens))
            tr.last_enqueue_t = time.perf_counter()
        self._queue.requeue(seq.req)
        _C_EVICT.inc()

    def _decode_step(self):
        # checked BEFORE any KV, table or sequence change: a trip unwinds
        # to the loop with nothing torn, and the step retries
        _fault.check("serving.decode_step")
        # grow tables first; eviction inside can shrink the active set
        for seq in list(self._active):
            if seq not in self._active:
                continue
            while not self._kv.ensure(seq.req.id, seq.cache_len + 1):
                victim = self._youngest_evictable(exclude=seq)
                if victim is not None:
                    self._evict(victim)
                    continue
                if self._evictable(seq):
                    self._evict(seq)
                else:
                    # unrestorable and the pool is exhausted: finish at the
                    # current length rather than wedge the loop
                    self._active.remove(seq)
                    self._kv.free(seq.req.id)
                    self._finish(seq.req, "length")
                break
        if not self._active:
            return
        B = len(self._active)
        Bb = bucket_for(B, self._batch_buckets)
        max_pages = max(pages_for(s.cache_len + 1, self._page_size)
                        for s in self._active)
        P = bucket_for(max_pages, self._page_buckets)
        pad = Bb - B
        dev = self._device
        sids = [s.req.id for s in self._active] + [None] * pad
        ids = torch.as_tensor([s.last_token for s in self._active]
                              + [0] * pad, device=dev)
        pos = torch.as_tensor([s.cache_len for s in self._active]
                              + [0] * pad, device=dev)
        table = torch.as_tensor(self._kv.table_rows(sids, P), device=dev)
        t_dec = time.perf_counter()
        logits = self._decode_body(ids, pos, table)
        _H_OCCUPANCY.observe(B / Bb)
        rows = list(self._active)
        t_sm = time.perf_counter()
        toks = self._sample(logits, [s.req for s in rows])
        t_done = time.perf_counter()
        now = time.monotonic()
        for seq, tok in zip(rows, toks):
            req = seq.req
            tr = req.trace
            if tr is not None:
                # this request rode this batched step; the sample child is
                # where the step's one token fetch lands
                did = tr.add_span("decode_step", t_dec, t_sm,
                                  step=len(req.tokens), batch=B, bucket=Bb)
                tr.add_span("sample", t_sm, t_done, parent=did)
            seq.cache_len += 1
            seq.last_token = tok
            req.tokens.append(tok)
            if self._is_finished(req, tok, seq.cache_len + 1):
                self._active.remove(seq)
                self._kv.free(req.id)
                self._finish(req, "stop" if tok == req.eos_id else "length")
        _C_TOKENS.labels(kind="generated").inc(len(rows))
        self._tok_window.append((now, len(rows)))

    def _sample(self, logits, reqs):
        """One token per request row (padded rows are ignored), as python
        ints.  THE one host sync of the engine step lives here."""
        toks = self._sample_body(logits[:len(reqs)], reqs)
        return toks.tolist()

    def _trace_finished(self, req):
        """Request.resolve hook: classify the outcome and file the trace
        in the tail-retention store.  Every resolution path goes through
        resolve(), so this one hook sees them all."""
        tr = req.trace
        if tr is None:
            return
        err = req.error
        if err is None:
            outcome = req.finish_reason or "done"
        elif isinstance(err, DeadlineExceededError):
            outcome = "expired"
        else:
            outcome = "error"
        tr.finish(outcome, error=err)
        self._traces.add(tr)

    def _is_finished(self, req, tok, ctx_next):
        return (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)
                or ctx_next >= self._ctx_cap)

    def _finish(self, req, reason):
        req.finish_reason = reason
        # counted before the resolve wakes the caller, so a caller that
        # reads /v1/serving or /metrics after its answer sees its request
        now = time.monotonic()
        with self._lock:
            self._latencies.append(now - req.submitted)
        _H_LATENCY.observe(now - req.submitted)
        # "stop" (hit its eos_id) vs "length" (max_new_tokens or a cap)
        _C_REQS.labels(outcome=reason).inc()
        req.resolve(now=now)

    def _fail_active(self, error):
        """Resolve every in-flight sequence with ``error`` (persistent step
        failure): pages free, callers unblock with the real cause."""
        for seq in list(self._active):
            self._kv.free(seq.req.id)
            _C_REQS.labels(outcome="error").inc()
            seq.req.resolve(MXNetError(
                f"request {seq.req.id} failed: serving engine step "
                f"persistently failing ({error!r})"))
        self._active = []

    def _abort_active(self):
        for seq in list(self._active):
            self._kv.free(seq.req.id)
            _C_REQS.labels(outcome="aborted").inc()
            seq.req.resolve(MXNetError(
                f"request {seq.req.id} aborted: server closed without "
                "drain"))
        self._active = []

    # -- observability -----------------------------------------------------
    def stats(self):
        """JSON-able engine snapshot (served at /v1/serving), with the
        reference's keys.  ``compiled_signatures`` counts the bucket
        signatures the warm-up ran (the port compiles nothing ahead of
        time: the reference counts its AOT executables there)."""
        with self._lock:
            # snapshot under the lock: the loop thread appends to these
            lat = sorted(self._latencies)
            ttft = sorted(self._ttfts)

        def pct(xs, p):
            return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else None

        return {
            "model": self._name,
            "queue_depth": len(self._queue),
            "active_sequences": len(self._active),
            "kv_pages": {"free": self._kv.pages_free,
                         "used": self._kv.pages_used,
                         "page_size": self._page_size,
                         "pool_bytes": self._kv.nbytes()},
            "compiled_signatures": len(self._warmed),
            "warm": self._warm,
            "latency_s": {"p50": pct(lat, 0.50), "p99": pct(lat, 0.99),
                          "count": len(lat)},
            "ttft_s": {"p50": pct(ttft, 0.50), "p99": pct(ttft, 0.99),
                       "count": len(ttft)},
            "tokens_per_s": _G_TOKS_S.value,
            "tokens_per_s_per_chip": _G_TOKS_CHIP.value,
            "context_cap": self._ctx_cap,
            "buckets": {"batch": self._batch_buckets,
                        "prefill": self._prefill_buckets,
                        "pages": self._page_buckets},
            "request_traces": {"enabled": self._trace_enabled,
                               "traced": self._traces.count()},
        }

    # -- HTTP plane (mounted beside /metrics on the telemetry server) ------
    def mount_http(self, prefix="/v1"):
        """Register ``{prefix}/completions`` (POST), ``{prefix}/serving``
        (GET) and ``{prefix}/requests`` (GET: the retained request traces)
        on the telemetry HTTP endpoint."""
        comp, stat = prefix + "/completions", prefix + "/serving"
        reqs = prefix + "/requests"
        _telemetry.register_http_route(comp, self._http_completions)
        _telemetry.register_http_route(stat, self._http_stats)
        _telemetry.register_http_route(reqs, self._http_requests)
        self._mounted = [comp, stat, reqs]
        return self

    def unmount_http(self):
        for path in self._mounted:
            _telemetry.unregister_http_route(path)
        self._mounted = []

    def _http_stats(self, method, path, query, body):
        return 200, "application/json", json.dumps(self.stats()).encode()

    def _http_requests(self, method, path, query, body):
        doc = self._traces.snapshot()
        doc["enabled"] = self._trace_enabled
        return 200, "application/json", json.dumps(doc).encode()

    def _http_completions(self, method, path, query, body):
        """POST {"prompt": [ids], "max_new_tokens", "temperature",
        "eos_id", "deadline_ms", "trace_id", "timeout_s", "return_trace"},
        as the reference, and "seed" (the port's temperature seed).  Runs
        on the HTTP server's thread: it only submits and waits, so no
        tensor is made here."""
        if method != "POST":
            return 405, "application/json", b'{"error": "POST only"}'
        try:
            data = json.loads(body or b"{}")
            prompt = data["prompt"]
        except (ValueError, KeyError) as e:
            return 400, "application/json", json.dumps(
                {"error": f"bad request: {e!r}"}).encode()
        try:
            req = self.submit(
                prompt,
                max_new_tokens=int(data.get("max_new_tokens", 16)),
                temperature=float(data.get("temperature", 0.0)),
                eos_id=data.get("eos_id"),
                deadline_ms=data.get("deadline_ms"),
                trace_id=data.get("trace_id"),
                seed=data.get("seed"))
        except QueueFullError as e:
            _C_REQS.labels(outcome="rejected").inc()
            return 429, "application/json", json.dumps(
                {"error": str(e)}).encode()
        except MXNetError as e:
            return 400, "application/json", json.dumps(
                {"error": str(e)}).encode()
        try:
            res = req.result(timeout=float(data.get("timeout_s", 120)))
        except MXNetError as e:
            # the trace store keeps this error: its traceback would hold
            # this frame, and so the engine (its KV pool, the weights), in
            # a reference cycle that outlives serve()
            e.__traceback__ = None
            status = 408 if isinstance(e, DeadlineExceededError) else 503
            return status, "application/json", json.dumps(
                {"error": str(e)}).encode()
        if data.get("return_trace") and req.trace is not None:
            res["trace"] = req.trace.to_dict()
        return 200, "application/json", json.dumps(res).encode()


def serve(net, port=None, install_signals=True, on_ready=None,
          **engine_kw):
    """Blocking server entry point: start the telemetry HTTP endpoint (the
    serving routes mounted beside ``/metrics``), run the engine until a
    graceful stop (SIGTERM/SIGINT or ``lifecycle.request_stop``), drain,
    and return the lifecycle exit code (``EXIT_PREEMPTED`` after a stop
    request, 0 after ``close()``).

    ``on_ready(engine, bound_port)`` is called on this thread once the
    engine is warm and the routes are mounted; a caller that drives the
    server from the same process starts its own thread there.  Signal
    handlers can only be installed from the main thread.  ``engine_kw``
    go to :class:`ServingEngine` (``device=None``: the first CUDA card,
    which raises without one).  The caller owns ``sys.exit(serve(...))``
    and the telemetry server (``telemetry.stop_http_server()``)."""
    engine = ServingEngine(net, **engine_kw)
    if install_signals:
        lifecycle.install_signal_handlers()
    server = _telemetry.start_http_server(
        port if port is not None else (_env.serving_port() or 0))
    engine.start()
    engine.mount_http()
    bound = server.server_address[1]
    print(f"mxnet_tpu_torch serving: engine up on 127.0.0.1:{bound} "
          f"(/v1/completions, /v1/serving, /metrics)", flush=True)
    try:
        if on_ready is not None:
            on_ready(engine, bound)
        engine.join()
    finally:
        engine.close()
    if lifecycle.stop_requested():
        lifecycle.cancel_grace_deadline()
        return lifecycle.EXIT_PREEMPTED
    return 0
