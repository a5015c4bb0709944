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
"""
from __future__ import annotations

import logging
import secrets
import threading
import time

import numpy as np
import torch

from .. import _kernels
from .. import env as _env
from ..base import MXNetError
from ..context import resolve_device
from ..gluon.model_zoo.language.llama import (LlamaForCausalLM, _dense_nb,
                                              _prefill_trunk, decode_apply,
                                              serving_params)
from .kvcache import PagedKVCache, pages_for
from .scheduler import (AdmissionQueue, DeadlineExceededError, Request,
                        bucket_for, parse_buckets)

__all__ = ["ServingEngine"]

_LOGGER = logging.getLogger(__name__)


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
    knobs (``env.py``)."""

    # consecutive step failures before the loop stops retrying and fails
    # the in-flight work (~2.5 s at the 0.05 s per-failure backoff)
    _MAX_CONSEC_STEP_FAILURES = 50

    def __init__(self, net, *, batch_buckets=None, prefill_buckets=None,
                 kv_pages=None, page_size=None, queue_bound=None,
                 max_batch=None, deadline_ms=None, device=None):
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
        self._params = dict(serving_params(net))
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
        # longest context a sequence can reach: the model's window and the
        # pool minus scratch both cap it
        self._ctx_cap = min(cfg.max_seq_len, (pages - 1) * self._page_size)
        self._page_buckets = self._make_page_buckets()
        if max(self._prefill_buckets) > self._ctx_cap:
            raise MXNetError(
                f"prefill bucket {max(self._prefill_buckets)} exceeds the "
                f"context cap {self._ctx_cap} (max_seq_len / KV pool)")
        self._queue = AdmissionQueue(queue_bound or
                                     _env.serving_queue_bound())
        self._active: list = []
        self._lock = threading.Lock()          # guards phase_seconds
        self._stop_evt = threading.Event()     # close() requested
        self._drain = True                     # finish in-flight on stop
        self._drained = False                  # loop ran its final drain
        self._thread = None
        self._warm = False
        # wall seconds per phase; each phase ends in a host sync, so these
        # include the device time of the work they dispatched
        self.phase_seconds = {"prefill": 0.0, "decode": 0.0}

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

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Build the kernels (on the card), warm up, and start the loop
        thread."""
        if self._thread is not None:
            return self
        if self._device.type == "cuda":
            _kernels.build_all()
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
            self._prefill_body(np.zeros(1, dtype=np.int32),
                               self._prefill_buckets[0], [0])
            b = self._batch_buckets[0]
            zeros = torch.zeros(b, dtype=torch.long, device=self._device)
            self._decode_body(zeros, zeros, zeros[:, None]).argmax(-1) \
                .tolist()

    def close(self, drain=True, timeout=60):
        """Stop the loop: with ``drain`` in-flight sequences finish and
        queued requests get a clean shutdown error; without, everything
        resolves with the shutdown error immediately."""
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

    # -- request surface ---------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, temperature=0.0,
               eos_id=None, deadline_ms=None, seed=None):
        """Enqueue a generation request; returns the Request future.
        ``seed`` fixes the temperature draws (default: a fresh random
        seed).  Raises QueueFullError at the admission bound and MXNetError
        when the server is shutting down or the prompt cannot fit."""
        if self._stop_evt.is_set():
            raise MXNetError("serving engine is shutting down")
        if not self._warm:
            raise MXNetError("serving engine not started; call start()")
        if seed is None:
            seed = secrets.randbits(63)
        elif int(seed) < 0:
            raise MXNetError("seed must be non-negative")
        req = Request(prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_id=eos_id,
                      deadline_ms=deadline_ms if deadline_ms is not None
                      else (self._deadline_ms or None), seed=seed)
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
                if self._stop_evt.is_set():
                    if not self._drain:
                        self._abort_active()
                    if not self._active:
                        break
                try:
                    did_work = self._step()
                    consec_fail = 0
                except Exception as e:
                    # a step must never kill the loop thread: back off and
                    # retry; a persistent failure resolves the in-flight
                    # work with the error instead of hanging its callers
                    consec_fail += 1
                    if consec_fail <= 3 or consec_fail % 10 == 0:
                        _LOGGER.warning(
                            "serving engine step failed (%r); retrying "
                            "(%d consecutive)", e, consec_fail)
                    if consec_fail >= self._MAX_CONSEC_STEP_FAILURES:
                        _LOGGER.critical(
                            "serving engine step failed %d times in a row "
                            "(%r); failing the in-flight work",
                            consec_fail, e)
                        self._fail_active(e)
                        consec_fail = 0
                    self._stop_evt.wait(0.05)
                    continue
                if not did_work and not self._stop_evt.is_set():
                    self._queue.wait_nonempty(0.02)
        # flag BEFORE the final drain: a submit() racing past the stop
        # check either lands before this drain or sees the flag
        self._drained = True
        self._queue.drain(lambda r: MXNetError(
            f"request {r.id} rejected: server shutting down"))

    def _timed(self, phase, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.phase_seconds[phase] += dt

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
                raise
            did = True
            if not admitted:
                break    # pool full: stop admitting this step
        if self._active:
            self._timed("decode", self._decode_step)
            did = True
        return did

    def _admit(self, req):
        """Prefill one request (or its post-eviction continuation).
        Returns False when the pool cannot host it right now (requeued)."""
        if req.expired():
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
                req.resolve(MXNetError(
                    f"request {req.id}: prompt length {L} exceeds the "
                    f"serving context cap {self._ctx_cap}"))
            return True
        # admission never evicts (two sequences that cannot coexist would
        # ping-pong); eviction is reserved for growth in _decode_step
        if not self._kv.alloc(req.id, L):
            self._queue.requeue(req)
            return False
        Lb = bucket_for(L, self._prefill_buckets)
        last_logits = self._prefill_body(ids_full, Lb, self._kv.table(req.id))
        req.prefills += 1
        tok = self._sample(last_logits[None], [req])[0]
        if req.first_token_t is None:
            req.first_token_t = time.monotonic()
        req.tokens.append(tok)
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
        self._queue.requeue(seq.req)

    def _decode_step(self):
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
        logits = self._decode_body(ids, pos, table)
        rows = list(self._active)
        toks = self._sample(logits, [s.req for s in rows])
        for seq, tok in zip(rows, toks):
            req = seq.req
            seq.cache_len += 1
            seq.last_token = tok
            req.tokens.append(tok)
            if self._is_finished(req, tok, seq.cache_len + 1):
                self._active.remove(seq)
                self._kv.free(req.id)
                self._finish(req, "stop" if tok == req.eos_id else "length")

    def _sample(self, logits, reqs):
        """One token per request row (padded rows are ignored), as python
        ints.  THE one host sync of the engine step lives here."""
        toks = self._sample_body(logits[:len(reqs)], reqs)
        return toks.tolist()

    def _is_finished(self, req, tok, ctx_next):
        return (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)
                or ctx_next >= self._ctx_cap)

    def _finish(self, req, reason):
        req.finish_reason = reason
        req.resolve()

    def _fail_active(self, error):
        """Resolve every in-flight sequence with ``error`` (persistent step
        failure): pages free, callers unblock with the real cause."""
        for seq in list(self._active):
            self._kv.free(seq.req.id)
            seq.req.resolve(MXNetError(
                f"request {seq.req.id} failed: serving engine step "
                f"persistently failing ({error!r})"))
        self._active = []

    def _abort_active(self):
        for seq in list(self._active):
            self._kv.free(seq.req.id)
            seq.req.resolve(MXNetError(
                f"request {seq.req.id} aborted: server closed without "
                "drain"))
        self._active = []
