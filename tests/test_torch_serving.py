"""The port's serving stack (mxnet_tpu_torch.serving) on the CPU: the paged
KV pool and the scheduler mirror tests/test_serving.py, and the engine is
held against the reference ``ServingEngine`` serving the same weights.

Greedy comparison rule: the port's tokens must equal the reference's,
except at a step where the reference's two best logits differ by under
1e-4 (fp32 sums in two frameworks can order such a near-tie either way);
there the port's token must be one of the two, and comparison of that
sequence stops.
"""
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import nd
from mxnet_tpu import serving as ref_serving
from mxnet_tpu.gluon.model_zoo.language import llama as ref_llama
from mxnet_tpu_torch import env as port_env
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.language import llama as port_llama
from mxnet_tpu_torch.serving import ServingEngine
from mxnet_tpu_torch.serving.kvcache import PagedKVCache, pages_for
from mxnet_tpu_torch.serving.scheduler import (AdmissionQueue,
                                               DeadlineExceededError,
                                               QueueFullError, Request,
                                               bucket_for, parse_buckets)

TIE = 1e-4
ENGINE_KW = dict(batch_buckets=[1, 2], prefill_buckets=[8, 16],
                 kv_pages=32, page_size=8, max_batch=2)


# -- shared fixtures -------------------------------------------------------
@pytest.fixture(scope="module")
def nets():
    ref = ref_llama.llama_tiny()
    ref.initialize()
    ref(nd.zeros((1, 8), dtype="int32"))     # settle deferred shapes
    port = port_llama.llama_tiny(device="cpu")
    port_llama.load_reference_params(
        port, {k: np.asarray(v)
               for k, v in ref_llama.serving_params(ref).items()})
    return ref, port


@pytest.fixture(scope="module")
def engine(nets):
    eng = ServingEngine(nets[1], device="cpu", **ENGINE_KW).start()
    yield eng
    eng.close()


def full_logits(net, prompt, tokens):
    """Full-context logits predicting each of ``tokens`` after
    ``prompt`` (teacher-forced), from either package's net."""
    ids = np.concatenate([np.asarray(prompt, "int32"),
                          np.asarray(tokens, "int32")])[None, :]
    if isinstance(net, torch.nn.Module):
        with torch.no_grad():
            out = net(torch.from_numpy(ids)).numpy()
    else:
        out = net(nd.array(ids, dtype="int32")).asnumpy()
    return out[0, len(prompt) - 1:len(prompt) - 1 + len(tokens)]


def assert_greedy_match(got, want, want_logits):
    """``got`` equals ``want`` up to the near-tie rule (module docstring)."""
    for step, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        row = want_logits[step]
        top2 = np.argsort(row)[-2:]
        gap = row[top2[1]] - row[top2[0]]
        assert gap < TIE and g in top2, (
            f"step {step}: port token {g}, reference {w}, top-two gap "
            f"{gap:.3g}")
        return
    assert len(got) == len(want)


def full_greedy(net, prompt, n):
    """Sequential full-context greedy decoding with the port's net."""
    ids = [int(t) for t in np.asarray(prompt).ravel()]
    out = []
    for _ in range(n):
        with torch.no_grad():
            tok = int(net(torch.as_tensor([ids]))[0, -1].argmax())
        out.append(tok)
        ids.append(tok)
    return out


# -- paged KV cache --------------------------------------------------------
def test_pages_for():
    assert pages_for(1, 8) == 1
    assert pages_for(8, 8) == 1
    assert pages_for(9, 8) == 2
    assert pages_for(0, 8) == 1   # a sequence always owns a page


def test_paged_kvcache_pools_on_device_in_dtype():
    kv = PagedKVCache(3, 2, 4, pages=5, page_size=8, dtype=torch.bfloat16,
                      device="cpu")
    assert kv.k_pool.shape == kv.v_pool.shape == (3, 5, 2, 8, 4)
    assert kv.k_pool.dtype == torch.bfloat16
    assert kv.k_pool.device.type == "cpu"
    assert kv.nbytes() == 2 * 3 * 5 * 2 * 8 * 4 * 2


def test_paged_kvcache_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(MXNetError, match="no CUDA device"):
        PagedKVCache(2, 2, 4, pages=4, page_size=8)


def test_paged_kvcache_alloc_grow_free():
    kv = PagedKVCache(2, 2, 4, pages=5, page_size=8, device="cpu")
    assert kv.pages_free == 4            # page 0 is reserved scratch
    assert kv.alloc("a", 7)              # 1 page
    assert kv.alloc("b", 9)              # 2 pages
    assert kv.pages_free == 1 and kv.pages_used == 3
    assert 0 not in kv.table("a") + kv.table("b")
    assert kv.ensure("a", 8)             # still 1 page
    assert kv.ensure("a", 9)             # grows to 2
    assert kv.pages_free == 0
    assert not kv.ensure("b", 17)        # would need a 3rd page: refused
    assert len(kv.table("b")) == 2       # untouched on refusal
    assert kv.free("b") == 2
    assert kv.pages_free == 2
    assert kv.free("b") == 0             # idempotent
    with pytest.raises(KeyError):
        kv.table("b")
    with pytest.raises(MXNetError):
        kv.alloc("a", 1)                 # already allocated


def test_paged_kvcache_alloc_is_all_or_nothing():
    kv = PagedKVCache(2, 2, 4, pages=4, page_size=8, device="cpu")
    assert kv.alloc("a", 16)             # 2 of 3 pages
    assert not kv.alloc("b", 17)         # needs 3: refused whole
    assert kv.pages_free == 1
    assert not kv.holds("b")
    with pytest.raises(MXNetError):
        PagedKVCache(2, 2, 4, pages=1, page_size=8, device="cpu")


def test_paged_kvcache_table_rows_pad_with_scratch():
    kv = PagedKVCache(2, 2, 4, pages=6, page_size=8, device="cpu")
    kv.alloc("a", 20)                    # 3 pages
    kv.alloc("b", 3)                     # 1 page
    rows = kv.table_rows(["a", "b", None], 4)
    assert len(rows) == 3 and all(len(r) == 4 for r in rows)
    assert rows[0][:3] == kv.table("a") and rows[0][3] == 0
    assert rows[1][0] == kv.table("b")[0] and rows[1][1:] == [0, 0, 0]
    assert rows[2] == [0, 0, 0, 0]       # padded batch row: all scratch
    with pytest.raises(MXNetError):
        kv.table_rows(["a"], 2)          # bucket smaller than the table


# -- scheduler and knobs ---------------------------------------------------
def test_parse_buckets_and_bucket_for():
    assert parse_buckets("8,4, 16") == [4, 8, 16]
    assert bucket_for(5, [4, 8, 16]) == 8
    assert bucket_for(16, [4, 8, 16]) == 16
    assert bucket_for(17, [4, 8, 16]) is None
    with pytest.raises(MXNetError):
        parse_buckets("4,-2")
    with pytest.raises(MXNetError):
        parse_buckets("abc")


def test_admission_queue_bound_and_requeue_exemption():
    q = AdmissionQueue(2)
    a, b, c = (Request([1]) for _ in range(3))
    q.put(a)
    q.put(b)
    with pytest.raises(QueueFullError):
        q.put(c)
    q.requeue(c)                         # eviction re-admission is exempt
    assert len(q) == 3
    assert q.pop_ready() is c            # requeue goes to the FRONT


def test_admission_queue_expires_deadlined_requests():
    q = AdmissionQueue(4)
    stale = Request([1], deadline_ms=1)
    fresh = Request([2])
    q.put(stale)
    q.put(fresh)
    time.sleep(0.01)
    assert q.pop_ready() is fresh
    with pytest.raises(DeadlineExceededError):
        stale.result(timeout=1)


def test_queue_drain_resolves_waiting_requests():
    q = AdmissionQueue(4)
    reqs = [Request([1]) for _ in range(3)]
    for r in reqs:
        q.put(r)
    assert q.drain(lambda r: MXNetError("shutdown")) == 3
    for r in reqs:
        with pytest.raises(MXNetError):
            r.result(timeout=1)


def test_request_validation():
    with pytest.raises(MXNetError):
        Request([])
    with pytest.raises(MXNetError):
        Request([1], max_new_tokens=0)
    r = Request([3, 4], max_new_tokens=2)
    r.tokens += [5, 6]
    assert list(r.full_ids()) == [3, 4, 5, 6]


def test_serving_knob_defaults():
    assert port_env.serving_max_batch() == 8
    assert port_env.serving_batch_buckets() == "1,2,4,8"
    assert port_env.serving_prefill_buckets() == "32,64,128"
    assert port_env.serving_queue_bound() == 64
    assert port_env.serving_kv_pages() == 512
    assert port_env.serving_page_size() == 16
    assert port_env.serving_deadline_ms() == 0


# -- the engine ------------------------------------------------------------
def test_concurrent_greedy_matches_reference_engine(nets, engine):
    ref, port = nets
    r = np.random.RandomState(0)
    prompts = [r.randint(1, 512, (n,)).astype("int32")
               for n in (5, 9, 3, 12)]
    ref_eng = ref_serving.ServingEngine(ref, **ENGINE_KW)
    ref_eng.start()
    try:
        want = [q.result(timeout=300)["token_ids"] for q in
                [ref_eng.submit(p, max_new_tokens=6) for p in prompts]]
    finally:
        ref_eng.close()
    reqs = [engine.submit(p, max_new_tokens=6) for p in prompts]
    for prompt, q, w in zip(prompts, reqs, want):
        res = q.result(timeout=120)
        assert res["prompt_len"] == prompt.size
        assert res["finish_reason"] == "length"
        assert res["prefills"] == 1
        assert res["ttft_s"] is not None and res["latency_s"] > 0
        assert_greedy_match(res["token_ids"], w, full_logits(ref, prompt, w))


def test_engine_matches_own_full_context_greedy_and_eos(nets, engine):
    _, port = nets
    p = np.random.RandomState(1).randint(1, 512, (11,)).astype("int32")
    got = engine.submit(p, max_new_tokens=5).result(60)["token_ids"]
    want = full_greedy(port, p, 5)
    assert_greedy_match(got, want, full_logits(port, p, want))
    # an eos_id hit ends the stream early with finish_reason "stop"
    res = engine.submit(p, max_new_tokens=5, eos_id=got[0]).result(60)
    assert res["token_ids"] == [got[0]] and res["finish_reason"] == "stop"


def test_eviction_under_pool_pressure_preserves_greedy(nets):
    _, port = nets
    eng = ServingEngine(port, device="cpu", batch_buckets=[1, 2],
                        prefill_buckets=[8, 16], kv_pages=4, page_size=8,
                        max_batch=2).start()
    try:
        p = np.random.RandomState(2).randint(1, 512, (7,)).astype("int32")
        a = eng.submit(p, max_new_tokens=10)
        b = eng.submit(p[:5], max_new_tokens=10)
        ra, rb = a.result(120), b.result(120)
    finally:
        eng.close()
    # the pool (3 allocatable pages) cannot hold both at full length: at
    # least one sequence was evicted and re-prefilled ...
    assert ra["prefills"] + rb["prefills"] >= 3
    # ... and the outputs are what full-context greedy produces
    for prompt, res in ((p, ra), (p[:5], rb)):
        want = full_greedy(port, prompt, 10)
        assert_greedy_match(res["token_ids"], want,
                            full_logits(port, prompt, want))


def test_temperature_draws_reproducible_and_batch_independent(engine):
    alone = engine.submit([5, 6, 7], max_new_tokens=5, temperature=0.7,
                          seed=123).result(60)["token_ids"]
    # the same request beside a greedy neighbour: the batch differs, the
    # sampled sequence must not
    paired = engine.submit([5, 6, 7], max_new_tokens=5, temperature=0.7,
                           seed=123)
    other = engine.submit([9, 9], max_new_tokens=5)
    assert paired.result(60)["token_ids"] == alone
    other.result(60)
    # another seed draws another sequence (5 draws over 512 tokens)
    diff = engine.submit([5, 6, 7], max_new_tokens=5, temperature=0.7,
                         seed=124).result(60)["token_ids"]
    assert diff != alone
    # greedy ignores the seed entirely
    g1 = engine.submit([5, 6, 7], max_new_tokens=4, seed=1).result(60)
    g2 = engine.submit([5, 6, 7], max_new_tokens=4, seed=2).result(60)
    assert g1["token_ids"] == g2["token_ids"]


def test_submit_validation(engine):
    with pytest.raises(MXNetError):
        engine.submit([], max_new_tokens=2)          # empty prompt
    with pytest.raises(MXNetError):
        engine.submit([1] * 99, max_new_tokens=2)    # no prefill bucket
    with pytest.raises(MXNetError):
        engine.submit([1, 2], max_new_tokens=0)
    with pytest.raises(MXNetError):
        engine.submit([1, 2], temperature=1.0, seed=-1)


def test_queue_full_is_a_clean_rejection(nets):
    eng = ServingEngine(nets[1], device="cpu", batch_buckets=[1],
                        prefill_buckets=[8], kv_pages=8, page_size=8,
                        max_batch=1, queue_bound=1)
    with pytest.raises(MXNetError, match="not started"):
        eng.submit([1, 2], max_new_tokens=2)
    # started in name only: nothing drains the queue, so the bound is hit
    eng._warm = True
    eng.submit([1, 2], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        eng.submit([3, 4], max_new_tokens=2)


def test_deadline_expires_queued_request(engine):
    req = Request([1, 2, 3], max_new_tokens=2, deadline_ms=0.01)
    time.sleep(0.01)
    engine._queue.put(req)
    with pytest.raises(DeadlineExceededError):
        req.result(timeout=30)


def test_engine_device_rules(nets):
    _, port = nets
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            ServingEngine(port, **ENGINE_KW)
    with pytest.raises(MXNetError, match="serves the model-zoo llama"):
        ServingEngine(torch.nn.Linear(2, 2), device="cpu")


def test_failed_prefill_resolves_the_request_with_its_error(nets):
    eng = ServingEngine(nets[1], device="cpu", **ENGINE_KW).start()
    try:
        def boom(*args):
            raise RuntimeError("kernel exploded")

        eng._prefill_body = boom
        req = eng.submit([1, 2, 3], max_new_tokens=3)
        with pytest.raises(MXNetError, match="kernel exploded"):
            req.result(timeout=30)
        assert eng._kv.pages_used == 0      # its pages went back
    finally:
        eng.close()


def test_persistently_failing_decode_fails_in_flight_work(nets):
    eng = ServingEngine(nets[1], device="cpu", **ENGINE_KW).start()
    eng._MAX_CONSEC_STEP_FAILURES = 3

    def boom(*args):
        raise RuntimeError("decode exploded")

    eng._decode_body = boom
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(MXNetError, match="decode exploded"):
            req.result(timeout=30)
        assert req.tokens != [] and eng._kv.pages_used == 0
    finally:
        eng.close()


def test_close_rejects_queued_and_later_work(nets):
    eng = ServingEngine(nets[1], device="cpu", **ENGINE_KW).start()
    eng.close()
    assert eng._thread is None
    with pytest.raises(MXNetError, match="shutting down"):
        eng.submit([1, 2], max_new_tokens=2)


def test_warmup_writes_only_the_scratch_page(nets):
    eng = ServingEngine(nets[1], device="cpu", **ENGINE_KW)
    eng._warmup()
    assert eng._kv.pages_used == 0
    for pool in (eng._kv.k_pool, eng._kv.v_pool):
        assert pool[:, 0].abs().sum() > 0        # warmup k/v landed here
        assert torch.count_nonzero(pool[:, 1:]) == 0
