"""The port's serving entry point over HTTP held against the reference's on
the CPU: ``serve()`` on ``llama_tiny`` in fp32, the reference's weights
carried across by ``load_reference_params``, each package's routes mounted
on its own telemetry server on port 0.

One client runs the same call sequence against each server: concurrent
greedy ``/v1/completions``, ``/v1/serving``, ``/v1/requests`` and
``/metrics``, requests under ``serving.admit`` and ``serving.decode_step``
injection (retried, then failing persistently), then
``lifecycle.request_stop``, after which ``serve()`` must return 43.  The
port must answer with the reference's greedy token ids (up to the near-tie
rule of ``test_torch_serving.py``: a step where the reference's top two
logits lie within 1e-4 may take either), the reference's ``/v1/serving``
keys and counts, the same span names, the same serving metric families,
and the same status codes and error class under injection.

Every HTTP call and wait has a timeout, every server binds port 0 and is
stopped in a ``finally``, and signal handlers are not installed: the one
real-signal test is in ``test_torch_planes.py``.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mxnet_tpu import fault as ref_fault
from mxnet_tpu import lifecycle as ref_lifecycle
from mxnet_tpu import nd
from mxnet_tpu import serving as ref_serving
from mxnet_tpu import telemetry as ref_telemetry
from mxnet_tpu.gluon.model_zoo.language import llama as ref_llama
from mxnet_tpu_torch import fault as port_fault
from mxnet_tpu_torch import lifecycle as port_lifecycle
from mxnet_tpu_torch import serving as port_serving
from mxnet_tpu_torch import telemetry as port_telemetry
from mxnet_tpu_torch.gluon.model_zoo.language import llama as port_llama
from test_torch_serving import assert_greedy_match, full_logits
from torch_threads import one_torch_thread  # noqa: F401

ENGINE_KW = dict(batch_buckets=[1, 2], prefill_buckets=[8, 16],
                 kv_pages=32, page_size=8, max_batch=2)
TIMEOUT = 120          # seconds, every HTTP call and every wait
PERSISTENT = 3         # step failures before the in-flight work fails


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


def _reset(lifecycle, telemetry, fault):
    lifecycle.reset()
    telemetry.reset()
    fault.reload_spec()
    fault.reset_stats()


def _http(port, path, body=None):
    """(status, decoded body) of one call; JSON bodies are parsed."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data,
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    text = raw.decode()
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


def _span_names(node):
    out = {node["name"]}
    for child in node["children"]:
        out |= _span_names(child)
    return out


def _drive(engine, port, fault, prompts):
    """The call sequence; returns what each call answered."""
    out = {}
    answers = [None] * len(prompts)

    def post(i):
        answers[i] = _http(port, "/v1/completions",
                           {"prompt": prompts[i].tolist(),
                            "max_new_tokens": 6})

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    out["greedy"] = answers
    out["serving"] = _http(port, "/v1/serving")
    out["requests"] = _http(port, "/v1/requests")
    out["metrics"] = _http(port, "/metrics")
    out["bad"] = [_http(port, "/v1/completions", {"no_prompt": 1}),
                  _http(port, "/v1/completions", {"prompt": []}),
                  _http(port, "/v1/completions",
                        {"prompt": [1] * 40, "max_new_tokens": 2})]
    out["get_completions"] = _http(port, "/v1/completions")
    if fault is port_fault:
        # "seed" is the port's field: a malformed one is a bad request
        out["bad_seed"] = [
            _http(port, "/v1/completions",
                  {"prompt": [1, 2], "max_new_tokens": 1, "seed": seed})
            for seed in ("x", 1.5e30, 2.5, -1, [3])]
    probe = {"prompt": prompts[0].tolist(), "max_new_tokens": 4}
    with fault.inject("serving.admit", times=2):
        out["admit"] = _http(port, "/v1/completions", probe)
    with fault.inject("serving.decode_step", times=1):
        out["decode_once"] = _http(port, "/v1/completions", probe)
    engine._MAX_CONSEC_STEP_FAILURES = PERSISTENT
    with fault.inject("serving.decode_step", times=PERSISTENT):
        out["decode_persistent"] = _http(port, "/v1/completions", probe)
    out["after"] = _http(port, "/v1/completions", probe)
    out["stats"] = fault.stats()
    return out


def _serve(serving, lifecycle, telemetry, fault, net, prompts, **kw):
    """serve() with the client on the on_ready thread, then request_stop;
    returns (serve's exit code, the client's answers)."""
    _reset(lifecycle, telemetry, fault)
    box = {}

    def on_ready(engine, port):
        def run():
            try:
                box["out"] = _drive(engine, port, fault, prompts)
            except BaseException as e:          # surfaced by the caller
                box["error"] = e
            finally:
                lifecycle.request_stop("test client done")
        threading.Thread(target=run, daemon=True).start()

    try:
        box["rc"] = serving.serve(net, port=0, install_signals=False,
                                  on_ready=on_ready, **ENGINE_KW, **kw)
    finally:
        telemetry.stop_http_server()
        _reset(lifecycle, telemetry, fault)
    if "error" in box:
        raise box["error"]
    return box["rc"], box["out"]


@pytest.fixture(scope="module")
def runs(nets):
    ref, port = nets
    r = np.random.RandomState(0)
    prompts = [r.randint(1, 512, (n,)).astype("int32") for n in (5, 9, 13)]
    want = _serve(ref_serving, ref_lifecycle, ref_telemetry, ref_fault, ref,
                  prompts)
    got = _serve(port_serving, port_lifecycle, port_telemetry, port_fault,
                 port, prompts, device="cpu")
    return prompts, got, want


def test_serve_returns_preempted_after_request_stop(runs):
    _, (got_rc, _), (want_rc, _) = runs
    assert got_rc == want_rc == port_lifecycle.EXIT_PREEMPTED == 43


def test_completions_give_the_reference_greedy_token_ids(runs, nets):
    ref, _ = nets
    prompts, (_, got), (_, want) = runs
    for prompt, (gs, g), (ws, w) in zip(prompts, got["greedy"],
                                        want["greedy"]):
        assert gs == ws == 200
        assert set(g) == set(w)
        assert g["prompt_len"] == w["prompt_len"] == prompt.size
        assert g["finish_reason"] == w["finish_reason"] == "length"
        assert len(g["token_ids"]) == 6 and g["prefills"] == 1
        assert_greedy_match(g["token_ids"], w["token_ids"],
                            full_logits(ref, prompt, w["token_ids"]))


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_serving_stats_have_the_reference_keys_and_counts(runs):
    _, (_, got), (_, want) = runs
    (gs, g), (ws, w) = got["serving"], want["serving"]
    assert gs == ws == 200
    assert _keys(g) == _keys(w)
    for key in ("model", "queue_depth", "active_sequences", "warm",
                "context_cap", "buckets", "request_traces"):
        assert g[key] == w[key], key
    for key in ("latency_s", "ttft_s"):
        assert g[key]["count"] == w[key]["count"] == 3
    assert g["kv_pages"]["page_size"] == w["kv_pages"]["page_size"]
    assert g["kv_pages"]["free"] == w["kv_pages"]["free"]
    assert g["kv_pages"]["pool_bytes"] == w["kv_pages"]["pool_bytes"]
    # the port counts the signatures its warm-up ran, the reference its
    # AOT executables
    assert 0 < g["compiled_signatures"] <= w["compiled_signatures"]


def test_request_traces_have_the_reference_span_names(runs):
    _, (_, got), (_, want) = runs
    (gs, g), (ws, w) = got["requests"], want["requests"]
    assert gs == ws == 200
    assert g["traced_requests"] == w["traced_requests"] == 3
    assert g["retention"] == w["retention"] and g["enabled"] and w["enabled"]
    for gr, wr in zip(sorted(g["requests"], key=lambda r: r["trace_id"]),
                      sorted(w["requests"], key=lambda r: r["trace_id"])):
        assert set(gr) == set(wr)
        # compile_wait: a reference executable looked up slowly
        names = _span_names(wr["tree"]) - {"compile_wait"}
        assert _span_names(gr["tree"]) == names == \
            {"request", "queue_wait", "prefill", "sample", "decode_step"}
        assert [e["name"] for e in gr["events"]] == \
            [e["name"] for e in wr["events"]]
        assert gr["outcome"] == wr["outcome"] == "length"


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metrics_render_the_reference_serving_families(runs):
    _, (_, got), (_, want) = runs
    (gs, g), (ws, w) = got["metrics"], want["metrics"]
    assert gs == ws == 200
    serving = {f for f in _families(w) if f.startswith("mxnet_serving_")
               or f == "mxnet_tokens_per_s_per_chip"}
    assert len(serving) == 14
    assert serving <= _families(g)
    line = 'mxnet_serving_requests_total{outcome="length"} 3'
    assert line in g.splitlines() and line in w.splitlines()


def test_bad_requests_get_the_reference_status_codes(runs):
    _, (_, got), (_, want) = runs
    assert [s for s, _ in got["bad"]] == [s for s, _ in want["bad"]] == \
        [400, 400, 400]
    assert got["get_completions"][0] == want["get_completions"][0] == 405
    assert [s for s, _ in got["bad_seed"]] == [400] * 5
    assert "seed must be" in got["bad_seed"][0][1]["error"]


def test_fault_injection_outcomes_match_reference(runs):
    _, (_, got), (_, want) = runs
    for key in ("admit", "decode_once", "after"):
        (gs, g), (ws, w) = got[key], want[key]
        assert gs == ws == 200, key
        assert g["token_ids"] == got["greedy"][0][1]["token_ids"][:4], key
        assert w["token_ids"] == want["greedy"][0][1]["token_ids"][:4], key
    (gs, g), (ws, w) = got["decode_persistent"], want["decode_persistent"]
    assert gs == ws == 503
    cause = "OSError('injected fault at serving.decode_step')"
    assert cause in g["error"] and cause in w["error"]
    assert "persistently failing" in g["error"]
    for seam in ("serving.admit", "serving.decode_step"):
        assert got["stats"][seam]["trips"] == want["stats"][seam]["trips"]
    assert got["stats"]["serving.decode_step"]["trips"] == 1 + PERSISTENT


def test_serve_without_a_card_raises(nets):
    import torch

    from mxnet_tpu_torch.base import MXNetError

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    try:
        with pytest.raises(MXNetError, match="no CUDA device"):
            port_serving.serve(nets[1], port=0, install_signals=False,
                               **ENGINE_KW)
        assert port_telemetry._HTTP_SERVER is None     # nothing was started
    finally:
        port_telemetry.stop_http_server()


def test_serve_frees_its_engine_after_a_failed_request(nets):
    """A failed request's error stays in the engine's trace store; the
    route must not leave its traceback there, which would hold the engine
    (the KV pool and the weights) in a reference cycle after serve()
    returns.  Checked with the cycle collector off."""
    import gc
    import weakref

    box = {}

    def on_ready(engine, port):
        box["engine"] = weakref.ref(engine)
        engine._MAX_CONSEC_STEP_FAILURES = 1

        def run():
            try:
                with port_fault.inject("serving.decode_step", times=1):
                    box["status"] = _http(port, "/v1/completions",
                                          {"prompt": [1, 2, 3],
                                           "max_new_tokens": 4})[0]
            finally:
                port_lifecycle.request_stop("test client done")
        box["thread"] = threading.Thread(target=run, daemon=True)
        box["thread"].start()

    _reset(port_lifecycle, port_telemetry, port_fault)
    gc.disable()
    try:
        rc = port_serving.serve(nets[1], port=0, install_signals=False,
                                on_ready=on_ready, device="cpu", **ENGINE_KW)
        box["thread"].join(timeout=TIMEOUT)
        assert not box["thread"].is_alive()
        assert rc == 43 and box["status"] == 503
        assert box["engine"]() is None
    finally:
        gc.enable()
        port_telemetry.stop_http_server()
        _reset(port_lifecycle, port_telemetry, port_fault)
