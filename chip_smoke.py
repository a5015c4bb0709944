"""Chip smoke test of the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA
H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``--bert-step-seeds 1 2 3`` runs only the build and the BERT-base step
check of phase 6 (b), once for each seed.)

Phases (any failed check exits nonzero; nothing runs on the CPU):

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: every kernel under mxnet_tpu_torch/csrc/ with nvcc for sm_90a;
   ptxas's registers, spills and wgmma-serialisation warnings for every
   instance (a bf16 instance that spills or serialises fails), and the
   SASS of the bf16 D = 128 instance (HGMMA and UTMALDG, no HMMA);
3. kernels: each kernel held against its plain PyTorch version on the card
   at the serving path's shapes and a coverage grid (contiguous inputs and
   transposed (B, L, H, D) views), then timed at every prefill bucket
   beside one PyTorch library call and the bound, and at the largest
   beside the plain version;
4. serving: Llama-3-8B widths in bf16 (random weights from a seed) served
   by ServingEngine through submit()/result(); the kernels' launch counts
   over the run, in all and by prefill bucket, and every logits row the
   engine sampled from held against
   the port's full-context forward with the plain attention (bf16, to a
   bound measured in the run); 4b: the same net behind serving.serve()
   on this thread, driven over HTTP from the on_ready thread: the same 8
   requests POSTed concurrently to /v1/completions (every sampled logits
   row held as in 4, flash_attn_fwd launched layers x prefills times),
   /v1/serving, /metrics and /v1/requests, a decode fault the loop
   retries, a persistent one that fails the in-flight request and dumps
   the flight recorder's black box, and a SIGTERM with one request in
   flight and one queued (the first finishes, the second is rejected,
   serve() returns 43), with TTFT, latency and decode tokens/s beside
   phase 4's; then the same weights upcast to fp32 and served again,
   every logits row held to FP32_LOGIT_TOL;
5. training: ResNet-50 v1 at full width (1000 classes, 224x224, NHWC,
   random weights from --seed, a synthetic batch from --seed as bench.py
   makes it).  One TrainStep step at batch 8 on the card against the same
   step on the CPU (loss, every parameter, the BatchNorm running stats;
   TF32 off), in fp32 and in fp64, each also with planted faults, which
   must fail the check; one fp32 record / backward / Trainer.step step on
   the card against the TrainStep step; then bench.py's configuration
   (batch 256, SGD 0.1 / 0.9, dtype bfloat16): 2 warm-up and 20 timed
   steps on one batch (finite, falling loss), img/s, ms/step, MFU, peak
   memory, and a profiled pass (device-busy share, device time by kernel
   group).  The training path launches none of the port's hand-written
   kernels;
6. transformer training at BERT-base widths: (a) the gradients of
   flash_attention (kernel forward, the ported blockwise backward) against
   the plain version under torch autograd at the BERT shape, a causal GQA
   Llama-3-8B shape and an Lq < Lk causal shape, fp32 and bf16, each with
   planted backward faults that must fail, and llama_tiny's gradients on
   the card against the CPU's fp64 ones, three times on NaN-filled cached
   memory; (b) one TrainStep step of
   BertForPretraining (dropout 0, batch 8, sequence 128) on the card in
   fp32 and bf16 against the CPU's fp64 step (the bf16 one within a
   multiple of the CPU's bf16 step's deviation), every tensor but the
   token-type embedding with a non-zero gradient, and a planted fault;
   per layer of the bf16 step, the attention's o and gradients through
   the kernel held to the plain bf16 forward's deviation from fp64; (c)
   flash_attn_fwd launched once per layer and step; (d) bench.py's
   bench_bert configuration (batch 64, bf16, Adam 1e-4, dropout 0.1): 2
   warm-up and 20 timed steps, samples/s, ms/step, MFU, peak memory, a
   profiled pass by kernel group (the attention backward apart), and
   TrainStep's ``_foreach`` Adam update timed beside the loop form; (e)
   the kernel's forward and the ported backward at the BERT and the Llama
   shape, timed beside SDPA's forward and backward;
7. Llama training: (a) one TrainStep step of LlamaForCausalLM at
   Llama-3-8B widths (one layer, batch 1, sequence 256, SGD) on the card
   in fp32 and bf16 against the CPU's fp64 step (bf16 within a multiple of
   the CPU's bf16 step's deviation), every tensor with a non-zero
   gradient, planted faults (the GQA fold, the rope sign) that must fail;
   (b) the same step with LlamaConfig(remat=True) against the plain one,
   flash_attn_fwd launched once per layer and step without remat and twice
   with it; (c) a four-expert MoE Llama at narrow widths against the CPU's
   fp64 step, and the aux loss moving the router; (d) four layers at
   Llama-3-8B widths, batch 1, sequence 2048, bf16, Adam 3e-4: 2 warm-up
   and 20 timed steps without remat and with it (tokens/s, ms/step, MFU,
   peak memory, a profiled pass by kernel group with the attention
   backward apart, falling loss); (e) bench.py's llama_proxy_train
   configuration timed the same way, and the attention at its shape beside
   SDPA's forward and backward;
8. the kernels line (its times and launches at the main path's shape,
   serving over HTTP;
   each path's shape, times and launches under ``by_path``), then the
   device line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

BF16_TOL = {"atol": 2e-2, "rtol": 1e-2}   # o, bf16 kernel vs fp32 plain
LSE_TOL = 1e-3
F32_TOL = 1e-4
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"CHECK FAILED: {what}")


def cuda_time_ms(fn, iters=20, warmup=3):
    """Eager time per call with CUDA events: the host's launch cost shows
    where it exceeds the device's."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_time_ms(fn, iters=20, warmup=3):
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, timed with CUDA events, so no host launch cost is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / iters


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# phase 3: flash_attn_fwd against its plain version
# ---------------------------------------------------------------------------
# (B, Hq, Hkv, Lq, Lk, D, causal, views): views = q/k/v are transposed views
# of (B, L, H, D) tensors, as the model's projections hand them over.  The
# first three rows are the serving path's prefills at Llama-3-8B widths
# (buckets 2048, 512, 128), timed; the kernels line gives the largest
# bucket's times for the serving paths (submit() and HTTP, this slice's
# main path) and for Llama training at Llama-3-8B widths (sequence 2048:
# the same shape);
# BertSelfAttention's at bench.py's batch for the BERT training path; and
# bench.py's Llama proxy's (batch 8, 16/8 heads of 64, sequence 1024).
SERVING_SHAPE = (1, 32, 8, 2048, 2048, 128, True, False)
BUCKET_SHAPES = [SERVING_SHAPE,
                 (1, 32, 8, 512, 512, 128, True, False),
                 (1, 32, 8, 128, 128, 128, True, False)]
BERT_SHAPE = (64, 12, 12, 128, 128, 64, False, True)
PROXY_SHAPE = (8, 16, 8, 1024, 1024, 64, True, False)
PATH_SHAPES = {"serving": SERVING_SHAPE, "serve_http": SERVING_SHAPE,
               "bert_train": BERT_SHAPE, "llama_train": SERVING_SHAPE,
               "llama_proxy_train": PROXY_SHAPE}
KERNEL_CASES = BUCKET_SHAPES + [PROXY_SHAPE] + [
    (1, 32, 8, 512, 512, 128, False, False),
    (1, 32, 8, 1000, 1000, 128, True, False),     # ragged length
    (1, 32, 8, 1000, 1000, 128, False, False),
    (1, 32, 8, 100, 1100, 128, True, False),      # Lq < Lk: the decode offset
    (2, 32, 8, 2048, 2048, 128, False, False),    # batch 2, no diagonal
    (1, 32, 8, 1, 2048, 128, True, False),        # one query row
    (1, 32, 8, 200, 2048, 128, True, False),      # offset not a tile multiple
    (1, 32, 32, 512, 512, 128, True, False),      # no GQA
    (1, 32, 8, 2048, 2048, 128, True, True),      # the serving layout
    (2, 32, 8, 300, 700, 128, True, True),
    BERT_SHAPE,                                   # BertSelfAttention,
    (2, 12, 12, 384, 384, 64, False, False),      # BERT-base heads
    (2, 12, 12, 384, 384, 64, True, True),
    (1, 4, 2, 256, 256, 32, True, False),         # llama_tiny heads
    (1, 4, 2, 200, 300, 32, True, True),
    (1, 8, 8, 300, 300, 256, True, False),
    (1, 8, 2, 130, 333, 256, True, True),
]


def attention_work(shape, dtype):
    """(FLOPs, bytes) the function needs: 4·D per visible (q, k) pair per
    head; each input read once, o and lse written once."""
    b, hq, hkv, lq, lk, d, causal = shape[:7]
    if causal:
        off = lk - lq
        pairs = sum(min(lk, i + off + 1) for i in range(lq))
    else:
        pairs = lq * lk
    flops = 4.0 * b * hq * d * pairs
    es = torch.finfo(dtype).bits // 8
    nbytes = es * (2 * b * hq * lq * d + 2 * b * hkv * lk * d) \
        + 4 * b * hq * lq
    return flops, nbytes


def bound_ms(shape, dtype):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    flops, nbytes = attention_work(shape, dtype)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def make_qkv(shape, dtype, gen):
    b, hq, hkv, lq, lk, d, _, views = shape

    def one(h, length):
        if views:
            t = torch.randn(b, length, h, d, device="cuda", generator=gen)
            return t.to(dtype).transpose(1, 2)
        return torch.randn(b, h, length, d, device="cuda",
                           generator=gen).to(dtype)

    return one(hq, lq), one(hkv, lk), one(hkv, lk)


def kernel_phase(gen):
    from mxnet_tpu_torch.ops.flash_attention import (_flash_fwd_cuda,
                                                     _mha_with_lse,
                                                     flash_attention)

    worst = 0.0
    for shape in KERNEL_CASES:
        b, hq, hkv, lq, lk, d, causal, views = shape
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = make_qkv(shape, dtype, gen)
            scale = 1.0 / math.sqrt(d)
            o, lse = _flash_fwd_cuda(q, k, v, causal, scale)
            torch.cuda.synchronize()
            o_ref, lse_ref = _mha_with_lse(q.float(), k.float(), v.float(),
                                           causal, scale)
            err_o = (o.float() - o_ref).abs().max().item()
            err_l = (lse - lse_ref).abs().max().item()
            if dtype == torch.bfloat16:
                ok = torch.allclose(o.float(), o_ref, **BF16_TOL) and \
                    err_l <= LSE_TOL
                worst = max(worst, err_o)
            else:
                ok = err_o <= F32_TOL and err_l <= F32_TOL
            log(f"  flash_attn_fwd {str(dtype)[6:]:8s} B={b} Hq={hq} "
                f"Hkv={hkv} Lq={lq} Lk={lk} D={d} causal={causal} "
                f"{'(B,L,H,D) views' if views else 'contiguous'}: "
                f"max|o err|={err_o:.3e} max|lse err|={err_l:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attn_fwd {dtype} {shape} disagrees with "
                      f"_mha_with_lse")
            check(bool(torch.isfinite(o).all()), f"non-finite o at {shape}")
            check(o.shape == q.shape and o.transpose(1, 2).is_contiguous(),
                  f"o at {shape} is not the (B, Hq, Lq, D) view of a "
                  f"(B, Lq, Hq, D) tensor")
            del q, k, v, o, lse, o_ref, lse_ref

    # timing at the serving path's prefill shapes and the BERT shape,
    # bf16: device time from a replayed CUDA graph for the kernel and SDPA
    # alike, and the eager time per call (host launch cost included), also
    # of the public op under no_grad as serving calls it (its
    # autograd.Function around the kernel)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    by_path = {}
    for shape in BUCKET_SHAPES + [BERT_SHAPE, PROXY_SHAPE]:
        b, hq, hkv, lq, lk, d, causal, _ = shape
        q, k, v = make_qkv(shape, torch.bfloat16, gen)
        scale = 1.0 / math.sqrt(d)
        run = lambda: _flash_fwd_cuda(q, k, v, causal, scale)   # noqa: E731
        lib = lambda: sdpa(q, k, v, is_causal=causal, scale=scale,  # noqa
                           enable_gqa=True)
        ms, lib_ms = graph_time_ms(run), graph_time_ms(lib)
        eager_ms, lib_eager_ms = cuda_time_ms(run), cuda_time_ms(lib)
        with torch.no_grad():
            op_eager_ms = cuda_time_ms(lambda: flash_attention(
                q, k, v, causal=causal, sm_scale=scale))
        bound, bound_by = bound_ms(shape, torch.bfloat16)
        flops, nbytes = attention_work(shape, torch.bfloat16)
        log(f"  timing B={b} Hq={hq} Hkv={hkv} Lq=Lk={lq} D={d} bf16 "
            f"causal={causal}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f}% of "
            f"bound), sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
            f"eager per call: kernel {eager_ms:.4f} ms, flash_attention "
            f"under no_grad {op_eager_ms:.4f} ms, sdpa {lib_eager_ms:.4f} "
            f"ms")
        for path, path_shape in PATH_SHAPES.items():
            if shape != path_shape:
                continue
            plain_ms = cuda_time_ms(
                lambda: _mha_with_lse(q, k, v, causal, scale), iters=5)
            log(f"  plain version at the {path} shape: {plain_ms:.4f} ms")
            by_path[path] = {"shape": list(shape[:7]), "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound,
                             "bound_by": bound_by, "library_ms": lib_ms}
        del q, k, v
    main = by_path["serve_http"]
    return {"name": "flash_attn_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "mxnet_tpu/ops/flash_attention.py:68",
            "launches": None, "max_abs_err": worst,
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "by_path": by_path}


def build_checks(kernels):
    """ptxas's report for every instance, and the SASS of the bf16 D = 128
    instance.  A bf16 instance that spills or whose wgmma ptxas serialises
    fails; so does a D = 128 instance without HGMMA and UTMALDG or with
    HMMA (mma.sync)."""
    import re

    for name in kernels.sources():
        fn = None
        for line in (kernels.build_log(name) or "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                continue
            tag = re.search(r"fa_fwd_(\w+?)ILi(\d+)E", fn or "")
            inst = f"{tag.group(1)}<{tag.group(2)}>" if tag else (fn or name)
            if "serializ" in line:
                log(f"  {name} {inst}: {line.strip()}")
                check(False, f"ptxas serialises wgmma: {line.strip()}")
            elif "(C75" in line:      # ptxas's other performance notes
                log(f"  {name}: {line.strip()}")
            elif "registers" in line or "spill" in line:
                log(f"  {name} {inst}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores", line)
                if m and int(m.group(1)) and "wgmma" in inst:
                    check(False, f"{inst} spills registers")
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    check(os.path.isfile(cuobjdump),
          f"cuobjdump is missing ({cuobjdump}); the SASS check needs it")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(kernels._target("flash_attn_fwd"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    main = [f for f in funcs if "fa_fwd_wgmmaILi128E" in f.split("\n", 1)[0]]
    check(len(main) == 1, "no bf16 D = 128 instance in the SASS")
    counts = {op: len(re.findall(rf"\b{op}\b", main[0]))
              for op in ("HGMMA", "UTMALDG", "HMMA")}
    log(f"  SASS of fa_fwd_wgmma<128>: {counts}")
    check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
          and counts["HMMA"] == 0,
          "the bf16 D = 128 instance is not wgmma + TMA without mma.sync")


# ---------------------------------------------------------------------------
# phase 4: serving at Llama-3-8B widths
# ---------------------------------------------------------------------------
N_REQUESTS = 8
MAX_NEW = 32


def make_prompts(seed, vocab):
    """Lengths over ~60-2000 tokens, drawn so that every prefill bucket
    (128, 512, 2048) is hit; ids uniform over the vocabulary."""
    r = np.random.RandomState(seed)
    lengths = list(r.randint(60, 129, 2)) + list(r.randint(129, 513, 3)) \
        + list(r.randint(513, 2001, 3))
    r.shuffle(lengths)
    return [r.randint(0, vocab, (int(n),)).astype(np.int32)
            for n in lengths]


KERNEL_GROUPS = (("flash_attn_fwd", ("fa_fwd",)),
                 ("matmul", ("gemm", "xmma", "nvjet", "cutlass", "gemv")),
                 ("copy/index", ("index", "copy", "gather", "scatter",
                                 "Memcpy", "Memset")))


def profile_pass(engine, prompts, temps, seed):
    """Serve the same requests again under torch.profiler, device activity
    only, and print the device time by kernel group against the wall time
    of the pass (its busy share).  The measured pass ran without the
    profiler."""
    log_device_profile(lambda: serve(engine, prompts, temps, seed),
                       KERNEL_GROUPS)


def log_device_profile(run, kernel_groups, n_top=8, label=None, steps=1,
                       step_ms=None):
    """Run ``run()`` (``steps`` steps) under torch.profiler and print its
    wall time, the device-busy share and the device time by kernel group
    (the first group whose pattern a kernel's name holds), per step.  With
    ``label``, host activity is traced too, and the kernels that ran inside
    a ``label`` range (its annotation on the device timeline) form the
    group ``label``.  With ``step_ms`` (the unprofiled step time) the busy
    share is the device time per step over it, as the host profiler slows
    the host; else it is the device time over the profiled wall time."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if label:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [ev for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and ev.time_range.end > ev.time_range.start]
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in device if ev.name == label)
    starts = [a for a, _ in spans]

    def group_of(ev):
        i = bisect.bisect_right(starts, ev.time_range.start) - 1
        if i >= 0 and ev.time_range.start < spans[i][1]:
            return label
        return next((gr for gr, pats in kernel_groups
                     if any(pt in ev.name for pt in pats)), "other")

    groups, by_kernel = {}, {}
    for ev in device:
        if ev.name == label or getattr(ev, "is_user_annotation", False):
            continue                 # ranges, not kernels
        ms = (ev.time_range.end - ev.time_range.start) / 1e3
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ms
        group = group_of(ev)
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(groups.values())
    if busy == 0:
        log("  profile: no device time recorded (not measured)")
        return
    if step_ms is None:
        share = f"{100 * busy / 1e3 / wall:.1f}% busy"
    else:
        share = (f"{100 * busy / steps / step_ms:.1f}% of the unprofiled "
                 f"{step_ms:.2f} ms step")
    head = (f"  profiled pass: wall {wall:.3f} s, device busy "
            f"{busy / 1e3:.3f} s")
    unit = " a step" if steps > 1 else ""
    if steps > 1:
        head += f" = {busy / steps:.2f} ms{unit} over {steps} steps"
    if label:
        share += f"; host profiler on, {len(spans)} {label} ranges"
    log(f"{head} ({share})")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {group:18s} {ms / steps:10.2f} ms{unit}  "
            f"{100 * ms / busy:5.1f}%")
    for key, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:n_top]:
        log(f"    {ms / steps:10.2f} ms{unit}  {key[:110]}")


@contextlib.contextmanager
def recorded_rows(engine):
    """While open, the logits row the engine samples each token from is
    kept in the yielded dict, keyed by (request id, token index): the
    engine's ``_sample`` is wrapped, and each row is cloned on the device
    (the last capture of a key wins, so a re-prefilled continuation keeps
    its own rows)."""
    rows = {}
    sample = engine._sample

    def recording_sample(logits, reqs):
        for i, req in enumerate(reqs):
            rows[(req.id, len(req.tokens))] = logits[i].detach().clone()
        return sample(logits, reqs)

    engine._sample = recording_sample
    try:
        yield rows
    finally:
        del engine._sample


def serve(engine, prompts, temps, seed):
    """Submit every prompt at once and wait for all.  Returns the results
    and the logits rows the engine sampled from (``recorded_rows``)."""
    with recorded_rows(engine) as rows:
        reqs = [engine.submit(p, max_new_tokens=MAX_NEW, temperature=t,
                              seed=seed * 1000 + i)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        results = [r.result(timeout=900) for r in reqs]
    return results, rows


def phase_totals():
    """Wall seconds of the serving engine's prefill and decode phases since
    the last telemetry reset (``mxnet_serving_phase_seconds``)."""
    from mxnet_tpu_torch import telemetry

    fam = telemetry.snapshot()["metrics"]["mxnet_serving_phase_seconds"]
    out = {"prefill": 0.0, "decode": 0.0}
    for sample in fam["samples"]:
        out[sample["labels"]["phase"]] = sample["sum"]
    return out


def occupancy():
    """(mean decode-batch fill, decode steps) from the serving engine's
    ``mxnet_serving_batch_occupancy`` histogram since the last reset."""
    from mxnet_tpu_torch import telemetry

    sample = telemetry.snapshot()["metrics"][
        "mxnet_serving_batch_occupancy"]["samples"][0]
    return sample["sum"] / max(1, sample["count"]), sample["count"]


def engine_rows(rows, result):
    """(tokens, V) fp32: the logits behind each of a request's tokens."""
    rid = result["request_id"]
    return torch.stack([rows[(rid, j)] for j in
                        range(len(result["token_ids"]))]).float()


def forward_rows(llama_mod, params, cfg, device, prompt, toks):
    """The port's full-context forward over prompt + toks[:-1] with the
    PLAIN attention: the logits (tokens, V) fp32 at the positions that
    produced each token.  The caller swaps the model's attention function;
    nothing in the package falls back."""
    ids = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
    x = llama_mod._prefill_trunk(
        params, cfg, torch.as_tensor(ids[None], device=device),
        lambda *a: None)
    return llama_mod._dense_nb(x[0, prompt.size - 1:],
                               params["lm_head.weight"]).float()


class plain_attention_in:
    """Context manager: the model module's flash_attention is the plain
    version while it is open (the reference forwards of the checks)."""

    def __init__(self, llama_mod, fa_mod):
        self.llama_mod, self.fa_mod = llama_mod, fa_mod

    def __enter__(self):
        fa = self.fa_mod
        self.saved = self.llama_mod.flash_attention
        self.llama_mod.flash_attention = \
            lambda q, k, v, causal=False, sm_scale=None: \
            fa._mha_with_lse(q, k, v, causal, sm_scale)[0]

    def __exit__(self, *exc):
        self.llama_mod.flash_attention = self.saved


def check_bf16_run(llama_mod, fa_mod, net, prompts, temps, results, rows):
    """The timed bf16 run against the full-context forward.  Two correct
    bf16 evaluations of this 32-layer model differ by tenths on logits of
    ~5 through rounding order alone, far above the single-kernel
    tolerance, so the bound is measured in this run: NOISE = max|forward
    in bf16 - forward in fp32| per position.  Every logits row the engine
    sampled from (prefill and decode, all requests) must lie within
    2 x NOISE of the fp32 forward, and each greedy token must trail the
    fp32 forward's best logit by at most 2 x NOISE.  This catches gross
    faults only; the fp32 pass (check_fp32_run) holds the engine tight."""
    cfg = net.config
    params = llama_mod.serving_params(net)
    params32 = {k: v.float() for k, v in params.items()}
    worst_err, worst_deficit = 0.0, 0.0
    with torch.no_grad(), plain_attention_in(llama_mod, fa_mod):
        for p, t, r in zip(prompts, temps, results):
            toks = r["token_ids"]
            f16 = forward_rows(llama_mod, params, cfg, net.device, p, toks)
            f32 = forward_rows(llama_mod, params32, cfg, net.device, p, toks)
            eng = engine_rows(rows, r)
            check(bool(torch.isfinite(eng).all()),
                  f"non-finite engine logits for request {r['request_id']}")
            noise = (f16 - f32).abs().amax(dim=-1)
            err = (eng - f32).abs().amax(dim=-1)
            worst_err = max(worst_err, (err / noise).amax().item())
            msg = (f"  request {r['request_id']}: bf16-vs-fp32 forward noise "
                   f"max {noise.amax().item():.4f}; engine logits vs fp32 "
                   f"forward max|err| {err.amax().item():.4f} "
                   f"({(err / noise).amax().item():.2f} x noise)")
            check(bool((err <= 2 * noise).all()),
                  f"request {r['request_id']}: engine logits stray more "
                  f"than 2 x noise from the full-context forward")
            if t == 0.0:
                idx = torch.as_tensor(toks, device=f32.device)
                deficit = f32.amax(dim=-1) - f32.gather(1, idx[:, None])[:, 0]
                ratio = (deficit / noise).amax().item()
                worst_deficit = max(worst_deficit, ratio)
                msg += (f"; greedy tokens trail the fp32 best by at most "
                        f"{deficit.amax().item():.4f} ({ratio:.2f} x noise), "
                        f"{int((deficit == 0).sum())}/{len(toks)} are its "
                        f"argmax")
                check(bool((deficit <= 2 * noise).all()),
                      f"request {r['request_id']}: a greedy token trails "
                      f"the full-context forward by more than 2 x noise")
            log(msg)
    log(f"  bf16 run agrees with the full-context forward: logits within "
        f"{worst_err:.2f} x noise, greedy deficits within "
        f"{worst_deficit:.2f} x noise (bound 2)")


FP32_LOGIT_TOL = 1e-3


def check_fp32_run(llama_mod, fa_mod, net, prompts, temps, results, rows):
    """The engine in fp32 (the same weights, upcast) against the fp32
    full-context forward with the plain attention: every logits row the
    engine sampled from, prefill and each decode step of every request,
    within FP32_LOGIT_TOL; every greedy token the forward's argmax unless
    the forward's top two lie within FP32_LOGIT_TOL (then it must be one
    of them).  fp32 rounding through 32 layers stays far below the
    tolerance; a wrong page, slot, position or mask moves logits far
    above it."""
    cfg = net.config
    params = llama_mod.serving_params(net)
    worst = 0.0
    with torch.no_grad(), plain_attention_in(llama_mod, fa_mod):
        for p, t, r in zip(prompts, temps, results):
            toks = r["token_ids"]
            ref = forward_rows(llama_mod, params, cfg, net.device, p, toks)
            err = (engine_rows(rows, r) - ref).abs().amax(dim=-1)
            worst = max(worst, err.amax().item())
            log(f"  request {r['request_id']}: fp32 engine logits vs fp32 "
                f"forward max|err| {err.amax().item():.3e} (first token "
                f"{err[0].item():.3e}), logits span "
                f"{ref.amin().item():.3f}..{ref.amax().item():.3f}")
            check(bool((err <= FP32_LOGIT_TOL).all()),
                  f"request {r['request_id']}: fp32 engine logits differ "
                  f"from the full-context forward by more than "
                  f"{FP32_LOGIT_TOL}")
            if t != 0.0:
                continue
            top2 = ref.topk(2, dim=-1)
            for j, tok in enumerate(toks):
                best, second = top2.indices[j].tolist()
                tie = (top2.values[j, 0] - top2.values[j, 1]).item() \
                    < FP32_LOGIT_TOL
                check(tok == best or (tie and tok == second),
                      f"request {r['request_id']}: fp32 greedy token {j} is "
                      f"{tok}, the forward's argmax is {best}")
                if tok != best:
                    break        # a near tie took the other branch
    log(f"  fp32 run agrees with the full-context forward: worst logit "
        f"error {worst:.3e} (tolerance {FP32_LOGIT_TOL})")


# ---------------------------------------------------------------------------
# phase 4b: the same net served over HTTP by serving.serve()
# ---------------------------------------------------------------------------
HTTP_TIMEOUT = 600        # seconds: every HTTP call and every wait
DRAIN_TOKENS = 96         # the in-flight request of the drain check
SERVING_FAMILIES = (
    "mxnet_serving_queue_depth", "mxnet_serving_active_sequences",
    "mxnet_serving_batch_occupancy", "mxnet_serving_phase_seconds",
    "mxnet_serving_request_seconds", "mxnet_serving_ttft_seconds",
    "mxnet_serving_tokens_total", "mxnet_serving_requests_total",
    "mxnet_serving_evictions_total", "mxnet_serving_kv_pages",
    "mxnet_serving_tokens_per_s", "mxnet_tokens_per_s_per_chip",
    "mxnet_serving_join_to_first_token_seconds",
    "mxnet_serving_step_failures_total")


def http_call(port, path, body=None):
    """(status, body) of one call to the server on 127.0.0.1:``port``;
    a JSON body is parsed, any other is text."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data,
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    text = raw.decode()
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


def wait_until(cond, what, timeout=HTTP_TIMEOUT, poll=0.005):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(poll)


def in_thread(fn, *args):
    """Start ``fn(*args)`` on a thread; returns (thread, result box)."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:       # re-raised by joined()
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def joined(t, box):
    t.join(HTTP_TIMEOUT)
    check(not t.is_alive(), "a phase 4b thread did not end in time")
    if "error" in box:
        raise box["error"]
    return box["out"]


def metric_lines(port):
    status, text = http_call(port, "/metrics")
    check(status == 200, f"/metrics answered {status}")
    return text.splitlines()


def http_checks(engine, port, prompts, temps, seed, stop, counter,
                drain_tokens):
    """Phase 4b's requests and checks, run on their own thread while
    ``serve()`` holds the main thread.  Returns the completions, the logits
    rows the engine sampled from (as ``serve`` records them), the kernel's
    launches over the 8 completions and the timing figures."""
    from mxnet_tpu_torch import fault, lifecycle

    out = {}

    def post(body):
        """(status, body, client wall-clock start and end)."""
        t0 = time.time()
        status, res = http_call(port, "/v1/completions", body)
        return status, res, (t0, time.time())

    # the client's first call in a process builds urllib's default opener
    # (with a TLS context), once per thread that races to it: made here,
    # outside the timed calls
    check(http_call(port, "/healthz")[0] == 200, "/healthz did not answer")

    # (1) the 8 requests of phase 4, concurrently, through /v1/completions
    counter.launches = 0
    counter.launches_by_len = {}
    t0 = time.perf_counter()
    with recorded_rows(engine) as rows:
        calls = [in_thread(post, {"prompt": p.tolist(),
                                  "max_new_tokens": MAX_NEW,
                                  "temperature": t,
                                  "seed": seed * 1000 + i})
                 for i, (p, t) in enumerate(zip(prompts, temps))]
        answers = [joined(*c) for c in calls]
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = counter.launches
    out["launches_by_len"] = dict(sorted(counter.launches_by_len.items()))
    out["decode_s"] = phase_totals()["decode"]
    out["occupancy"] = occupancy()
    for status, res, _ in answers:
        check(status == 200, f"/v1/completions answered {status}: {res}")
        check(len(res["token_ids"]) == MAX_NEW
              and res["finish_reason"] == "length",
              f"HTTP request {res['request_id']} came back with "
              f"{len(res['token_ids'])} tokens, finish "
              f"{res['finish_reason']}; expected {MAX_NEW}, length")
    out["results"] = [res for _, res, _ in answers]
    out["client_s"] = [t1 - t0 for _, _, (t0, t1) in answers]
    out["rows"] = rows

    # (2) the engine's planes over HTTP
    status, st = http_call(port, "/v1/serving")
    check(status == 200 and st["latency_s"]["count"] == N_REQUESTS
          and st["ttft_s"]["count"] == N_REQUESTS
          and st["queue_depth"] == 0 and st["active_sequences"] == 0,
          f"/v1/serving after the completions: {st}")
    lines = metric_lines(port)
    families = {ln.split()[2] for ln in lines if ln.startswith("# TYPE ")}
    missing = set(SERVING_FAMILIES) - families
    check(not missing, f"/metrics lacks the serving families {missing}")
    done = f'mxnet_serving_requests_total{{outcome="length"}} {N_REQUESTS}'
    check(done in lines, f"/metrics does not count {N_REQUESTS} completed "
                         f"requests ({done!r})")
    status, tr = http_call(port, "/v1/requests")
    want = {"queue_wait", "prefill", "sample", "decode_step"}
    check(status == 200 and tr["traced_requests"] == N_REQUESTS
          and len(tr["requests"]) == N_REQUESTS,
          f"/v1/requests holds {tr.get('traced_requests')} traces")
    # the client's round trip beyond the server's submit -> resolve: before
    # the submit (connection, request parse) and after (response)
    spans = {item["trace_id"]: (item["time"], item["duration_s"])
             for item in tr["requests"]}
    out["pre_s"], out["post_s"] = [], []
    for _, res, (c0, c1) in answers:
        wall0, dur = spans[res["request_id"]]
        out["pre_s"].append(wall0 - c0)
        out["post_s"].append(c1 - (wall0 + dur))
    for item in tr["requests"]:
        names = {c["name"] for c in item["tree"]["children"]}
        names |= {g["name"] for c in item["tree"]["children"]
                  for g in c["children"]}
        check(want <= names and item["outcome"] == "length",
              f"trace {item['trace_id']} has spans {sorted(names)}")
    out["stats"] = st

    # (3) fault seams: one decode failure is retried ...
    probe = {"prompt": prompts[0][:64].tolist(), "max_new_tokens": 8}
    with fault.inject("serving.decode_step", times=1):
        status, res, _ = post(probe)
    check(status == 200 and len(res["token_ids"]) == 8,
          f"after one injected decode failure: {status} {res}")
    check("mxnet_serving_step_failures_total 1" in metric_lines(port),
          "the step failure was not counted")
    # ... a persistent one fails the in-flight request and dumps the ring
    n = engine._MAX_CONSEC_STEP_FAILURES
    with fault.inject("serving.decode_step", times=n):
        status, res, _ = post(probe)
    check(status == 503
          and "injected fault at serving.decode_step" in res["error"]
          and "persistently failing" in res["error"],
          f"after {n} injected decode failures: {status} {res}")
    path = os.path.join(os.environ["MXNET_FLIGHT_DIR"], "blackbox.rank0.json")
    check(os.path.isfile(path), f"no black-box dump at {path}")
    with open(path) as f:
        box = json.load(f)
    events = [e.get("event") or e.get("seam") for e in box["events"]]
    check(box["reason"] == "serving_step_failure"
          and "serving_step_failure" in events
          and "serving.decode_step" in events,
          f"black-box dump: reason {box['reason']}, events {events[-5:]}")
    out["blackbox"] = path
    status, res, _ = post(probe)
    check(status == 200 and len(res["token_ids"]) == 8,
          f"the request after the persistent failure: {status} {res}")

    # (4) the stop: one request in flight, one held in the queue by a
    # tripping admission; the in-flight one finishes, the queued one is
    # rejected, and serve() returns EXIT_PREEMPTED (checked by the caller)
    a = in_thread(post, {"prompt": prompts[0][:64].tolist(),
                         "max_new_tokens": drain_tokens})
    wait_until(lambda: http_call(port, "/v1/serving")[1]
               ["active_sequences"] == 1, "the first request's prefill")
    with contextlib.ExitStack() as stack:
        stack.enter_context(fault.inject("serving.admit", times=10**9))
        b = in_thread(post, {"prompt": prompts[1][:64].tolist(),
                             "max_new_tokens": 8})
        wait_until(lambda: http_call(port, "/v1/serving")[1]
                   ["queue_depth"] == 1, "the second request in the queue")
        st = http_call(port, "/v1/serving")[1]
        check(st["active_sequences"] == 1 and a[0].is_alive(),
              f"the first request left the batch before the stop: {st}")
        stop()
        wait_until(lifecycle.stop_requested, "the stop request", timeout=60)
        # the engine has seen the stop (and admits nothing more) before
        # the admission fault is disarmed
        wait_until(engine._stop_evt.is_set, "the engine's stop", timeout=60)
    status_a, res_a, _ = joined(*a)
    status_b, res_b, _ = joined(*b)
    check(status_a == 200 and len(res_a["token_ids"]) == drain_tokens,
          f"the in-flight request at the stop: {status_a} {res_a}")
    check(status_b == 503 and "rejected: server shutting down"
          in res_b.get("error", ""),
          f"the queued request at the stop: {status_b} {res_b}")
    return out


def http_phase(net, engine_kw, prompts, temps, seed, counter, check_rows,
               stop=None, install_signals=True, device=None,
               drain_tokens=DRAIN_TOKENS):
    """Phase 4b: ``serving.serve(net, port=0)`` on this (the main) thread,
    driven over HTTP from a thread started in ``on_ready``: the 8
    completions (each with MAX_NEW tokens, every sampled logits row held by
    ``check_rows(results, rows)``), ``/v1/serving``, ``/metrics`` and
    ``/v1/requests``, a retried decode fault, a persistent one (the request
    fails, a black box is dumped), and the stop (``stop()``: SIGTERM to
    this process by default), which must drain and make ``serve()`` return
    ``lifecycle.EXIT_PREEMPTED``.  ``counter`` is the kernel wrapper whose
    launches are counted over the 8 completions.  Returns the client's
    figures."""
    from mxnet_tpu_torch import fault, flight_recorder, lifecycle, telemetry
    from mxnet_tpu_torch.serving import serve

    if stop is None:
        def stop():
            os.kill(os.getpid(), signal.SIGTERM)
    for plane in (lifecycle, telemetry, flight_recorder):
        plane.reset()
    fault.reload_spec()
    fault.reset_stats()
    client = []

    def on_ready(engine, port):
        def drive():
            try:
                return http_checks(engine, port, prompts, temps, seed, stop,
                                   counter, drain_tokens)
            except BaseException:
                lifecycle.request_stop("phase 4b client failed")
                raise
        client.extend(in_thread(drive))

    saved = os.environ.get("MXNET_FLIGHT_DIR")
    with tempfile.TemporaryDirectory(prefix="mxnet_blackbox_") as tmp:
        os.environ["MXNET_FLIGHT_DIR"] = tmp
        try:
            rc = serve(net, port=0, install_signals=install_signals,
                       on_ready=on_ready, device=device, **engine_kw)
            out = joined(*client)          # the client's failure, raised
            drained = "mxnet_serving_requests_total" \
                '{outcome="drain_rejected"} 1' in \
                telemetry.render_prometheus().splitlines()
        finally:
            telemetry.stop_http_server()
            lifecycle.reset()
            if saved is None:
                os.environ.pop("MXNET_FLIGHT_DIR", None)
            else:
                os.environ["MXNET_FLIGHT_DIR"] = saved
    check(rc == lifecycle.EXIT_PREEMPTED,
          f"serve() returned {rc} after the stop, expected "
          f"{lifecycle.EXIT_PREEMPTED}")
    check(drained, "the drain's rejection was not counted "
                   "(mxnet_serving_requests_total{outcome=drain_rejected})")
    check_rows(out["results"], out["rows"])
    out["rc"] = rc
    return out


def serving_phase(seed):
    from mxnet_tpu_torch.gluon.model_zoo.language import llama as llama_mod
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    net = llama_mod.init_random_(llama_mod.llama3_8b(dtype="bfloat16"), seed)
    cfg = net.config
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    log(f"  model: vocab {cfg.vocab_size}, hidden {cfg.hidden_size}, "
        f"{cfg.num_layers} layers, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, head_dim {cfg.head_dim}, ffn "
        f"{cfg.intermediate_size}, bf16, {n_params / 1e9:.3f} B params "
        f"({time.perf_counter() - t0:.1f} s to build)")
    engine_kw = dict(batch_buckets=[1, 2, 4, 8],
                     prefill_buckets=[128, 512, 2048], kv_pages=2048,
                     page_size=16, max_batch=8)
    engine = ServingEngine(net, **engine_kw).start()
    log(f"  KV pool: {engine._kv.nbytes() / 2**30:.3f} GiB")
    prompts = make_prompts(seed, cfg.vocab_size)
    temps = [0.8 if i in (1, 5) else 0.0 for i in range(N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_mod._flash_fwd_cuda.launches = 0          # counts of this run only
    fa_mod._flash_fwd_cuda.launches_by_len = {}
    telemetry.reset()
    t0 = time.perf_counter()
    results, rows = serve(engine, prompts, temps, seed)
    wall = time.perf_counter() - t0
    fill = occupancy()
    launches = fa_mod._flash_fwd_cuda.launches
    by_bucket = dict(sorted(fa_mod._flash_fwd_cuda.launches_by_len.items()))
    peak = torch.cuda.max_memory_allocated()
    phase = phase_totals()

    prefills = sum(r["prefills"] for r in results)
    for p, t, r in zip(prompts, temps, results):
        log(f"  request {r['request_id']}: prompt {p.size}, temperature "
            f"{t}, {len(r['token_ids'])} tokens, {r['prefills']} "
            f"prefill(s), ttft {r['ttft_s']:.4f} s, latency "
            f"{r['latency_s']:.4f} s, finish {r['finish_reason']}")
        check(len(r["token_ids"]) == MAX_NEW and
              r["finish_reason"] == "length",
              f"request {r['request_id']} did not generate {MAX_NEW} tokens")
    check(launches == cfg.num_layers * prefills,
          f"flash_attn_fwd launched {launches} times in the serving run, "
          f"expected num_layers x prefills = {cfg.num_layers * prefills}")
    ttft = sorted(r["ttft_s"] for r in results)
    decode_tokens = sum(len(r["token_ids"]) - r["prefills"]
                        for r in results)
    log(f"  served {N_REQUESTS} requests in {wall:.3f} s: TTFT p50 "
        f"{ttft[len(ttft) // 2]:.4f} s (max {ttft[-1]:.4f} s); prefill "
        f"{phase['prefill']:.4f} s, decode {phase['decode']:.4f} s; decode "
        f"{decode_tokens / phase['decode']:.1f} tokens/s; flash_attn_fwd "
        f"launches {launches} = {cfg.num_layers} layers x {prefills} "
        f"prefills; peak memory {peak / 2**30:.3f} GiB")
    log(f"  flash_attn_fwd launches by prefill bucket: "
        + ", ".join(f"{n} at {lb}" for lb, n in by_bucket.items()))
    profile_pass(engine, prompts, temps, seed)
    engine.close()
    del engine
    check_bf16_run(llama_mod, fa_mod, net, prompts, temps, results, rows)
    del rows

    log("== serving 4b: the same net behind serving.serve() over HTTP")
    t0 = time.perf_counter()
    http = http_phase(
        net, engine_kw, prompts, temps, seed, fa_mod._flash_fwd_cuda,
        lambda res, rows: check_bf16_run(llama_mod, fa_mod, net, prompts,
                                         temps, res, rows))
    http_prefills = sum(r["prefills"] for r in http["results"])
    check(http["launches"] == cfg.num_layers * http_prefills,
          f"flash_attn_fwd launched {http['launches']} times over the HTTP "
          f"completions, expected num_layers x prefills = "
          f"{cfg.num_layers * http_prefills}")
    http_ttft = sorted(r["ttft_s"] for r in http["results"])
    http_lat = sorted(r["latency_s"] for r in http["results"])
    client = sorted(http["client_s"])
    lat = sorted(r["latency_s"] for r in results)
    mid = N_REQUESTS // 2
    http_tokens = sum(len(r["token_ids"]) - r["prefills"]
                      for r in http["results"])
    log(f"  [{gpu_line()}] {N_REQUESTS} requests, submit() (phase 4) | "
        f"HTTP (4b): TTFT p50 {ttft[mid]:.4f} | {http_ttft[mid]:.4f} s; "
        f"latency p50 {lat[mid]:.4f} | {http_lat[mid]:.4f} s (client "
        f"round trip p50 {client[mid]:.4f} s); decode "
        f"{decode_tokens / phase['decode']:.1f} | "
        f"{http_tokens / http['decode_s']:.1f} tokens/s; wall {wall:.3f} | "
        f"{http['wall_s']:.3f} s; decode-batch fill {fill[0]:.3f} over "
        f"{fill[1]} steps | {http['occupancy'][0]:.3f} over "
        f"{http['occupancy'][1]} steps")
    pre, post = sorted(http["pre_s"]), sorted(http["post_s"])
    log(f"  HTTP round trip beyond the server's submit -> resolve: before "
        f"the submit p50 {pre[mid]:.4f} s (max {pre[-1]:.4f} s), after the "
        f"resolve p50 {post[mid]:.4f} s (max {post[-1]:.4f} s)")
    log(f"  flash_attn_fwd over the HTTP completions: {http['launches']} = "
        f"{cfg.num_layers} layers x {http_prefills} prefills ("
        + ", ".join(f"{n} at {lb}" for lb, n in
                    http["launches_by_len"].items())
        + f"); decode faults retried and failed as the reference's loop "
        f"does, black box {os.path.basename(http['blackbox'])}; SIGTERM "
        f"drained and serve() returned {http['rc']} "
        f"({time.perf_counter() - t0:.1f} s)")

    log("== serving in fp32: the same weights and requests, held tight")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    net.float()
    engine = ServingEngine(net, **engine_kw).start()
    fa_mod._flash_fwd_cuda.launches = 0
    results32, rows32 = serve(engine, prompts, temps, seed)
    engine.close()
    prefills32 = sum(r["prefills"] for r in results32)
    check(fa_mod._flash_fwd_cuda.launches == cfg.num_layers * prefills32,
          "flash_attn_fwd launches in the fp32 run != layers x prefills")
    check(all(len(r["token_ids"]) == MAX_NEW for r in results32),
          "an fp32 request did not generate its tokens")
    del engine
    check_fp32_run(llama_mod, fa_mod, net, prompts, temps, results32, rows32)
    log(f"  fp32 pass took {time.perf_counter() - t0:.1f} s")
    return {"serving": launches, "serve_http": http["launches"]}


# ---------------------------------------------------------------------------
# phase 5: training at ResNet-50 v1 widths
# ---------------------------------------------------------------------------
TRAIN_SIZE = 224
CHECK_BATCH = 8
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 256, 2, 20
TRAIN_OPT = {"learning_rate": 0.1, "momentum": 0.9}        # bench.py
# the checked steps add weight decay, so that a dropped wd shows
CHECK_OPT = dict(TRAIN_OPT, wd=1e-4)
# compare_steps's ratio.  Updates below UPDATE_FLOOR of the largest of
# their kind (trainable tensors, running stats) are rounding noise; on this
# net the stem convolution's update (~2.3) sets the trainable floor, so
# most deeper convolution weights are measured against the floor, not
# against their own update.  Measured on the card (PERF.md, training): fp32 rounding alone
# moves the fp32 step of this net by ~0.17 (card and CPU alike, against
# the fp64 step), so the fp32 card-vs-CPU check catches gross faults only;
# in fp64 the card's step and the CPU's agree to ~3e-12, and that check
# holds the step tight (the planted faults read 3.8e-3 and up); the Gluon
# loop and TrainStep on the card, both fp32, agree to ~8e-4.
UPDATE_FLOOR = 1e-3
FP32_STEP_BOUND = 0.5
FP64_STEP_BOUND = 1e-5
LOOP_BOUND = 1e-2
# the card's bf16 step must land as close to the fp64 step as the CPU's
# bf16 step of the same port does (oneDNN's kernels, not cuDNN's), within
# this factor, tensor by tensor (as tests/test_torch_resnet_train.py holds
# the port's bf16 step to the reference's)
BF16_NOISE_FACTOR = 3.0

# model FLOPs of one ResNet-50 training image, bench.py's
# RESNET50_TRAIN_FLOPS_PER_IMG (its MFU numerator)
RESNET50_TRAIN_FLOPS_PER_IMG = 11.7e9

TRAIN_KERNEL_GROUPS = (
    ("batchnorm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("copies", ("copy", "Memcpy", "Memset", "cast")),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "wgrad",
                     "dgrad", "sm90", "nhwc", "nchw")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "pool",
                     "softmax", "threshold", "unrolled")))


def train_batch(seed, batch, size=TRAIN_SIZE, classes=1000):
    """A synthetic NHWC batch, as bench.py makes it: images uniform on
    [-1, 1], labels uniform over the classes (numpy, from ``seed``)."""
    r = np.random.RandomState(seed)
    x = r.uniform(-1, 1, (batch, size, size, 3)).astype("float32")
    y = r.randint(0, classes, (batch,)).astype("int32")
    return x, y


def init_net(make_net, seed, ctx, size=TRAIN_SIZE):
    """``make_net()`` initialized on ``ctx`` from the device generator
    seeded with ``seed``, its deferred shapes settled by one forward."""
    import mxnet_tpu_torch as mx

    mx.random.seed(seed)
    net = make_net()
    net.initialize(ctx=ctx)
    net(mx.nd.zeros((1, size, size, 3), ctx=ctx))
    return net


def copy_net(net, make_net, ctx, size=TRAIN_SIZE):
    """A second ``make_net()`` on ``ctx`` holding ``net``'s weights."""
    from mxnet_tpu_torch.gluon import load_reference_params

    other = init_net(make_net, 0, ctx, size)
    load_reference_params(other, {k: p.data().asnumpy() for k, p in
                                  net.collect_params().items()})
    return other


def _host(t):
    return t.detach().to("cpu", copy=True)


def trainstep_result(net, x, y, device, opt=CHECK_OPT, dtype=None,
                     loss_fn=None, before=None):
    """One SGD TrainStep step of ``net`` on ``device``, in the net's dtype
    or under TrainStep's ``dtype``, with ``loss_fn`` (default softmax
    cross-entropy): (loss, the parameters before, after), in
    collect_params() order, on the host.  ``before``: the host copy of the
    weights to return (shared by steps from the same weights, so that a
    full-width net's weights are held on the host once)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep

    params = net.collect_params()
    if before is None:
        before = [_host(p.data()._data) for p in params.values()]
    step = TrainStep(net, loss_fn or gluon.loss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd", optimizer_params=opt, device=device,
                     dtype=dtype)
    loss = step(x, y).item()
    return loss, before, [_host(step.params[n]) for n in params]


def gluon_loop_result(net, x, y, opt=CHECK_OPT):
    """One record / backward / Trainer.step step on ``net`` itself (it is
    trained in place): (loss, before, after) as trainstep_result."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    params = net.collect_params()
    before = [_host(p.data()._data) for p in params.values()]
    ctx = next(iter(params.values())).data().context
    trainer = gluon.Trainer(params, "sgd", dict(opt))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    X = mx.nd.array(x, ctx=ctx, dtype=x.dtype)
    Y = mx.nd.array(y, ctx=ctx)
    with autograd.record():
        loss = loss_fn(net(X), Y)
    loss.backward()
    trainer.step(len(x))
    return (float(loss.mean().asscalar()), before,
            [_host(p.data()._data) for p in params.values()])


def _kind(name):
    """"stats" for a BatchNorm running mean or variance, else "trainable"."""
    return "stats" if name.endswith(("running_mean", "running_var")) \
        else "trainable"


def step_deviations(cand, ref, names):
    """How far step ``cand`` strays from step ``ref`` (both (loss, before,
    after) from the same weights; ``cand``'s tensors are cast to ``ref``'s
    dtype, so an fp32 or bf16 step can be held to an fp64 one): a list of
    (where, deviation), first |loss difference| / max(1, |loss|), then per
    tensor max |after difference|.  None if the steps start from
    different weights."""
    (loss_c, before_c, after_c), (loss_r, before_r, after_r) = cand, ref
    for b_c, b_r in zip(before_c, before_r):
        if not torch.equal(b_c.to(b_r.dtype), b_r):
            return None
    devs = [("loss", abs(loss_c - loss_r) / max(1.0, abs(loss_r)))]
    for name, a_c, a_r in zip(names, after_c, after_r):
        devs.append((name, (a_c.to(a_r.dtype) - a_r).abs().max().item()))
    return devs


def update_floors(ref, names):
    """Per kind (_kind), UPDATE_FLOOR of the largest update in step
    ``ref`` among the tensors of that kind: {kind: (floor, tensor)}."""
    _, before, after = ref
    floors = {}
    for name, a, b in zip(names, after, before):
        upd = UPDATE_FLOOR * (a - b).abs().max().item()
        if upd >= floors.get(_kind(name), (-1.0, None))[0]:
            floors[_kind(name)] = (upd, name)
    return floors


def update_scales(ref, names):
    """The scale of each entry of step_deviations: 1 for the loss; per
    tensor the largest entry of ``ref``'s update of it, or its kind's
    floor (update_floors) if that is more.  Measured against the update, a
    fault in the step itself (the optimizer's arithmetic, the running-stat
    update) shows even where it is small beside the weights; the floor is
    for tensors whose gradient is rounding noise, such as a convolution's
    bias before BatchNorm (which cancels it).  The trainable tensors and
    the running stats have floors of their own, so the running variances'
    large updates do not lift the floor of the weights."""
    _, before, after = ref
    floors = update_floors(ref, names)
    return [1.0] + [max((a - b).abs().max().item(), floors[_kind(name)][0])
                    for name, a, b in zip(names, after, before)]


def compare_steps(cand, ref, names, scales=None):
    """The worst deviation of ``cand`` from ``ref`` over ``scales`` (by
    default update_scales(ref)): (ratio, where)."""
    devs = step_deviations(cand, ref, names)
    if devs is None:
        return float("inf"), "the steps start from different weights"
    if scales is None:
        scales = update_scales(ref, names)
    return max((d / s, where) for (where, d), s in zip(devs, scales))


def noise_scales(noise, ref, names):
    """Scales that hold a step to ``ref`` within a multiple of another
    step's deviation from it (``noise``, e.g. an independent bf16 step):
    per entry that deviation, or UPDATE_FLOOR of update_scales(ref) if
    that is more."""
    devs = step_deviations(noise, ref, names)
    check(devs is not None, "the noise step starts from other weights")
    return [max(d, UPDATE_FLOOR * s)
            for (_, d), s in zip(devs, update_scales(ref, names))]


def check_steps(cand, ref, names, what, bound, scales=None,
                unit="of the update"):
    ratio, where = compare_steps(cand, ref, names, scales)
    log(f"  {what}: worst deviation {ratio:.3e} {unit} ({where}), "
        f"bound {bound:g}; loss {cand[0]:.9f} vs {ref[0]:.9f}")
    check(ratio <= bound, f"{what}: deviation {ratio:.3e} at {where} "
                          f"exceeds {bound:g}")
    return ratio


def planted_fault(fault):
    """Context manager planting ``fault`` in the training step, for showing
    that the step checks catch it: "unbiased" (BatchNorm's running
    variance takes the unbiased batch variance), "momentum" (the running
    stats weigh the batch by ``momentum``) or "no_wd" (TrainStep's SGD
    drops weight decay)."""
    import contextlib

    from mxnet_tpu_torch.parallel import data_parallel

    @contextlib.contextmanager
    def no_wd():
        orig = data_parallel.make_sgd_update
        data_parallel.make_sgd_update = \
            lambda lr, momentum, wd: orig(lr, momentum, 0.0)
        try:
            yield
        finally:
            data_parallel.make_sgd_update = orig

    return no_wd() if fault == "no_wd" else planted_bn_fault(fault)


def planted_bn_fault(fault):
    """Context manager: the BatchNorm op with ``fault`` planted, for
    showing that the step checks catch it: "unbiased" (the running
    variance takes the unbiased batch variance) or "momentum" (the running
    stats weigh the batch by ``momentum``)."""
    import contextlib

    from mxnet_tpu_torch.ops.registry import get_op

    od = get_op("BatchNorm")
    orig = od.fn

    def faulty(x, gamma, beta, mean, var, momentum=0.9, axis=1,
               training=False, **kw):
        if fault == "momentum":
            return orig(x, gamma, beta, mean, var, momentum=1 - momentum,
                        axis=axis, training=training, **kw)
        out, new_mean, new_var = orig(x, gamma, beta, mean, var,
                                      momentum=momentum, axis=axis,
                                      training=training, **kw)
        if training:
            n = x.numel() // x.shape[axis]
            batch_var = (new_var - var * momentum) / (1 - momentum)
            new_var = var * momentum + batch_var * n / (n - 1) * \
                (1 - momentum)
        return out, new_mean, new_var

    @contextlib.contextmanager
    def scope():
        od.fn = faulty
        try:
            yield
        finally:
            od.fn = orig

    return scope()


def resnet50():
    from mxnet_tpu_torch.gluon.model_zoo import vision

    return vision.resnet50_v1(layout="NHWC")


def training_phase(seed):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch.parallel import TrainStep

    t0 = time.perf_counter()
    net = init_net(resnet50, seed, mx.gpu(0))
    params = net.collect_params()
    names = list(params)
    log(f"  resnet50_v1 NHWC: {len(names)} parameters, "
        f"{sum(p.data().size for p in params.values()) / 1e6:.3f} M values, "
        f"1000 classes, {TRAIN_SIZE}x{TRAIN_SIZE} "
        f"({time.perf_counter() - t0:.1f} s to build)")
    fa_mod._flash_fwd_cuda.launches = 0

    log(f"== training 1: one TrainStep step at batch {CHECK_BATCH}, card "
        f"against CPU (TF32 off), in fp32 and in fp64")
    x, y = train_batch(seed, CHECK_BATCH)
    cpu_net = copy_net(net, resnet50, mx.cpu())
    t0 = time.perf_counter()
    cpu_ref = trainstep_result(cpu_net, x, y, "cpu")
    t1 = time.perf_counter()
    cpu16 = trainstep_result(cpu_net, x, y, "cpu", dtype="bfloat16")
    log(f"  CPU steps: fp32 {t1 - t0:.1f} s, bf16 "
        f"{time.perf_counter() - t1:.1f} s")
    card = trainstep_result(net, x, y, "cuda")
    check(all(bool(torch.isfinite(t).all()) for t in card[2]),
          "non-finite parameters after the card's step")
    check_steps(card, cpu_ref, names, "fp32, card vs CPU", FP32_STEP_BOUND)
    with planted_fault("momentum"):
        ratio, where = compare_steps(trainstep_result(net, x, y, "cuda"),
                                     cpu_ref, names)
    log(f"  fp32 with a planted fault (momentum): {ratio:.3e} at {where}")
    check(ratio > FP32_STEP_BOUND, "the fp32 check misses a planted fault")

    net64 = copy_net(cpu_net, resnet50, mx.gpu(0)).double()
    cpu_net.double()
    x64 = x.astype(np.float64)
    cpu64 = trainstep_result(cpu_net, x64, y, "cpu")
    check_steps(trainstep_result(net64, x64, y, "cuda"), cpu64, names,
                "fp64, card vs CPU", FP64_STEP_BOUND)
    for fault in ("unbiased", "momentum", "no_wd"):
        with planted_fault(fault):
            ratio, where = compare_steps(
                trainstep_result(net64, x64, y, "cuda"), cpu64, names)
        log(f"  fp64 with a planted fault ({fault}): {ratio:.3e} at {where}")
        check(ratio > FP64_STEP_BOUND,
              f"the fp64 check misses the planted fault {fault}")
    log("  update floors of the fp64 step: " + ", ".join(
        f"{kind} {floor:.3e} ({UPDATE_FLOOR:g} x {name}'s)"
        for kind, (floor, name) in update_floors(cpu64, names).items()))
    check_steps(card, cpu64, names, "fp32 rounding: the card's fp32 step "
                "vs the fp64 step", FP32_STEP_BOUND)
    check_steps(cpu_ref, cpu64, names, "fp32 rounding: the CPU's fp32 step "
                "vs the fp64 step", FP32_STEP_BOUND)
    del net64, cpu_net

    log(f"== training 2: one TrainStep(dtype='bfloat16') step at batch "
        f"{CHECK_BATCH} on the card, held to the fp64 step within "
        f"{BF16_NOISE_FACTOR:g} x the CPU's bf16 step's deviation from it")
    card16 = trainstep_result(net, x, y, "cuda", dtype="bfloat16")
    check(all(t.dtype == torch.float32 for t in card16[2]),
          "the bf16 step's master weights are not fp32")
    for what, cand in (("card", card16), ("CPU", cpu16)):
        ratio, where = compare_steps(cand, cpu64, names)
        log(f"  {what}'s bf16 step vs the fp64 step: {ratio:.3e} of the "
            f"update ({where})")
    scales = noise_scales(cpu16, cpu64, names)
    check_steps(card16, cpu64, names, "bf16, card vs the fp64 step",
                BF16_NOISE_FACTOR, scales, "of the CPU's bf16 deviation")
    with planted_fault("momentum"):
        ratio, where = compare_steps(
            trainstep_result(net, x, y, "cuda", dtype="bfloat16"), cpu64,
            names, scales)
    log(f"  bf16 with a planted fault (momentum): {ratio:.3e} at {where}")
    check(ratio > BF16_NOISE_FACTOR, "the bf16 check misses a planted fault")

    log("== training 3: one record / backward / Trainer.step step on the "
        "card against the TrainStep step (fp32)")
    loop = gluon_loop_result(net, x, y)
    check_steps(loop, card, names, "Gluon loop vs TrainStep", LOOP_BOUND)

    log(f"== training 4: bench.py's configuration, batch {TRAIN_BATCH}, "
        f"SGD 0.1 / 0.9, bf16")
    net = init_net(resnet50, seed, mx.gpu(0))
    x, y = train_batch(seed, TRAIN_BATCH)
    xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd", optimizer_params=TRAIN_OPT,
                     dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        losses.append(step(xt, yt))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(step(xt, yt))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    losses = [v.item() for v in losses]
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses: {' '.join(f'{v:.4f}' for v in losses)}")
    check(all(math.isfinite(v) for v in losses), "non-finite bf16 loss")
    check(losses[-1] < losses[0], "the bf16 loss did not fall")
    img_s = TRAIN_BATCH * TRAIN_STEPS / dt
    mfu = img_s * RESNET50_TRAIN_FLOPS_PER_IMG / PEAK_FLOPS[torch.bfloat16]
    log(f"  [{gpu_line()}] {img_s:.1f} img/s, "
        f"{1e3 * dt / TRAIN_STEPS:.2f} ms/step over {TRAIN_STEPS} steps "
        f"(warm-up {TRAIN_WARMUP} steps {t1 - t0:.2f} s), MFU "
        f"{100 * mfu:.2f}% (bench.py's FLOPs per image over the bf16 "
        f"peak), peak memory {peak / 2**30:.3f} GiB")
    log_device_profile(lambda: [step(xt, yt) for _ in range(3)],
                       TRAIN_KERNEL_GROUPS, n_top=12)
    launches = fa_mod._flash_fwd_cuda.launches
    log(f"  hand-written kernel launches on the training path: "
        f"flash_attn_fwd {launches} (the path has no TPU kernel)")
    check(launches == 0, "the training path launched flash_attn_fwd")


# ---------------------------------------------------------------------------
# phase 6: transformer training at BERT-base widths
# ---------------------------------------------------------------------------
# (B, Hq, Hkv, Lq, Lk, D, causal): attention shapes whose gradients are held
# on the card.  BertSelfAttention at bench.py's batch (one key block); the
# Llama-3-8B prefill width with GQA 32/8 (four key blocks of 512); Lq < Lk
# causal, whose diagonal offset (1024) spans three key blocks.
BERT_ATTN = BERT_SHAPE[:7]
LLAMA_ATTN = (1, 32, 8, 2048, 2048, 128, True)
OFFSET_ATTN = (1, 32, 8, 512, 1536, 128, True)
ATTN_GRAD_CASES = (BERT_ATTN, LLAMA_ATTN, OFFSET_ATTN)
# planted backward faults, each with the shape where it shows
ATTN_FAULTS = (("no_gqa_fold", LLAMA_ATTN), ("no_delta", BERT_ATTN),
               ("offset_0", OFFSET_ATTN))
# fp32 (TF32 off): the kernel's forward and the ported backward against the
# plain version under torch autograd, max |difference| / max |plain| per
# gradient.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# 2.9e-7 to 1.0e-6 at the three shapes; the planted faults 0.79 to 1.0
ATTN_FP32_BOUND = 1e-5
# the port's Llama on the card, fp32, against the same net's fp64 gradients
# on the CPU: measured 7.442e-7 in every run.  Not against the CPU's fp32
# ones: their deviation from fp64 depends on the host (8.505e-7 on most,
# 7.807e-5 at layer 0's q_proj on some, same card and card readings)
LLAMA_GRAD_BOUND = 1e-5
# the llama_tiny check runs this often on the card, each run after this many
# GiB of the caching allocator's blocks were filled with NaN
LLAMA_GRAD_REPEATS, POISON_GIB = 3, 4

BERT_SEQ, BERT_CHECK_BATCH = 128, 8
BERT_BATCH, BERT_WARMUP, BERT_STEPS = 64, 2, 20            # bench.py
BERT_OPT = {"learning_rate": 1e-4}                         # bench.py, Adam
# the checked step: SGD, whose update is the gradient itself (Adam's first
# step is ~lr x sign(g), blind to the gradient's size)
BERT_CHECK_OPT = {"learning_rate": 0.1, "momentum": 0.9}
# compare_steps's ratio, the card's fp32 step against the CPU's fp64 step:
# measured 1.5e-4 of the update on the same card (a planted no_delta: 9.6e3)
BERT_FP32_BOUND = 1e-3

BERT_KERNEL_GROUPS = (
    ("flash_attn_fwd", ("fa_fwd",)),
    ("optimizer", ("multi_tensor", "foreach")),
    ("layernorm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("gelu", ("gelu", "Gelu")),
    ("dropout", ("bernoulli", "fused_dropout")),
    ("matmul", ("gemm", "xmma", "nvjet", "cutlass", "gemv", "sm90")),
    ("copies/casts", ("copy", "Memcpy", "Memset", "cast")),
    ("softmax/loss", ("softmax", "nll", "gather", "scatter")),
    ("embedding", ("embedding", "index")))


def attention_inputs(shape, dtype, gen, device="cuda"):
    """q, k, v and the cotangent g of o, normal from ``gen``."""
    b, hq, hkv, lq, lk, d = shape[:6]

    def one(*dims):
        return torch.randn(*dims, generator=gen, device=device).to(dtype)

    return one(b, hq, lq, d), one(b, hkv, lk, d), one(b, hkv, lk, d), \
        one(b, hq, lq, d)


def attention_grads(fa_mod, q, k, v, g, causal, plain=False):
    """(dq, dk, dv) of sum(o * g): through ``flash_attention`` (on the card
    the kernel's forward and the ported backward), or with ``plain``
    through ``_mha_with_lse`` under torch autograd."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    scale = 1.0 / math.sqrt(q.shape[-1])
    if plain:
        o = fa_mod._mha_with_lse(*leaves, causal, scale)[0]
    else:
        o = fa_mod.flash_attention(*leaves, causal=causal, sm_scale=scale)
    return torch.autograd.grad(o, leaves, g)


def grad_deviations(cand, ref):
    """Per gradient (dq, dk, dv): max |cand - ref| / max |ref|, in fp32."""
    return [((c.float() - r.float()).abs().max() /
             r.float().abs().max()).item() for c, r in zip(cand, ref)]


@contextlib.contextmanager
def patched(obj, attr, value):
    """``obj.attr`` is ``value`` while the scope is open."""
    orig = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def planted_attention_fault(fa_mod, fault):
    """Context manager planting ``fault`` in the attention backward:
    "no_gqa_fold" (each kv head takes one q head's gradient instead of the
    group's sum), "no_delta" (ds = p * dp, delta dropped) or "offset_0"
    (the causal mask without the Lk - Lq diagonal offset)."""
    name = {"no_gqa_fold": "_fold_gqa", "no_delta": "_fa_backward_blockwise",
            "offset_0": "_causal_mask"}[fault]
    orig = getattr(fa_mod, name)
    if fault == "no_gqa_fold":
        def fake(d, hkv):
            return d[:, ::d.shape[1] // hkv]
    elif fault == "no_delta":
        def fake(q, k, v, o, *args, **kw):
            return orig(q, k, v, torch.zeros_like(o), *args, **kw)
    else:
        def fake(lq, lk, k0, bk, device):
            return orig(lq, lq, k0, bk, device)

    return patched(fa_mod, name, fake)


def check_attention_grads(fa_mod, shape, gen, device="cuda"):
    """fp32: ``flash_attention``'s gradients against the plain version's,
    each within ATTN_FP32_BOUND.  Returns the worst ratio."""
    bound = ATTN_FP32_BOUND
    causal = shape[6]
    q, k, v, g = attention_inputs(shape, torch.float32, gen, device)
    devs = grad_deviations(attention_grads(fa_mod, q, k, v, g, causal),
                           attention_grads(fa_mod, q, k, v, g, causal, True))
    log(f"  attention grads fp32 {shape}: dq/dk/dv deviations "
        + " ".join(f"{x:.3e}" for x in devs) + f" (bound {bound:g})")
    check(max(devs) <= bound, f"fp32 attention gradients at {shape} "
                              f"deviate {max(devs):.3e} > {bound:g}")
    return max(devs)


def check_attention_grads_bf16(fa_mod, shape, gen, device="cuda"):
    """bf16: ``flash_attention``'s gradients against the fp32 plain
    gradients of the same (bf16-rounded) inputs, each within
    BF16_NOISE_FACTOR x the plain version's own bf16 deviation."""
    causal = shape[6]
    q, k, v, g = attention_inputs(shape, torch.bfloat16, gen, device)
    ref = attention_grads(fa_mod, *(t.float() for t in (q, k, v, g)),
                          causal, True)
    port = grad_deviations(attention_grads(fa_mod, q, k, v, g, causal), ref)
    plain = grad_deviations(
        attention_grads(fa_mod, q, k, v, g, causal, True), ref)
    log(f"  attention grads bf16 {shape}: dq/dk/dv deviations from fp32 "
        + " ".join(f"{x:.3e}" for x in port) + "; the plain bf16 path's "
        + " ".join(f"{x:.3e}" for x in plain))
    check(all(a <= BF16_NOISE_FACTOR * b for a, b in zip(port, plain)),
          f"bf16 attention gradients at {shape} stray more than "
          f"{BF16_NOISE_FACTOR:g} x the plain bf16 path")


def attention_fault_ratio(fa_mod, fault, shape, gen, device="cuda"):
    """The fp32 deviation of the gradients with ``fault`` planted."""
    causal = shape[6]
    q, k, v, g = attention_inputs(shape, torch.float32, gen, device)
    ref = attention_grads(fa_mod, q, k, v, g, causal, True)
    with planted_attention_fault(fa_mod, fault):
        cand = attention_grads(fa_mod, q, k, v, g, causal)
    return max(grad_deviations(cand, ref))


def llama_grads(net, ids, cot):
    """{name: gradient} of sum(logits * cot) for the port's Llama."""
    net.zero_grad()
    (net(ids) * cot).sum().backward()
    return {n: p.grad.detach().cpu() for n, p in net.named_parameters()}


def poison_cached_memory(gib=POISON_GIB):
    """Fill ``gib`` GiB of blocks of the caching allocator with NaN, in its
    large pool and its small one (512 KiB tensors), and hand them back to
    the cache, not to CUDA: the tensors allocated next start as NaN, so
    a kernel or op that reads memory nothing wrote reads NaN, not what an
    earlier phase left there."""
    blocks = [torch.full((2**28,), float("nan"), device="cuda")
              for _ in range(gib)]
    blocks += [torch.full((2**17,), float("nan"), device="cuda")
               for _ in range(512)]
    del blocks


def grad_deviation(got, want):
    """(worst max |got - want| / max |want| over the tensors, its name)."""
    worst, where = 0.0, None
    for name, g in got.items():
        w = want[name].double()
        dev = ((g.double() - w).abs().max() /
               w.abs().max().clamp_min(1e-30)).item()
        if dev >= worst:
            worst, where = dev, name
    return worst, where


def check_llama_grads(llama_mod, seed, device="cuda"):
    """The port's LlamaForCausalLM at llama_tiny widths (fp32, causal GQA
    4/2, 256 tokens): its gradients on ``device`` against the same net's
    fp64 gradients on the CPU, LLAMA_GRAD_REPEATS times on the card, each
    after poison_cached_memory; the q/k/v projections must have non-zero
    ones.  The CPU's fp32 deviation is printed beside each reading."""
    cpu = llama_mod.init_random_(llama_mod.llama_tiny(device="cpu"), seed)
    card = llama_mod.llama_tiny(device=device)
    card.load_state_dict(cpu.state_dict())
    r = np.random.RandomState(seed)
    ids = torch.from_numpy(r.randint(0, 512, (2, 256)).astype(np.int64))
    cot = torch.from_numpy(r.randn(2, 256, 512).astype(np.float32))
    cpu32 = llama_grads(cpu, ids, cot)
    exact = llama_grads(cpu.double(), ids, cot.double())
    cpu_dev, cpu_where = grad_deviation(cpu32, exact)
    on_card = torch.device(device).type == "cuda"
    worst = 0.0
    for i in range(LLAMA_GRAD_REPEATS if on_card else 1):
        if on_card:
            poison_cached_memory()
        got = llama_grads(card, ids.to(device), cot.to(device))
        for name, g in got.items():
            check(bool(torch.isfinite(g).all()),
                  f"llama_tiny's gradient of {name} on {device} is not "
                  f"finite")
            if "_proj" in name:
                check(g.abs().max().item() > 0,
                      f"the port's Llama gets a zero gradient for {name}")
        dev, where = grad_deviation(got, exact)
        qkv = [n for n in got if n.endswith(("q_proj.weight",
                                             "k_proj.weight",
                                             "v_proj.weight"))]
        log(f"  llama_tiny on {device}, run {i}: {len(qkv)} q/k/v "
            f"projections with non-zero gradients; gradients vs the CPU's "
            f"fp64 worst {dev:.3e} ({where}), bound {LLAMA_GRAD_BOUND:g}; "
            f"the CPU's fp32 vs fp64 {cpu_dev:.3e} ({cpu_where})")
        check(dev <= LLAMA_GRAD_BOUND,
              f"llama_tiny gradients on {device} deviate {dev:.3e} from "
              f"fp64 at {where}")
        worst = max(worst, dev)
    return worst


def bert_batch(seed, batch, seq, vocab):
    """Token ids and labels as bench.py makes them (ids uniform over the
    vocabulary; labels: the MLM targets, then the NSP label in the last
    column), from ``seed``."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, vocab, (batch, seq)).astype("int32")
    labels = np.concatenate(
        [r.randint(0, vocab, (batch, seq)), r.randint(0, 2, (batch, 1))],
        axis=1).astype("int32")
    return ids, labels


def bert_loss(outs, labels):
    """bench.py's pretraining loss: mean MLM cross-entropy + mean NSP
    cross-entropy."""
    mlm, nsp = outs
    labels = labels.long()
    mlm_l = -torch.log_softmax(mlm, dim=-1).gather(-1, labels[:, :-1, None])
    nsp_l = -torch.log_softmax(nsp, dim=-1).gather(-1, labels[:, -1:])
    return mlm_l.mean() + nsp_l.mean()


def init_bert(cfg, seed, ctx, seq=BERT_SEQ):
    """BertForPretraining(cfg) initialized on ``ctx`` from the device
    generator seeded with ``seed`` (Gluon's default init), its deferred
    shapes settled by one forward."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    mx.random.seed(seed)
    net = bert.BertForPretraining(cfg)
    net.initialize(ctx=ctx)
    net(mx.nd.zeros((1, seq), ctx=ctx, dtype="int32"))
    return net


def copy_bert(net, cfg, ctx):
    from mxnet_tpu_torch.gluon import load_reference_params

    other = init_bert(cfg, 0, ctx)
    load_reference_params(other, {k: p.data().asnumpy() for k, p in
                                  net.collect_params().items()})
    return other


def unchanged(result, names):
    """The tensors a step left exactly as they were: under BERT_CHECK_OPT
    (SGD, no weight decay) those whose gradient is zero."""
    _, before, after = result
    return [n for n, b, a in zip(names, before, after) if torch.equal(a, b)]


def matmul_params(step, bench_py=False):
    """The parameters of the matrix products: every table of two or more
    dimensions but the embeddings, which are gathers (BERT's
    ``embedding<N>_weight`` and Llama's ``embed_tokens_weight``).  With
    ``bench_py``, bench.py's _matmul_params count instead: its test,
    ``"embedding" in name``, keeps Llama's ``embed_tokens_weight`` (BERT's
    count is the same either way)."""
    return sum(v.numel() for k, v in step.params.items()
               if ("embedding" if bench_py else "embed") not in k
               and v.dim() >= 2)


def backward_work(shape, dtype):
    """(FLOPs, bytes) of the attention backward: five products of
    2·D per visible (q, k) pair per head (s recomputed, dv, dp, dk, dq);
    q, k, v, o, g read once, lse read once, dq, dk, dv written once."""
    b, hq, hkv, lq, lk, d, causal = shape[:7]
    flops_fwd, _ = attention_work(shape, dtype)
    es = torch.finfo(dtype).bits // 8
    nbytes = es * (3 * b * hq * lq * d + 4 * b * hkv * lk * d) \
        + 4 * b * hq * lq
    return 2.5 * flops_fwd, nbytes


def time_attention(fa_mod, shape, gen):
    """Device ms at ``shape`` (bf16), each by CUDA graph replay: the
    kernel's forward beside SDPA's forward, and the ported backward beside
    SDPA's backward and the plain version's under autograd (each forward +
    backward less its forward), with the bound of each.  Returns the
    ported backward's ms."""
    b, hq, hkv, lq, lk, d, causal = shape
    scale = 1.0 / math.sqrt(d)
    q, k, v, g = attention_inputs(shape, torch.bfloat16, gen)
    o, lse = fa_mod._flash_fwd_cuda(q, k, v, causal, scale)
    fwd_ms = graph_time_ms(
        lambda: fa_mod._flash_fwd_cuda(q, k, v, causal, scale), iters=10)
    bwd_ms = graph_time_ms(lambda: fa_mod._fa_backward_blockwise(
        q, k, v, o, lse, g, causal, scale), iters=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd():
        return sdpa(*leaves, is_causal=causal, scale=scale,
                    enable_gqa=hq != hkv)

    def plain_fwd():
        return fa_mod._mha_with_lse(*leaves, causal, scale)[0]

    sdpa_fwd_ms = graph_time_ms(sdpa_fwd, iters=10)
    sdpa_both_ms = graph_time_ms(
        lambda: torch.autograd.grad(sdpa_fwd(), leaves, g), iters=10)
    plain_bwd_ms = graph_time_ms(
        lambda: torch.autograd.grad(plain_fwd(), leaves, g), iters=5) - \
        graph_time_ms(plain_fwd, iters=5)
    fwd_bound, fwd_by = bound_ms(shape, torch.bfloat16)
    flops, nbytes = backward_work(shape, torch.bfloat16)
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bwd_bound = max(t_ops, t_bytes)
    log(f"  attention bf16 {shape}: forward kernel {fwd_ms:.4f} ms "
        f"({100 * fwd_bound / fwd_ms:.1f}% of its {fwd_bound:.4f} ms bound, "
        f"{fwd_by}), SDPA forward {sdpa_fwd_ms:.4f} ms; backward ported "
        f"{bwd_ms:.4f} ms ({flops / bwd_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bwd_bound / bwd_ms:.1f}% of its {bwd_bound:.4f} ms bound, "
        f"{'operations' if t_ops >= t_bytes else 'bytes'}: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), SDPA backward "
        f"{sdpa_both_ms - sdpa_fwd_ms:.4f} ms (forward + backward "
        f"{sdpa_both_ms:.4f}), plain backward {plain_bwd_ms:.4f} ms")
    return bwd_ms


def labelled(module, attr, label):
    """Context manager: ``module.attr`` runs inside a profiler range named
    ``label`` (for attributing its kernels in a profile)."""
    orig = getattr(module, attr)

    def wrapped(*args, **kw):
        with torch.profiler.record_function(label):
            return orig(*args, **kw)

    return patched(module, attr, wrapped)


@contextlib.contextmanager
def record_backward(fa_mod):
    """Every call of the attention backward in the scope appends its
    arguments (q, k, v, o, lse, g, causal, sm_scale) to the list it
    yields, in call order (the last layer first)."""
    orig = fa_mod._fa_backward_blockwise
    calls = []

    def recording(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    with patched(fa_mod, "_fa_backward_blockwise", recording):
        yield calls


def attention_layer_errors(fa_mod, calls):
    """Per layer of a bf16 step (``calls`` from record_backward): how far o
    and (dq, dk, dv) stray from the fp64 ones at the same inputs, each as
    max |x - x64| / max |x64|, and last the same for dq summed over batch
    and tokens (the attention's share of the query bias's gradient).  Three
    ways, all through the ported backward: with the forward that ran (on
    the card the kernel), with the plain bf16 forward (the CPU's path),
    and with the forward that ran but o unrounded (fp64 o in fp32, so
    ``delta = sum(o * g)`` is free of o's bf16 rounding).  Returns
    [(layer, ran, plain, unrounded)], layers numbered from the first."""
    rows = []
    for i, (q, k, v, o, lse, g, causal, scale) in enumerate(calls):
        wide = [t.double() for t in (q, k, v, g)]
        o64, lse64 = fa_mod._mha_with_lse(*wide[:3], causal, scale)
        ref = (o64, *fa_mod._fa_backward_blockwise(
            *wide[:3], o64, lse64, wide[3], causal, scale))

        def devs(o_, lse_):
            got = (o_, *fa_mod._fa_backward_blockwise(q, k, v, o_, lse_, g,
                                                      causal, scale))
            pairs = list(zip(got, ref)) + [(got[1].double().sum((0, 2)),
                                            ref[1].sum((0, 2)))]
            return [((x.double() - r).abs().max() / r.abs().max()).item()
                    for x, r in pairs]

        rows.append((len(calls) - 1 - i, devs(o, lse),
                     devs(*fa_mod._mha_with_lse(q, k, v, causal, scale)),
                     devs(o64.float(), lse)))
    return sorted(rows)


def check_attention_layers(fa_mod, calls):
    """attention_layer_errors of a bf16 step, printed; at every layer the
    forward that ran must keep o, dq, dk and dv within BF16_NOISE_FACTOR x
    the plain bf16 forward's deviation (the token sum is printed only: it
    is a small difference of large terms)."""
    log("  attention per layer in the bf16 step, deviation from fp64 at its "
        "inputs (o, dq, dk, dv, dq summed over tokens), each with the "
        "forward that ran / the plain bf16 forward / the forward that ran "
        "with o unrounded, all with the ported backward")
    layers = attention_layer_errors(fa_mod, calls)
    for layer, *ways in layers:
        log(f"    layer {layer:2d}: " + "  ".join(
            "/".join(f"{x:.2e}" for x in cell) for cell in zip(*ways)))
    for layer, ran, plain, _ in layers:
        check(all(a <= BF16_NOISE_FACTOR * b
                  for a, b in zip(ran[:4], plain[:4])),
              f"layer {layer}: the bf16 attention (o, dq, dk, dv) strays "
              f"more than {BF16_NOISE_FACTOR:g} x the plain bf16 forward's")


def bert_step_check(seed):
    """One TrainStep step of BertForPretraining (BERT-base width, dropout 0,
    batch BERT_CHECK_BATCH, weights and batch from ``seed``) on the card in
    fp32 and in bf16, each held to the CPU's fp64 step, with the zero
    gradients, the launch count, planted faults, and the attention's error
    per layer in the bf16 step.  Returns the bf16 step's worst ratio to
    the CPU's bf16 deviation."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.language import bert
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    cfg0 = bert.BertConfig(dropout=0.0)
    t0 = time.perf_counter()
    net = init_bert(cfg0, seed, mx.gpu(0))
    params = net.collect_params()
    names = list(params)
    token_type = net.bert.token_type_embed.weight.name
    log(f"  BertForPretraining: {len(names)} parameters, "
        f"{sum(p.data().size for p in params.values()) / 1e6:.3f} M values "
        f"({time.perf_counter() - t0:.1f} s to build)")
    ids, labels = bert_batch(seed, BERT_CHECK_BATCH, BERT_SEQ,
                             cfg0.vocab_size)
    cpu_net = copy_bert(net, cfg0, mx.cpu())
    t0 = time.perf_counter()
    cpu16 = trainstep_result(cpu_net, ids, labels, "cpu", BERT_CHECK_OPT,
                             "bfloat16", bert_loss)
    t1 = time.perf_counter()
    cpu64 = trainstep_result(cpu_net.double(), ids, labels, "cpu",
                             BERT_CHECK_OPT, None, bert_loss)
    log(f"  CPU steps: bf16 {t1 - t0:.1f} s, fp64 "
        f"{time.perf_counter() - t1:.1f} s")
    del cpu_net
    fa_mod._flash_fwd_cuda.launches = 0
    card = trainstep_result(net, ids, labels, "cuda", BERT_CHECK_OPT, None,
                            bert_loss)
    launches = fa_mod._flash_fwd_cuda.launches
    log(f"  flash_attn_fwd launches in one training step: {launches}")
    check(launches == cfg0.num_layers,
          f"flash_attn_fwd launched {launches} times in a step, expected "
          f"num_layers = {cfg0.num_layers}")
    check(all(bool(torch.isfinite(t).all()) for t in card[2]),
          "non-finite parameters after the card's BERT step")
    check_steps(card, cpu64, names, "fp32 card vs the fp64 CPU step",
                BERT_FP32_BOUND)
    for what, result in (("card fp32", card), ("CPU fp64", cpu64)):
        zero = unchanged(result, names)
        log(f"  tensors with a zero gradient ({what}): {zero}")
        check(zero == [token_type], f"{what}: tensors other than "
              f"{token_type} (token types are not passed) have a zero "
              f"gradient: {zero}")
    with planted_attention_fault(fa_mod, "no_delta"):
        ratio, where = compare_steps(
            trainstep_result(net, ids, labels, "cuda", BERT_CHECK_OPT, None,
                             bert_loss), cpu64, names)
    log(f"  fp32 with a planted fault (no_delta): {ratio:.3e} at {where}")
    check(ratio > BERT_FP32_BOUND, "the fp32 BERT check misses no_delta")

    with record_backward(fa_mod) as calls:
        card16 = trainstep_result(net, ids, labels, "cuda", BERT_CHECK_OPT,
                                  "bfloat16", bert_loss)
    check(all(t.dtype == torch.float32 for t in card16[2]),
          "the bf16 step's master weights are not fp32")
    for what, cand in (("card", card16), ("CPU", cpu16)):
        ratio, where = compare_steps(cand, cpu64, names)
        log(f"  {what}'s bf16 step vs the fp64 step: {ratio:.3e} of the "
            f"update ({where})")
    check_attention_layers(fa_mod, calls)
    del calls
    scales = noise_scales(cpu16, cpu64, names)
    ratio16 = check_steps(card16, cpu64, names, "bf16, card vs the fp64 step",
                          BF16_NOISE_FACTOR, scales,
                          "of the CPU's bf16 deviation")
    with planted_attention_fault(fa_mod, "no_delta"):
        ratio, where = compare_steps(
            trainstep_result(net, ids, labels, "cuda", BERT_CHECK_OPT,
                             "bfloat16", bert_loss), cpu64, names, scales)
    log(f"  bf16 with a planted fault (no_delta): {ratio:.3e} at {where}")
    check(ratio > BF16_NOISE_FACTOR, "the bf16 BERT check misses no_delta")
    del net, cpu16, cpu64, card, card16
    torch.cuda.empty_cache()
    return ratio16



def loop_adam_update(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, wd=0.0):
    """TrainStep's Adam (make_adam_update's formula) as a Python loop of
    ~8 ops per tensor: the form that make_adam_update's ``_foreach`` calls
    replace, kept here to time them against."""

    def init(params):
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params], "t": 0}

    @torch.no_grad()
    def update(params, grads, state):
        state["t"] += 1
        c1 = 1.0 - beta1 ** state["t"]
        c2 = 1.0 - beta2 ** state["t"]
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            g = g + wd * p
            m.mul_(beta1).add_((1 - beta1) * g)
            v.mul_(beta2).add_((1 - beta2) * g * g)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))

    return init, update


def time_adam_forms(params, gen):
    """One Adam update (BERT_OPT) over fresh copies of ``params`` with
    random gradients, by TrainStep's ``_foreach`` form and by the loop
    form: each timed eager (CUDA events, so the host's launch cost shows
    where it exceeds the device's) and by graph replay (device time), and
    the two forms' results after one update from the same start compared
    (max |difference| / max |update|)."""
    from mxnet_tpu_torch.parallel.data_parallel import make_adam_update

    start = [p.detach().clone() for p in params]
    grads = [torch.randn(p.shape, generator=gen, device=p.device)
             for p in params]
    after, times = {}, {}
    for form, make in (("_foreach", make_adam_update),
                       ("loop", loop_adam_update)):
        init, update = make(lr=BERT_OPT["learning_rate"])
        ps = [p.clone() for p in start]
        state = init(ps)
        update(ps, grads, state)
        after[form] = [p.clone() for p in ps]
        times[form] = (cuda_time_ms(lambda: update(ps, grads, state),
                                    iters=10),
                       graph_time_ms(lambda: update(ps, grads, state),
                                     iters=3, warmup=1))
        del ps, state
    upd = max((a - b).abs().max().item()
              for a, b in zip(after["loop"], start))
    diff = max((a - b).abs().max().item()
               for a, b in zip(after["_foreach"], after["loop"]))
    log(f"  Adam update over {len(params)} tensors "
        f"({sum(p.numel() for p in params) / 1e6:.3f} M values): "
        + ", ".join(f"{form} {eager:.3f} ms eager / {dev:.3f} ms device"
                    for form, (eager, dev) in times.items())
        + f"; the forms differ by {diff / upd:.2e} of the update")
    check(diff <= 1e-3 * upd, "the _foreach Adam update disagrees with "
                              "the loop form")
    return times


def bert_phase(seed):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.language import bert
    from mxnet_tpu_torch.gluon.model_zoo.language import llama as llama_mod
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch.parallel import TrainStep

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    log("== bert 1: attention gradients on the card (kernel forward, "
        "ported backward) against the plain version under autograd")
    for shape in ATTN_GRAD_CASES:
        check_attention_grads(fa_mod, shape, gen)
        check_attention_grads_bf16(fa_mod, shape, gen)
    for fault, shape in ATTN_FAULTS:
        ratio = attention_fault_ratio(fa_mod, fault, shape, gen)
        log(f"  planted fault {fault} at {shape}: {ratio:.3e}")
        check(ratio > ATTN_FP32_BOUND,
              f"the attention gradient check misses the fault {fault}")
    check_llama_grads(llama_mod, seed)

    log(f"== bert 2: one TrainStep step of BertForPretraining at BERT-base "
        f"width, batch {BERT_CHECK_BATCH}, sequence {BERT_SEQ}, dropout 0, "
        f"SGD {BERT_CHECK_OPT}: card against the CPU's fp64 step")
    bert_step_check(seed)

    log(f"== bert 3: bench.py's configuration: BertForPretraining at "
        f"BERT-base width, batch {BERT_BATCH}, sequence {BERT_SEQ}, dropout "
        f"0.1, Adam {BERT_OPT}, bf16")
    cfg = bert.BertConfig()
    net = init_bert(cfg, seed, mx.gpu(0))
    ids, labels = bert_batch(seed, BERT_BATCH, BERT_SEQ, cfg.vocab_size)
    ids_t = torch.from_numpy(ids).cuda()
    labels_t = torch.from_numpy(labels).cuda()
    step = TrainStep(net, bert_loss, optimizer="adam",
                     optimizer_params=BERT_OPT, dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_mod._flash_fwd_cuda.launches = 0        # this path's count
    losses = []
    t0 = time.perf_counter()
    for _ in range(BERT_WARMUP):
        losses.append(step(ids_t, labels_t))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(BERT_STEPS):
        losses.append(step(ids_t, labels_t))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = fa_mod._flash_fwd_cuda.launches
    losses = [v.item() for v in losses]
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses: {' '.join(f'{v:.4f}' for v in losses)}")
    check(all(math.isfinite(v) for v in losses), "non-finite BERT loss")
    check(losses[-1] < losses[0], "the BERT loss did not fall")
    n_steps = BERT_WARMUP + BERT_STEPS
    check(launches == cfg.num_layers * n_steps,
          f"flash_attn_fwd launched {launches} times in {n_steps} steps, "
          f"expected {cfg.num_layers * n_steps}")
    samples_s = BERT_BATCH * BERT_STEPS / dt
    n_mm = matmul_params(step)
    mfu = samples_s * 6.0 * n_mm * BERT_SEQ / PEAK_FLOPS[torch.bfloat16]
    log(f"  [{gpu_line()}] {samples_s:.1f} samples/s, "
        f"{1e3 * dt / BERT_STEPS:.2f} ms/step over {BERT_STEPS} steps "
        f"(warm-up {BERT_WARMUP} steps {t1 - t0:.2f} s), MFU "
        f"{100 * mfu:.2f}% (bench.py: 6 x {n_mm / 1e6:.3f} M matmul "
        f"parameters x {BERT_SEQ} tokens per sample over the bf16 peak), "
        f"peak memory {peak / 2**30:.3f} GiB; flash_attn_fwd launches "
        f"{launches} = {cfg.num_layers} layers x {n_steps} steps")
    with labelled(fa_mod, "_fa_backward_blockwise", "attention_backward"):
        log_device_profile(lambda: [step(ids_t, labels_t)
                                    for _ in range(3)],
                           BERT_KERNEL_GROUPS, n_top=12,
                           label="attention_backward", steps=3,
                           step_ms=1e3 * dt / BERT_STEPS)
    time_adam_forms(list(step.train_params.values()), gen)
    del step, net
    torch.cuda.empty_cache()

    log("== bert 4: attention device times beside SDPA's")
    for shape in (BERT_ATTN, LLAMA_ATTN):
        time_attention(fa_mod, shape, gen)
    return launches

# ---------------------------------------------------------------------------
# phase 7: Llama training at Llama-3-8B widths
# ---------------------------------------------------------------------------
# the checked step: one layer (the CPU's fp64 step of the embedding and the
# head, 2 x 525 M parameters, dominates the phase), batch 1, sequence 256,
# SGD (its update is the gradient itself)
LLAMA_CHECK_LAYERS, LLAMA_CHECK_BATCH, LLAMA_CHECK_SEQ = 1, 1, 256
LLAMA_CHECK_OPT = {"learning_rate": 0.1}
# the timed run: four layers (Adam's 16 bytes a parameter over 1.92 G
# parameters, ~31 GB, with the net's own copy and the logits, fit the 80 GB
# card), batch 1, sequence 2048, bf16, Adam 3e-4 as bench.py
LLAMA_TRAIN_LAYERS, LLAMA_BATCH, LLAMA_SEQ = 4, 1, 2048
LLAMA_WARMUP, LLAMA_STEPS = 2, 20
LLAMA_OPT = {"learning_rate": 3e-4}
# bench.py's llama_proxy_train configuration (_bench_llama_once)
PROXY_CFG = dict(vocab_size=32000, hidden_size=1024, num_layers=16,
                 num_heads=16, num_kv_heads=8, intermediate_size=2816,
                 max_seq_len=1024)
PROXY_BATCH, PROXY_SEQ = 8, 1024
PROXY_ATTN = PROXY_SHAPE[:7]
# the MoE check: narrow widths, four experts, bench.py's capacity factor
LLAMA_MOE_CFG = dict(vocab_size=1024, hidden_size=256, num_layers=2,
                     num_heads=4, num_kv_heads=2, intermediate_size=512,
                     max_seq_len=256, num_experts=4, moe_capacity_factor=1.25)
LLAMA_MOE_BATCH, LLAMA_MOE_SEQ = 2, 128
# compare_steps's ratio, the card's fp32 step against the CPU's fp64 step:
# measured 1.218e-4 of the update at Llama-3-8B widths, 1.403e-4 for the
# MoE check (an NVIDIA H100 80GB HBM3 at 700 W, PERF.md); the planted
# faults read 0.90 (GQA fold) and 1.28 (rope sign)
LLAMA_FP32_BOUND = 1e-3
# the remat step against the plain one, both on the card in fp32: measured
# bit-equal (0.0) on the same card
LLAMA_REMAT_BOUND = 1e-6

LLAMA_KERNEL_GROUPS = (
    ("flash_attn_fwd", ("fa_fwd",)),
    ("optimizer", ("multi_tensor", "foreach")),
    ("matmul", ("gemm", "xmma", "nvjet", "cutlass", "gemv", "sm90")),
    ("copies/casts", ("copy", "Memcpy", "Memset", "cast")),
    ("softmax/loss", ("softmax", "nll", "gather", "scatter")),
    ("embedding", ("embedding", "index")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "cat",
                     "unrolled")))


def llama_batch(seed, batch, seq, vocab):
    """Token ids and next-token labels uniform over the vocabulary, as
    bench.py makes them (numpy, from ``seed``)."""
    r = np.random.RandomState(seed)
    return (r.randint(0, vocab, (batch, seq)).astype("int32"),
            r.randint(0, vocab, (batch, seq)).astype("int32"))


def llama_loss(logits, labels):
    """bench.py's loss: the cross-entropy of every token (TrainStep takes
    the mean)."""
    return -torch.log_softmax(logits, dim=-1).gather(
        -1, labels.long()[..., None])


def init_llama(cfg, seed, ctx):
    """LlamaForCausalLM(cfg) on ``ctx`` with init_random_ weights from
    ``seed``."""
    from mxnet_tpu_torch.gluon.model_zoo.language import llama

    net = llama.LlamaForCausalLM(cfg)
    net.initialize(init="zeros", ctx=ctx)
    return llama.init_random_(net, seed)


def copy_llama(net, ctx, cfg=None):
    """LlamaForCausalLM(cfg, default ``net``'s) on ``ctx`` holding ``net``'s
    weights, copied by structural name."""
    from mxnet_tpu_torch.gluon.model_zoo.language import llama

    other = llama.LlamaForCausalLM(cfg or net.config)
    other.initialize(init="zeros", ctx=ctx)
    dst = other._collect_params_with_prefix()
    for name, t in llama.serving_params(net).items():
        dst[name].set_data(t)
    return other


def planted_rope_fault():
    """Context manager: the rope op rotating the wrong way (the sine's
    sign flipped), for showing that the step checks catch it."""
    from mxnet_tpu_torch.ops.registry import get_op

    od = get_op("rope")
    orig = od.fn

    def faulty(x, positions=None, base=10000.0, scale=1.0):
        if positions is None:
            positions = torch.arange(x.shape[2], device=x.device)
        return orig(x, -torch.as_tensor(positions, device=x.device),
                    base=base, scale=scale)

    return patched(od, "fn", faulty)


def llama_fault(fa_mod, fault):
    """Context manager planting ``fault``: "rope_sign" (planted_rope_fault)
    or an attention backward fault (planted_attention_fault)."""
    return planted_rope_fault() if fault == "rope_sign" else \
        planted_attention_fault(fa_mod, fault)


def llama_step_check(seed):
    """(a) one SGD TrainStep step of LlamaForCausalLM at Llama-3-8B widths
    (LLAMA_CHECK_LAYERS layers, weights and batch from ``seed``) on the card
    in fp32 and in bf16, each held to the CPU's fp64 step, every tensor with
    a non-zero gradient, and planted faults; (b) the same step with remat,
    held to the plain step, and flash_attn_fwd's launches with and without
    it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.language import llama
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    cfg = llama.LlamaConfig(num_layers=LLAMA_CHECK_LAYERS)
    t0 = time.perf_counter()
    net = init_llama(cfg, seed, mx.gpu(0))
    params = net.collect_params()
    names = list(params)
    before = [_host(p.data()._data) for p in params.values()]
    log(f"  LlamaForCausalLM: {len(names)} parameters, "
        f"{sum(t.numel() for t in before) / 1e9:.3f} G values, "
        f"{cfg.num_layers} layer(s) ({time.perf_counter() - t0:.1f} s to "
        f"build)")
    ids, labels = llama_batch(seed, LLAMA_CHECK_BATCH, LLAMA_CHECK_SEQ,
                              cfg.vocab_size)

    def step(model, device, dtype=None):
        return trainstep_result(model, ids, labels, device, LLAMA_CHECK_OPT,
                                dtype, llama_loss, before)

    cpu_net = copy_llama(net, mx.cpu())
    t0 = time.perf_counter()
    cpu16 = step(cpu_net, "cpu", "bfloat16")
    t1 = time.perf_counter()
    cpu64 = step(cpu_net.double(), "cpu")
    log(f"  CPU steps: bf16 {t1 - t0:.1f} s, fp64 "
        f"{time.perf_counter() - t1:.1f} s")
    del cpu_net
    t0 = time.perf_counter()
    fa_mod._flash_fwd_cuda.launches = 0
    card = step(net, "cuda")
    plain_launches = fa_mod._flash_fwd_cuda.launches
    check(all(bool(torch.isfinite(t).all()) for t in card[2]),
          "non-finite parameters after the card's Llama step")
    s64 = update_scales(cpu64, names)       # computed once: 1.3 G values
    check_steps(card, cpu64, names, "fp32 card vs the fp64 CPU step",
                LLAMA_FP32_BOUND, s64)
    for what, result in (("card fp32", card), ("CPU fp64", cpu64)):
        zero = unchanged(result, names)
        log(f"  tensors with a zero gradient ({what}): {zero}")
        check(not zero, f"{what}: tensors with a zero gradient: {zero}")
    for fault in ("no_gqa_fold", "rope_sign"):
        with llama_fault(fa_mod, fault):
            ratio, where = compare_steps(step(net, "cuda"), cpu64, names,
                                         s64)
        log(f"  fp32 with a planted fault ({fault}): {ratio:.3e} at {where}")
        check(ratio > LLAMA_FP32_BOUND,
              f"the fp32 Llama check misses the planted fault {fault}")

    card16 = step(net, "cuda", "bfloat16")
    check(all(t.dtype == torch.float32 for t in card16[2]),
          "the bf16 step's master weights are not fp32")
    for what, cand in (("card", card16), ("CPU", cpu16)):
        ratio, where = compare_steps(cand, cpu64, names, s64)
        log(f"  {what}'s bf16 step vs the fp64 step: {ratio:.3e} of the "
            f"update ({where})")
    scales = noise_scales(cpu16, cpu64, names)
    del cpu16
    check_steps(card16, cpu64, names, "bf16, card vs the fp64 step",
                BF16_NOISE_FACTOR, scales, "of the CPU's bf16 deviation")
    del card16
    with planted_rope_fault():
        ratio, where = compare_steps(step(net, "cuda", "bfloat16"), cpu64,
                                     names, scales)
    log(f"  bf16 with a planted fault (rope_sign): {ratio:.3e} at {where}")
    check(ratio > BF16_NOISE_FACTOR, "the bf16 Llama check misses rope_sign")
    del cpu64
    log(f"  card steps and their checks: {time.perf_counter() - t0:.1f} s")

    log("  remat: the same fp32 step with LlamaConfig(remat=True)")
    rnet = copy_llama(net, mx.gpu(0), llama.LlamaConfig(
        num_layers=LLAMA_CHECK_LAYERS, remat=True))
    del net
    fa_mod._flash_fwd_cuda.launches = 0
    remat = step(rnet, "cuda")
    remat_launches = fa_mod._flash_fwd_cuda.launches
    check_steps(remat, card, names, "remat vs plain, card fp32",
                LLAMA_REMAT_BOUND)
    log(f"  flash_attn_fwd launches in one step: {plain_launches} plain, "
        f"{remat_launches} with remat ({cfg.num_layers} layer(s))")
    check(plain_launches == cfg.num_layers,
          f"flash_attn_fwd launched {plain_launches} times in a step, "
          f"expected num_layers = {cfg.num_layers}")
    check(remat_launches == 2 * cfg.num_layers,
          f"flash_attn_fwd launched {remat_launches} times in a remat step, "
          f"expected 2 x num_layers = {2 * cfg.num_layers}")
    del rnet, card, remat
    torch.cuda.empty_cache()


def llama_moe_check(seed, device="cuda"):
    """(c) an MoE Llama (LLAMA_MOE_CFG, aux-loss weight 0.5): one SGD step
    on ``device`` held to the CPU's fp64 step, and the router's step
    changed by the aux-loss weight (0 against 0.5) by more than that
    bound.  Returns (the step's ratio, the router's change)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.language import llama

    def cfg(w):
        return llama.LlamaConfig(moe_aux_loss_weight=w, **LLAMA_MOE_CFG)

    ctx = mx.Context.from_device(device)
    net = init_llama(cfg(0.5), seed, ctx)
    names = list(net.collect_params())
    before = [_host(p.data()._data) for p in net.collect_params().values()]
    ids, labels = llama_batch(seed, LLAMA_MOE_BATCH, LLAMA_MOE_SEQ,
                              LLAMA_MOE_CFG["vocab_size"])

    def step(model, dev):
        return trainstep_result(model, ids, labels, dev, LLAMA_CHECK_OPT,
                                None, llama_loss, before)

    cpu64 = step(copy_llama(net, mx.cpu()).double(), "cpu")
    card = step(net, device)
    ratio = check_steps(card, cpu64, names, f"MoE fp32 {device} vs the "
                        "fp64 CPU step", LLAMA_FP32_BOUND)
    card0 = step(copy_llama(net, ctx, cfg(0.0)), device)
    moved = 0.0
    for i, name in enumerate(names):
        if name.endswith("router_weight"):
            upd = (card[2][i] - before[i]).abs().max().item()
            diff = (card0[2][i] - card[2][i]).abs().max().item()
            moved = max(moved, diff / upd)
    log(f"  the router's step at aux-loss weight 0 differs from its step at "
        f"0.5 by {moved:.3e} of the update")
    check(moved > LLAMA_FP32_BOUND,
          "the aux loss does not reach the router")
    return ratio, moved


def time_llama(net, ids, labels, what):
    """bench.py's timing of a bf16 Adam TrainStep (LLAMA_OPT) of ``net``:
    LLAMA_WARMUP warm-up and LLAMA_STEPS timed steps on one batch (finite,
    falling loss), tokens/s, ms/step, MFU, peak memory, and a profiled
    pass by kernel group with the attention backward apart.  Returns
    flash_attn_fwd's launches over the warm-up and timed steps."""
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch.parallel import TrainStep

    ids_t = torch.from_numpy(ids).cuda()
    labels_t = torch.from_numpy(labels).cuda()
    step = TrainStep(net, llama_loss, optimizer="adam",
                     optimizer_params=LLAMA_OPT, dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fa_mod._flash_fwd_cuda.launches = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(LLAMA_WARMUP):
        losses.append(step(ids_t, labels_t))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(LLAMA_STEPS):
        losses.append(step(ids_t, labels_t))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = fa_mod._flash_fwd_cuda.launches
    losses = [v.item() for v in losses]
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses: {' '.join(f'{v:.4f}' for v in losses)}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss ({what})")
    check(losses[-1] < losses[0], f"the loss did not fall ({what})")
    tokens_s = ids.size * LLAMA_STEPS / dt
    n_mm = matmul_params(step)
    n_bench = matmul_params(step, bench_py=True)
    mfu, mfu_bench = (tokens_s * 6.0 * n / PEAK_FLOPS[torch.bfloat16]
                      for n in (n_mm, n_bench))
    step_ms = 1e3 * dt / LLAMA_STEPS
    log(f"  [{gpu_line()}] {what}: {tokens_s:.1f} tokens/s, "
        f"{step_ms:.2f} ms/step over {LLAMA_STEPS} steps (warm-up "
        f"{LLAMA_WARMUP} steps {t1 - t0:.2f} s), MFU {100 * mfu:.2f}% (6 x "
        f"{n_mm / 1e9:.4f} G matmul parameters = "
        f"{6 * n_mm / 1e9:.2f} GFLOP a token, over the bf16 peak; "
        f"{100 * mfu_bench:.2f}% with bench.py's count, "
        f"{n_bench / 1e9:.4f} G, which keeps embed_tokens), peak "
        f"memory {peak / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB before "
        f"the first step: the net, the step's fp32 weights, Adam's m and "
        f"v); flash_attn_fwd launches {launches}")
    with labelled(fa_mod, "_fa_backward_blockwise", "attention_backward"):
        log_device_profile(lambda: [step(ids_t, labels_t)
                                    for _ in range(2)],
                           LLAMA_KERNEL_GROUPS, n_top=12,
                           label="attention_backward", steps=2,
                           step_ms=step_ms)
    del step
    torch.cuda.empty_cache()
    return launches


def llama_phase(seed):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.language import llama
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    log(f"== llama 1: one TrainStep step of LlamaForCausalLM at Llama-3-8B "
        f"widths, {LLAMA_CHECK_LAYERS} layer(s), batch {LLAMA_CHECK_BATCH}, "
        f"sequence {LLAMA_CHECK_SEQ}, SGD {LLAMA_CHECK_OPT}: card against "
        f"the CPU's fp64 step; then with remat")
    llama_step_check(seed)

    log(f"== llama 2: an MoE Llama ({LLAMA_MOE_CFG['num_experts']} "
        f"experts, narrow widths): card against the CPU's fp64 step, and "
        f"the aux loss reaching the router")
    llama_moe_check(seed)

    n_steps = LLAMA_WARMUP + LLAMA_STEPS
    launches = {}
    for remat in (False, True):
        log(f"== llama {3 + remat}: Llama-3-8B widths, "
            f"{LLAMA_TRAIN_LAYERS} layers, batch {LLAMA_BATCH}, sequence "
            f"{LLAMA_SEQ}, Adam {LLAMA_OPT}, bf16, remat {remat}")
        cfg = llama.LlamaConfig(num_layers=LLAMA_TRAIN_LAYERS, remat=remat)
        t0 = time.perf_counter()
        net = init_llama(cfg, seed, mx.gpu(0))
        log(f"  built in {time.perf_counter() - t0:.1f} s")
        ids, labels = llama_batch(seed, LLAMA_BATCH, LLAMA_SEQ,
                                  cfg.vocab_size)
        n = time_llama(net, ids, labels, f"remat {remat}")
        want = cfg.num_layers * n_steps * (2 if remat else 1)
        check(n == want, f"flash_attn_fwd launched {n} times in {n_steps} "
                         f"steps (remat {remat}), expected {want}")
        if not remat:
            launches["llama_train"] = n       # this path's count
        del net
        torch.cuda.empty_cache()

    log(f"== llama 5: bench.py's llama_proxy_train configuration: "
        f"{PROXY_CFG}, batch {PROXY_BATCH}, sequence {PROXY_SEQ}, Adam "
        f"{LLAMA_OPT}, bf16")
    mx.random.seed(seed)
    cfg = llama.LlamaConfig(**PROXY_CFG)
    net = llama.LlamaForCausalLM(cfg)
    net.initialize(ctx=mx.gpu(0))                 # Gluon's default, bench.py
    ids, labels = llama_batch(seed, PROXY_BATCH, PROXY_SEQ, cfg.vocab_size)
    n = time_llama(net, ids, labels, "bench.py's proxy")
    check(n == cfg.num_layers * n_steps,
          f"flash_attn_fwd launched {n} times in the proxy's {n_steps} "
          f"steps, expected {cfg.num_layers * n_steps}")
    launches["llama_proxy_train"] = n
    del net
    torch.cuda.empty_cache()

    log("== llama 6: attention device times at the proxy's shape")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    time_attention(fa_mod, PROXY_ATTN, gen)
    return launches



def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights, prompts and inputs")
    parser.add_argument("--bert-step-seeds", type=int, nargs="+",
                        metavar="SEED",
                        help="run only the build and the BERT-base step "
                             "check (bert 2) once for each seed, and print "
                             "the bf16 step's readings (its spread over "
                             "seeds)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch import _kernels

    t_all = time.perf_counter()
    log("== environment")
    log(f"  {gpu_line()}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        f"host CPU: {os.cpu_count()} threads, "
        f"{torch.backends.cpu.get_cpu_capability()}")
    nvcc = _kernels._nvcc()
    log(f"  {nvcc}: " + subprocess.run([nvcc, "--version"],
                                       capture_output=True, text=True,
                                       check=True).stdout.strip()
        .splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== build")
    shutil.rmtree(_kernels._BUILD, ignore_errors=True)   # build from source
    secs = _kernels.build_all()
    log(f"  built {_kernels.sources()} in {secs:.2f} s")
    build_checks(_kernels)

    if args.bert_step_seeds:
        ratios = {}
        for seed in args.bert_step_seeds:
            log(f"== bert 2 at seed {seed}")
            ratios[seed] = bert_step_check(seed)
        log(f"  [{gpu_line()}] the bf16 step's worst ratio to the CPU's "
            f"bf16 deviation by seed: " + ", ".join(
                f"{seed}: {r:.3f}" for seed, r in ratios.items()))
        return 0

    log("== kernels vs plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    row = kernel_phase(gen)
    log(f"  kernel phase took {time.perf_counter() - t0:.1f} s")

    # the kernel's launches on each path, each counted from zero over the
    # path's run; this slice's main path is serving over HTTP (4b)
    t0 = time.perf_counter()
    log("== serving: Llama-3-8B widths and depth (32 layers)")
    launches = serving_phase(args.seed)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    log(f"  serving phase took {t1 - t0:.1f} s")

    log("== training: ResNet-50 v1 widths")
    training_phase(args.seed)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    log(f"  resnet phase took {t2 - t1:.1f} s")

    log("== transformer training: BERT-base widths")
    launches["bert_train"] = bert_phase(args.seed)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    log(f"  bert phase took {t3 - t2:.1f} s")

    log("== Llama training: Llama-3-8B widths")
    launches.update(llama_phase(args.seed))
    log(f"  llama phase took {time.perf_counter() - t3:.1f} s")
    for path, n in launches.items():
        check(n > 0, f"flash_attn_fwd never ran on the {path} path")
        row["by_path"][path]["launches"] = n
    row["launches"] = launches["serve_http"]

    log(f"== done in {time.perf_counter() - t_all:.1f} s")
    print(gpu_line())
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
