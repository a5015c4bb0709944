"""Chip smoke test of the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA
H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

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
   bound measured in the run); then the same weights upcast to fp32 and
   served again, every logits row held to FP32_LOGIT_TOL;
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
6. the kernels line, then the device line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

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
# (buckets 2048, 512, 128), timed; the first is the kernels line's shape.
MAIN_SHAPE = (1, 32, 8, 2048, 2048, 128, True, False)
BUCKET_SHAPES = [MAIN_SHAPE,
                 (1, 32, 8, 512, 512, 128, True, False),
                 (1, 32, 8, 128, 128, 128, True, False)]
KERNEL_CASES = BUCKET_SHAPES + [
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
                                                     _mha_with_lse)

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

    # timing at the serving path's prefill shapes, bf16: device time from
    # a replayed CUDA graph for the kernel and SDPA alike, and the eager
    # time per call (host launch cost included)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = None
    for shape in BUCKET_SHAPES:
        b, hq, hkv, lq, lk, d, causal, _ = shape
        q, k, v = make_qkv(shape, torch.bfloat16, gen)
        scale = 1.0 / math.sqrt(d)
        run = lambda: _flash_fwd_cuda(q, k, v, causal, scale)   # noqa: E731
        lib = lambda: sdpa(q, k, v, is_causal=causal, scale=scale,  # noqa
                           enable_gqa=True)
        ms, lib_ms = graph_time_ms(run), graph_time_ms(lib)
        eager_ms, lib_eager_ms = cuda_time_ms(run), cuda_time_ms(lib)
        bound, bound_by = bound_ms(shape, torch.bfloat16)
        flops, nbytes = attention_work(shape, torch.bfloat16)
        log(f"  timing Lq=Lk={lq} bf16 causal: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f}% of "
            f"bound), sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
            f"eager per call: kernel {eager_ms:.4f} ms, sdpa "
            f"{lib_eager_ms:.4f} ms")
        if shape == MAIN_SHAPE:
            plain_ms = cuda_time_ms(
                lambda: _mha_with_lse(q, k, v, causal, scale), iters=5)
            log(f"  plain version at Lq=Lk={lq}: {plain_ms:.4f} ms")
            row = {"name": "flash_attn_fwd", "route": "cuda",
                   "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
                   "replaces":
                       "mxnet_tpu/ops/flash_attention.py::_fa_fwd_kernel",
                   "launches": None, "max_abs_err": worst, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by, "library_ms": lib_ms}
        del q, k, v
    return row


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


def log_device_profile(run, kernel_groups, n_top=8):
    """Run ``run()`` under torch.profiler (device activity only) and print
    its wall time, the device-busy share and the device time by kernel
    group (the first group whose pattern a kernel's name holds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_kernel[ev.key] = us / 1e3
    busy = sum(by_kernel.values())
    if busy == 0:
        log("  profile: no device time recorded (not measured)")
        return
    groups = {}
    for key, ms in by_kernel.items():
        group = next((g for g, pats in kernel_groups
                      if any(pt in key for pt in pats)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    log(f"  profiled pass: wall {wall:.3f} s, device busy "
        f"{busy / 1e3:.3f} s ({100 * busy / 1e3 / wall:.1f}% busy)")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {group:15s} {ms:10.2f} ms  {100 * ms / busy:5.1f}%")
    for key, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:n_top]:
        log(f"    {ms:10.2f} ms  {key[:110]}")


def serve(engine, prompts, temps, seed):
    """Submit every prompt at once and wait for all.  Returns the results
    and the logits row the engine sampled each token from, keyed by
    (request id, token index): the engine's ``_sample`` is wrapped for the
    run, and each row is cloned on the device (the last capture of a key
    wins, so a re-prefilled continuation keeps its own rows)."""
    rows = {}
    sample = engine._sample

    def recording_sample(logits, reqs):
        for i, req in enumerate(reqs):
            rows[(req.id, len(req.tokens))] = logits[i].detach().clone()
        return sample(logits, reqs)

    engine._sample = recording_sample
    try:
        reqs = [engine.submit(p, max_new_tokens=MAX_NEW, temperature=t,
                              seed=seed * 1000 + i)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        results = [r.result(timeout=900) for r in reqs]
    finally:
        del engine._sample
    return results, rows


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


def serving_phase(seed):
    from mxnet_tpu_torch.gluon.model_zoo.language import llama as llama_mod
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch.serving import ServingEngine

    cfg = llama_mod.LlamaConfig(dtype="bfloat16")
    t0 = time.perf_counter()
    net = llama_mod.init_random_(llama_mod.LlamaForCausalLM(cfg), seed)
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
    t0 = time.perf_counter()
    results, rows = serve(engine, prompts, temps, seed)
    wall = time.perf_counter() - t0
    launches = fa_mod._flash_fwd_cuda.launches
    by_bucket = dict(sorted(fa_mod._flash_fwd_cuda.launches_by_len.items()))
    peak = torch.cuda.max_memory_allocated()
    phase = dict(engine.phase_seconds)

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

    log("== serving in fp32: the same weights and requests, held tight")
    del rows
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
    return {"flash_attn_fwd": launches}


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


def trainstep_result(net, x, y, device, opt=CHECK_OPT, dtype=None):
    """One TrainStep step of ``net`` on ``device``, in the net's dtype or
    under TrainStep's ``dtype``: (loss, the parameters before, after), in
    collect_params() order, on the host."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep

    params = net.collect_params()
    before = [_host(p.data()._data) for p in params.values()]
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights, prompts and inputs")
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
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
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

    log("== kernels vs plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    row = kernel_phase(gen)

    log("== serving: Llama-3-8B widths and depth (32 layers)")
    counts = serving_phase(args.seed)
    row["launches"] = counts[row["name"]]
    check(row["launches"] > 0, "flash_attn_fwd never ran on the main path")
    torch.cuda.empty_cache()

    log("== training: ResNet-50 v1 widths")
    training_phase(args.seed)
    log(f"== done in {time.perf_counter() - t_all:.1f} s")
    print(gpu_line())
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
