"""Chip smoke test of the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA
H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``--bert-step-seeds 1 2 3`` runs only the build and the BERT-base step
check of phase 6 (b), once for each seed, and ``--gluon-bert-seeds 1 2
3`` the same for phase 9 (b); ``--op-table``, ``--gluon-train``,
``--persistence``, ``--frontend``, ``--data``, ``--planes``,
``--symbolic``, ``--distributed`` and ``--model-parallel`` run only the
build and phase 8, 9, 10, 11, 12, 13, 14, 15 or 16.)

Phases (any failed check exits nonzero; nothing runs on the CPU):

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: every kernel under mxnet_tpu_torch/csrc/ with nvcc for sm_90a;
   ptxas's registers, spills and wgmma-serialisation warnings for every
   instance (a bf16 instance that spills or serialises fails), and the
   SASS of the bf16 D = 128 instance (HGMMA and UTMALDG, no HMMA);
3. kernels: each kernel held against its plain PyTorch version on the card
   at the serving path's shapes and a coverage grid (contiguous inputs and
   transposed (B, L, H, D) views), in bf16, fp16 (within FP16_NOISE_FACTOR
   x the plain fp16 version's own deviation from fp32) and fp32, every
   other tile of D = 64 and 128 (the flash_block_q / flash_block_kv
   knobs' instances) the same way in bf16 and fp16, then
   timed at every prefill bucket beside one PyTorch library call and the
   bound, at the largest beside the plain version, and in fp16 at the BERT
   shapes beside SDPA in fp16;
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
   phase 4's; 4c: the same net behind ``serve_fleet`` in local mode, two
   replicas on the card, the second ``ServingEngine.join_replica`` of the
   first (every parameter's storage the donor's; the card's memory grows
   by its KV pool, at most 10% more), the 8 requests POSTed at once to the
   router (every answer 32 tokens, each delivered once, both replicas
   healthy and serving, every sampled logits row of each engine held as
   in 4, flash_attn_fwd launched layers x prefills summed over the
   replicas), then ``replica.crash`` armed once mid-load (every request
   answered exactly once, the crashed replica reaped and freed, a
   ``join_replica`` replacement that serves, the card back at the
   two-replica level) and a SIGTERM (``serve_fleet`` returns 43); then
   the same weights upcast to fp32 and served again, every logits row
   held to FP32_LOGIT_TOL; 4c (3): the parent's nets freed, a process
   fleet of two children of this script (``--fleet-replica``: the same
   net from the seed, ``serve(net, port=0)``), one SIGKILLed mid-load
   (every request answered exactly once, the death noted by the first
   health sweep after the child's exit, a cold replacement that serves)
   and a SIGTERM that drains both children (43 each) and makes
   ``serve_fleet`` return 43;
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
8. the mx.nd op table: (a) every op definition of the table (all 278:
   the tensor, nn, LLM, optimizer, random, image, detection,
   quantization, legacy and fused-subgraph families) on the card at a
   shape one of the port's models carries, against the CPU on the same
   seeded inputs (fp32, linalg and the ReLU-fused products fp64, TF32
   off): each output on the card with the CPU's dtype and shape, within
   OP_TOL, and each float input's gradient under a seeded head;
   detections in the reference's convention (the same rows dropped, ids
   and scores equal), MultiBoxTarget's classes and masks, Proposal's
   boxes, the matchings and the int8 products' int32 accumulators equal;
   the samplers by dtype and shape; the op's call reads nothing back to
   the host, and a definition the phase leaves out fails the run; (b)
   the "medium" PTB
   LSTM language model (Zaremba et al. 2014) through mx.nd (Embedding ->
   RNN -> FullyConnected -> SoftmaxOutput): one step at dropout 0 on the
   card in fp32 against the CPU's fp64 step, three planted faults that
   must fail it, then 2 warm-up and 20 timed steps at dropout 0.5
   (tokens/s, ms/step, peak memory, a profiled pass), and the two LSTM
   layers beside torch.nn.LSTM (cuDNN) with the same weights; (c)
   benchmark/opperf.py's DEFAULT_SUITE through the port's invoke (eager
   and device ms, bound); (d) every sampler on the card at a model's size
   (random_normal at Llama-3-8B's embedding, sample_multinomial over 8 x
   128256 probabilities, the others 4M draws) by the KS statistic against
   scipy's CDF, or its moments and a chi-square, at p 1e-6; the same
   seed's draws twice, set_state(get_state()) replaying, and a planted
   scale fault in random_normal that must fail; the random image ops at
   a fixed factor equal to their closed forms, their factors in range,
   the flips fair; (e) SSD-300's prior -> target -> detection at batch
   32, Faster R-CNN's Proposal -> ROIAlign and box_nms's full sweep over
   8732 rows, card against CPU, in ms a call, and the int8 product's
   exact routes (torch._int_mm and fp64) at ResNet-50's classifier.  The
   op table path's count of flash_attn_fwd is set to 0 just before (b)
   and read just after it, and must be 0; (a)'s check of
   _contrib_flash_attention launches the kernel outside that window.
   ``--op-table`` runs only the build and this phase;
9. the Gluon training surface: (a) every registered optimizer (3
   updates over BERT-base's word embedding and a bias, a warm-up
   PolyScheduler, clip_gradient, an index lr_mult) on the card against
   the CPU within OP_TOL, SGLD's noise by KS against N(0, lr), a LAMB
   with its trust ratio forced to 1 that must fail; (b) GluonNLP's BERT
   pretraining step through gluon.Trainer (LAMB, warm-up poly schedule,
   wd_mult 0 on LayerNorm and biases, scale_loss -> backward -> unscale
   -> clip_global_norm -> step, batch 8, dropout 0): fp32 on the card
   against the CPU's fp64 step within 6 x the CPU's fp32 deviation, bf16
   under amp within 6 x the CPU's bf16 deviation, the reference's
   param_dict lookup (multipliers ignored), TF32 matmuls and fp16 in
   place of bf16 planted and failing, flash_attn_fwd once a layer; (c) float16 dynamic
   loss scaling on GluonNLP's BERT-base step (the attention in the
   kernel's fp16 instance): the scale kept, doubled, and halved with the
   weights untouched on a planted inf gradient; (d) the
   recipe timed at batch 64 in AMP bf16 with dropout 0.1 and the
   metrics every step (samples/s, MFU, peak memory, a profile with the
   optimizer and clip_global_norm apart, beside phase 6 (d)'s
   TrainStep figure); (e) GluonCV's ResNet-50 v1 recipe (NAG, cosine
   warm-up, no wd on BatchNorm and biases, label smoothing, top-5
   accuracy), one step at batch 8 on the card against the CPU's fp64
   step, an ignored warm-up planted and failing.  ``--gluon-train`` runs
   only the build and this phase;
10. persistence and preemption: (a) nd.save of every dtype and a 0-d
   array from the card writes the bytes it writes from the CPU, and
   nd.load gives them back on the card bit for bit; (b) GluonNLP's
   BERT-base recipe under amp.init("float16") with the dynamic loss
   scaler (batch 8 x 128, dropout 0.1): run U (8 steps) twice; run R (4
   steps, an async CheckpointManager save after step 2, the
   lifecycle.sigterm seam at the step-4 boundary publishing the final
   checkpoint with capture_train_state), then a fresh net and Trainer from
   another seed restore it (restore() + restore_train_state) and run
   steps 5-8: the restored parameters, LAMB's moments, update count,
   scheduler position, scaler state and generators bit for bit what was
   saved, R's losses U's (bit for bit when U repeats, else within twice
   U's own gap) and its final scaler and update count U's; a resume
   without restore_train_state and one with the scale reset must fail;
   a byte flipped in the newest model.params falls back to step 2; (c) a
   child of this script (``--resume-worker``) runs the recipe under
   run_with_recovery, gets a real SIGTERM (exit 43), and a relaunch
   resumes and finishes, its joined losses held to U by (b)'s rule; (d)
   TrainStep.run at bench.py's BERT configuration: prefetch 2 from pinned
   memory gives prefetch 0's losses, both timed, and the sigterm seam
   armed in step 3 stops it after 3 steps; (e) Estimator.fit over
   GluonCV's ResNet-50 recipe at batch 8 with a checkpoint_manager stops
   on the seam and publishes a checkpoint that restores bit for bit; (f)
   the checkpoint's bytes, sync save, async snapshot, sha256 verify and
   restore seconds at BERT-base.  ``--persistence`` runs only the build
   and this phase;
11. the Gluon frontend (``hybridize()`` as CUDA graphs): (a)
   autograd.grad, plain and create_graph=True (a gradient penalty through
   BERT-base's 768 -> 3072 -> 768 feed-forward block at batch 64, eager
   and hybridized), a custom autograd.Function, foreach, while_loop and
   cond, card against CPU within FRONT_TOL; (b) every vision family at its
   published width (AlexNet, VGG-16-bn, SqueezeNet 1.1, MobileNet 1.0 and
   v2 1.0, DenseNet-121, ResNet-50 s2d at 224, Inception-v3 at 299), fp32,
   batch 8: the hybridized forward equal to the eager one, a hybridized
   Trainer step against the eager step, and the card's hybridized step
   against the CPU's fp64 step by phase 5's measure (fp32 and fp64, batch
   1); (c) GluonCV's train_imagenet.py, eager and --mode hybrid, bf16 AMP,
   batch 128 (img/s, ms a step, peak memory); (d) the medium PTB word LM
   through gluon.rnn hybridized: its fp32 step against the CPU's fp64
   step, LSTMCell.unroll against the layer, tokens/s eager and hybrid; (e)
   GluonNLP's BERT-base LAMB recipe with the model and the loss
   hybridized: the step against the eager one and against the CPU's fp64
   step (phase 9 (b)'s bound), samples/s, ms a step and peak memory eager
   and hybrid, flash_attn_fwd launched 12 a step from the graph and
   counted so by the profiler over two replayed steps; hybridized
   gradients against eager across a grad_req change and over two
   recorded calls before one backward; six planted faults (an output
   returned without a copy, a stale cache after a parameter's tensor is
   replaced, an eager fallback for a host read, a graph left on the
   generator a reseed replaced, a grad_req change not noticed, two
   pending calls sharing one capture) each failing its check.  ``--frontend`` runs only the build and this phase;
12. the data path: (a) a Criteo-shaped factorization machine (13 integer
   and 26 categorical fields hashed into 2^20 features, rank 16, batch
   1024): a LibSVM file read by io.LibSVMIter into CSR batches on the
   card, nd.dot of a CSR and a dense operand, its transpose_a form and the
   gradient to the dense operand card against CPU within 1e-4 of max(1,
   |CPU|) (a shifted row pointer planted beyond it), then 20 steps of the
   FM example's local mode with SGD's lazy row-sparse update (the loss
   falling, the first 5 within 1e-4 of the CPU's; ms a step); (b) 2816
   ImageNet-shaped records (256 x 256 x 3 uint8 .npy, ~554 MB with an
   index) read by io.ImageRecordIter at 224 x 224 (shuffle, crop,
   mirror, ImageNet mean/std, no resize: no PIL on the card's machine,
   os.cpu_count() decode threads): the first batch at 1 thread and at N
   equal bit for bit and to the per-record seeds written out (a shared
   decode stream planted and failing), the iterator's img/s alone, and
   ResNet-50 v1 in bf16 through TrainStep.run at prefetch 0 and 2 in
   turns (img/s beside the synthetic batch's, equal losses, a profiled
   run of each for the busy share); (c) BERT-base samples through
   DataLoader(4 spawned process workers, prefetch_to_device) into phase
   9 (d)'s recipe for 10 steps: the losses bit for bit those of the same
   batches fed from a list, every worker reporting CUDA uninitialised,
   flash_attn_fwd 12 a step; the loader's state captured after step 5
   restores a fresh loader to the same next batches (the restore skipped,
   planted, fails), and a worker that reaches for the card raises.
   ``--data`` runs only the build and this phase;
13. the runtime planes on phase 9 (d)'s recipe (GluonNLP's BERT-base,
   LAMB, batch 64 x 128, bf16 AMP, 12 launches a step): (a) 3 steps under
   ``mx.profiler`` with profile_all and the device trace: one device event
   of flash_attn_fwd's kernel per launch counted, op spans, a marker and
   a counter, a ``dumps()`` row for every op invoked, the losses those of
   the same steps unprofiled bit for bit, ms a step with and without; (b)
   a step's FLOPs counted once (``introspection.counting``) within 1% of
   the analytic count of its products and the attention's forward and
   backward, the attention's report left out (planted) beyond it; the
   recipe hybridized: the graphs' count taken once at the capture, 100
   timed steps, the MFU gauge within 2% of FLOPs x steps / (window x
   peak), bench.py's MFU beside it; the serving engine's prefill and
   decode FLOPs over phase 4's requests within 1% of the analytic count
   (in phase 4; alone, at 2 layers); (c) the guard attached: clean losses
   bit for bit, ms a step with and without, a NaN gradient skipped
   (parameters, LAMB's moments and the update count untouched bit for
   bit), a loss spike caught, the planted guard fault (one parameter left
   out) missing the NaN, and a persistent NaN weight escalating to
   ``GuardRewind``: ``run_with_recovery`` restores the checkpoint,
   charges ``rewind``, and the steps after it give the unguarded losses
   bit for bit; (d) a child (``--watchdog-worker``, the recipe at a tiny
   size) arms ``watchdog.stall``: exit 45 within the deadline plus a poll,
   the black box written; (e) successive halving over the four tiles at
   BERT's shape and a causal GQA prefill at 2048, winners in a DB, every
   tile's time beside the bound, a second process (``--tune-replay``)
   replaying the winners with no trial; (f) rank 0's snapshot published
   and merged.  The two children run beside (b) and (c).
   ``--planes`` runs only the build, the tiles' checks, the serving FLOP
   check and this phase;
14. the symbolic half: (a) BERT-base (bench.py's configuration, dropout
   0) exported by HybridBlock.export and read back by
   SymbolBlock.imports(..., ctx=mx.gpu()): the imported fp32 forward at
   64 x 128 equal to the Gluon net's bit for bit with flash_attn_fwd 12
   times, the hybridized imported block equal to the eager one; an SGD
   step through the imported block at batch 8 against the CPU's fp64
   step (fp32 within BERT_FP32_BOUND, bf16 within BF16_NOISE_FACTOR x the
   CPU's bf16 deviation); two planted faults (layer 0's query and key
   weights swapped in the params file, the attention's scale changed in
   the symbol file) failing the equality; bf16 forwards timed, the
   imported block eager and hybridized beside the Gluon net hybridized;
   (b) ResNet-50 v1 exported, its symbol given a SoftmaxOutput head and
   loaded by mx.mod.Module.load on the card at batch 32: one SGD step
   against the CPU's (fp32 within 0.5, fp64 within 1e-5, the running
   stats written back), the same step through gluon.Trainer within 1e-2,
   Module.fit over 8 batches with callback.do_checkpoint and the loaded
   checkpoint's score and predictions equal, 20 Module steps at batch 256
   in bf16 timed beside phase 5's TrainStep; (c)
   test_utils.check_consistency over [mx.cpu(), mx.gpu()] on the attention
   symbol at BERT's shape and a conv + BatchNorm symbol, an offset planted
   on the card's weight raising.  ``--symbolic`` runs only the build and
   this phase;
15. data parallelism across processes: (a) world size 1 over a NCCL
   communicator: TrainStep(mesh=) and the KVStore's sharded and ZeRO
   paths equal to the plain steps bit for bit; (b) two processes on the
   card through tools/launch.py and dist_sync (gloo), held to the
   one-process step, planted data faults failing; (c) the agreements;
16. the sharded training step at Llama-3-8B widths, fp32, TF32 off: (b)-
   (d) in one pair of ranks started as children of this script
   (``--mp-rank``), both on the card over gloo with host copies: (b) tp =
   2 under the megatron plan (1 layer, 2 SGD steps, 1 x 256) against the
   one-rank step as |diff| / |update| within MP_TP_BOUND, flash_attn_fwd
   launched layers x steps on each rank at the local-head shape (16/4
   heads), the row-parallel all-reduce left out and the kv heads moved off
   their query group each planted and failing, the planner's HBM estimate
   beside the measured peak; (c) pp = 2, M = 4 (2 layers, batch 4), GPipe
   and 1F1B within MP_PP_BOUND, the microbatches reversed in 1F1B's
   backward planted and failing; (d) sp = 2: ring and Ulysses attention
   at (1, 32, 8192, 128) causal against the plain attention over the
   whole sequence within MP_SP_BOUND, an off-by-one in the ring's source
   shard planted and failing; (e) the planner's mesh for Llama-3-8B at
   full depth on 8 cards of this card's memory (while the pair runs); (a)
   after the pair, over a one-rank NCCL group: TrainStep(plan=) under
   each named rule set equal to the plain step bit for bit;
17. the kernels line (its times and launches at the main path's shape,
   the serving fleet, 4c;
   each path's shape, times and launches under ``by_path``, the op table
   with none, the tile pairs' times and the tuned winners), then the
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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}                  # H100 SXM, dense
# fp16 o: the kernel's deviation from the fp32 plain version within this
# factor of the plain fp16 version's own (phase 6's rule for bf16 gradients)
FP16_NOISE_FACTOR = 3.0
PEAK_BYTES = 3.35e12
# the (query rows, keys) tiles the kernel is built at for D = 64 and 128,
# the default first (ops/flash_attention.KERNEL_TILES)
KERNEL_TILE_PAIRS = ((128, 128), (128, 64), (64, 128), (64, 64))


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
# the processes this script starts
# ---------------------------------------------------------------------------
PR_SET_CHILD_SUBREAPER = 36


def become_subreaper():
    """Adopt this process's orphaned descendants (a grandchild whose parent
    died comes here instead of to init), so that stop_children finds every
    process the script started."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def descendants():
    """{pid: (state, command line)} of this process's descendants, read
    from /proc; zombies included (state "Z")."""
    tree = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:                     # ended while we looked
            continue
        # "pid (comm) state ppid ...": comm may hold spaces and brackets
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        tree.setdefault(int(ppid), []).append((int(name), state))
    found, todo = {}, [os.getpid()]
    while todo:
        for pid, state in tree.get(todo.pop(), ()):
            if pid not in found:
                found[pid] = state
                todo.append(pid)
    out = {}
    for pid, state in found.items():
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            cmd = ""
        out[pid] = (state, cmd.strip()[:200])
    return out


def report_children(label):
    """Log the processes that still run after ``label`` (multiprocessing's
    resource tracker stays from phase 12's DataLoader pool to the end)."""
    left = descendants()
    if left:
        log(f"  processes running after {label}: " + "; ".join(
            f"{pid} ({state}) {cmd}" for pid, (state, cmd) in left.items()))


def _reap():
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_children(say=log, grace=10.0):
    """Stop every process this one started that still runs: the resource
    tracker by closing its pipe, the rest by SIGTERM and, ``grace`` seconds
    later, SIGKILL; then reap them.  Returns what was found running."""
    import gc
    from multiprocessing import resource_tracker

    gc.collect()         # semaphores of pools no one holds: unlinked now
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    _reap()
    left = {pid: v for pid, v in descendants().items() if v[0] != "Z"}
    for pid, (state, cmd) in left.items():
        say(f"  stopping process {pid} ({state}), still running at the "
            f"end: {cmd}")
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            _reap()
            if not any(v[0] != "Z" for v in descendants().values()):
                break
            time.sleep(0.05)
        left = {pid: v for pid, v in descendants().items() if v[0] != "Z"}
        if not left:
            break
    _reap()
    return left


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
# phase 10's recipe: BertSelfAttention at batch 8 under amp.init("float16")
RESUME_SHAPE = (8, 12, 12, 128, 128, 64, False, True)
RESUME_DTYPE = torch.float16
PATH_SHAPES = {"serving": SERVING_SHAPE, "serve_http": SERVING_SHAPE,
               "serve_fleet": SERVING_SHAPE,
               "bert_train": BERT_SHAPE, "llama_train": SERVING_SHAPE,
               "llama_proxy_train": PROXY_SHAPE,
               "gluon_bert_lamb": BERT_SHAPE,
               "gluon_bert_resume": RESUME_SHAPE,
               "gluon_bert_lamb_hybrid": BERT_SHAPE,
               "gluon_bert_dataloader": BERT_SHAPE,
               "gluon_bert_planes": BERT_SHAPE,
               "symbol_block_bert": BERT_SHAPE,
               "dp_bert_nccl": BERT_SHAPE,
               "dp_bert_dist_sync": (32, 12, 12, 128, 128, 64, False, True),
               # phase 16: a tp rank's local heads (32/8 over tp = 2), and
               # a pipeline stage's microbatch (4 rows in M = 4)
               "mp_tp_llama": (1, 16, 4, 256, 256, 128, True, False),
               "mp_pp_gpipe": (1, 32, 8, 256, 256, 128, True, False),
               "mp_pp_1f1b": (1, 32, 8, 256, 256, 128, True, False)}
# each path's attention dtype where it is not bf16
PATH_DTYPES = {"gluon_bert_resume": RESUME_DTYPE,
               "dp_bert_dist_sync": torch.float32,
               "mp_tp_llama": torch.float32, "mp_pp_gpipe": torch.float32,
               "mp_pp_1f1b": torch.float32}
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
    RESUME_SHAPE,
    PATH_SHAPES["dp_bert_dist_sync"],             # a dist_sync rank's
    PATH_SHAPES["mp_tp_llama"],                   # a tp rank's heads
    PATH_SHAPES["mp_pp_gpipe"],                   # a pipeline stage's
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
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            q, k, v = make_qkv(shape, dtype, gen)
            scale = 1.0 / math.sqrt(d)
            o, lse = _flash_fwd_cuda(q, k, v, causal, scale)
            torch.cuda.synchronize()
            o_ref, lse_ref = _mha_with_lse(q.float(), k.float(), v.float(),
                                           causal, scale)
            err_o = (o.float() - o_ref).abs().max().item()
            err_l = (lse - lse_ref).abs().max().item()
            note = ""
            if dtype == torch.bfloat16:
                ok = torch.allclose(o.float(), o_ref, **BF16_TOL) and \
                    err_l <= LSE_TOL
                worst = max(worst, err_o)
            elif dtype == torch.float16:
                plain = (_mha_with_lse(q, k, v, causal, scale)[0].float()
                         - o_ref).abs().max().item()
                ok = err_o <= FP16_NOISE_FACTOR * plain and err_l <= LSE_TOL
                note = (f" (the plain fp16 version's {plain:.3e}, bound "
                        f"{FP16_NOISE_FACTOR:g}x)")
                worst = max(worst, err_o)
            else:
                ok = err_o <= F32_TOL and err_l <= F32_TOL
            log(f"  flash_attn_fwd {str(dtype)[6:]:8s} B={b} Hq={hq} "
                f"Hkv={hkv} Lq={lq} Lk={lk} D={d} causal={causal} "
                f"{'(B,L,H,D) views' if views else 'contiguous'}: "
                f"max|o err|={err_o:.3e}{note} max|lse err|={err_l:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attn_fwd {dtype} {shape} disagrees with "
                      f"_mha_with_lse")
            check(bool(torch.isfinite(o).all()), f"non-finite o at {shape}")
            check(o.shape == q.shape and o.transpose(1, 2).is_contiguous(),
                  f"o at {shape} is not the (B, Hq, Lq, D) view of a "
                  f"(B, Lq, Hq, D) tensor")
            del q, k, v, o, lse, o_ref, lse_ref
    # the other tiles of D = 64 and 128 (the tuning knobs' instances)
    worst = max(worst, check_tiles(
        gen, [sh for sh in KERNEL_CASES if sh[5] in (64, 128)]))

    # timing at the serving path's prefill shapes and the BERT shape,
    # bf16, and the fp16 recipe's shapes: device time from a replayed CUDA
    # graph for the kernel and SDPA alike, and the eager time per call
    # (host launch cost included), also of the public op under no_grad as
    # serving calls it (its autograd.Function around the kernel)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    by_path = {}
    timed = [(shape, torch.bfloat16) for shape in
             BUCKET_SHAPES + [BERT_SHAPE, PROXY_SHAPE]] + \
        [(BERT_SHAPE, torch.float16), (RESUME_SHAPE, torch.float16),
         (PATH_SHAPES["dp_bert_dist_sync"], torch.float32),
         (PATH_SHAPES["mp_tp_llama"], torch.float32),
         (PATH_SHAPES["mp_pp_gpipe"], torch.float32)]
    for shape, dtype in timed:
        b, hq, hkv, lq, lk, d, causal, _ = shape
        q, k, v = make_qkv(shape, dtype, gen)
        scale = 1.0 / math.sqrt(d)
        run = lambda: _flash_fwd_cuda(q, k, v, causal, scale)   # noqa: E731
        lib = lambda: sdpa(q, k, v, is_causal=causal, scale=scale,  # noqa
                           enable_gqa=True)
        ms, lib_ms = graph_time_ms(run), graph_time_ms(lib)
        eager_ms, lib_eager_ms = cuda_time_ms(run), cuda_time_ms(lib)
        with torch.no_grad():
            op_eager_ms = cuda_time_ms(lambda: flash_attention(
                q, k, v, causal=causal, sm_scale=scale))
        bound, bound_by = bound_ms(shape, dtype)
        flops, nbytes = attention_work(shape, dtype)
        log(f"  timing B={b} Hq={hq} Hkv={hkv} Lq=Lk={lq} D={d} "
            f"{str(dtype)[6:]} "
            f"causal={causal}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f}% of "
            f"bound), sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
            f"eager per call: kernel {eager_ms:.4f} ms, flash_attention "
            f"under no_grad {op_eager_ms:.4f} ms, sdpa {lib_eager_ms:.4f} "
            f"ms")
        for path, path_shape in PATH_SHAPES.items():
            if shape != path_shape or \
                    PATH_DTYPES.get(path, torch.bfloat16) != dtype:
                continue
            plain_ms = cuda_time_ms(
                lambda: _mha_with_lse(q, k, v, causal, scale), iters=5)
            log(f"  plain version at the {path} shape: {plain_ms:.4f} ms")
            by_path[path] = {"shape": list(shape[:7]),
                             "dtype": str(dtype)[6:], "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound,
                             "bound_by": bound_by, "library_ms": lib_ms}
        del q, k, v
    main = by_path["serve_fleet"]
    return {"name": "flash_attn_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "mxnet_tpu/ops/flash_attention.py:68",
            "launches": None, "max_abs_err": worst,
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "by_path": by_path}


def build_checks(kernels):
    """ptxas's report for every instance, and the SASS of the bf16 and
    fp16 D = 128 instances at each tile.  A wgmma instance (bf16 or fp16)
    that spills or whose wgmma ptxas serialises fails; so does a D = 128
    instance without HGMMA and UTMALDG or with HMMA (mma.sync)."""
    import re

    for name in kernels.sources():
        fn = None
        for line in (kernels.build_log(name) or "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                continue
            tag = re.search(r"fa_fwd_(f32|wgmma)I(?:\d+(__nv_bfloat16|__half))?"
                            r"Li(\d+)E(?:Li(\d+)ELi(\d+)E)?", fn or "")
            tile = f", {tag.group(4)}x{tag.group(5)}" \
                if tag and tag.group(4) else ""
            inst = (f"{tag.group(1)}<{tag.group(2) + ', ' if tag.group(2) else ''}"
                    f"{tag.group(3)}{tile}>") if tag else (fn or name)
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
    for elem in ("13__nv_bfloat16", "6__half"):
        for bq, bk in KERNEL_TILE_PAIRS:
            sym = f"fa_fwd_wgmmaI{elem}Li128ELi{bq}ELi{bk}EE"
            main = [f for f in funcs if sym in f.split("\n", 1)[0]]
            check(len(main) == 1, f"no {elem} D = 128 {bq} x {bk} instance "
                                  f"in the SASS")
            counts = {op: len(re.findall(rf"\b{op}\b", main[0]))
                      for op in ("HGMMA", "UTMALDG", "HMMA")}
            log(f"  SASS of fa_fwd_wgmma<{elem[2:].lstrip('_')}, 128, "
                f"{bq}x{bk}>: {counts}")
            check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
                  and counts["HMMA"] == 0,
                  f"the {elem} D = 128 {bq} x {bk} instance is not wgmma + "
                  f"TMA without mma.sync")


# ---------------------------------------------------------------------------
# phase 4: serving at Llama-3-8B widths
# ---------------------------------------------------------------------------
N_REQUESTS = 8
MAX_NEW = 32
SERVING_ENGINE_KW = dict(batch_buckets=[1, 2, 4, 8],
                         prefill_buckets=[128, 512, 2048], kv_pages=2048,
                         page_size=16, max_batch=8)


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
    (the first group whose pattern a kernel's name holds) and its count of
    device operations (kernels and copies), per step.  With
    ``label`` (one name or a tuple), host activity is traced too, and the
    kernels that ran inside a range of that name (its annotation on the
    device timeline) form a group of that name.  With ``step_ms`` (the
    unprofiled step time) the busy share is the device time per step over
    it, as the host profiler slows the host; else it is the device time
    over the profiled wall time.  Returns {group: device ops per step}."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels = (label,) if isinstance(label, str) else tuple(label or ())
    activities = [ProfilerActivity.CUDA]
    if labels:
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
    spans = {lb: sorted((ev.time_range.start, ev.time_range.end)
                        for ev in device if ev.name == lb) for lb in labels}
    starts = {lb: [a for a, _ in sp] for lb, sp in spans.items()}

    def group_of(ev):
        for lb, sp in spans.items():
            i = bisect.bisect_right(starts[lb], ev.time_range.start) - 1
            if i >= 0 and ev.time_range.start < sp[i][1]:
                return lb
        return next((gr for gr, pats in kernel_groups
                     if any(pt in ev.name for pt in pats)), "other")

    groups, counts, by_kernel = {}, {}, {}
    for ev in device:
        if ev.name in labels or getattr(ev, "is_user_annotation", False):
            continue                 # ranges, not kernels
        ms = (ev.time_range.end - ev.time_range.start) / 1e3
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ms
        group = group_of(ev)
        groups[group] = groups.get(group, 0.0) + ms
        counts[group] = counts.get(group, 0) + 1
    busy = sum(groups.values())
    if busy == 0:
        log("  profile: no device time recorded (not measured)")
        return {}
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
    if labels:
        share += "; host profiler on, " + ", ".join(
            f"{len(sp)} {lb} ranges" for lb, sp in spans.items())
    log(f"{head} ({share})")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {group:18s} {ms / steps:10.2f} ms{unit}  "
            f"{100 * ms / busy:5.1f}%  {counts[group] / steps:8.1f} device "
            f"ops{unit}")
    for key, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:n_top]:
        log(f"    {ms / steps:10.2f} ms{unit}  {key[:110]}")
    return {group: n / steps for group, n in counts.items()}


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


def joined(t, box, timeout=None):
    t.join(HTTP_TIMEOUT if timeout is None else timeout)
    check(not t.is_alive(), "a thread of the script did not end in time")
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


# ---------------------------------------------------------------------------
# phase 4c: the serving fleet, a router over engine replicas
# ---------------------------------------------------------------------------
FLEET_PROBE_MS = 250        # the router's health-probe period (the default)
FLEET_DEADLINE_MS = 600_000  # every fleet request's deadline
# hedging off: a 32-token answer at these widths takes seconds, so at the
# default 50 ms floor every request would be sent to both replicas
FLEET_HEDGE_MS = 3_600_000
FLEET_DISPATCHERS = 16      # requests the router has in flight at most
FLEET_WAIT = 600            # seconds: every wait for a replica to change
FLEET_MEM_SLACK = 0.10      # a join may add its KV pool and this share more
FLEET_WAKE_S = 0.05         # the health thread's wake-up, on a loaded host


def metric_total(name, field="value", **labels):
    """The sum of ``field`` over the samples of one telemetry family whose
    labels include ``labels`` (0 when it has none yet)."""
    from mxnet_tpu_torch import telemetry

    fam = telemetry.snapshot()["metrics"].get(name, {"samples": []})
    return sum(s[field] for s in fam["samples"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def fleet_post(port, prompt, max_new, temperature=0.0):
    """(status, body, client seconds) of one completion through the
    router."""
    t0 = time.perf_counter()
    status, res = http_call(port, "/v1/completions", {
        "prompt": [int(t) for t in prompt], "max_new_tokens": max_new,
        "temperature": temperature, "deadline_ms": FLEET_DEADLINE_MS})
    return status, res, time.perf_counter() - t0


def fleet_answers(calls, n_tokens, what):
    """Join the POST threads; every answer a 200 with ``n_tokens`` tokens
    and finish ``length``, each fleet request id once."""
    answers = [joined(*c) for c in calls]
    for status, res, _ in answers:
        check(status == 200, f"{what}: the router answered {status}: {res}")
        check(len(res["token_ids"]) == n_tokens
              and res["finish_reason"] == "length",
              f"{what}: fleet request {res['fleet']['request_id']} came "
              f"back with {len(res['token_ids'])} tokens, finish "
              f"{res['finish_reason']}; expected {n_tokens}, length")
    ids = [res["fleet"]["request_id"] for _, res, _ in answers]
    check(len(set(ids)) == len(ids),
          f"{what}: a fleet request id was answered twice: {ids}")
    return answers


def fleet_delivery(answers, ok0, dup0, resub0, what):
    """Every answer delivered exactly once: the router's successful
    dispatches since ``ok0`` equal the answers; each late completion the
    ledger dropped belongs to a request attempted more than once; the
    resubmit counter agrees with the answers.  Returns (attempts beyond
    one, duplicates suppressed, resubmits)."""
    ok = int(metric_total("mxnet_fleet_dispatches_total", outcome="ok")
             - ok0)
    dup = int(metric_total("mxnet_fleet_duplicates_suppressed_total") - dup0)
    resub = int(metric_total("mxnet_fleet_resubmits_total") - resub0)
    extra = sum(res["fleet"]["attempts"] - 1 for _, res, _ in answers)
    check(ok == len(answers),
          f"{what}: the router delivered {ok} completions for "
          f"{len(answers)} requests")
    check(dup <= extra,
          f"{what}: {dup} duplicate completions suppressed, more than the "
          f"{extra} repeated attempts")
    check(resub == sum(res["fleet"]["resubmits"] for _, res, _ in answers),
          f"{what}: {resub} resubmits counted, the answers carry "
          f"{sum(res['fleet']['resubmits'] for _, res, _ in answers)}")
    return extra, dup, resub


def fleet_homed_on(rid, rids, prompts):
    """A prompt (a slice of one of ``prompts``) whose affinity home among
    ``rids`` is ``rid``."""
    from mxnet_tpu_torch.serving.fleet import prefix_key, rendezvous_order

    for p in prompts:
        for j in range(0, min(64, len(p)), 4):
            cand = p[j:j + 64]
            if rendezvous_order(prefix_key(cand), sorted(rids))[0] == rid:
                return cand
    check(False, f"no prompt has its affinity home on {rid}")


def fleet_served_by(port):
    """{fleet request id: (replica id, the grafted replica trace's id)}
    from the router's request traces."""
    status, doc = http_call(port, "/v1/requests")
    check(status == 200, f"/v1/requests answered {status}")
    out = {}
    for item in doc["requests"]:
        for span in item["tree"]["children"]:
            if span["name"] == "dispatch":
                tree = span["attrs"]["replica_trace"]
                out[item["trace_id"]] = (span["attrs"]["replica"],
                                         tree["trace_id"])
    return out


def fleet_local_checks(router, port, state, prompts, temps, counter, stop):
    """4c (1) and (2), run on their own thread while ``serve_fleet`` holds
    the main thread.  Returns the figures and, per engine, the indices of
    the prompts it answered, its answers and the logits rows it sampled
    from.  It holds no engine beyond part (1): the reaped one must be
    freed."""
    import gc

    from mxnet_tpu_torch import fault

    out = {}
    check(http_call(port, "/healthz")[0] == 200, "/healthz did not answer")
    rids = [r.rid for r in router.replicas()]
    check(rids == ["replica-1", "replica-2"], f"the fleet started with {rids}")
    join = state["joins"][0]
    check(join["shared"], "join_replica did not share the donor's weights "
                          "(a parameter's storage differs)")
    if join["grew"] is not None:
        check(join["kv"] <= join["grew"] <= (1 + FLEET_MEM_SLACK) * join["kv"],
              f"the join added {join['grew'] / 2**30:.3f} GiB to the card; "
              f"its KV pool is {join['kv'] / 2**30:.3f} GiB (bound "
              f"{1 + FLEET_MEM_SLACK:.2f} x)")

    # (1) the 8 requests of phase 4 at once through the router
    counter.launches = 0
    counter.launches_by_len = {}
    ok0 = metric_total("mxnet_fleet_dispatches_total", outcome="ok")
    dup0 = metric_total("mxnet_fleet_duplicates_suppressed_total")
    resub0 = metric_total("mxnet_fleet_resubmits_total")
    dec0 = phase_totals()["decode"]
    if state["on_card"]:
        torch.cuda.reset_peak_memory_stats()
    engines = [r.engine for r in router.replicas()]
    t0 = time.perf_counter()
    with recorded_rows(engines[0]) as rows1, \
            recorded_rows(engines[1]) as rows2:
        answers = fleet_answers(
            [in_thread(fleet_post, port, p, MAX_NEW, t)
             for p, t in zip(prompts, temps)], MAX_NEW, "fleet (1)")
    out["wall_s"] = time.perf_counter() - t0
    del engines
    out["launches"] = counter.launches
    out["launches_by_len"] = dict(sorted(counter.launches_by_len.items()))
    out["decode_s"] = phase_totals()["decode"] - dec0
    if state["on_card"]:
        out["peak"] = torch.cuda.max_memory_allocated()
    fleet_delivery(answers, ok0, dup0, resub0, "fleet (1)")
    for _, res, _ in answers:
        check(res["fleet"]["attempts"] == 1 and res["fleet"]["hedges"] == 0,
              f"fleet (1): request {res['fleet']} was not served by one "
              f"dispatch")
    status, doc = http_call(port, "/v1/fleet")
    states = [r["health"]["state"] for r in doc["replicas"]]
    check(status == 200 and states == ["healthy", "healthy"],
          f"/v1/fleet after the completions: {status} {states}")
    check(metric_total("mxnet_serving_join_to_first_token_seconds",
                       "count") == state["j0"][0] + 1,
          "replica 2's first token did not stop its join clock")
    out["first_join_s"] = metric_total(
        "mxnet_serving_join_to_first_token_seconds", "sum") - state["j0"][1]
    served = fleet_served_by(port)
    by_replica = {}
    for i, (_, res, _) in enumerate(answers):
        rid, eng_trace = served[res["fleet"]["request_id"]]
        check(eng_trace == res["fleet"]["request_id"],
              f"the replica's trace of fleet request {res['fleet']} is "
              f"{eng_trace}")
        by_replica.setdefault(rid, []).append((i, res))
    check(sorted(by_replica) == ["replica-1", "replica-2"],
          f"not both replicas served: {sorted(by_replica)}")
    out["results"] = [res for _, res, _ in answers]
    out["client_s"] = [dt for _, _, dt in answers]
    out["per_engine"] = [
        ([i for i, _ in by_replica[rid]], [r for _, r in by_replica[rid]],
         rows) for rid, rows in (("replica-1", rows1), ("replica-2", rows2))]
    if state["on_card"]:
        torch.cuda.synchronize()
        out["mem_two"] = torch.cuda.memory_allocated()

    # (1b) the same requests with each replica on a device turn of its own:
    # the two loops contend for the GIL op by op, the contrast that the
    # engines' shared turn is measured against
    shared = [(r.engine, r.engine._turn) for r in router.replicas()]
    for eng, _ in shared:
        eng._turn = threading.Lock()
    t0 = time.perf_counter()
    own = fleet_answers(
        [in_thread(fleet_post, port, p, MAX_NEW, t)
         for p, t in zip(prompts, temps)], MAX_NEW, "fleet (1b)")
    out["own_turns_wall_s"] = time.perf_counter() - t0
    out["own_turns_tokens"] = sum(len(r["token_ids"]) - r["prefills"]
                                  for _, r, _ in own)
    for eng, turn in shared:
        eng._turn = turn
    del shared, eng

    # (2) a replica crashes mid-load: 4 requests in flight, then
    # replica.crash armed once and 4 more, the first of which takes its
    # replica down; the manager reaps it and joins a replacement
    ok0 = metric_total("mxnet_fleet_dispatches_total", outcome="ok")
    dup0 = metric_total("mxnet_fleet_duplicates_suppressed_total")
    resub0 = metric_total("mxnet_fleet_resubmits_total")
    trips0 = fault.stats()["replica.crash"]["trips"]
    first = [in_thread(fleet_post, port, p, MAX_NEW) for p in prompts[:4]]
    wait_until(lambda: sum(r.inflight_count() for r in router.replicas())
               == 4, "the first 4 requests on the replicas")
    with fault.inject("replica.crash", times=1):
        rest = [in_thread(fleet_post, port, p, MAX_NEW) for p in prompts[4:]]
        wait_until(lambda: fault.stats()["replica.crash"]["trips"]
                   == trips0 + 1, "the replica crash", timeout=FLEET_WAIT)
    answers2 = fleet_answers(first + rest, MAX_NEW, "fleet (2)")
    extra, dup, resub = fleet_delivery(answers2, ok0, dup0, resub0,
                                       "fleet (2)")
    check(extra + resub > 0, "fleet (2): the crash moved no request")
    manager = router._manager
    wait_until(lambda: len(router.replicas()) == 2
               and any(k == "replacement" for _, k, _ in manager.spawn_times),
               "the replacement replica", timeout=FLEET_WAIT)
    now = [r.rid for r in router.replicas()]
    dead = [rid for rid in rids if rid not in now]
    check(len(dead) == 1 and "replica-3" in now,
          f"fleet (2): after the heal the fleet is {now}")
    rids = now
    check(len(state["joins"]) == 2 and state["joins"][1]["shared"],
          "the replacement's join did not share the donor's weights")
    out["spawn_s"] = [dt for _, _, dt in manager.spawn_times]
    # the replacement's first token stops its join clock
    j0 = metric_total("mxnet_serving_join_to_first_token_seconds", "count")
    js0 = metric_total("mxnet_serving_join_to_first_token_seconds", "sum")
    probe = fleet_homed_on("replica-3", rids, prompts)
    status, res, _ = fleet_post(port, probe, 8)
    check(status == 200 and len(res["token_ids"]) == 8,
          f"the request homed on the replacement: {status} {res}")
    check(fleet_served_by(port)[res["fleet"]["request_id"]][0] == "replica-3",
          "the request homed on the replacement went elsewhere")
    check(metric_total("mxnet_serving_join_to_first_token_seconds", "count")
          == j0 + 1, "the replacement's first token did not stop its "
                     "join clock")
    out["join_s"] = [out.pop("first_join_s"),
                     metric_total("mxnet_serving_join_to_first_token_seconds",
                                  "sum") - js0]
    # the reaped engine is gone, its pool back on the card
    gone = state["engines"][dead[0]]
    wait_until(lambda: gone() is None or not gone().running(),
               "the reaped engine's loop", timeout=60)
    gc.collect()
    check(gone() is None, f"the reaped replica {dead[0]}'s engine is still "
                          f"referenced")
    if state["on_card"]:
        torch.cuda.synchronize()
        out["mem_healed"] = torch.cuda.memory_allocated()
        check(abs(out["mem_healed"] - out["mem_two"]) <= 0.02 * join["kv"],
              f"after the heal the card holds "
              f"{out['mem_healed'] / 2**30:.3f} GiB, with two replicas "
              f"{out['mem_two'] / 2**30:.3f} GiB")
    out["crash"] = {"dead": dead[0], "extra_attempts": extra,
                    "duplicates": dup, "resubmits": resub}
    stop()
    return out


def fleet_local_phase(net, engine_kw, prompts, temps, counter, check_rows,
                      stop=None, install_signals=True, device=None):
    """Phase 4c (1) and (2): ``serve_fleet`` in local mode on this (the
    main) thread, replica 1 a ServingEngine, replica 2 and every
    replacement ``ServingEngine.join_replica`` on a live replica; driven
    over HTTP from a thread that ``on_ready`` starts.  ``check_rows(idx,
    results, rows)`` holds the logits rows one engine sampled from for the
    prompts ``idx`` it answered; ``stop()`` (SIGTERM to this process by
    default) must drain the fleet and make ``serve_fleet`` return 43."""
    import weakref

    from mxnet_tpu_torch import fault, flight_recorder, lifecycle, telemetry
    from mxnet_tpu_torch.serving import ServingEngine
    from mxnet_tpu_torch.serving.fleet import serve_fleet

    if stop is None:
        def stop():
            os.kill(os.getpid(), signal.SIGTERM)
    for plane in (lifecycle, telemetry, flight_recorder):
        plane.reset()
    fault.reload_spec()
    fault.reset_stats()
    on_card = torch.device(device or "cuda").type == "cuda"
    state = {"on_card": on_card, "engines": {}, "joins": [],
             "j0": (metric_total("mxnet_serving_join_to_first_token_seconds",
                                 "count"),
                    metric_total("mxnet_serving_join_to_first_token_seconds",
                                 "sum"))}

    def factory(rid, donor):
        live = [e() for e in state["engines"].values()]
        live = [e for e in live if e is not None and e.running()]
        donor = donor or (live[0] if live else None)
        if donor is None:
            eng = ServingEngine(net, device=device, **engine_kw).start()
        else:
            if on_card:
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
            eng = ServingEngine.join_replica(net, donor, device=device,
                                             **engine_kw).start()
            grew = None
            if on_card:
                torch.cuda.synchronize()
                grew = torch.cuda.memory_allocated() - before
            state["joins"].append({
                "rid": rid, "kv": eng._kv.nbytes(), "grew": grew,
                "shared": set(eng._params) == set(donor._params) and all(
                    eng._params[k].data_ptr() == v.data_ptr()
                    for k, v in donor._params.items())})
        state["engines"][rid] = weakref.ref(eng)
        return eng

    client = []

    def on_ready(router, port):
        def drive():
            try:
                return fleet_local_checks(router, port, state, prompts,
                                          temps, counter, stop)
            except BaseException:
                lifecycle.request_stop("phase 4c client failed")
                raise
        client.extend(in_thread(drive))

    try:
        rc = serve_fleet(engine_factory=factory, replicas=2, port=0,
                         install_signals=install_signals, on_ready=on_ready,
                         hedge_ms=FLEET_HEDGE_MS,
                         dispatchers=FLEET_DISPATCHERS,
                         probe_interval_ms=FLEET_PROBE_MS)
        out = joined(*client)
    finally:
        telemetry.stop_http_server()
        lifecycle.reset()
    check(rc == lifecycle.EXIT_PREEMPTED,
          f"serve_fleet returned {rc} after the stop, expected "
          f"{lifecycle.EXIT_PREEMPTED}")
    for rid, ref in state["engines"].items():
        eng = ref()
        check(eng is None or (not eng.running() and eng._kv.k_pool is None),
              f"{rid}'s engine outlived the fleet's drain with its pool")
    for idx, results, rows in out.pop("per_engine"):
        check_rows(idx, results, rows)
    out["rc"] = rc
    return out


def fleet_replica_main(args):
    """A child of 4c's process-mode fleet: the Llama-3-8B-width bf16 net
    from the seed on the card, served by ``serving.serve(net, port=0)``
    (its banner is the fleet manager's readiness signal) until a SIGTERM
    drains it (exit 43).  Its stderr goes to ``args.fleet_replica_log``."""
    from mxnet_tpu_torch.gluon.model_zoo.language import llama as llama_mod
    from mxnet_tpu_torch.serving import serve

    if args.fleet_replica_log:
        fd = os.open(args.fleet_replica_log,
                     os.O_WRONLY | os.O_CREAT | os.O_APPEND)
        os.dup2(fd, 2)
        os.close(fd)
    net = llama_mod.init_random_(llama_mod.llama3_8b(dtype="bfloat16"),
                                 args.seed)
    return serve(net, port=0, **SERVING_ENGINE_KW)


def fleet_process_checks(router, port, prompts, stop, n_tokens):
    """4c (3), on its own thread while ``serve_fleet`` holds the main
    thread: the requests at once, one child SIGKILLed while it has work in
    flight, every request answered exactly once, the death seen by the
    first health sweep after the child's exit, a cold replacement that
    serves, then ``stop()``."""
    out = {}
    check(http_call(port, "/healthz")[0] == 200, "/healthz did not answer")
    children = router.replicas()
    check([c.rid for c in children] == ["replica-1", "replica-2"],
          f"the process fleet started with {[c.rid for c in children]}")
    victim = children[0]
    monitor = router._monitor
    sweeps, seen = [], {}
    poll_once, fire_dead = monitor.poll_once, monitor._fire_dead

    def timed_sweep():
        t0 = time.monotonic()
        try:
            poll_once()
        finally:
            sweeps.append(time.monotonic() - t0)

    def noted_death(replica):
        seen.setdefault(replica.rid, time.monotonic())
        fire_dead(replica)

    monitor.poll_once, monitor._fire_dead = timed_sweep, noted_death
    exited = {}

    def wait_exit():
        victim.proc.wait()
        exited["t"] = time.monotonic()

    ok0 = metric_total("mxnet_fleet_dispatches_total", outcome="ok")
    dup0 = metric_total("mxnet_fleet_duplicates_suppressed_total")
    resub0 = metric_total("mxnet_fleet_resubmits_total")
    t0 = time.perf_counter()
    calls = [in_thread(fleet_post, port, p, n_tokens) for p in prompts]
    wait_until(lambda: victim.inflight_count() > 0,
               "work in flight on the victim")
    waiter = threading.Thread(target=wait_exit, daemon=True)
    waiter.start()
    victim.kill()
    answers = fleet_answers(calls, n_tokens, "process fleet")
    out["wall_s"] = time.perf_counter() - t0
    extra, dup, resub = fleet_delivery(answers, ok0, dup0, resub0,
                                       "process fleet")
    check(extra + resub > 0, "process fleet: the SIGKILL moved no request")
    waiter.join(60)
    check("t" in exited and victim.proc.returncode == -signal.SIGKILL,
          f"the victim's exit: {victim.proc.returncode}")
    wait_until(lambda: victim.rid in seen, "the victim's death noted",
               timeout=60)
    # the first sweep that starts after the exit notes it: at most one
    # probe interval after the sweep in progress ends
    lag = seen[victim.rid] - exited["t"]
    allowed = FLEET_PROBE_MS / 1e3 + max(sweeps) + FLEET_WAKE_S
    check(lag <= allowed,
          f"the victim's death was noted {lag:.3f} s after its exit; one "
          f"probe interval plus the longest sweep and the thread's wake-up "
          f"is {allowed:.3f} s")
    out["lag_s"], out["sweep_s"] = lag, max(sweeps)
    manager = router._manager
    wait_until(lambda: len(router.replicas()) == 2
               and any(k == "replacement" for _, k, _ in manager.spawn_times),
               "the replacement child", timeout=FLEET_WAIT)
    rids = [r.rid for r in router.replicas()]
    check(rids == ["replica-2", "replica-3"],
          f"after the heal the fleet is {rids}")
    probe = fleet_homed_on("replica-3", rids, prompts)
    status, res, _ = fleet_post(port, probe, 8)
    check(status == 200 and len(res["token_ids"]) == 8,
          f"the request homed on the replacement: {status} {res}")
    check(fleet_served_by(port)[res["fleet"]["request_id"]][0] == "replica-3",
          "the request homed on the replacement went elsewhere")
    out["spawn_s"] = list(manager.spawn_times)
    out["results"] = [res for _, res, _ in answers]
    out["client_s"] = [dt for _, _, dt in answers]
    out["crash"] = {"extra_attempts": extra, "duplicates": dup,
                    "resubmits": resub}
    smi = shutil.which("nvidia-smi")
    out["memory_used"] = subprocess.run(
        [smi, "--query-gpu=memory.used", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip() if smi else \
        "not measured"
    out["children"] = router.replicas()
    stop()
    return out


def fleet_process_phase(prompts, spawn_argv, stop=None, install_signals=True,
                        n_tokens=None):
    """Phase 4c (3): ``serve_fleet(spawn_cmd=...)`` on this thread, two
    children each started as ``spawn_argv(rid, log_path)`` (exec, no fork;
    each builds its own weights), driven over HTTP from a thread that
    ``on_ready`` starts.  ``stop()`` (SIGTERM to this process by default)
    must drain every child (exit 43) and make ``serve_fleet`` return 43.
    Each child's stderr goes to a log whose tail is printed if the phase
    fails."""
    from mxnet_tpu_torch import fault, flight_recorder, lifecycle, telemetry
    from mxnet_tpu_torch.serving.fleet import serve_fleet

    if stop is None:
        def stop():
            os.kill(os.getpid(), signal.SIGTERM)
    for plane in (lifecycle, telemetry, flight_recorder):
        plane.reset()
    fault.reload_spec()
    fault.reset_stats()
    client = []

    def on_ready(router, port):
        def drive():
            try:
                return fleet_process_checks(router, port, prompts, stop,
                                            n_tokens or MAX_NEW)
            except BaseException:
                lifecycle.request_stop("phase 4c client failed")
                raise
        client.extend(in_thread(drive))

    with tempfile.TemporaryDirectory(prefix="mxnet_fleet_") as logs:
        def spawn_cmd(rid):
            return spawn_argv(rid, os.path.join(logs, f"{rid}.log")), {}

        try:
            try:
                rc = serve_fleet(spawn_cmd=spawn_cmd, replicas=2, port=0,
                                 install_signals=install_signals,
                                 on_ready=on_ready, hedge_ms=FLEET_HEDGE_MS,
                                 dispatchers=FLEET_DISPATCHERS,
                                 probe_interval_ms=FLEET_PROBE_MS)
                out = joined(*client)
            finally:
                telemetry.stop_http_server()
                lifecycle.reset()
            check(rc == lifecycle.EXIT_PREEMPTED,
                  f"serve_fleet returned {rc} after the stop, expected "
                  f"{lifecycle.EXIT_PREEMPTED}")
            codes = [c.proc.returncode for c in out.pop("children")]
            check(codes == [43, 43],
                  f"the children exited {codes} after the drain, expected "
                  f"43 each")
        except BaseException:
            for name in sorted(os.listdir(logs)):
                with open(os.path.join(logs, name), errors="replace") as f:
                    tail = f.read()[-3000:]
                log(f"  --- {name} (last 3000 bytes) ---\n{tail}")
            raise
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
    engine_kw = SERVING_ENGINE_KW
    engine = ServingEngine(net, **engine_kw).start()
    log(f"  KV pool: {engine._kv.nbytes() / 2**30:.3f} GiB")
    prompts = make_prompts(seed, cfg.vocab_size)
    temps = [0.8 if i in (1, 5) else 0.0 for i in range(N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_mod._flash_fwd_cuda.launches = 0          # counts of this run only
    fa_mod._flash_fwd_cuda.launches_by_len = {}
    telemetry.reset()
    flops0 = serving_flops_totals()
    t0 = time.perf_counter()
    results, rows = serve(engine, prompts, temps, seed)
    wall = time.perf_counter() - t0
    fill = occupancy()
    serving_flops_check(engine, cfg, flops0)
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

    log("== serving 4c: the same net behind serve_fleet, two local replicas "
        "(the second joined on the first's weights)")
    t0 = time.perf_counter()
    fleet = fleet_local_phase(
        net, engine_kw, prompts, temps, fa_mod._flash_fwd_cuda,
        lambda idx, res, rows: check_bf16_run(
            llama_mod, fa_mod, net, [prompts[i] for i in idx],
            [temps[i] for i in idx], res, rows))
    log_fleet_local(fleet, cfg, phase, decode_tokens, ttft, lat,
                    time.perf_counter() - t0)

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
    return {"serving": launches, "serve_http": http["launches"],
            "serve_fleet": fleet["launches"]}


def log_fleet_local(fleet, cfg, phase, decode_tokens, ttft, lat, secs):
    """4c (1) and (2)'s figures beside phase 4's, and the launch check."""
    res = fleet["results"]
    prefills = sum(r["prefills"] for r in res)
    check(fleet["launches"] == cfg.num_layers * prefills,
          f"flash_attn_fwd launched {fleet['launches']} times over the "
          f"fleet's completions, expected num_layers x prefills = "
          f"{cfg.num_layers * prefills}")
    mid = N_REQUESTS // 2
    f_ttft = sorted(r["ttft_s"] for r in res)
    f_lat = sorted(r["latency_s"] for r in res)
    client = sorted(fleet["client_s"])
    tokens = sum(len(r["token_ids"]) - r["prefills"] for r in res)
    log(f"  [{gpu_line()}] {N_REQUESTS} requests, submit() (phase 4) | "
        f"fleet (4c): TTFT p50 {ttft[mid]:.4f} | {f_ttft[mid]:.4f} s; "
        f"latency p50 {lat[mid]:.4f} | {f_lat[mid]:.4f} s (client round "
        f"trip through the router p50 {client[mid]:.4f} s); decode "
        f"{decode_tokens / phase['decode']:.1f} | "
        f"{tokens / fleet['decode_s']:.1f} tokens/s per engine loop "
        f"(decode-phase seconds summed over the replicas); fleet aggregate "
        f"{tokens / fleet['wall_s']:.1f} decode tokens/s over the "
        f"{fleet['wall_s']:.3f} s wall; with a device turn per replica "
        f"{fleet['own_turns_tokens'] / fleet['own_turns_wall_s']:.1f} "
        f"decode tokens/s over {fleet['own_turns_wall_s']:.3f} s")
    log(f"  flash_attn_fwd over the fleet's completions: {fleet['launches']}"
        f" = {cfg.num_layers} layers x {prefills} prefills, summed over "
        f"both replicas (" + ", ".join(f"{n} at {lb}" for lb, n in
                                       fleet["launches_by_len"].items())
        + ")")
    gib = 2 ** 30
    log(f"  memory: two replicas {fleet['mem_two'] / gib:.3f} GiB at rest, "
        f"peak {fleet['peak'] / gib:.3f} GiB over the 8 requests, after "
        f"the crash and heal {fleet['mem_healed'] / gib:.3f} GiB; spawn "
        f"seconds " + ", ".join(f"{dt:.3f}" for dt in fleet["spawn_s"])
        + f" (replica 1, the join, the replacement join); join to first "
        f"token {fleet['join_s'][0]:.3f} s (replica 2), "
        f"{fleet['join_s'][1]:.3f} s (the replacement)")
    c = fleet["crash"]
    log(f"  replica.crash took {c['dead']} down mid-load: 8 answers, each "
        f"once; {c['extra_attempts']} repeated attempts, {c['resubmits']} "
        f"resubmits, {c['duplicates']} duplicate completions suppressed; "
        f"serve_fleet returned {fleet['rc']} after the SIGTERM "
        f"({secs:.1f} s)")


def fleet_process_run(seed):
    """4c (3) on the card: the parent's nets are gone first, then two
    children of this script at Llama-3-8B widths behind the router."""
    import gc

    from mxnet_tpu_torch.gluon.model_zoo.language.llama import LlamaConfig

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"the parent still holds {held / 2**30:.3f} GiB on "
                        f"the card before the process fleet")
    prompts = make_prompts(seed, LlamaConfig().vocab_size)
    script = os.path.abspath(__file__)

    def spawn_argv(rid, log_path):
        return [sys.executable, script, "--fleet-replica", "--seed",
                str(seed), "--fleet-replica-log", log_path]

    t0 = time.perf_counter()
    out = fleet_process_phase(prompts, spawn_argv)
    res = out["results"]
    mid = len(res) // 2
    ttft = sorted(r["ttft_s"] for r in res)
    lat = sorted(r["latency_s"] for r in res)
    tokens = sum(len(r["token_ids"]) - r["prefills"] for r in res)
    spawns = ", ".join(f"{rid} {kind} {dt:.2f} s"
                       for rid, kind, dt in out["spawn_s"])
    c = out["crash"]
    log(f"  [{gpu_line()}] process fleet: spawns (cold) {spawns}; "
        f"{len(res)} requests with replica-1 SIGKILLed mid-load: each "
        f"answered once, {c['extra_attempts']} repeated attempts, "
        f"{c['resubmits']} resubmits, {c['duplicates']} duplicates "
        f"suppressed; death noted {out['lag_s']:.3f} s after the exit "
        f"(probe interval {FLEET_PROBE_MS / 1e3:.3f} s, longest sweep "
        f"{out['sweep_s']:.3f} s); TTFT p50 {ttft[mid]:.4f} s, latency p50 "
        f"{lat[mid]:.4f} s, {tokens / out['wall_s']:.1f} decode tokens/s "
        f"over the {out['wall_s']:.3f} s wall; card memory used with two "
        f"children {out['memory_used']}; SIGTERM drained both children "
        f"(43) and serve_fleet returned {out['rc']} "
        f"({time.perf_counter() - t0:.1f} s)")


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
# phase 9 (b)'s bf16 LAMB step (as GLUON_FP32_NOISE_FACTOR for its fp32
# step): LAMB's first step reads each tensor's worst entry, 1.252-3.168 x
# the CPU's bf16 deviation over seeds 0-7, while fp16 in place of bf16
# reads 13.66-34.94 x and the updated weights kept in bf16 34668-34864 x
# (--gluon-bert-seeds); 6 is 1.9 x over the worst reading and 2.3 x under
# the nearest fault.  AMP's fp32 list dropped reads 2.07-4.37 x here, and
# 0.13-4.37 x at the loss, against 0.01-0.72 x for the right step: it
# rounds the loss to bf16 and moves the step within bf16's noise, so the
# check reads the loss's precision instead (a bf16 number on every seed
# with the fault, on none without)
GLUON_BF16_NOISE_FACTOR = 6.0
# a planted bf16 fault of phase 9 (b) that is read, not checked, under
# --gluon-bert-seeds: the attention's scale off by one bf16 ulp at 1.0
# (2^-7)
BF16_SCALE_FAULT = 1.0 + 2.0 ** -7

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
                     loss_fn=None, before=None, keep=False):
    """One SGD TrainStep step of ``net`` on ``device``, in the net's dtype
    or under TrainStep's ``dtype``, with ``loss_fn`` (default softmax
    cross-entropy): (loss, the parameters before, after), in
    collect_params() order, on the host (with ``keep``, after stays on
    ``device``).  ``before``: the copy of the weights to return (shared by
    steps from the same weights, so that a full-width net's weights are
    held once)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep

    params = net.collect_params()
    if before is None:
        before = [_host(p.data()._data) for p in params.values()]
    step = TrainStep(net, loss_fn or gluon.loss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd", optimizer_params=opt, device=device,
                     dtype=dtype)
    loss = step(x, y).item()
    return loss, before, [step.params[n].detach() if keep else
                          _host(step.params[n]) for n in params]


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


def max_abs_diff(a, b):
    """max |a - b| in ``b``'s dtype, computed exactly (a widening cast, a
    subtraction, a max) and so the same number on either device; on the
    card when there is one: the CPU's passes over a full-width net's fp64
    host copies took most of phase 7's checks (~100 s)."""
    if torch.cuda.is_available():
        return (a.to("cuda", b.dtype) - b.to("cuda")).abs().max().item()
    return (a.to(b.dtype) - b).abs().max().item()


def step_deviations(cand, ref, names):
    """How far step ``cand`` strays from step ``ref`` (both (loss, before,
    after) from the same weights; ``cand``'s tensors are cast to ``ref``'s
    dtype, so an fp32 or bf16 step can be held to an fp64 one): a list of
    (where, deviation), first |loss difference| / max(1, |loss|), then per
    tensor max |after difference|.  None if the steps start from
    different weights."""
    (loss_c, before_c, after_c), (loss_r, before_r, after_r) = cand, ref
    for b_c, b_r in zip(before_c, before_r):
        if b_c is not b_r and max_abs_diff(b_c, b_r) != 0:
            return None
    devs = [("loss", abs(loss_c - loss_r) / max(1.0, abs(loss_r)))]
    for name, a_c, a_r in zip(names, after_c, after_r):
        devs.append((name, max_abs_diff(a_c, a_r)))
    return devs


def update_floors(ref, names, upd=None):
    """Per kind (_kind), UPDATE_FLOOR of the largest update in step
    ``ref`` among the tensors of that kind: {kind: (floor, tensor)}.
    ``upd``: updates(ref), when the caller has it."""
    floors = {}
    for name, upd in zip(names, updates(ref) if upd is None else upd):
        upd = UPDATE_FLOOR * upd
        if upd >= floors.get(_kind(name), (-1.0, None))[0]:
            floors[_kind(name)] = (upd, name)
    return floors


def updates(ref):
    """The largest entry of step ``ref``'s update of each tensor."""
    _, before, after = ref
    return [max_abs_diff(a, b) for a, b in zip(after, before)]


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
    upd = updates(ref)
    floors = update_floors(ref, names, upd)
    return [1.0] + [max(u, floors[_kind(name)][0])
                    for name, u in zip(names, upd)]


def is_bf16_value(x):
    """Whether the float ``x`` is exactly a bfloat16 number: a loss that
    was reduced or rounded in bf16.  An fp32 result is one by chance
    about once in 2^16."""
    t = torch.tensor(x, dtype=torch.float64)
    return bool(t.to(torch.bfloat16).to(torch.float64) == t)


def step_readings(cand, ref, names, scales):
    """The readings of step ``cand`` against ``ref`` over ``scales``
    (step_deviations over their scales): the worst entry ("worst") and
    where it is ("where"), the loss's ("loss"; "loss gap" is its
    unscaled |loss difference| / max(1, |loss|)) and the median
    tensor's ("median")."""
    devs = step_deviations(cand, ref, names)
    check(devs is not None, "the steps start from different weights")
    ratios = [(d / s, where) for (where, d), s in zip(devs, scales)]
    worst, where = max(ratios)
    tensors = sorted(r for r, _ in ratios[1:])
    return {"worst": worst, "where": where, "loss": ratios[0][0],
            "loss gap": devs[0][1], "median": tensors[len(tensors) // 2]}


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
    return img_s


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
def planted_attention_scale(factor):
    """Every flash_attention call (on the card the kernel, on the CPU the
    plain version) scales its scores by ``factor`` times the right
    sm_scale while the scope is open: a scale computed wrong."""
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    orig = fa_mod.flash_attention

    def wrong(q, k, v, causal=False, sm_scale=None):
        scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
            else sm_scale
        return orig(q, k, v, causal=causal, sm_scale=scale * factor)

    with patched(fa_mod, "flash_attention", wrong):
        yield


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
    log(f"  CPU steps: fp32 and bf16 {t1 - t0:.1f} s, fp64 "
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
    """Phase 6: (a) to (e); returns flash_attn_fwd's launches over (d)'s
    steps and (d)'s samples/s."""
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
    return launches, samples_s

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
                                dtype, llama_loss, before,
                                keep=device == "cuda")

    cpu_net = copy_llama(net, mx.cpu())
    t0 = time.perf_counter()
    cpu16 = step(cpu_net, "cpu", "bfloat16")
    t1 = time.perf_counter()
    cpu64 = step(cpu_net.double(), "cpu")
    log(f"  CPU steps: fp32 and bf16 {t1 - t0:.1f} s, fp64 "
        f"{time.perf_counter() - t1:.1f} s")
    del cpu_net
    t0 = time.perf_counter()
    # the checks compare on the card: the weights and the CPU's steps move
    # there once, and the card's steps stay (each check moved 15 GB of
    # them from the host before)
    before = [t.cuda() for t in before]
    cpu16, cpu64 = ((r[0], before, [t.cuda() for t in r[2]])
                    for r in (cpu16, cpu64))
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


# ---------------------------------------------------------------------------
# phase 8: the mx.nd op table
# ---------------------------------------------------------------------------
# (a) every op definition of the table on the card at a
# shape one of the port's models carries, against the CPU on the same
# seeded inputs (fp32, TF32 off): each output on the card, with the CPU's
# dtype and shape, within OP_TOL of it (relative to the larger of 1 and the
# CPU output's largest magnitude), and so each float input's gradient
# under the same seeded head.  linalg runs in fp64.
OP_TOL = 1e-4
OP_SHAPES = {
    "hidden": (64, 128, 768),     # BERT-base hidden state, bench_bert batch
    "logits": (8, 128256),        # Llama-3-8B logits, serving's batch bucket
    "scores": ((768, 128, 64), (768, 64, 128)),   # BERT attention scores
    "ffn": (8192, 768, 3072),     # BERT FFN: (8192, 768) x (768, 3072)
    "spd": (64, 256),             # linalg: 64 SPD 256 x 256, fp64
    "nhwc": (32, 56, 56, 256),    # ResNet-50 stage 1, NHWC, batch 32
    "ids": (2048, 32000, 1024),   # 2048 ids into the proxy's 32000-row table
    "tnc": (128, 64, 768),        # Sequence*, masked_softmax: TNC, ragged
    "nchw": (32, 256, 56, 56),    # Group/InstanceNorm, LRN, L2Normalization
    "up": (8, 256, 64, 64),       # Deconvolution, UpSampling, resize: x2
    "loss": (2048, 32000),        # SoftmaxOutput, the regression outputs
    "ctc": (100, 32, 29, 20),     # CTC: T, batch, alphabet, max label len
    "stn": (32, 3, 224, 224),     # SpatialTransformer
    "rnn": (35, 20, 650, 2),      # the LM's LSTM: T, batch, width, layers
    "eye": 4096,
    "opt": (30522, 768),          # BERT-base's word embedding (and a bias)
    "interleaved": (128, 64, 12, 64),   # BERT-base: L, batch, heads, D
    "rope": (1, 32, 2048, 128),   # Llama-3-8B's q at sequence 2048
    "swiglu": (2048, 14336),      # Llama-3-8B's FFN gate at 2048 tokens
    "moe": (1, 256, 512, 4, 1024),   # a four-expert MoE at narrow widths
    "attn": (8, 12, 128, 64),     # BERT-base attention, fp32
    "flow": (8, 256, 48, 64, 20),    # FlowNetC: conv3 maps, displacement
    "image": (32, 224, 256, 160),    # NHWC batch side, resize targets
    "draws": (4096, 1024),        # the samplers in (a): 4M draws
    "pdf": (1000, 1000),          # the densities: a million points
    "qconv": (32, 64, 56, 64),    # ResNet-50 stage 1 3 x 3: N, C, H, O
    "qfc": (256, 2048, 1000),     # ResNet-50's classifier: batch, in, out
    # SSD-300 VOC: batch, classes, ground-truth rows, nms_topk, map sides
    "ssd": (32, 21, 56, 400, (38, 19, 10, 5, 3, 1)),
    # Faster R-CNN, ResNet-101 C4 of 600 x 1000: batch, map h, w, channels,
    # post- and pre-NMS proposals
    "rcnn": (1, 38, 63, 1024, 300, 6000),
    "dcn": (8, 512, 28),          # DCNv1 at ResNet conv5: batch, C, side
}


def _u(g, shape, lo=-1.0, hi=1.0, dtype=torch.float32):
    """Uniform on [lo, hi), drawn on the generator's device (the inputs of
    a phase 8 call are made on the card, then copied to the CPU)."""
    return torch.rand(shape, generator=g, dtype=dtype, device=g.device) * \
        (hi - lo) + lo


def _away(g, shape, lo=0.25, hi=1.0):
    """Magnitudes in [lo, hi], random signs: away from kinks at 0."""
    sign = torch.randint(0, 2, shape, generator=g,
                         device=g.device).float() * 2 - 1
    return _u(g, shape, lo, hi) * sign


def _ints(g, shape, lo, hi):
    return torch.randint(lo, hi, shape, generator=g, device=g.device).float()


def _distinct(g, shape):
    """Distinct, well-separated values (no ties for sort and top-k)."""
    return torch.randperm(math.prod(shape), generator=g,
                          device=g.device).reshape(shape).float() * 0.25 + 0.1


def _spd(g, b, n):
    m = _u(g, (b, n, n), dtype=torch.float64)
    return m @ m.transpose(-1, -2) / n + torch.eye(n, dtype=torch.float64,
                                                   device=g.device)


class OpCase:
    """One op call of phase 8 (a): ``make(g)`` gives its CPU inputs;
    ``grad`` the inputs whose gradient is compared (None: every float
    input of a differentiable op); ``head_out`` the output the head
    gradient enters; ``compare`` "value", "svd" (singular vectors up to
    sign), "permutation" (shuffle), "dropout", or one of
    compare_outputs's; ``extra(*inputs)`` more tensors to hold, computed
    after the op on the same device (the int8 products' accumulators)."""

    def __init__(self, label, name, make, attrs=None, grad=None, head_out=0,
                 compare="value", creation=False, extra=None):
        self.label, self.name, self.make = label, name, make
        self.attrs = dict(attrs or {})
        self.grad, self.head_out = grad, head_out
        self.compare, self.creation = compare, creation
        self.extra = extra


def op_cases(S):
    """Phase 8 (a)'s calls at the shapes ``S`` (OP_SHAPES), at least one
    for each op definition of the two families."""
    H, L, X, NC = S["hidden"], S["logits"], S["nhwc"], S["nchw"]
    n_ids, rows, width = S["ids"]
    cases = []

    def add(name, make, attrs=None, label=None, **kw):
        cases.append(OpCase(label or name, name, make, attrs, **kw))

    def unary(names, gen):
        for n in names:
            add(n, lambda g: [gen(g)])

    unary(["sin", "cos", "tanh", "arctan", "arcsinh", "sigmoid",
           "log_sigmoid", "softsign", "gelu", "erf", "negative", "identity",
           "square", "hard_sigmoid", "degrees", "radians", "sinh", "cosh",
           "expm1", "smooth_l1", "stop_gradient"], lambda g: _u(g, H))
    unary(["abs", "relu", "sign", "cbrt", "rcbrt"], lambda g: _away(g, H))
    unary(["exp"], lambda g: _u(g, H, -1.5, 1.0))
    unary(["tan"], lambda g: _u(g, H, -0.9, 0.9))
    unary(["arcsin", "arccos"], lambda g: _u(g, H, -0.8, 0.8))
    unary(["arctanh", "erfinv"], lambda g: _u(g, H, -0.7, 0.7))
    unary(["arccosh"], lambda g: _u(g, H, 1.3, 2.5))
    unary(["log", "log10", "log1p", "log2", "sqrt", "rsqrt", "reciprocal",
           "gamma", "gammaln", "digamma"], lambda g: _u(g, H, 0.3, 1.6))
    unary(["ceil", "floor", "round", "rint", "fix", "trunc", "logical_not",
           "isnan", "isinf", "isfinite", "zeros_like", "ones_like",
           "argmax_channel"], lambda g: _u(g, H, -2.0, 2.0))
    add("clip", lambda g: [_away(g, H)], {"a_min": -0.8, "a_max": 0.8})
    add("cast", lambda g: [_u(g, H)], {"dtype": "bfloat16"})
    add("amp_multicast", lambda g: [_u(g, H).to(torch.bfloat16)],
        {"num_outputs": 1})
    for act in ("relu", "sigmoid", "tanh", "softrelu", "softsign"):
        add("Activation", lambda g: [_away(g, H)], {"act_type": act},
            label=f"Activation {act}")
    for act in ("leaky", "elu", "selu", "gelu", "rrelu"):
        add("LeakyReLU", lambda g: [_away(g, H)], {"act_type": act},
            label=f"LeakyReLU {act}")
    add("LeakyReLU", lambda g: [_away(g, H), _u(g, (H[1],), 0.1, 0.3)],
        {"act_type": "prelu"}, label="LeakyReLU prelu")

    # binary, broadcasting the last axis, and the scalar forms
    row = (1, 1, H[2])
    for n in ("broadcast_add", "broadcast_sub", "broadcast_mul",
              "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
              "arctan2"):
        add(n, lambda g: [_away(g, H), _away(g, row)])
    for n in ("broadcast_div", "broadcast_mod"):
        add(n, lambda g: [_u(g, H), _u(g, row, 0.5, 1.5)])
    add("broadcast_power", lambda g: [_u(g, H, 0.3, 1.6),
                                      _u(g, row, 0.3, 1.6)])
    for n in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
              "broadcast_greater_equal", "broadcast_lesser",
              "broadcast_lesser_equal", "broadcast_logical_and",
              "broadcast_logical_or", "broadcast_logical_xor"):
        add(n, lambda g: [_ints(g, H, -1, 2), _ints(g, row, -1, 2)])
    for n in ("add", "sub", "mul", "div", "mod", "maximum", "minimum"):
        add(f"broadcast_{n}_scalar", lambda g: [_away(g, H)],
            {"scalar": 0.7})
    add("broadcast_power_scalar", lambda g: [_u(g, H, 0.3, 1.6)],
        {"scalar": 1.3})
    for n in ("equal", "not_equal", "greater", "greater_equal", "lesser",
              "lesser_equal"):
        add(f"broadcast_{n}_scalar", lambda g: [_ints(g, H, -1, 2)],
            {"scalar": 0.0})
    add("where", lambda g: [_ints(g, H, 0, 2), _u(g, H), _u(g, H)],
        grad=[1, 2])
    for n in ("add_n", "maximum_n"):
        add(n, lambda g: [_away(g, H), _away(g, H), _away(g, H)])

    # reductions and ordering at the logits
    for n in ("sum", "mean", "nansum", "norm"):
        add(n, lambda g: [_u(g, L)], {"axis": 1})
    for n in ("max", "min"):
        add(n, lambda g: [_distinct(g, L)], {"axis": 1})
    for n in ("prod", "nanprod"):
        add(n, lambda g: [_u(g, L, 0.5, 1.5)], {"axis": 0})
    add("moments", lambda g: [_u(g, L)], {"axes": (1,)})
    for n in ("argmax", "argmin", "argsort", "sort"):
        add(n, lambda g: [_distinct(g, L)], {"axis": -1})
    for typ in ("indices", "value", "both", "mask"):
        add("topk", lambda g: [_distinct(g, L)], {"k": 50, "ret_typ": typ},
            label=f"topk {typ}")
    add("histogram", lambda g: [_u(g, L, 0.0, 1.0)],
        {"bin_cnt": 10, "range": (0.0, 1.0)})
    add("histogram", lambda g: [_u(g, L)], {"bin_cnt": 10},
        label="histogram (data range)")
    add("multi_sum_sq", lambda g: [_u(g, L), _u(g, H)], {"num_arrays": 2})
    add("softmax", lambda g: [_u(g, L, -4.0, 4.0)])
    add("log_softmax", lambda g: [_u(g, L, -4.0, 4.0)])
    add("softmin", lambda g: [_u(g, L, -4.0, 4.0)])

    # products
    (qk, kv), (fm, fk, fn) = S["scores"], S["ffn"]
    add("batch_dot", lambda g: [_u(g, qk), _u(g, kv)])
    add("dot", lambda g: [_u(g, (fm, fk)), _u(g, (fk, fn))])
    add("matmul", lambda g: [_u(g, (fm, fk)), _u(g, (fk, fn))])
    add("linalg_gemm2", lambda g: [_u(g, (fm, fk)), _u(g, (fn, fk))],
        {"transpose_b": True, "alpha": 0.5})
    add("linalg_gemm", lambda g: [_u(g, (fm, fk)), _u(g, (fk, fn)),
                                  _u(g, (fm, fn))], {"beta": 0.5})
    add("FullyConnected", lambda g: [_u(g, (fm, fk)), _u(g, (fn, fk)),
                                     _u(g, (fn,))], {"num_hidden": fn})
    add("khatri_rao", lambda g: [_u(g, (qk[1], qk[2])),
                                 _u(g, (qk[2], qk[2]))])

    # linalg, fp64
    b, s = S["spd"]
    add("linalg_potrf", lambda g: [_spd(g, b, s)])
    add("linalg_trsm", lambda g: [torch.linalg.cholesky(_spd(g, b, s)),
                                  _u(g, (b, s, s), dtype=torch.float64)],
        {"alpha": 0.5})
    add("linalg_sumlogdiag", lambda g: [_spd(g, b, s)])
    add("linalg_syrk", lambda g: [_u(g, (b, s, s), dtype=torch.float64)])
    add("linalg_det", lambda g: [_spd(g, b, s)])
    add("linalg_inverse", lambda g: [_spd(g, b, s)])
    add("linalg_svd", lambda g: [_u(g, (b, s, s // 4), dtype=torch.float64)],
        head_out=1, compare="svd")

    # shape ops at ResNet-50's stage 1, NHWC
    n_, h_, w_, c_ = X
    add("reshape", lambda g: [_u(g, X)], {"shape": (n_, h_ * w_, c_)})
    add("flatten", lambda g: [_u(g, X)])
    add("transpose", lambda g: [_u(g, X)], {"axes": (0, 3, 1, 2)})
    add("swapaxes", lambda g: [_u(g, X)], {"dim1": 1, "dim2": 2})
    add("expand_dims", lambda g: [_u(g, X)], {"axis": 3})
    add("squeeze", lambda g: [_u(g, (n_, h_, w_, 1, c_))], {"axis": 3})
    add("tile", lambda g: [_u(g, X)], {"reps": (1, 1, 1, 2)})
    add("repeat", lambda g: [_u(g, X)], {"repeats": 2, "axis": 2})
    add("broadcast_to", lambda g: [_u(g, (n_, h_, w_, 1))],
        {"shape": X})
    add("broadcast_axis", lambda g: [_u(g, (n_, h_, w_, 1))],
        {"axis": 3, "size": c_})
    add("broadcast_like", lambda g: [_u(g, (1, h_, w_, c_)), _u(g, X)],
        grad=[0])
    add("slice", lambda g: [_u(g, X)],
        {"begin": (0, 8, 8, 0), "end": (n_, h_ - 8, w_ - 8, c_ // 2)})
    add("slice", lambda g: [_u(g, X)], {"begin": (None, None, None, None),
                                        "end": (None, None, None, None),
                                        "step": (1, -1, 2, 1)},
        label="slice (negative step)")
    add("slice_axis", lambda g: [_u(g, X)],
        {"axis": 3, "begin": 0, "end": c_ // 2})
    add("slice_like", lambda g: [_u(g, X), _u(g, (n_, h_ // 2, w_ // 2,
                                                   c_))], grad=[0])
    add("reverse", lambda g: [_u(g, X)], {"axis": 3})
    add("pad", lambda g: [_u(g, X)], {"mode": "constant", "pad_width": (
        0, 0, 1, 1, 1, 1, 0, 0), "constant_value": 0.5})
    for mode in ("edge", "reflect"):
        add("pad", lambda g: [_u(g, NC)], {"mode": mode, "pad_width": (
            0, 0, 0, 0, 1, 1, 1, 1)}, label=f"pad {mode}")
    add("space_to_depth", lambda g: [_u(g, NC)], {"block_size": 2})
    add("depth_to_space", lambda g: [_u(g, NC)], {"block_size": 2})
    add("concat", lambda g: [_u(g, X), _u(g, X)], {"dim": 3})
    add("stack", lambda g: [_u(g, X), _u(g, X)], {"axis": 3})
    add("split", lambda g: [_u(g, X)], {"num_outputs": 4, "axis": 3})
    add("diag", lambda g: [_u(g, X)], {"k": 1})
    region = (slice(None), slice(8, h_ - 8), slice(None, None, 2),
              slice(0, c_ // 2))
    add("_slice_key", lambda g: [_u(g, X)], {"key": region})
    add("_scatter_set_key", lambda g: [_u(g, X), _u(g, (
        n_, h_ - 16, (w_ + 1) // 2, c_ // 2))], {"key": region})

    # indexing: 2048 ids into the proxy's table
    def table(g):
        return _u(g, (rows, width))

    def ids(g):
        return _ints(g, (n_ids,), 0, rows)

    def distinct_ids(g):
        return torch.randperm(rows, generator=g,
                              device=g.device)[:n_ids].float()

    add("take", lambda g: [table(g), ids(g)], grad=[0])
    add("Embedding", lambda g: [ids(g), table(g)],
        {"input_dim": rows, "output_dim": width}, grad=[1])
    add("one_hot", lambda g: [ids(g)], {"depth": rows})
    LS = S["loss"]
    add("pick", lambda g: [_u(g, LS), _ints(g, (LS[0],), 0, LS[1])],
        {"axis": 1}, grad=[0])
    add("batch_take", lambda g: [_u(g, LS), _ints(g, (LS[0],), 0, LS[1])],
        grad=[0])
    add("gather_nd", lambda g: [table(g), ids(g)[None]], grad=[0])
    add("scatter_nd", lambda g: [_u(g, (n_ids, width)),
                                 distinct_ids(g)[None]],
        {"shape": (rows, width)})
    add("_contrib_index_copy", lambda g: [table(g), distinct_ids(g),
                                          _u(g, (n_ids, width))],
        grad=[0, 2])
    add("_contrib_index_array", lambda g: [_u(g, H)])
    add("where_index", lambda g: [(_u(g, H, 0.0, 1.0) > 0.9).float()])
    add("boolean_mask", lambda g: [_u(g, (n_ids, width)),
                                   _ints(g, (n_ids,), 0, 2)])
    add("ravel_multi_index", lambda g: [torch.stack([
        _ints(g, (n_ids,), 0, n_ids), _ints(g, (n_ids,), 0, width)])],
        {"shape": (n_ids, width)})
    add("unravel_index", lambda g: [_ints(g, (n_ids,), 0, n_ids * width)],
        {"shape": (n_ids, width)})
    add("shuffle", lambda g: [torch.cat([
        torch.arange(n_ids, dtype=torch.float32, device=g.device)[:, None],
        _u(g, (n_ids, width - 1))], dim=1)], compare="permutation")

    # sequences: TNC with ragged lengths
    T_, N_, C_ = S["tnc"]

    def lengths(g):
        return _ints(g, (N_,), 1, T_ + 1)

    for n in ("sequence_mask", "sequence_last", "sequence_reverse"):
        add(n, lambda g: [_u(g, S["tnc"]), lengths(g)],
            {"use_sequence_length": True}, grad=[0])

    def ragged_mask(g):
        steps = torch.arange(T_, dtype=torch.float32,
                             device=g.device)[:, None, None]
        return (steps < lengths(g)[None, :, None]).float()

    add("masked_softmax", lambda g: [_u(g, S["tnc"]), ragged_mask(g)],
        {"axis": 0}, grad=[0])

    # creation, on the card
    for name, attrs in (("zeros", {"shape": H}), ("ones", {"shape": H}),
                        ("full", {"shape": H, "val": 1.5}),
                        ("arange", {"start": 0, "stop": L[1], "step": 1.0}),
                        ("linspace", {"start": -1, "stop": 1, "num": L[1]}),
                        ("eye", {"N": S["eye"], "M": S["eye"], "k": 1})):
        add(name, lambda g: [], attrs, creation=True)

    # nn layers
    add("Convolution", lambda g: [_u(g, X), _u(g, (64, 1, 1, c_), -0.1,
                                                   0.1)],
        {"kernel": (1, 1), "num_filter": 64, "no_bias": True,
         "layout": "NHWC"})
    U_ = S["up"]
    add("Deconvolution", lambda g: [_u(g, U_), _u(g, (U_[1], U_[1] // 2, 2,
                                                      2), -0.1, 0.1)],
        {"kernel": (2, 2), "stride": (2, 2), "num_filter": U_[1] // 2})
    add("UpSampling", lambda g: [_u(g, U_)], {"scale": 2,
                                              "sample_type": "nearest"})
    add("UpSampling", lambda g: [_u(g, U_)], {"scale": 2,
                                              "sample_type": "bilinear"},
        label="UpSampling bilinear")
    add("BilinearResize2D", lambda g: [_u(g, U_)],
        {"height": 2 * U_[2], "width": 2 * U_[3]})
    add("Pooling", lambda g: [_u(g, NC)], {"kernel": (3, 3), "stride": (2, 2),
                                           "pad": (1, 1), "pool_type": "max"})
    ch = (NC[1],)
    add("BatchNorm", lambda g: [_u(g, NC), _u(g, ch, 0.5, 1.5), _u(g, ch),
                                torch.zeros(ch, device=g.device),
                                torch.ones(ch, device=g.device)],
        {"fix_gamma": False, "training": True}, grad=[0, 1, 2])
    add("LayerNorm", lambda g: [_u(g, H), _u(g, (H[2],), 0.5, 1.5),
                                _u(g, (H[2],))])
    add("GroupNorm", lambda g: [_u(g, NC), _u(g, ch, 0.5, 1.5), _u(g, ch)],
        {"num_groups": NC[1] // 8})
    add("InstanceNorm", lambda g: [_u(g, NC), _u(g, ch, 0.5, 1.5),
                                   _u(g, ch)])
    add("L2Normalization", lambda g: [_u(g, NC)])
    add("LRN", lambda g: [_u(g, NC)], {"nsize": 5})
    add("Dropout", lambda g: [_u(g, H, 0.5, 1.0)],
        {"p": 0.5, "training": True}, compare="dropout")

    # the loss layers
    add("SoftmaxOutput", lambda g: [_u(g, LS, -4.0, 4.0),
                                    _ints(g, (LS[0],), -1, LS[1])],
        {"use_ignore": True, "normalization": "valid"}, grad=[0])
    for n in ("LinearRegressionOutput", "MAERegressionOutput",
              "LogisticRegressionOutput"):
        add(n, lambda g: [_u(g, LS), _u(g, LS, 0.0, 1.0)], grad=[0])
    add("MakeLoss", lambda g: [_u(g, LS)], {"normalization": "batch"})
    T_c, B_c, A_c, S_c = S["ctc"]

    def ctc_labels(g):
        lab = _ints(g, (B_c, S_c), 1, A_c)
        keep = torch.arange(S_c, device=g.device)[None] < _ints(
            g, (B_c, 1), S_c // 2, S_c + 1)
        return lab * keep

    add("CTCLoss", lambda g: [_u(g, (T_c, B_c, A_c), -2.0, 2.0),
                              ctc_labels(g)], grad=[0])
    add("CTCLoss", lambda g: [
        _u(g, (T_c, B_c, A_c), -2.0, 2.0), ctc_labels(g),
        _ints(g, (B_c,), T_c // 2, T_c + 1), _ints(g, (B_c,), 1, S_c // 2)],
        {"use_data_lengths": True, "use_label_lengths": True}, grad=[0],
        label="CTCLoss (lengths)")

    # the fused RNN at the LM's widths
    from mxnet_tpu_torch.ops.nn import rnn_param_size

    T_r, N_r, C_r, L_r = S["rnn"]
    add("RNN", lambda g: [
        _u(g, (T_r, N_r, C_r)),
        _u(g, (rnn_param_size("lstm", C_r, C_r, L_r),), -0.05, 0.05),
        _u(g, (L_r, N_r, C_r)), _u(g, (L_r, N_r, C_r))],
        {"state_size": C_r, "num_layers": L_r, "mode": "lstm",
         "state_outputs": True})

    # the spatial transformer family
    ST = S["stn"]
    theta = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]

    def loc(g):
        return torch.tensor(theta, dtype=torch.float64, device=g.device) + \
            _u(g, (ST[0], 6), -0.1, 0.1, dtype=torch.float64)

    add("GridGenerator", lambda g: [loc(g)],
        {"transform_type": "affine", "target_shape": ST[2:]})
    add("GridGenerator", lambda g: [_u(g, (ST[0], 2) + ST[2:], -2.0, 2.0)],
        {"transform_type": "warp"}, label="GridGenerator warp")
    add("BilinearSampler", lambda g: [_u(g, ST), _u(g, (ST[0], 2) + ST[2:],
                                                    -1.1, 1.1)])
    # the affine grid's matmul rounds differently on the card, and in fp32
    # one ulp of a position (up to 223) moves it across a pixel edge, where
    # the sampler's derivative jumps: loc's gradient differs by ~1e-2
    # between devices in fp32, so this call runs in fp64
    add("SpatialTransformer", lambda g: [_u(g, ST, dtype=torch.float64),
                                         loc(g)],
        {"target_shape": ST[2:], "transform_type": "affine",
         "sampler_type": "bilinear"})
    other_family_cases(S, add)
    return cases


# the families beyond tensor and nn, at the shapes of the models that use
# them.  GluonCV's SSD-300 VOC anchors: six feature maps, per map the
# sizes (s_k, sqrt(s_k s_k+1)) / 300 and the ratios below, centres on the
# map's step / 300
SSD_SIZES = (30, 60, 111, 162, 213, 264, 315)
SSD_STEPS = (8, 16, 32, 64, 100, 300)
SSD_RATIOS = ((1, 2, 0.5),) + ((1, 2, 0.5, 3, 1 / 3),) * 3 + \
    ((1, 2, 0.5),) * 2
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def ssd_prior_attrs(maps):
    """MultiBoxPrior's attributes for each of SSD-300's feature maps."""
    out = []
    for i, m in enumerate(maps):
        s0, s1 = SSD_SIZES[i] / 300, SSD_SIZES[i + 1] / 300
        step = SSD_STEPS[i] / 300
        out.append({"sizes": (s0, math.sqrt(s0 * s1)),
                    "ratios": SSD_RATIOS[i], "steps": (step, step),
                    "clip": False})
    return out


def ssd_anchors(maps, device):
    """SSD-300's anchors over feature maps of the given sides: (1, A, 4)
    (8732 for 38, 19, 10, 5, 3, 1)."""
    from mxnet_tpu_torch.ops.detection_ops import multibox_prior

    return torch.cat([multibox_prior(torch.empty(1, 1, m, m, device=device),
                                     **attrs)
                      for m, attrs in zip(maps, ssd_prior_attrs(maps))], 1)


def ssd_labels(g, batch, rows, classes):
    """(batch, rows, 5) ground truth [class, x1, y1, x2, y2]: a random
    count of boxes an image (at least two), the rest padding (class -1).
    The second row repeats the first box with the next class, as a doubly
    annotated object does, so both claim the same best anchor."""
    lo = _u(g, (batch, rows, 2), 0.0, 0.7)
    wh = _u(g, (batch, rows, 2), 0.05, 0.3)
    cls = _ints(g, (batch, rows, 1), 0, classes - 1)
    lo[:, 1], wh[:, 1] = lo[:, 0], wh[:, 0]
    cls[:, 1] = (cls[:, 0] + 1) % (classes - 1)
    count = _ints(g, (batch, 1, 1), 2, rows + 1)
    pad = torch.arange(rows, device=g.device)[None, :, None] >= count
    cls = torch.where(pad, torch.full_like(cls, -1.0), cls)
    return torch.cat([cls, lo, torch.clamp(lo + wh, max=1.0)], -1)


def _softmax(g, shape, dim, scale=1.0):
    return torch.softmax(torch.randn(shape, generator=g, device=g.device)
                         * scale, dim)


def ssd_loc(g, batch, anchors, sizes=False):
    """(batch, anchors * 4) box offsets: centre offsets N(0, 0.5); the size
    offsets 0 unless ``sizes`` (exp(0) is exact on both devices, so the
    decoded boxes, and NMS's decisions on them, are the same bits)."""
    loc = torch.randn((batch, anchors, 4), generator=g, device=g.device) \
        * 0.5
    if not sizes:
        loc[..., 2:] = 0.0
    return loc.reshape(batch, -1)


def ssd_detections(g, batch, anchors, classes):
    """(batch, anchors, 6) rows [class, score, x1, y1, x2, y2], the scores
    on a grid of 1/256 so that many tie (the sort must keep their order)."""
    lo = _u(g, (batch, anchors, 2), 0.0, 0.8)
    wh = _u(g, (batch, anchors, 2), 0.02, 0.3)
    return torch.cat([_ints(g, (batch, anchors, 1), 0, classes - 1),
                      _ints(g, (batch, anchors, 1), 1, 257) / 256, lo,
                      lo + wh], -1)


def rpn_inputs(g, n, h, w, sizes=False):
    """Faster R-CNN's RPN outputs over an (h, w) C4 map, 9 anchors: the
    (bg, fg) softmax pairs (n, 18, h, w) and the deltas (n, 36, h, w),
    whose size deltas are 0 unless ``sizes`` (as ssd_loc's)."""
    probs = _softmax(g, (n, 2, 9, h, w), 1, 2.0).reshape(n, 18, h, w)
    deltas = torch.randn((n, 9, 4, h, w), generator=g, device=g.device) * 0.1
    if not sizes:
        deltas[:, :, 2:] = 0.0
    info = torch.tensor([[16.0 * h - 8, 16.0 * w - 8, 1.0]] * n,
                        device=g.device)
    return [probs, deltas.reshape(n, 36, h, w), info]


def proposal_rois(g, count, h, w):
    """``count`` proposals (batch 0) inside an (16h, 16w) image."""
    lo = torch.stack([_u(g, (count,), 0, 16.0 * w * 0.8),
                      _u(g, (count,), 0, 16.0 * h * 0.8)], 1)
    wh = _u(g, (count, 2), 16.0, 16.0 * min(h, w) * 0.5)
    hi = torch.minimum(lo + wh, torch.tensor([16.0 * w - 1, 16.0 * h - 1],
                                             device=g.device))
    return torch.cat([torch.zeros(count, 1, device=g.device), lo, hi], 1)


def _int8(g, shape, lo=-127, hi=127):
    return torch.randint(lo, hi, shape, generator=g, device=g.device,
                         dtype=torch.int8)


def _opt_inputs(name, g, shape):
    """(weight, grad, states...) of an update op; the states that must be
    positive are."""
    def u(lo=-1.0, hi=1.0):
        return _u(g, shape, lo, hi)

    states = {"sgd_update": [], "signsgd_update": [],
              "sgd_mom_update": [u()], "nag_mom_update": [u()],
              "signum_update": [u()], "adam_update": [u(), u(0.0, 1.0)],
              "adagrad_update": [u(0.0, 1.0)],
              "adadelta_update": [u(0.0, 1.0), u(0.0, 1.0)],
              "rmsprop_update": [u(0.0, 1.0)],
              "rmspropalex_update": [u(0.5, 1.0), torch.zeros(
                  shape, device=g.device), torch.zeros(shape,
                                                       device=g.device)],
              "ftrl_update": [u(), u(0.0, 1.0)],
              "ftml_update": [u(0.0, 1.0), u(0.0, 1.0), u()],
              "lamb_update_phase1": [u(), u(0.0, 1.0)]}[name]
    return [u(), u() * 0.1] + states


OPT_ATTRS = {
    "sgd_update": {"lr": 0.1, "wd": 1e-4},
    "sgd_mom_update": {"lr": 0.1, "momentum": 0.9, "wd": 1e-4},
    "nag_mom_update": {"lr": 0.1, "momentum": 0.9, "clip_gradient": 0.05},
    "adam_update": {"lr": 1e-3, "wd": 0.01},
    "adagrad_update": {"lr": 0.1},
    "adadelta_update": {"rho": 0.9},
    "rmsprop_update": {"lr": 1e-3, "clip_weights": 0.9},
    "rmspropalex_update": {"lr": 1e-3},
    "ftrl_update": {"lr": 0.1, "lamda1": 0.01},
    "ftml_update": {"lr": 0.0025, "t": 3},
    "signsgd_update": {"lr": 0.01},
    "signum_update": {"lr": 0.01, "wd_lh": 1e-4},
    "lamb_update_phase1": {"t": 3, "wd": 0.01}}


def int32_dense_acc(x, weight_q, wscale, act_range, *bias):
    """The int32 accumulator of quantized_fully_connected, through the
    op's own int8 product."""
    from mxnet_tpu_torch.ops import quantization_ops as q

    xq = q._quantize(x, q._symmetric_scale(act_range[0], act_range[1]))
    return [q.int8_matmul(xq, weight_q)]


def int32_conv_acc(x, weight_q, wscale, act_range, *bias):
    """The int32 accumulator of quantized_conv (3 x 3, pad 1)."""
    from mxnet_tpu_torch.ops import quantization_ops as q

    xq = q._quantize(x, q._symmetric_scale(act_range[0], act_range[1]))
    return [q.int8_conv(xq, weight_q, (1, 1), (1, 1), (1, 1), 1)]


def other_family_cases(S, add):
    """Phase 8 (a)'s calls of every family beyond tensor and nn."""
    # the optimizer updates over BERT-base's word embedding and a bias
    rows, width = S["opt"]
    inner = S["ffn"][2]
    for name, attrs in OPT_ATTRS.items():
        for label, shape in (("", (rows, width)), (" bias", (width,))):
            add(name, lambda g, n=name, s=shape: _opt_inputs(n, g, s), attrs,
                label=name + label)
    for label, shape in (("", (rows, width)), (" bias", (width,))):
        add("lamb_update_phase2", lambda g, s=shape: [
            _u(g, s), _u(g, s), _u(g, (1,), 0.5, 2.0),
            _u(g, (1,), 0.5, 2.0)], {"lr": 0.01, "lower_bound": 0.1,
                                     "upper_bound": 10.0},
            label="lamb_update_phase2" + label)
    layer = [(width, width), (width,)] * 4 + [(inner, width), (inner,),
                                              (width, inner), (width,)]
    add("multi_sgd_update", lambda g: [t for s in layer
                                       for t in (_u(g, s), _u(g, s) * 0.1)],
        {"lrs": (0.1,) * len(layer), "wds": (1e-4,) * len(layer),
         "num_weights": len(layer), "clip_gradient": 0.05},
        label="multi_sgd_update (one BERT layer's 12 tensors)")

    # GluonNLP's interleaved attention at BERT-base
    L_, B_, heads, d_ = S["interleaved"]
    e_ = heads * d_
    att = (B_ * heads, L_, L_)
    add("_contrib_interleaved_matmul_selfatt_qk",
        lambda g: [_u(g, (L_, B_, 3 * e_))], {"heads": heads})
    add("_contrib_interleaved_matmul_selfatt_valatt",
        lambda g: [_u(g, (L_, B_, 3 * e_)), _softmax(g, att, -1)],
        {"heads": heads})
    add("_contrib_interleaved_matmul_encdec_qk",
        lambda g: [_u(g, (L_, B_, e_)), _u(g, (L_, B_, 2 * e_))],
        {"heads": heads})
    add("_contrib_interleaved_matmul_encdec_valatt",
        lambda g: [_u(g, (L_, B_, 2 * e_)), _softmax(g, att, -1)],
        {"heads": heads})

    # the LLM blocks and the kernel-backed attention
    H = S["hidden"]
    add("rms_norm", lambda g: [_u(g, H), _u(g, (H[2],), 0.5, 1.5)])
    add("rope", lambda g: [_u(g, S["rope"])])
    add("swiglu", lambda g: [_u(g, S["swiglu"]), _u(g, S["swiglu"])])
    mb, ml, mh, me, mi = S["moe"]
    add("_contrib_moe_swiglu", lambda g: [
        _u(g, (mb, ml, mh)), _u(g, (mh, me), -0.1, 0.1),
        _u(g, (me, mh, mi), -0.05, 0.05), _u(g, (me, mh, mi), -0.05, 0.05),
        _u(g, (me, mi, mh), -0.05, 0.05)], {"capacity_factor": 4.0},
        grad=[0, 2, 3, 4])
    qkv = S["attn"]
    add("_contrib_flash_attention", lambda g: [_u(g, qkv), _u(g, qkv),
                                               _u(g, qkv)],
        {"causal": True})

    # the fused subgraph ops, with ReLU: in fp32 the products round
    # differently on the card, and a pre-activation within that of 0 takes
    # the other side of the kink (the gradient differs by ~5e-3 at BERT's
    # FFN), so these run in fp64
    fm, fk, fn = S["ffn"]
    f64 = torch.float64
    add("_sg_fused_dense_act", lambda g: [
        _u(g, (fm, fk), dtype=f64), _u(g, (fn, fk), -0.05, 0.05, dtype=f64),
        _u(g, (fn,), dtype=f64)], {"num_hidden": fn, "act_type": "relu"})
    n_, h_, w_, c_ = S["nhwc"]
    add("_sg_fused_conv_act", lambda g: [
        _u(g, S["nhwc"], dtype=f64),
        _u(g, (64, 3, 3, c_), -0.05, 0.05, dtype=f64),
        _u(g, (64,), dtype=f64)],
        {"kernel": (3, 3), "pad": (1, 1), "num_filter": 64,
         "layout": "NHWC", "act_type": "relu"})

    # legacy: FlowNetC's correlation, an SVM head over the LM's batch
    fl_n, fl_c, fl_h, fl_w, fl_d = S["flow"]
    add("Correlation", lambda g: [_u(g, (fl_n, fl_c, fl_h, fl_w)),
                                  _u(g, (fl_n, fl_c, fl_h, fl_w))],
        {"kernel_size": 1, "max_displacement": fl_d, "stride1": 1,
         "stride2": 2, "pad_size": fl_d})
    LS = S["loss"]
    add("SVMOutput", lambda g: [_u(g, LS), _ints(g, (LS[0],), 0, LS[1])],
        {"margin": 1.0}, grad=[0])

    # the image ops on an NHWC batch
    ib, isz, up, down = S["image"]
    IM = (ib, isz, isz, 3)
    add("image_to_tensor", lambda g: [torch.randint(
        0, 256, IM, generator=g, device=g.device, dtype=torch.uint8)])
    add("image_normalize", lambda g: [_u(g, (ib, 3, isz, isz), 0.0, 1.0)],
        {"mean": IMAGENET_MEAN, "std": IMAGENET_STD})
    for interp, mode in enumerate(("nearest", "bilinear", "bicubic")):
        for size in (up, down):
            add("image_resize", lambda g: [_u(g, IM, 0.0, 1.0)],
                {"size": size, "interp": interp},
                label=f"image_resize {mode} to {size}")
    # halving: each output centre falls on a source pixel's edge, an
    # integer quotient that a reciprocal product floors one pixel short
    add("image_resize", lambda g: [_u(g, IM, 0.0, 1.0)],
        {"size": isz // 2, "interp": 0},
        label=f"image_resize nearest to {isz // 2}")
    add("image_crop", lambda g: [_u(g, IM, 0.0, 1.0)],
        {"x0": isz // 8, "y0": isz // 16, "width": isz // 2,
         "height": isz // 2})
    for name in ("image_flip_left_right", "image_flip_top_bottom"):
        add(name, lambda g: [_u(g, IM, 0.0, 1.0)])
    for name in ("image_random_flip_left_right",
                 "image_random_flip_top_bottom"):
        add(name, lambda g: [_u(g, IM, 0.0, 1.0)], compare="flip")
    # the random colour ops at a fixed factor are deterministic
    for name, attrs in (("image_random_brightness", (1.2, 1.2)),
                        ("image_random_contrast", (0.8, 0.8)),
                        ("image_random_saturation", (1.3, 1.3)),
                        ("image_random_hue", (0.1, 0.1))):
        add(name, lambda g: [_u(g, IM, 0.0, 1.0)],
            {"min_factor": attrs[0], "max_factor": attrs[1]})
    add("image_random_lighting", lambda g: [_u(g, IM, 0.0, 1.0)],
        {"alpha_std": 0.0})
    add("image_random_color_jitter", lambda g: [_u(g, IM, 0.0, 1.0)])

    # the samplers: dtype and shape here, the distributions in (d)
    for name, attrs in (("random_uniform", {"low": -1.0, "high": 2.0}),
                        ("random_normal", {"loc": 0.0, "scale": 0.02}),
                        ("random_gamma", {"alpha": 2.0, "beta": 0.5}),
                        ("random_exponential", {"lam": 2.0}),
                        ("random_poisson", {"lam": 3.0}),
                        ("random_negative_binomial", {"k": 3, "p": 0.4}),
                        ("random_randint", {"low": 0, "high": 1000}),
                        ("bernoulli", {"prob": 0.3})):
        add(name, lambda g: [], dict(attrs, shape=S["draws"]),
            creation=True, compare="sampler")
    add("sample_multinomial", lambda g: [_softmax(g, S["logits"], -1, 4.0)],
        {"shape": 4}, compare="sampler")
    for name in ("sample_uniform_like", "sample_normal_like"):
        add(name, lambda g: [_u(g, S["draws"])], compare="sampler")

    # the densities at a million points
    pr, pc = S["pdf"]

    def pos(g, shape, lo=0.5, hi=2.0):
        return _u(g, shape, lo, hi)

    add("_random_pdf_uniform", lambda g: [_u(g, (pr, pc), -0.1, 1.1),
                                          _u(g, (pr,), -0.2, 0.0),
                                          _u(g, (pr,), 0.9, 1.2)],
        grad=[1, 2])
    add("_random_pdf_normal", lambda g: [_u(g, (pr, pc), -3.0, 3.0),
                                         _u(g, (pr,)), pos(g, (pr,))])
    add("_random_pdf_gamma", lambda g: [pos(g, (pr, pc), 0.1, 5.0),
                                        pos(g, (pr,), 0.5, 4.0),
                                        pos(g, (pr,))])
    add("_random_pdf_exponential", lambda g: [pos(g, (pr, pc), 0.0, 4.0),
                                              pos(g, (pr,))])
    add("_random_pdf_poisson", lambda g: [_ints(g, (pr, pc), 0, 12),
                                          pos(g, (pr,), 0.5, 6.0)],
        grad=[1])
    add("_random_pdf_negative_binomial", lambda g: [
        _ints(g, (pr, pc), 0, 12), pos(g, (pr,), 1.0, 5.0),
        _u(g, (pr,), 0.2, 0.8)], grad=[1, 2])
    add("_random_pdf_generalized_negative_binomial", lambda g: [
        _ints(g, (pr, pc), 0, 12), pos(g, (pr,), 0.5, 5.0),
        pos(g, (pr,), 0.2, 1.5)], grad=[1, 2])
    add("_random_pdf_dirichlet", lambda g: [
        _softmax(g, (pr, pc // 4, 4), -1), pos(g, (pr, 4))])

    # quantization at ResNet-50's stage 1 and its classifier
    qn, qc, qh, qo = S["qconv"]
    QX = (qn, qc, qh, qh)
    add("_contrib_quantize_v2", lambda g: [_u(g, QX)],
        {"min_calib_range": -1.0, "max_calib_range": 1.0})
    add("_contrib_quantize_v2", lambda g: [_u(g, QX, -2.0, 1.5)],
        label="_contrib_quantize_v2 (data range)")
    add("_contrib_quantize", lambda g: [_u(g, QX), torch.tensor(
        [-1.0], device=g.device), torch.tensor([1.0], device=g.device)])
    add("_contrib_dequantize", lambda g: [_int8(g, QX), torch.tensor(
        [-1.0], device=g.device), torch.tensor([1.0], device=g.device)])
    add("_contrib_requantize", lambda g: [
        torch.randint(-2 ** 20, 2 ** 20, QX, generator=g, device=g.device,
                      dtype=torch.int32),
        torch.tensor([-50.0], device=g.device),
        torch.tensor([50.0], device=g.device)],
        {"min_calib_range": -0.01, "max_calib_range": 0.01})
    add("_contrib_quantized_conv", lambda g: [
        _u(g, QX), _int8(g, (qo, qc, 3, 3)), _u(g, (qo,), 1e-3, 1e-2),
        torch.tensor([-1.0, 1.0], device=g.device), _u(g, (qo,), -0.1, 0.1)],
        {"kernel": (3, 3), "pad": (1, 1), "num_filter": qo},
        compare="exact", extra=int32_conv_acc)
    fb, fi, fo = S["qfc"]
    add("_contrib_quantized_fully_connected", lambda g: [
        _u(g, (fb, fi)), _int8(g, (fo, fi)), _u(g, (fo,), 1e-3, 1e-2),
        torch.tensor([-1.0, 1.0], device=g.device), _u(g, (fo,), -0.1, 0.1)],
        {"num_hidden": fo}, compare="exact", extra=int32_dense_acc)
    # activations near the range's end and large weights of one sign: the
    # int32 sums pass 2^24, where an fp32 product would round
    add("_contrib_quantized_fully_connected", lambda g: [
        _u(g, (fb, fi), 0.7, 1.0), _int8(g, (fo, fi), 64, 127),
        _u(g, (fo,), 1e-3, 1e-2), torch.tensor([-1.0, 1.0], device=g.device)],
        {"num_hidden": fo, "no_bias": True}, compare="exact",
        extra=int32_dense_acc,
        label="_contrib_quantized_fully_connected (sums past 2^24)")

    # SSD-300 VOC: its anchors, targets and detections at batch 32
    sb, scls, srows, stopk, maps = S["ssd"]
    na = sum(m * m * (len(r) + 1) for m, r in zip(maps, SSD_RATIOS))
    for m, attrs in zip(maps[:1], ssd_prior_attrs(maps)):
        add("_contrib_MultiBoxPrior", lambda g, m=m: [
            torch.empty(1, 1, m, m, device=g.device)], attrs)

    def anchors(g):
        return ssd_anchors(maps, g.device)

    add("_contrib_box_iou", lambda g: [
        ssd_labels(g, sb, srows, scls)[..., 1:], anchors(g)[0]])
    add("_contrib_MultiBoxTarget", lambda g: [
        anchors(g), ssd_labels(g, sb, srows, scls),
        _softmax(g, (sb, scls, na), 1)],
        {"overlap_threshold": 0.5, "negative_mining_ratio": 3,
         "negative_mining_thresh": 0.5}, compare="targets")
    add("_contrib_MultiBoxDetection", lambda g: [
        _softmax(g, (sb, scls, na), 1, 2.0), ssd_loc(g, sb, na), anchors(g)],
        {"threshold": 0.01, "nms_threshold": 0.45, "nms_topk": stopk},
        compare="detections")
    add("_contrib_MultiBoxDetection", lambda g: [
        _softmax(g, (sb, scls, na), 1, 2.0), ssd_loc(g, sb, na, sizes=True),
        anchors(g)], {"threshold": 0.01, "nms_threshold": 1.0,
                      "nms_topk": stopk}, compare="detections",
        label="_contrib_MultiBoxDetection (size offsets, NMS off)")
    add("_contrib_box_nms", lambda g: [ssd_detections(g, sb, na, scls)],
        {"overlap_thresh": 0.45, "topk": stopk, "id_index": 0},
        compare="detections")
    add("_contrib_bipartite_matching", lambda g: [
        _u(g, (sb, srows, na), 0.0, 1.0)], {"threshold": 0.5},
        compare="exact")

    # Faster R-CNN (ResNet-101 C4, 600 x 1000): proposals and ROI pooling
    rn, rh, rw, rc, post, pre = S["rcnn"]
    attrs = {"scales": (8, 16, 32), "ratios": (0.5, 1, 2),
             "feature_stride": 16, "rpn_pre_nms_top_n": pre,
             "rpn_post_nms_top_n": post, "threshold": 0.7,
             "rpn_min_size": 16}
    add("_contrib_Proposal", lambda g: rpn_inputs(g, rn, rh, rw),
        dict(attrs, output_score=True), compare="exact")
    add("_contrib_Proposal", lambda g: rpn_inputs(g, rn, rh, rw, True),
        dict(attrs, threshold=1.0),
        label="_contrib_Proposal (size deltas, NMS off)")
    add("_contrib_ROIAlign", lambda g: [_u(g, (rn, rc, rh, rw)),
                                        proposal_rois(g, post, rh, rw)],
        {"pooled_size": (14, 14), "spatial_scale": 1 / 16,
         "sample_ratio": 2}, grad=[0])
    add("ROIPooling", lambda g: [_u(g, (rn, rc, rh, rw)),
                                 proposal_rois(g, post, rh, rw)],
        {"pooled_size": (7, 7), "spatial_scale": 1 / 16}, grad=[0])
    ps = 7
    add("_contrib_PSROIPooling", lambda g: [
        _u(g, (rn, scls * ps * ps, rh, rw)), proposal_rois(g, post, rh, rw)],
        {"output_dim": scls, "pooled_size": ps, "spatial_scale": 1 / 16},
        grad=[0])

    # DCNv1 at a ResNet conv5 3 x 3
    dn, dc, ds = S["dcn"]
    add("_contrib_DeformableConvolution", lambda g: [
        _u(g, (dn, dc, ds, ds)), _u(g, (dn, 18, ds, ds), -2.0, 2.0),
        _u(g, (dc, dc, 3, 3), -0.02, 0.02), _u(g, (dc,), -0.1, 0.1)],
        {"kernel": (3, 3), "pad": (1, 1), "num_filter": dc})


def detection_deviation(cand, ref, id_col=0, score_col=1):
    """Detections in the reference's convention: the same rows dropped
    (score -1), every kept row's id and score equal, the boxes' deviation
    as op_deviation's (inf on any other difference)."""
    drop_c, drop_r = cand[..., score_col] == -1, ref[..., score_col] == -1
    if not torch.equal(drop_c, drop_r):
        return math.inf
    keep = ~drop_r
    for col in (id_col, score_col):
        if not torch.equal(cand[..., col][keep], ref[..., col][keep]):
            return math.inf
    return op_deviation(cand[..., 2:], ref[..., 2:])


def _flip_axis(case):
    return 2 if case.name.endswith("left_right") else 1


def flip_grad_deviations(case, x, out, ref_out, grads, ref_grads, head):
    """A random flip's gradient on each device is the head gradient through
    the same choice as its output (the devices draw their coins apart)."""
    devs = []
    for o, gs in ((out, grads), (ref_out, ref_grads)):
        h = head(o.shape, o.dtype)
        took = torch.equal(o, torch.flip(x.to(o.device), (_flip_axis(case),)))
        want = torch.flip(h, (_flip_axis(case),)) if took else h
        devs += [op_deviation(g, want.to(g.device)) for g in gs]
    return devs


def compare_outputs(case, inputs, outs, ref_outs):
    """The deviations of a case's outputs by its ``compare`` mode (None:
    a mode that op_deviation covers)."""
    if case.compare == "sampler":
        return [0.0]
    if case.compare == "flip":
        x, axis = inputs[0], _flip_axis(case)
        ok = all(torch.equal(o, x.to(o.device)) or torch.equal(
            o, torch.flip(x.to(o.device), (axis,)))
            for o in (outs[0], ref_outs[0]))
        return [0.0 if ok else math.inf]
    if case.compare == "exact":
        return [0.0 if torch.equal(o, r) else math.inf
                for o, r in zip(outs, ref_outs)]
    if case.compare == "detections":
        return [detection_deviation(outs[0], ref_outs[0])]
    if case.compare == "targets":
        return [op_deviation(outs[0], ref_outs[0])] + [
            0.0 if torch.equal(o, r) else math.inf
            for o, r in zip(outs[1:], ref_outs[1:])]
    return None


# (d) the samplers and the random image ops on the card.  A continuous
# sampler is held by the one-sample Kolmogorov-Smirnov statistic against
# scipy's CDF: the sample is sorted on the card and its empirical CDF read
# at scipy's quantiles of KS_GRID evenly spaced probabilities, which is
# within 1 / KS_GRID below the statistic over every point; a discrete one
# by its mean and variance (within SE_BOUND standard errors) and a
# chi-square over its bins (every bin expecting >= 5 draws, the rest
# lumped).  Each bound is a p-value of P_BOUND for the seeded sample.
KS_GRID = 100_000
P_BOUND = 1e-6
SE_BOUND = 6.0
SAMPLER_SIZES = {"embed": (128256, 4096),   # Llama-3-8B's embedding
                 "vocab": (8, 128256),      # serving's batch of logits
                 "draws": 4_000_000, "multinomial_draws": 32768,
                 "image": (32, 224, 224, 3), "image_draws": 64}


def ks_bound(n):
    return math.sqrt(-math.log(P_BOUND / 2) / (2 * n))


def ks_statistic(x, ppf):
    """sup |F_n - F| at scipy's quantiles (see above), on x's device."""
    import numpy as np

    p = np.arange(1, KS_GRID) / KS_GRID
    xs = torch.sort(x.reshape(-1).float()).values
    q = torch.tensor(ppf(p), dtype=torch.float32, device=x.device)
    pt = torch.tensor(p, dtype=torch.float64, device=x.device)
    n = xs.numel()
    below = torch.searchsorted(xs, q).double() / n
    upto = torch.searchsorted(xs, q, right=True).double() / n
    return max((below - pt).abs().max().item(),
               (upto - pt).abs().max().item())


def _moment_chi2(x, probs, mean, var, m4, lo=0):
    """(mean and variance deviations in standard errors, chi-square, its
    bound) of integer draws ``x`` against a law with these moments and the
    probabilities ``probs`` (numpy) of lo, lo + 1, ..."""
    import numpy as np
    from scipy import stats

    n = x.numel()
    xd = x.reshape(-1).double()
    mean_se = abs(xd.mean().item() - mean) / math.sqrt(var / n)
    var_se = abs(xd.var(unbiased=False).item() - var) / math.sqrt(
        max(m4 - var ** 2, 1e-300) / n)
    v = len(probs)
    counts = torch.bincount((xd - lo).long().clamp(0, v),
                            minlength=v + 1)[:v].cpu().numpy()
    keep = probs * n >= 5
    obs = np.append(counts[keep], n - counts[keep].sum()).astype(float)
    exp = np.append(probs[keep], 1 - probs[keep].sum()) * n
    if exp[-1] < 5:        # the tail lumped into the last kept bin
        obs = np.append(obs[:-2], obs[-2] + obs[-1])
        exp = np.append(exp[:-2], exp[-2] + exp[-1])
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    return mean_se, var_se, chi2, stats.chi2.ppf(1 - P_BOUND, len(obs) - 1)


def discrete_check(x, dist, lo, hi):
    """_moment_chi2 of integer draws ``x`` against scipy's ``dist`` on
    [lo, hi)."""
    import numpy as np

    mean, var = dist.mean(), dist.var()
    m4 = dist.expect(lambda k: (k - mean) ** 4)
    return _moment_chi2(x, dist.pmf(np.arange(lo, hi)), mean, var, m4, lo)


def multinomial_check(draws, probs):
    """_moment_chi2 of each row of ``draws`` against its row of
    ``probs``: the worst row's mean and variance deviations, and the
    chi-square of the row worst against its bound, with that bound."""
    import numpy as np

    p = probs.double().cpu().numpy()
    k = np.arange(p.shape[1], dtype=np.float64)
    rows = []
    for r in range(p.shape[0]):
        mean = float((p[r] * k).sum())
        var = float((p[r] * (k - mean) ** 2).sum())
        m4 = float((p[r] * (k - mean) ** 4).sum())
        rows.append(_moment_chi2(draws[r], p[r], mean, var, m4))
    chi2, bound = max(((c, b) for _, _, c, b in rows),
                      key=lambda cb: cb[0] / cb[1])
    return (max(m for m, _, _, _ in rows), max(v for _, v, _, _ in rows),
            chi2, bound)


def distribution_check(label, x, dist, continuous):
    """Draws ``x`` held to scipy's ``dist``: a continuous law by the KS
    statistic, a discrete one by its moments and chi-square.  Returns
    (statistic, bound)."""
    if continuous:
        ks = ks_statistic(x, dist.ppf)
        bound = ks_bound(x.numel()) - 1.0 / KS_GRID
        check(ks < bound, f"{label}: KS statistic {ks:.3e} >= "
                          f"{bound:.3e} over {x.numel()} draws")
        return ks, bound
    lo = int(dist.support()[0])
    hi = int(min(dist.support()[1], dist.ppf(1 - 1e-12))) + 2
    mse, vse, chi2, bound = discrete_check(x, dist, lo, hi)
    check(mse < SE_BOUND and vse < SE_BOUND and chi2 < bound,
          f"{label}: mean {mse:.2f} SE, variance {vse:.2f} SE, "
          f"chi-square {chi2:.1f} (bound {bound:.1f})")
    return chi2, bound


@contextlib.contextmanager
def planted_sampler_fault(fault="normal_scale"):
    """random_normal drawing at 1.05 times its scale."""
    from mxnet_tpu_torch.ops.registry import OP_TABLE

    od = OP_TABLE["random_normal"]
    orig = od.fn

    def faulty(loc=0.0, scale=1.0, **kw):
        return orig(loc=loc, scale=scale * 1.05, **kw)

    od.fn = faulty
    try:
        yield
    finally:
        od.fn = orig


def _sampler_draws(device, sizes):
    """{label: (draw, scipy distribution, continuous?)} for (d)."""
    from scipy import stats

    import mxnet_tpu_torch as mx

    ctx = mx.Context.from_device(torch.device(device))
    nd = mx.nd.random
    n = sizes["draws"]
    like = mx.nd.zeros((n,), ctx=ctx)
    return {
        "random_normal (Llama-3-8B embedding, N(0, 0.02))": (
            lambda: nd.normal(0.0, 0.02, shape=sizes["embed"], ctx=ctx),
            stats.norm(0.0, 0.02), True),
        "random_uniform": (lambda: nd.uniform(-1.0, 2.0, shape=(n,),
                                              ctx=ctx),
                           stats.uniform(-1.0, 3.0), True),
        "random_gamma": (lambda: nd.gamma(2.5, 0.7, shape=(n,), ctx=ctx),
                         stats.gamma(2.5, scale=0.7), True),
        "random_gamma (shape < 1)": (
            lambda: nd.gamma(0.3, 2.0, shape=(n,), ctx=ctx),
            stats.gamma(0.3, scale=2.0), True),
        "random_exponential": (lambda: nd.exponential(2.0, shape=(n,),
                                                      ctx=ctx),
                               stats.expon(scale=2.0), True),
        "sample_uniform_like": (lambda: nd.uniform(like, 4.0),
                                stats.uniform(0.0, 4.0), True),
        "sample_normal_like": (lambda: mx.nd.sample_normal_like(
            like, loc=3.0, scale=0.5), stats.norm(3.0, 0.5), True),
        "random_poisson": (lambda: nd.poisson(3.5, shape=(n,), ctx=ctx),
                           stats.poisson(3.5), False),
        "random_negative_binomial": (
            lambda: nd.negative_binomial(3, 0.4, shape=(n,), ctx=ctx),
            stats.nbinom(3, 0.4), False),
        "random_randint": (lambda: nd.randint(-3, 997, shape=(n,), ctx=ctx),
                           stats.randint(-3, 997), False),
        "bernoulli": (lambda: nd.bernoulli(0.3, shape=(n,), ctx=ctx),
                      stats.bernoulli(0.3), False),
    }


def sampler_checks(seed, device, sizes=SAMPLER_SIZES, only=None):
    """(d): every sampler at its size on ``device``, by distribution;
    sample_multinomial over serving's probabilities; the seed and
    get_state / set_state replays (``only``: just the samplers whose label
    starts so).  Returns {label: (statistic, bound)} and the seconds each
    took."""
    import mxnet_tpu_torch as mx

    draws = _sampler_draws(device, sizes)
    stats_, secs = {}, {}
    for i, (label, (draw, dist, continuous)) in enumerate(draws.items()):
        if only is not None and not label.startswith(only):
            continue
        t0 = time.perf_counter()
        mx.random.seed(seed + i)
        x = draw()._data
        check(x.device.type == torch.device(device).type,
              f"{label} drew on {x.device}")
        stats_[label] = distribution_check(label, x, dist, continuous)
        del x
        secs[label] = time.perf_counter() - t0
    if only is not None:
        return stats_, secs
    # serving's sampling: 8 rows of Llama-3's vocabulary
    t0 = time.perf_counter()
    ctx = mx.Context.from_device(torch.device(device))
    g = torch.Generator(device=device).manual_seed(seed)
    probs = _softmax(g, sizes["vocab"], -1, 4.0)
    mx.random.seed(seed)
    out = mx.nd.random.multinomial(mx.nd.array(probs, ctx=ctx),
                                   shape=sizes["multinomial_draws"])._data
    check(out.dtype == torch.int32 and tuple(out.shape) == (
        sizes["vocab"][0], sizes["multinomial_draws"]),
        f"sample_multinomial gave {out.dtype} {tuple(out.shape)}")
    mse, vse, chi2, bound = multinomial_check(out, probs)
    stats_["sample_multinomial (8 x 128256)"] = (chi2, bound)
    check(mse < SE_BOUND and vse < SE_BOUND and chi2 < bound,
          f"sample_multinomial: mean {mse:.2f} SE, variance {vse:.2f} SE, "
          f"chi-square {chi2:.1f} (bound {bound:.1f})")
    secs["sample_multinomial (8 x 128256)"] = time.perf_counter() - t0
    replay_checks(seed, device)
    return stats_, secs


def _replay_draws(ctx):
    import mxnet_tpu_torch as mx

    nd = mx.nd.random
    return [nd.normal(shape=(1 << 20,), ctx=ctx)._data,
            nd.gamma(2.0, shape=(1 << 16,), ctx=ctx)._data,
            nd.poisson(3.0, shape=(1 << 16,), ctx=ctx)._data,
            nd.randint(0, 1000, shape=(1 << 16,), ctx=ctx)._data]


def replay_checks(seed, device):
    """The same seed gives the same draws twice, another seed others, and
    set_state(get_state()) replays what follows the snapshot."""
    import mxnet_tpu_torch as mx

    ctx = mx.Context.from_device(torch.device(device))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    mx.random.seed(seed)
    first = _replay_draws(ctx)
    mx.random.seed(seed)
    check(same(_replay_draws(ctx), first), "a seed did not fix the draws")
    mx.random.seed(seed + 1)
    check(not same(_replay_draws(ctx), first), "two seeds drew the same")
    state = json.loads(json.dumps(mx.random.get_state()))
    after = _replay_draws(ctx)
    mx.random.set_state(state)
    check(same(_replay_draws(ctx), after),
          "set_state(get_state()) did not replay the draws")


def image_factor_checks(seed, device, sizes=SAMPLER_SIZES):
    """(d) for the random image ops: at min factor = max factor each is its
    closed form; over a range, each draw's factor (solved from the output)
    lies in it; a random flip flips about half the time."""
    import mxnet_tpu_torch as mx

    ctx = mx.Context.from_device(torch.device(device))
    g = torch.Generator(device=device).manual_seed(seed)
    x = _u(g, sizes["image"], 0.0, 1.0)
    xn = mx.nd.array(x, ctx=ctx)
    gray = (x * torch.tensor([0.299, 0.587, 0.114],
                             device=x.device)).sum(-1, keepdim=True)
    mean = x.mean()
    closed = {"image_random_brightness": lambda f: x * f,
              "image_random_contrast": lambda f: x * f + mean * (1 - f),
              "image_random_saturation": lambda f: x * f + gray * (1 - f)}
    mx.random.seed(seed)
    worst = 0.0
    for name, form in closed.items():
        y = mx.nd.invoke(name, [xn], {"min_factor": 1.25,
                                      "max_factor": 1.25})._data
        worst = max(worst, op_deviation(y, form(1.25)))
        lo, hi = 0.6, 1.4
        for _ in range(sizes["image_draws"] // 4):
            y = mx.nd.invoke(name, [xn], {"min_factor": lo,
                                          "max_factor": hi})._data
            base = {"image_random_brightness": torch.zeros_like(x),
                    "image_random_contrast": mean.expand(x.shape),
                    "image_random_saturation": gray.expand(x.shape)}[name]
            # y - base = f (x - base): the least-squares f
            d = (x - base).reshape(-1).double()
            f = ((y - base).reshape(-1).double() @ d / (d @ d)).item()
            check(lo - 1e-5 <= f < hi + 1e-5, f"{name}: factor {f:.6f} "
                                              f"outside [{lo}, {hi})")
            worst = max(worst, op_deviation(y, form(f)))
    check(worst <= OP_TOL, f"the random colour ops deviate {worst:.3e} "
                           f"from their closed forms")
    y = mx.nd.invoke("image_random_lighting", [xn], {"alpha_std": 0.0})
    check(torch.equal(y._data, x), "random_lighting at alpha_std 0 moved "
                                   "the image")
    flips = 0
    n = sizes["image_draws"]
    for _ in range(n):
        y = mx.nd.invoke("image_random_flip_left_right", [xn], {})._data
        flipped = torch.equal(y, torch.flip(x, (2,)))
        check(flipped or torch.equal(y, x), "random_flip_left_right is "
                                            "neither x nor its flip")
        flips += flipped
    spread = 5 * math.sqrt(n / 4)
    check(abs(flips - n / 2) < spread, f"{flips} flips in {n} draws")
    return worst, flips / n


# (e) the two detection chains, end to end at (a)'s sizes, card against CPU
CHAIN_REPEATS = 5
NMS_CPU_IMAGES = 2


def _time_call(fn, device, repeats):
    """(the last result, ms per call): on the card one warm-up call, then
    the mean of ``repeats`` calls, each synchronised."""
    if device == "cuda":
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / repeats


def ssd_chain(nd, maps, data, topk):
    """SSD-300's prior -> target -> detection through mx.nd.contrib."""
    ctx = data["labels"].context
    anchors = nd.concat(*[nd.contrib.MultiBoxPrior(
        nd.zeros((1, 1, m, m), ctx=ctx), **attrs)
        for m, attrs in zip(maps, ssd_prior_attrs(maps))], dim=1)
    target = nd.contrib.MultiBoxTarget(
        anchors, data["labels"], data["cls_pred"], overlap_threshold=0.5,
        negative_mining_ratio=3, negative_mining_thresh=0.5)
    det = nd.contrib.MultiBoxDetection(
        data["cls_prob"], data["loc_pred"], anchors, threshold=0.01,
        nms_threshold=0.45, nms_topk=topk)
    return [anchors] + list(target) + [det]


def rcnn_chain(nd, data, post, pre):
    """Faster R-CNN's Proposal -> ROIAlign through mx.nd.contrib."""
    rois = nd.contrib.Proposal(
        data["cls_prob"], data["bbox_pred"], data["im_info"],
        scales=(8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
        rpn_pre_nms_top_n=pre, rpn_post_nms_top_n=post, threshold=0.7,
        rpn_min_size=16)
    pooled = nd.contrib.ROIAlign(data["feat"], rois, pooled_size=(14, 14),
                                 spatial_scale=1 / 16, sample_ratio=2)
    return [rois, pooled]


def detection_chains(seed, shapes=OP_SHAPES, device="cuda",
                     repeats=CHAIN_REPEATS):
    """(e): each chain on ``device`` and on the CPU from the same inputs,
    ms per call on each, the outputs held to each other (targets: classes
    and masks equal; detections: detection_deviation; the rest within
    OP_TOL); then box_nms's full sweep (no topk) over the SSD batch, on
    the CPU over its first NMS_CPU_IMAGES images only (the sweep takes
    ~1.1 s an image there).  Returns {label: (device ms, CPU ms,
    deviation)}."""
    import mxnet_tpu_torch as mx

    nd = mx.nd
    sb, scls, srows, stopk, maps = shapes["ssd"]
    rn, rh, rw, rc, post, pre = shapes["rcnn"]
    na = sum(m * m * (len(r) + 1) for m, r in zip(maps, SSD_RATIOS))
    g = torch.Generator(device=device).manual_seed(seed)
    ssd_in = {"labels": ssd_labels(g, sb, srows, scls),
              "cls_pred": _softmax(g, (sb, scls, na), 1),
              "cls_prob": _softmax(g, (sb, scls, na), 1, 2.0),
              "loc_pred": ssd_loc(g, sb, na)}
    probs, deltas, info = rpn_inputs(g, rn, rh, rw)
    rcnn_in = {"cls_prob": probs, "bbox_pred": deltas, "im_info": info,
               "feat": _u(g, (rn, rc, rh, rw))}
    nms_in = ssd_detections(g, sb, na, scls)
    out = {}

    def on(dev, tensors):
        ctx = mx.Context.from_device(torch.device(dev))
        return {k: nd.array(v, ctx=ctx, dtype=v.dtype)
                for k, v in tensors.items()}

    def run(label, fn, tensors, compare, cpu_images=None):
        res, ms = {}, {}
        for dev in (device, "cpu"):
            data = on(dev, tensors if dev == device else {
                k: v[:cpu_images] for k, v in tensors.items()})
            with no_host_reads():
                outs, ms[dev] = _time_call(lambda: fn(data), dev,
                                           repeats if dev != "cpu" else 1)
            res[dev] = [o._data for o in outs]
        ref = [r.to(device) for r in res["cpu"]]
        dev_ = max(compare(i, c[:cpu_images], r) for i, (c, r) in enumerate(
            zip(res[device], ref)))
        out[label] = (ms[device], ms["cpu"], dev_)
        check(dev_ <= OP_TOL, f"{label}: the card's outputs deviate "
                              f"{dev_:.3e} from the CPU's")

    def ssd_compare(i, c, r):
        if i in (2, 3):                       # the target mask and classes
            return 0.0 if torch.equal(c, r) else math.inf
        if i == 4:
            return detection_deviation(c, r)
        return op_deviation(c, r)

    run(f"SSD-300 prior -> target -> detection, batch {sb}",
        lambda d: ssd_chain(nd, maps, d, stopk), ssd_in, ssd_compare)
    run(f"Faster R-CNN Proposal ({pre} -> {post}) -> ROIAlign 14 x 14",
        lambda d: rcnn_chain(nd, d, post, pre), rcnn_in,
        lambda i, c, r: (0.0 if torch.equal(c, r) else math.inf) if i == 0
        else op_deviation(c, r))
    run(f"box_nms full sweep ({na} rows), batch {sb} (the CPU: "
        f"{min(sb, NMS_CPU_IMAGES)})",
        lambda d: [nd.contrib.box_nms(d["rows"], overlap_thresh=0.45,
                                      id_index=0)],
        {"rows": nms_in}, lambda i, c, r: detection_deviation(c, r),
        cpu_images=NMS_CPU_IMAGES)
    return out


def int8_route_times(seed, shape=(256, 2048, 1000)):
    """(e): the int8 product's exact routes on the card at ResNet-50's
    classifier (M, K) x (N, K): the port's torch._int_mm on the weight's
    transposed view, _int_mm on a row-major copy of the transpose, and
    the fp64 product, held equal.  Returns {route: ms per call}."""
    from mxnet_tpu_torch.ops import quantization_ops as q

    m, k, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                      dtype=torch.int8)
    routes = {"torch._int_mm on the weight's transposed view":
              q.int8_matmul_int_mm,
              "torch._int_mm on a row-major copy of the transpose":
              lambda a, b: torch._int_mm(a, b.t().contiguous()),
              "fp64": q.int8_matmul_fp64}
    outs = {r: fn(a, b) for r, fn in routes.items()}
    check(all(torch.equal(o, outs["fp64"]) for o in outs.values()),
          "the int8 product's routes disagree")
    return {r: cuda_time_ms(lambda fn=fn: fn(a, b), iters=200, warmup=10)
            for r, fn in routes.items()}


def op_table_definitions():
    """The canonical name of every op definition in the port's table."""
    from mxnet_tpu_torch.ops.registry import OP_TABLE

    return {od.name for od in OP_TABLE.values()}


def check_op_coverage(cases):
    missing = sorted(op_table_definitions() - {c.name for c in cases})
    check(not missing, f"phase 8 covers no call of {missing}")


_HOST_READS = ("cpu", "item", "tolist", "numpy", "__array__")


@contextlib.contextmanager
def no_host_reads():
    """Fail any tensor read back to the host (``.cpu()``, ``.item()``,
    ``.tolist()``, ``.numpy()``) inside the block: an op on the card keeps
    its result there (a data-dependent size synchronises inside
    ``nonzero``, which reads nothing back through these)."""
    saved = {name: getattr(torch.Tensor, name) for name in _HOST_READS}

    def refuse(self, *args, **kwargs):
        raise SystemExit("CHECK FAILED: an op read a tensor back to the "
                         "host")

    for name in saved:
        setattr(torch.Tensor, name, refuse)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def run_op_case(case, inputs, device, head):
    """The case's outputs and gradients (on ``device``) with ``inputs``
    copied there, through ``invoke`` under ``autograd.record()``;
    ``head(shape, dtype)`` gives the head gradient.  The call itself runs
    under no_host_reads, and every output must lie on ``device``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray.ndarray import invoke
    from mxnet_tpu_torch.ops.registry import OP_TABLE

    ctx = mx.Context.from_device(torch.device(device))
    nds = [mx.nd.array(t, ctx=ctx, dtype=t.dtype) for t in inputs]
    sel = case.grad
    if sel is None:
        sel = [i for i, t in enumerate(inputs) if t.is_floating_point()] \
            if OP_TABLE[case.name].differentiable else []
    for i in sel:
        nds[i].attach_grad()
    kw = {"ctx": ctx} if case.creation else {}
    with autograd.record(), no_host_reads():
        out = invoke(case.name, nds, dict(case.attrs), **kw)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    for o in outs:
        check(o._data.device.type == torch.device(device).type,
              f"{case.label}: an output lies on {o._data.device}, not "
              f"{device}")
    grads = []
    if sel:
        top = outs[case.head_out]._data
        outs[case.head_out].backward(mx.nd.array(
            head(top.shape, top.dtype), ctx=ctx, dtype=top.dtype))
        grads = [nds[i].grad._data for i in sel]
    outs = [o._data.detach() for o in outs]
    if case.extra is not None:
        with no_host_reads():
            outs += case.extra(*[n._data.detach() for n in nds])
    return outs, grads


def op_deviation(cand, ref):
    """Max |cand - ref| over max(1, max |ref|), NaN where ref has NaN; inf
    for another dtype or shape, or a differing integer or bool."""
    if cand.dtype != ref.dtype or cand.shape != ref.shape:
        return math.inf
    if not (ref.is_floating_point() or ref.is_complex()):
        return 0.0 if torch.equal(cand, ref) else math.inf
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(cand), nan):
        return math.inf
    if bool(nan.all()):
        return 0.0
    c = cand.double().masked_fill(nan, 0.0)
    r = ref.double().masked_fill(nan, 0.0)
    scale = max(1.0, r.abs().max().item())
    return (c - r).abs().max().item() / scale


def _svd_aligned(cand, ref):
    u, s, vt = cand
    sign = torch.sign((u * ref[0]).sum(dim=-2, keepdim=True))
    return [u * sign, s, vt * sign.transpose(-1, -2)]


def check_op_case(case, seed, device, dtype=None, fault=None):
    """Hold ``case`` on ``device`` to the CPU (module docstring, phase 8
    (a)): the inputs and the head gradient are drawn on ``device`` from
    ``seed`` and copied to the CPU; ``dtype`` recasts the float32 inputs
    (fp64 for the CPU tests); ``fault`` a context manager planted around
    the candidate's call only.  Returns the worst deviation, computed on
    ``device``."""
    inputs = case.make(torch.Generator(device=device).manual_seed(seed))
    if dtype is not None:
        inputs = [t.to(dtype) if t.dtype == torch.float32 else t
                  for t in inputs]
    heads = {}

    def head(shape, dt):
        if (shape, dt) not in heads:
            g = torch.Generator(device=device).manual_seed(seed + 1)
            draw = dt if dt == torch.float64 else torch.float32
            heads[shape, dt] = torch.randn(shape, generator=g, dtype=draw,
                                           device=device).to(dt)
        return heads[shape, dt]

    with fault or contextlib.nullcontext():
        outs, grads = run_op_case(case, inputs, device, head)
    ref_outs, ref_grads = run_op_case(case, [t.cpu() for t in inputs],
                                      "cpu", head)
    ref_outs = [r.to(device) for r in ref_outs]
    ref_grads = [r.to(device) for r in ref_grads]
    check(len(outs) == len(ref_outs), f"{case.label}: {len(outs)} outputs, "
                                      f"the CPU gives {len(ref_outs)}")
    for o, r in zip(outs, ref_outs):
        check(o.dtype == r.dtype and o.shape == r.shape,
              f"{case.label}: {o.dtype} {tuple(o.shape)}, the CPU gives "
              f"{r.dtype} {tuple(r.shape)}")
    if case.compare == "permutation":
        x = inputs[0]
        perm = outs[0][:, 0].long()
        check(torch.equal(torch.sort(perm).values,
                          torch.arange(len(x), device=perm.device))
              and torch.equal(outs[0], x[perm]),
              f"{case.label}: not a permutation of the rows")
        return 0.0
    if case.compare == "dropout":
        x, y = inputs[0], outs[0]
        dropped = (y == 0).double().mean().item()
        kept = y != 0
        p = case.attrs["p"]
        spread = 5 * math.sqrt(p * (1 - p) / y.numel())    # 5 sigma
        check(abs(dropped - p) < spread and torch.allclose(
            y[kept], (x / (1 - p)).to(y.dtype)[kept]),
            f"{case.label}: {dropped:.4f} dropped, p = {p}")
        return 0.0
    if case.compare == "svd":
        outs = _svd_aligned(outs, ref_outs)
    devs = compare_outputs(case, inputs, outs, ref_outs)
    if devs is None:
        devs = [op_deviation(o, r) for o, r in zip(outs, ref_outs)]
    if case.compare == "flip":
        devs += flip_grad_deviations(case, inputs[0], outs[0], ref_outs[0],
                                     grads, ref_grads, head)
    else:
        devs += [op_deviation(c, r) for c, r in zip(grads, ref_grads)]
    worst = max(devs)
    check(worst <= OP_TOL, f"{case.label}: deviation {worst:.3e} from the "
                           f"CPU exceeds {OP_TOL:g} (outputs, then "
                           f"gradients: {[f'{d:.1e}' for d in devs]})")
    return worst


def op_table_checks(seed, device, shapes=OP_SHAPES, dtype=None):
    """Phase 8 (a): every case of op_cases(shapes), after the coverage
    check.  Returns {label: worst deviation}."""
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    cases = op_cases(shapes)
    check_op_coverage(cases)
    devs, secs = {}, {}
    counter = fa_mod._flash_fwd_cuda
    for i, c in enumerate(cases):
        t0 = time.perf_counter()
        before = counter.launches
        devs[c.label] = check_op_case(c, seed + i, device, dtype)
        if c.name == "_contrib_flash_attention":
            # the kernel held against the CPU's plain version: comparison
            # launches, outside the op table path's count (op table 2)
            log(f"  {c.label}: {counter.launches - before} comparison "
                f"launches of flash_attn_fwd")
        secs[c.label] = time.perf_counter() - t0
    slow = sorted(secs, key=secs.get, reverse=True)[:12]
    log("  slowest calls (s, card and CPU): " + ", ".join(
        f"{label} {secs[label]:.2f}" for label in slow))
    return devs


@contextlib.contextmanager
def planted_op_fault(fault):
    """A fault in one op of the table: "argsort_int64" (indices as int64),
    "topk_flipped" (is_ascend inverted) or "where_index_host" (the
    coordinates computed through the host)."""
    from mxnet_tpu_torch.ops.registry import OP_TABLE

    name = {"argsort_int64": "argsort", "topk_flipped": "topk",
            "where_index_host": "where_index"}[fault]
    od = OP_TABLE[name]
    orig = od.fn
    if fault == "argsort_int64":
        def faulty(x, **kw):
            return orig(x, **kw).long()
    elif fault == "topk_flipped":
        def faulty(x, is_ascend=False, **kw):
            return orig(x, is_ascend=not is_ascend, **kw)
    else:
        def faulty(x):
            return torch.nonzero(x.cpu()).to(torch.int32).to(x.device)
    od.fn = faulty
    try:
        yield
    finally:
        od.fn = orig


@contextlib.contextmanager
def planted_family_fault(fault):
    """A fault in the families beyond tensor and nn: "nms_unstable" (the
    score sort breaks ties by the higher index), "target_first_write"
    (MultiBoxTarget's shared anchor keeps the first row), "int8_fp32" (the
    int8 products accumulate in fp32) or "resize_interpolate" (bicubic
    resize by F.interpolate)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import detection_ops, image_ops
    from mxnet_tpu_torch.ops import quantization_ops

    saved = []

    def swap(mod, attr, fn):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    if fault == "nms_unstable":
        def order(key, descending=False):
            n = key.shape[-1]
            flipped = torch.sort(torch.flip(key, (-1,)), dim=-1,
                                 descending=descending, stable=True)[1]
            return n - 1 - flipped
        swap(detection_ops, "_stable_order", order)
    elif fault == "target_first_write":
        def first(safe, na):
            nb, m = safe.shape
            rows = torch.arange(m, device=safe.device).expand(nb, m)
            out = torch.full((nb, na + 1), m, dtype=torch.int64,
                             device=safe.device)
            out = out.scatter_reduce(1, safe, rows, reduce="amin")[:, :na]
            return torch.where(out == m, torch.zeros_like(out), out)
        swap(detection_ops, "force_match_rows", first)
    elif fault == "int8_fp32":
        def matmul(a, b):
            return torch.matmul(a.float(), b.float().t()).to(torch.int32)

        def conv(x, w, stride, padding, dilation, groups):
            return F.conv2d(x.float(), w.float(), stride=stride,
                            padding=padding, dilation=dilation,
                            groups=groups).to(torch.int32)
        swap(quantization_ops, "int8_matmul", matmul)
        swap(quantization_ops, "int8_conv", conv)
    elif fault == "resize_interpolate":
        orig = image_ops.resize_axes

        def resize(x, out_sizes, method):
            if method != "bicubic":
                return orig(x, out_sizes, method)
            (_, h), (_, w) = sorted(out_sizes.items())
            x4 = x if x.dim() == 4 else x[None]
            y = F.interpolate(x4.permute(0, 3, 1, 2), size=(h, w),
                              mode="bicubic", align_corners=False)
            y = y.permute(0, 2, 3, 1)
            return y if x.dim() == 4 else y[0]
        swap(image_ops, "resize_axes", resize)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


# (b) the "medium" PTB LSTM of Zaremba et al. 2014, "Recurrent Neural
# Network Regularization" (arXiv:1409.2329), as MXNet's word-language-model
# examples reproduce it: vocabulary 10000, embedding 650, 2 LSTM layers of
# 650, unrolled 35 steps, batch 20, dropout 0.5 on the non-recurrent
# connections, weights uniform in [-0.05, 0.05]; random weights and token
# ids from --seed (no dataset)
LM_CFG = dict(vocab=10000, embed=650, hidden=650, layers=2, steps=35,
              batch=20, dropout=0.5)
LM_LR = 1.0
LM_WARMUP, LM_TIMED = 2, 20
LM_BOUND = 1e-3
LM_NAMES = ("embed_weight", "rnn_parameters", "fc_weight", "fc_bias",
            "state_h", "state_c")
LM_KERNEL_GROUPS = (
    ("gemm", ("gemm", "sm90", "cutlass", "xmma", "ampere", "cublas")),
    ("softmax", ("softmax",)),
    ("embedding", ("embedding", "index", "gather", "scatter")),
    ("reduce", ("reduce",)),
    ("copies", ("copy", "Memcpy", "Memset", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "sigmoid",
                     "tanh", "bernoulli")))


def lm_init(cfg, seed):
    """The LM's parameters (CPU fp32) and one batch of token ids and
    next-token labels (T, batch), from ``seed``."""
    from mxnet_tpu_torch.ops.nn import rnn_param_size

    g = torch.Generator().manual_seed(seed)
    V, E, H = cfg["vocab"], cfg["embed"], cfg["hidden"]
    params = {
        "embed_weight": _u(g, (V, E), -0.05, 0.05),
        "rnn_parameters": _u(g, (rnn_param_size("lstm", E, H,
                                                cfg["layers"]),),
                             -0.05, 0.05),
        "fc_weight": _u(g, (V, H), -0.05, 0.05),
        "fc_bias": torch.zeros(V)}
    tokens = torch.randint(0, V, (cfg["steps"] + 1, cfg["batch"]),
                           generator=g).float()
    return params, tokens[:-1], tokens[1:]


def lm_step(params, ids, labels, states, cfg, p_drop, lr):
    """One SGD step of the LM through mx.nd on the arrays' context: Embedding
    -> Dropout -> RNN (lstm, state_outputs) -> Dropout -> FullyConnected ->
    SoftmaxOutput (its gradient, the mean cross entropy's: grad_scale
    1 / tokens under normalization "null"), then w -= lr * grad.
    ``params`` (NDArrays, updated in place), ``states`` [h, c]; returns
    (probabilities, [h, c] detached)."""
    from mxnet_tpu_torch import autograd, nd

    H = cfg["hidden"]
    n_tok = cfg["steps"] * cfg["batch"]
    for v in params.values():
        v.attach_grad()
    with autograd.record():
        x = nd.Embedding(ids, params["embed_weight"],
                         input_dim=cfg["vocab"], output_dim=cfg["embed"])
        x = nd.Dropout(x, p=p_drop, training=True)
        out, h, c = nd.RNN(x, params["rnn_parameters"], *states,
                           state_size=H, num_layers=cfg["layers"],
                           mode="lstm", p=p_drop, training=True,
                           state_outputs=True)
        out = nd.Dropout(out, p=p_drop, training=True)
        logits = nd.FullyConnected(out.reshape((-1, H)),
                                   params["fc_weight"], params["fc_bias"],
                                   num_hidden=cfg["vocab"])
        prob = nd.SoftmaxOutput(logits, labels.reshape((-1,)),
                                grad_scale=1.0 / n_tok,
                                normalization="null")
    prob.backward()
    for v in params.values():
        v -= lr * v.grad
    return prob, [h.detach(), c.detach()]


def lm_loss(prob, labels):
    """Mean cross entropy of the step's probabilities."""
    from mxnet_tpu_torch import nd

    return -nd.log(nd.pick(prob, labels.reshape((-1,)), axis=1)).mean()


def lm_step_result(cfg, seed, device, dtype):
    """One step at dropout 0 from zero state: (loss, before, after) over
    LM_NAMES (the final h and c as tensors whose "before" is zero), all
    CPU tensors; checks every parameter has a non-zero gradient."""
    import mxnet_tpu_torch as mx

    params, ids, labels = lm_init(cfg, seed)
    ctx = mx.Context.from_device(torch.device(device))
    p = {k: mx.nd.array(v, ctx=ctx, dtype=dtype) for k, v in params.items()}
    shape = (cfg["layers"], cfg["batch"], cfg["hidden"])
    states = [mx.nd.zeros(shape, ctx=ctx, dtype=dtype) for _ in range(2)]
    ids_nd = mx.nd.array(ids, ctx=ctx)
    labels_nd = mx.nd.array(labels, ctx=ctx)
    prob, (h, c) = lm_step(p, ids_nd, labels_nd, states, cfg, 0.0, LM_LR)
    for k, v in p.items():
        check(bool((v.grad._data != 0).any()),
              f"LM step on {device}: {k} has a zero gradient")
    loss = lm_loss(prob, labels_nd).asscalar().item()
    before = [params[k].to(dtype) for k in LM_NAMES[:4]] + \
        [torch.zeros(shape, dtype=dtype)] * 2
    after = [p[k]._data.cpu() for k in LM_NAMES[:4]] + \
        [h._data.cpu(), c._data.cpu()]
    return loss, before, after


@contextlib.contextmanager
def planted_lm_fault(fault):
    """A fault in the LM's path: "gates_if" (the i and f gate blocks of
    the flat layout swapped), "first_h" (state_outputs' h taken from the
    first step) or "null_batch" (SoftmaxOutput divides by the batch under
    normalization "null")."""
    from mxnet_tpu_torch.ops import nn as nn_mod
    from mxnet_tpu_torch.ops.registry import OP_TABLE

    if fault == "gates_if":
        target, attr = nn_mod, "_rnn_cell"
        orig = nn_mod._rnn_cell

        def swap(t, dim):
            i, f, rest = t.split([t.shape[dim] // 4] * 2 + [
                t.shape[dim] // 2], dim=dim)
            return torch.cat([f, i, rest], dim=dim)

        def faulty(mode, i2h_t, h, c, wh, bh, clip):
            return orig(mode, swap(i2h_t, -1), h, c, swap(wh, 0),
                        swap(bh, 0), clip)
    elif fault == "first_h":
        target, attr = nn_mod, "_rnn_direction"
        orig = nn_mod._rnn_direction

        def faulty(*args):
            hs, h, c = orig(*args)
            return hs, hs[0], c
    else:
        target, attr = OP_TABLE["SoftmaxOutput"], "fn"
        orig = target.fn

        def faulty(data, label, normalization="null", **kw):
            return orig(data, label, normalization="batch"
                        if normalization == "null" else normalization, **kw)
    setattr(target, attr, faulty)
    try:
        yield
    finally:
        setattr(target, attr, orig)


def lm_step_check(cfg, seed, device, dtype, ref=None, fault=None):
    """Hold the step on ``device`` in ``dtype`` to the CPU's fp64 step
    (``ref``, computed if None) with compare_steps; returns (ratio, ref)."""
    if ref is None:
        ref = lm_step_result(cfg, seed, "cpu", torch.float64)
    planted = planted_lm_fault(fault) if fault else contextlib.nullcontext()
    with planted:
        cand = lm_step_result(cfg, seed, device, dtype)
    ratio, where = compare_steps(cand, ref, LM_NAMES)
    return ratio, where, ref


def lm_timing(cfg, seed):
    """LM_WARMUP + LM_TIMED steps at dropout cfg["dropout"] on the card,
    the state carried from step to step: tokens/s, ms/step, peak memory,
    falling loss, and a profiled pass by kernel group."""
    import mxnet_tpu_torch as mx

    params, ids, labels = lm_init(cfg, seed)
    ctx = mx.gpu(0)
    p = {k: mx.nd.array(v, ctx=ctx) for k, v in params.items()}
    shape = (cfg["layers"], cfg["batch"], cfg["hidden"])
    states = [mx.nd.zeros(shape, ctx=ctx) for _ in range(2)]
    ids_nd, labels_nd = mx.nd.array(ids, ctx=ctx), mx.nd.array(labels,
                                                               ctx=ctx)
    mx.random.seed(seed)

    def steps(n):
        nonlocal states
        prob = None
        for _ in range(n):
            prob, states = lm_step(p, ids_nd, labels_nd, states, cfg,
                                   cfg["dropout"], LM_LR)
        return prob

    loss0 = lm_loss(steps(LM_WARMUP), labels_nd).asscalar().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = steps(LM_TIMED)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / LM_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = lm_loss(prob, labels_nd).asscalar().item()
    tokens = cfg["steps"] * cfg["batch"]
    check(math.isfinite(loss) and loss < loss0,
          f"the LM's loss did not fall: {loss0:.4f} -> {loss:.4f}")
    log(f"  [{gpu_line()}] LM step: {ms:.3f} ms, {tokens / ms * 1e3:.0f} "
        f"tokens/s ({tokens} a step), peak memory {peak:.3f} GiB, loss "
        f"{loss0:.4f} -> {loss:.4f} over {LM_TIMED} steps")
    log_device_profile(lambda: steps(3), LM_KERNEL_GROUPS, steps=3,
                       step_ms=ms)
    return ms, params


def lstm_yardstick(cfg, params, seed):
    """The LM's two LSTM layers as the port's RNN op and as torch.nn.LSTM
    (cuDNN) with the same weights on the same input: outputs agree, and
    each one's forward + backward time (CUDA events).  A yardstick for a
    later cuDNN route; nothing in the port calls torch.nn.LSTM."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ops.nn import _rnn_param_layout

    E, H, nl = cfg["embed"], cfg["hidden"], cfg["layers"]
    flat = params["rnn_parameters"].cuda()
    lstm = torch.nn.LSTM(E, H, nl).cuda()
    pieces, off = [], 0
    for _, shp in _rnn_param_layout("lstm", E, H, nl, 1):
        pieces.append(flat[off:off + math.prod(shp)].reshape(shp))
        off += math.prod(shp)
    with torch.no_grad():
        for layer in range(nl):
            getattr(lstm, f"weight_ih_l{layer}").copy_(pieces[2 * layer])
            getattr(lstm, f"weight_hh_l{layer}").copy_(pieces[2 * layer + 1])
            getattr(lstm, f"bias_ih_l{layer}").copy_(pieces[2 * nl
                                                            + 2 * layer])
            getattr(lstm, f"bias_hh_l{layer}").copy_(
                pieces[2 * nl + 2 * layer + 1])
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((cfg["steps"], cfg["batch"], E), generator=g,
                   device="cuda") * 2 - 1
    head = torch.randn((cfg["steps"], cfg["batch"], H), generator=g,
                       device="cuda")
    x_nd = mx.nd.array(x, ctx=mx.gpu(0))
    p_nd = mx.nd.array(flat, ctx=mx.gpu(0))
    x_nd.attach_grad()
    p_nd.attach_grad()

    def port():
        with autograd.record():
            out = mx.nd.RNN(x_nd, p_nd, state_size=H, num_layers=nl,
                            mode="lstm")
        out.backward(mx.nd.array(head, ctx=mx.gpu(0)))
        return out

    xt = x.clone().requires_grad_(True)

    def cudnn():
        out, _ = lstm(xt)
        out.backward(head)
        return out

    err = (port()._data - cudnn()).abs().max().item()
    check(err <= OP_TOL, f"the RNN op and torch.nn.LSTM disagree by {err}")
    port_ms, cudnn_ms = cuda_time_ms(port, iters=10), cuda_time_ms(cudnn,
                                                                  iters=10)
    log(f"  [{gpu_line()}] two LSTM layers, T {cfg['steps']}, batch "
        f"{cfg['batch']}, width {H}, forward + backward: the port's RNN op "
        f"{port_ms:.3f} ms, torch.nn.LSTM (cuDNN) {cudnn_ms:.3f} ms "
        f"({port_ms / cudnn_ms:.2f}x); outputs agree to {err:.2e}")
    return port_ms, cudnn_ms


# (c) benchmark/opperf.py's DEFAULT_SUITE (its rows, copied), through the
# port's invoke at its own shapes: inputs uniform in [0.5, 1.5] as opperf
# makes them; (op, inputs, attrs, backward, (flops, bytes) of the forward)
def _gemm(m, k, n, batch=1):
    return 2 * batch * m * k * n, 4 * batch * (m * k + k * n + m * n)


OPPERF_SUITE = [
    ("exp", [(1024, 1024)], {}, True, (2**20, 8 * 2**20)),
    ("sqrt", [(1024, 1024)], {}, True, (2**20, 8 * 2**20)),
    ("elemwise_add", [(1024, 1024), (1024, 1024)], {}, True,
     (2**20, 12 * 2**20)),
    ("broadcast_mul", [(1024, 1024), (1, 1024)], {}, True,
     (2**20, 8 * 2**20 + 4096)),
    ("sum", [(1024, 1024)], {"axis": 1}, True, (2**20, 4 * 2**20 + 4096)),
    ("dot", [(512, 512), (512, 512)], {}, True, _gemm(512, 512, 512)),
    ("batch_dot", [(8, 256, 256), (8, 256, 256)], {}, True,
     _gemm(256, 256, 256, 8)),
    ("FullyConnected", [(128, 512), (256, 512), (256,)], {"num_hidden": 256},
     True, (2 * 128 * 512 * 256, 4 * (128 * 512 + 256 * 512 + 256
                                      + 128 * 256))),
    ("Convolution", [(8, 32, 56, 56), (64, 32, 3, 3)],
     {"kernel": (3, 3), "pad": (1, 1), "num_filter": 64, "no_bias": True},
     True, (2 * 8 * 64 * 56 * 56 * 32 * 9,
            4 * (8 * 32 * 56 * 56 + 64 * 32 * 9 + 8 * 64 * 56 * 56))),
    ("Pooling", [(8, 32, 56, 56)],
     {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"}, False,
     (8 * 32 * 56 * 56, 4 * 8 * 32 * (56 * 56 + 28 * 28))),
    ("softmax", [(128, 1024)], {}, True, (5 * 128 * 1024, 8 * 128 * 1024)),
    ("topk", [(128, 1024)], {"k": 8}, False,
     (128 * 1024, 4 * (128 * 1024 + 128 * 8))),
]


def opperf_rows(seed):
    """Each row: the eager ms per call (host included), the device ms (a
    replayed CUDA graph of the calls) and the bound, forward; and the
    eager forward + backward ms where opperf runs the backward."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray.ndarray import invoke

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for op, shapes, attrs, backward, (flops, nbytes) in OPPERF_SUITE:
        args = [mx.nd.array(torch.rand(s, generator=g, device="cuda") + 0.5,
                            ctx=mx.gpu(0)) for s in shapes]

        def fwd():
            return invoke(op, args, dict(attrs))

        eager = cuda_time_ms(fwd)
        device = graph_time_ms(fwd)
        bound = max(flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_FLOPS[torch.float32] > \
            nbytes / PEAK_BYTES else "bytes"
        row = {"op": op, "eager_ms": eager, "device_ms": device,
               "bound_ms": bound * 1e3, "bound_by": bound_by}
        if backward:
            for a in args:
                a.attach_grad()

            def both():
                with autograd.record():
                    out = invoke(op, args, dict(attrs))
                    out = out[0] if isinstance(out, list) else out
                out.backward()

            row["eager_fwd_bwd_ms"] = cuda_time_ms(both)
        log(f"  [{gpu_line()}] {op:15s} eager {eager:.4f} ms, device "
            f"{device:.4f} ms, bound {bound * 1e3:.4f} ms ({bound_by})"
            + (f", eager forward + backward {row['eager_fwd_bwd_ms']:.4f} "
               f"ms" if backward else ""))
        rows.append(row)
    return rows


def op_table_phase(seed):
    """Phase 8: (a) to (e); returns flash_attn_fwd's launches over the op
    table path's run, the LSTM LM of (b), counted from 0 just before it
    (the LM launches none; (a)'s comparison launches fall outside it)."""
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    log(f"== op table 1: every op definition of the table on the card "
        f"against the CPU, fp32 (linalg fp64), TF32 off, tolerance "
        f"{OP_TOL:g}")
    t0 = time.perf_counter()
    devs = op_table_checks(seed, "cuda")
    worst = max(devs, key=devs.get)
    log(f"  {len(devs)} calls, {len(op_table_definitions())} definitions "
        f"in {time.perf_counter() - t0:.1f} s; worst deviation "
        f"{devs[worst]:.3e} ({worst})")
    for label in sorted(devs, key=devs.get, reverse=True)[:10]:
        log(f"    {devs[label]:.3e}  {label}")

    cfg = LM_CFG
    log(f"== op table 2: the medium PTB LSTM LM (Zaremba et al. 2014) "
        f"through mx.nd: {cfg}, SGD {LM_LR}; one step at dropout 0 on the "
        f"card in fp32 against the CPU's fp64 step, bound {LM_BOUND:g}")
    fa_mod._flash_fwd_cuda.launches = 0          # counts of (b) only
    fa_mod._flash_fwd_cuda.launches_by_len = {}
    ratio, where, ref = lm_step_check(cfg, seed, "cuda", torch.float32)
    log(f"  fp32 step: worst deviation {ratio:.3e} of the update ({where})")
    check(ratio <= LM_BOUND, f"the LM step deviates {ratio:.3e} at {where}")
    for fault in ("gates_if", "first_h", "null_batch"):
        r, w, _ = lm_step_check(cfg, seed, "cuda", torch.float32, ref=ref,
                                fault=fault)
        log(f"  planted {fault}: deviation {r:.3e} ({w})")
        check(r > LM_BOUND, f"the LM check passed planted fault {fault}")
    ms, params = lm_timing(cfg, seed)
    lstm_yardstick(cfg, params, seed)
    launches = fa_mod._flash_fwd_cuda.launches

    log("== op table 3: benchmark/opperf.py's DEFAULT_SUITE through the "
        "port's invoke, fp32")
    opperf_rows(seed)

    log(f"== op table 4: the samplers on the card by distribution (KS "
        f"against scipy's CDF, moments and chi-square; p {P_BOUND:g}), "
        f"seed and state replay, a planted fault")
    t1 = time.perf_counter()
    stats_, secs = sampler_checks(seed, "cuda")
    for label, (stat, bound) in stats_.items():
        log(f"  {label}: {stat:.4g} (bound {bound:.4g}), {secs[label]:.2f} s")
    try:
        with planted_sampler_fault():
            sampler_checks(seed, "cuda", only="random_normal")
    except SystemExit as e:
        log(f"  planted random_normal scale x1.05: fails ({e})")
    else:
        check(False, "the sampler check passed random_normal at 1.05 times "
                     "its scale")
    worst, share = image_factor_checks(seed, "cuda")
    log(f"  random image ops: closed forms within {worst:.3e}, factors in "
        f"their ranges, {share:.3f} of the flips flipped; "
        f"{time.perf_counter() - t1:.1f} s")

    log("== op table 5: the detection chains end to end, card against CPU")
    for label, (ms, cpu_ms, dev) in detection_chains(seed).items():
        log(f"  [{gpu_line()}] {label}: {ms:.2f} ms a call on the card, "
            f"{cpu_ms:.1f} ms on the CPU; deviation {dev:.3e}")
    times = int8_route_times(seed)
    log(f"  [{gpu_line()}] the int8 product at ResNet-50's classifier "
        f"(256, 2048) x (1000, 2048), equal on every route: " + ", ".join(
            f"{route} {ms:.4f} ms" for route, ms in times.items()))
    return launches


# ---------------------------------------------------------------------------
# phase 9: the Gluon training surface (optimizers, schedulers, metrics, AMP
# loss scaling, gluon.utils) at BERT-base and ResNet-50 widths
# ---------------------------------------------------------------------------
# (a): every registered optimizer, 3 updates over BERT-base's word embedding
# and a bias, the index lr_mult on the bias; SGLD by its noise's KS
GLUON_OPT_SHAPES = ((30522, 768), (768,))
GLUON_OPT_STEPS = 3
GLUON_OPT_KW = dict(learning_rate=0.01, wd=1e-3, rescale_grad=0.125,
                    clip_gradient=0.2)
GLUON_OPT_LR_MULT = {1: 0.5}
GLUON_OPTIMIZERS = [
    ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}), ("adam", {}),
    ("adagrad", {}), ("adadelta", {}), ("rmsprop", {}),
    ("rmsprop", {"centered": True, "clip_weights": 0.5}), ("ftrl", {}),
    ("ftml", {}), ("signsgd", {}), ("signum", {}), ("lamb", {}),
    ("lamb", {"lower_bound": 0.1, "upper_bound": 10.0}), ("nadam", {}),
    ("adamax", {}), ("test", {})]
# (b): GluonNLP's BERT pretraining step: LAMB, a warm-up poly schedule,
# weight decay 0.01 but none on LayerNorm and biases, clip to norm 1
GLUON_BERT_OPT = {"learning_rate": 1e-3, "wd": 0.01}
GLUON_BERT_SCHEDULE = dict(max_update=1000, pwr=1, warmup_steps=10,
                           warmup_begin_lr=0.0)
GLUON_CLIP = 1.0
GLUON_NO_WD = ".*gamma|.*beta|.*bias"
# a tensor's gradient in the fp64 step is rounding noise below this share
# of the largest gradient (lamb_scales)
GRAD_NOISE = 1e-9
# LAMB divides each gradient entry by its size plus epsilon, so an entry
# that is small against its own rounding error carries the gradient's
# rounding into the step at full size (the worst tensors: the FFN and
# attention weights).  Measured on the CPU (a 2-layer BERT, batch 8 x 128),
# the fp32 step against the fp64 step by BERT_FP32_BOUND's measure:
# 9.3e-4 at hidden 32, 1.0e-3 at 128, 1.7e-3 at 256, so that bound
# cannot hold at hidden 768.  The card's fp32 step is held within this
# factor of the CPU's fp32 step's deviation instead, tensor by tensor, as
# the bf16 check is.  The card's fp32 gradients carry about twice the
# CPU's rounding (bert_recipe_check logs both), and a tensor's reading is
# that of its worst entry, so the worst of ~200 tensors reads 1.7-3.5x the
# CPU's over seeds (--gluon-bert-seeds); TF32 matmuls read > 1000x and
# the reference's multiplier lookup ~17x
GLUON_FP32_NOISE_FACTOR = 6.0
# (c): float16 dynamic loss scaling on a BERT-base-width FFN
GLUON_FP16_SCALE = 2.0 ** 10
# (d): the timed run, bench.py's BERT batch; LAMB's own lr
GLUON_TIMED_OPT = {"learning_rate": 2e-3, "wd": 0.01}
GLUON_TIMED_SCHEDULE = dict(max_update=100, pwr=1, warmup_steps=4,
                            warmup_begin_lr=2e-4)
# (e): GluonCV's ResNet-50 v1 ImageNet recipe
GLUON_CV_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
GLUON_CV_SCHEDULE = dict(max_update=1000, final_lr=0.0, warmup_steps=5,
                         warmup_begin_lr=0.0)
GLUON_LABEL_SMOOTHING = 0.1

# profiler ranges of bert_recipe_step, reported apart in (d)'s profile
GLUON_RANGES = ("trainer.step", "clip_global_norm")


def _opt_tensors(seed, device, shapes):
    """Weights (N(0, 0.02), BERT's init) and GLUON_OPT_STEPS gradients
    (N(0, 1)) of ``shapes``, drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    weights = [0.02 * torch.randn(s, generator=g, device=device)
               for s in shapes]
    grads = [[torch.randn(s, generator=g, device=device) for s in shapes]
             for _ in range(GLUON_OPT_STEPS)]
    return weights, grads


def optimizer_updates(name, params, weights, grads):
    """GLUON_OPT_STEPS updates of the port's optimizer ``name`` (under
    GLUON_OPT_KW, a warm-up PolyScheduler and GLUON_OPT_LR_MULT) through
    its Updater, from copies of ``weights``: the weights after."""
    from mxnet_tpu_torch import lr_scheduler, optimizer
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    kw = dict(GLUON_OPT_KW, **params)
    kw["lr_scheduler"] = lr_scheduler.PolyScheduler(
        max_update=20, base_lr=0.01, pwr=2, warmup_steps=2,
        warmup_begin_lr=0.001)
    opt = optimizer.create(name, **kw)
    opt.set_lr_mult(GLUON_OPT_LR_MULT)
    updater = optimizer.get_updater(opt)
    ws = [NDArray._wrap(w.clone()) for w in weights]
    for step in grads:
        for i, (w, g) in enumerate(zip(ws, step)):
            updater(i, NDArray._wrap(g), w)
    return [w._data for w in ws], opt


def planted_optimizer_fault(fault):
    """Context manager: "lamb_ratio_1" (LAMB's trust ratio forced to 1)
    or "reference_lookup" (the optimizer looks Parameters up in
    param_dict by name, as the reference does, so that through Trainer
    every multiplier is 1)."""
    from mxnet_tpu_torch.optimizer import optimizer as opt_mod

    if fault == "lamb_ratio_1":
        return patched(opt_mod, "lamb_trust_ratio",
                       lambda r1, r2: torch.ones_like(r1))

    def reference_lookup(self, index, attr, table):
        name = self.idx2name.get(index,
                                 index if isinstance(index, str) else None)
        if name in self.param_dict:
            return getattr(self.param_dict[name], attr)
        if index in table:
            return table[index]
        return table.get(name, 1.0) if name is not None else 1.0

    return patched(opt_mod.Optimizer, "_mult", reference_lookup)


def gluon_optimizer_checks(seed, device="cuda", shapes=GLUON_OPT_SHAPES,
                           fault=None, only=None):
    """(a) Every registered optimizer: GLUON_OPT_STEPS updates on
    ``device`` against the same on the CPU from the same tensors (drawn
    on ``device``), max |difference| / max(1, max |CPU|) within OP_TOL;
    ``fault`` planted on ``device``'s side only; ``only`` restricts the
    run to that optimizer.  SGLD: one update's noise (the update less its
    deterministic part, over sqrt(lr)) by the KS statistic against N(0,
    1).  Returns {label: deviation}."""
    import scipy.stats

    weights, grads = _opt_tensors(seed, device, shapes)
    cpu_w = [w.cpu() for w in weights]
    cpu_g = [[g.cpu() for g in step] for step in grads]
    devs = {}
    for name, params in GLUON_OPTIMIZERS:
        if only not in (None, name):
            continue
        label = name + "".join(f" {k}={v}" for k, v in params.items())
        want, _ = optimizer_updates(name, params, cpu_w, cpu_g)
        ctx = planted_optimizer_fault(fault) if fault else \
            contextlib.nullcontext()
        with ctx:
            got, _ = optimizer_updates(name, params, weights, grads)
        devs[label] = max(
            ((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1.0))
            .item() for a, b in zip(got, want))
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"{label}: non-finite weights on {device}")
    for label, dev in devs.items():
        check(dev <= OP_TOL, f"optimizer {label}: {device} deviates "
                             f"{dev:.3e} from the CPU (OP_TOL {OP_TOL:g})")
    if only not in (None, "sgld"):
        return devs
    # SGLD: w' = w - lr / 2 * (clip(rescale * g) + wd * w) + sqrt(lr) * n
    got, opt = optimizer_updates("sgld", {}, weights, grads[:1])
    w, g = weights[0].double(), grads[0][0].double()
    lr, wd = opt._get_lr(0), opt._get_wd(0)
    g = (g * GLUON_OPT_KW["rescale_grad"]).clamp(
        -GLUON_OPT_KW["clip_gradient"], GLUON_OPT_KW["clip_gradient"])
    noise = (got[0].double() - w + lr / 2 * (g + wd * w)) / math.sqrt(lr)
    ks, bound = distribution_check("sgld noise", noise,
                                   scipy.stats.norm(), True)
    devs["sgld (KS statistic)"] = ks
    log(f"  sgld's noise over {noise.numel()} draws: KS {ks:.3e} (bound "
        f"{bound:.3e})")
    return devs


def bert_labels(labels):
    """bench.py's labels as the MLM targets and the NSP label."""
    return labels[:, :-1], labels[:, -1]


def bert_recipe_trainer(net, opt=GLUON_BERT_OPT,
                        schedule=GLUON_BERT_SCHEDULE):
    """GluonNLP's pretraining Trainer: LAMB under a warm-up PolyScheduler,
    no weight decay on LayerNorm parameters and biases."""
    from mxnet_tpu_torch import gluon, lr_scheduler

    net.collect_params(GLUON_NO_WD).setattr("wd_mult", 0.0)
    sched = lr_scheduler.PolyScheduler(base_lr=opt["learning_rate"],
                                       **schedule)
    return gluon.Trainer(net.collect_params(), "lamb",
                         dict(opt, lr_scheduler=sched))


def bert_recipe_step(net, trainer, ids, mlm, nsp, metrics=(), times=None,
                     loss_block=None, before_step=None, clip_check=None):
    """One GluonNLP step: record -> amp.scale_loss -> backward ->
    amp.unscale -> clip_global_norm(GLUON_CLIP) -> trainer.step; the MLM
    and NSP accuracies and the loss into ``metrics``.  With ``times`` (a
    dict), the card is synchronised between the parts and each part's
    wall ms is added to ``times[part]``.  ``loss_block`` (a
    BertRecipeLoss over ``net``, hybridized) computes the model and the
    loss in one call.  ``before_step(loss)`` runs between the clip and
    ``trainer.step`` (phase 13's guard: a planted gradient, the staged
    loss).  ``clip_check=False`` turns the clip's finiteness check off (a
    guarded loop leaves the non-finite verdict to the guard).  Returns
    (the loss NDArray, the global norm before the clip)."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.contrib import amp

    clock = [time.perf_counter()]

    def lap(part):
        if times is not None:
            torch.cuda.synchronize()
            now = time.perf_counter()
            times[part] = times.get(part, 0.0) + 1e3 * (now - clock[0])
            clock[0] = now

    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    lap("start")
    with autograd.record():
        if loss_block is None:
            mlm_out, nsp_out = net(ids)
            loss = ce(mlm_out, mlm).mean() + ce(nsp_out, nsp).mean()
        else:
            loss, mlm_out, nsp_out = loss_block(ids, mlm, nsp)
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
    lap("forward and backward")
    amp.unscale(trainer)
    # under dynamic loss scaling an overflow is expected: the scaler finds
    # it and skips the step, as GluonNLP's fp16 trainer does
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    with torch.profiler.record_function(GLUON_RANGES[1]):
        if clip_check is None:
            clip_check = scaler is None or not scaler._dynamic
        norm = gluon.utils.clip_global_norm(
            [p.grad() for p in params], GLUON_CLIP,
            check_isfinite=clip_check)
    lap("unscale and clip_global_norm")
    if before_step is not None:
        before_step(loss)
    with torch.profiler.record_function(GLUON_RANGES[0]):
        trainer.step(1)
    lap("trainer.step")
    for m, label, pred in zip(metrics, (mlm, nsp, None),
                              (mlm_out, nsp_out, loss)):
        m.update([label], [pred])
    lap("metrics")
    return loss, norm


def gluon_step_result(net, run, params=None):
    """(loss, the parameters before, after) of ``run()`` (one training
    step of ``net`` in place, returning its loss), in collect_params()
    order on the host; the parameters are put back after, so that the
    next step starts from the same weights."""
    params = list((params or net.collect_params()).values())
    before = [_host(p.data()._data) for p in params]
    loss = float(run())
    after = [_host(p.data()._data) for p in params]
    for p, b in zip(params, before):
        p.set_data(b.to(p.data()._data.device))
    return loss, before, after


def bert_recipe_result(net, ids, labels, amp_dtype=None, info=None,
                       fp32_ops=None, scaler=None):
    """One recipe step of ``net`` (a fresh Trainer, so a first update),
    under ``amp.init(amp_dtype, fp32_ops=fp32_ops)`` + ``init_trainer(
    trainer, scaler)`` when given: (loss, before, after) as
    gluon_step_result.  ``info`` (a dict) gets the
    step's learning rate ("lr"), each parameter's largest gradient after
    the clip ("grad_max") and the gradients themselves, on the host in
    fp64 ("grads")."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp

    ctx = next(iter(net.collect_params().values())).data().context
    mlm, nsp = bert_labels(labels)
    args = [mx.nd.array(a, ctx=ctx, dtype="int32") for a in (ids, mlm, nsp)]
    trainer = bert_recipe_trainer(net)
    if amp_dtype:
        amp.init(amp_dtype, fp32_ops=fp32_ops)
        amp.init_trainer(trainer, scaler)
    try:
        result = gluon_step_result(net, lambda: bert_recipe_step(
            net, trainer, *args)[0].asscalar())
    finally:
        amp.disable()
    if info is not None:
        info["lr"] = trainer.learning_rate
        info["grad_max"] = [p.grad()._data.abs().max().item()
                            if p.grad_req != "null" else 0.0
                            for p in net.collect_params().values()]
        info["grads"] = [p.grad()._data.to("cpu", torch.float64)
                         if p.grad_req != "null" else None
                         for p in net.collect_params().values()]
    return result


def lamb_scales(scales, info, noise=GRAD_NOISE):
    """``scales`` (update_scales or noise_scales of a LAMB step) with the
    step's learning rate as the floor of every tensor whose gradient in
    the fp64 step is rounding noise (largest entry at most ``noise`` of
    the largest gradient, not exactly 0; BERT's key-projection biases,
    whose gradient is zero, as softmax ignores a shift of a query's
    scores).  LAMB
    divides a gradient by its own size plus epsilon, so on such a tensor
    it steps by up to lr in a direction set by rounding, whatever the
    arithmetic's precision: fp32's noise against fp64's, not a fault."""
    top = max(info["grad_max"])
    return [max(s, info["lr"]) if i and 0 < info["grad_max"][i - 1]
            <= noise * top else s for i, s in enumerate(scales)]


def bert_recipe_check(cfg, seed, device="cuda", batch=BERT_CHECK_BATCH,
                      seq=BERT_SEQ, check_bounds=True, controls=False):
    """(b) GluonNLP's BERT pretraining step through gluon.Trainer on
    ``device`` (fp32, and bf16 under amp) against the CPU's fp64 step:
    fp32 within GLUON_FP32_NOISE_FACTOR of the CPU's fp32 step's
    deviation, bf16 within GLUON_BF16_NOISE_FACTOR of the CPU's bf16 step's
    (both with lamb_scales' floor) with a loss that is not a bf16 number,
    the planted fault "reference_lookup" and, on the card, TF32 matmuls
    beyond the fp32 bound, fp16 in place of bf16 and bf16 weights without
    an fp32 master copy beyond the bf16 bound, and AMP's fp32 list
    dropped giving a bf16 loss.  ``controls`` also reads the attention's
    scale off by BF16_SCALE_FAULT, which no bound catches.
    Every reading of a precision is logged before its checks;
    ``check_bounds=False`` skips the bf16 checks (``--gluon-bert-seeds``
    reads their spread).  Returns the readings and flash_attn_fwd's
    launches in the fp32 step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    ctx = mx.gpu(0) if torch.device(device).type == "cuda" else mx.cpu()
    net = init_bert(cfg, seed, ctx, seq)
    names = list(net.collect_params())
    ids, labels = bert_batch(seed, batch, seq, cfg.vocab_size)
    cpu_net = copy_bert(net, cfg, mx.cpu())
    t0 = time.perf_counter()
    card_info, cpu32_info = {}, {}
    cpu32 = bert_recipe_result(cpu_net, ids, labels, info=cpu32_info)
    cpu16 = bert_recipe_result(cpu_net, ids, labels, "bfloat16")
    t1 = time.perf_counter()
    info = {}
    cpu64 = bert_recipe_result(cpu_net.double(), ids, labels, info=info)
    log(f"  CPU steps: fp32 and bf16 {t1 - t0:.1f} s, fp64 "
        f"{time.perf_counter() - t1:.1f} s")
    del cpu_net
    top = max(info["grad_max"])
    noisy = [n for n, g in zip(names, info["grad_max"])
             if 0 < g <= GRAD_NOISE * top]
    log(f"  the step's lr {info['lr']:.3e}; tensors whose fp64 gradient "
        f"is rounding noise (<= {GRAD_NOISE:g} of the largest, "
        f"{top:.3e}), held to lr: {noisy}")
    scales = lamb_scales(update_scales(cpu64, names), info)
    fa_mod._flash_fwd_cuda.launches = 0
    card = bert_recipe_result(net, ids, labels, info=card_info)
    launches = fa_mod._flash_fwd_cuda.launches
    out = {"launches": launches, "noisy": noisy}
    for what, cand in ((device, card), ("CPU", cpu32)):
        ratio, where = compare_steps(cand, cpu64, names, scales)
        out[f"fp32 {what} of the update"] = ratio
        log(f"  {what}'s fp32 step vs the fp64 step: {ratio:.3e} of the "
            f"update ({where}; phase 6's measure)")
    # the gradients' own rounding (after the clip, which every precision
    # computes to ~1e-8), tensor by tensor, the noise tensors left out
    gerr = {}
    for what, got in ((device, card_info), ("CPU", cpu32_info)):
        errs = sorted((g - r).norm().item() / r.norm().item() for n, g, r in
                      zip(names, got["grads"], info["grads"])
                      if r is not None and r.norm().item() > 0
                      and n not in noisy)
        gerr[what] = errs[len(errs) // 2]
    out["grad noise"] = gerr[device] / gerr["CPU"]
    log(f"  fp32 gradients vs the fp64 step's, relative L2 error of the "
        f"median tensor: {device} {gerr[device]:.3e}, CPU {gerr['CPU']:.3e} "
        f"({out['grad noise']:.2f}x)")
    scales32 = lamb_scales(noise_scales(cpu32, cpu64, names), info)
    out["fp32"], where32 = compare_steps(card, cpu64, names, scales32)
    log(f"  fp32, {device} vs the fp64 step: worst deviation "
        f"{out['fp32']:.3e} of the CPU's fp32 deviation ({where32}), bound "
        f"{GLUON_FP32_NOISE_FACTOR:g}; loss {card[0]:.9f} vs "
        f"{cpu64[0]:.9f}")
    ratios = sorted(d / sc for (_, d), sc in
                    zip(step_deviations(card, cpu64, names), scales32))
    out["fp32 median"] = ratios[len(ratios) // 2]
    log(f"  fp32, {device}'s deviation over the CPU's, tensor by tensor: "
        f"median {out['fp32 median']:.3f}, 90th percentile "
        f"{ratios[9 * len(ratios) // 10]:.3f}, worst {ratios[-1]:.3f} "
        f"({len(ratios)} entries)")
    if torch.device(device).type == "cuda":
        # a lower precision must fail the fp32 bound: TF32 matmuls
        with patched(torch.backends.cuda.matmul, "allow_tf32", True), \
                patched(torch.backends.cudnn, "allow_tf32", True):
            out["tf32"], where = compare_steps(
                bert_recipe_result(net, ids, labels), cpu64, names, scales32)
        log(f"  fp32 with TF32 matmuls (planted): {out['tf32']:.3e} of the "
            f"CPU's fp32 deviation at {where}")
    with planted_optimizer_fault("reference_lookup"):
        out["fault"], where = compare_steps(
            bert_recipe_result(net, ids, labels), cpu64, names, scales32)
    log(f"  fp32 with the reference's param_dict lookup (multipliers "
        f"ignored): {out['fault']:.3e} of the CPU's fp32 deviation at "
        f"{where}")
    check(out["fp32"] <= GLUON_FP32_NOISE_FACTOR,
          f"fp32, {device} vs the fp64 step: deviation {out['fp32']:.3e} "
          f"at {where32} exceeds {GLUON_FP32_NOISE_FACTOR:g}")
    check(out.get("tf32", math.inf) > GLUON_FP32_NOISE_FACTOR,
          "the Gluon BERT check misses TF32 matmuls")
    check(out["fault"] > GLUON_FP32_NOISE_FACTOR,
          "the Gluon BERT check misses the ignored multipliers")
    card16 = bert_recipe_result(net, ids, labels, "bfloat16")
    check(all(t.dtype == torch.float32 for t in card16[2]),
          "the bf16 step's master weights are not fp32")
    for what, cand in ((device, card16), ("CPU", cpu16)):
        ratio, where = compare_steps(cand, cpu64, names, scales)
        log(f"  {what}'s bf16 step vs the fp64 step: {ratio:.3e} of the "
            f"update ({where})")
    scales16 = lamb_scales(noise_scales(cpu16, cpu64, names), info)
    # planted bf16 faults, read like the bf16 step, each beyond a bound:
    # fp16 in place of bf16 (no loss scaling: small gradients flush to
    # zero) and the updated weights kept in bf16 (no fp32 master copy: a
    # precision loss in the step itself) beyond the worst-entry bound;
    # AMP's fp32 list dropped (softmax, log_softmax and the loss's
    # reductions in bf16) makes the loss a bf16 number, and changes the
    # step by no more than bf16's own noise.  With ``controls``, the
    # attention's scale off by one bf16 ulp at 1.0, which LAMB's first
    # step hides in bf16's own noise, is read beside them
    from mxnet_tpu_torch.contrib import amp

    runs = [("bf16", f"bf16, {device}",
             lambda: card16),
            ("fp16", "fp16 in place of bf16, unscaled (planted)",
             lambda: bert_recipe_result(
                 net, ids, labels, "float16",
                 scaler=amp.LossScaler(dynamic=False))),
            ("master", "bf16 with the updated weights kept in bf16 "
                       "(planted)",
             lambda: (card16[0], card16[1],
                      [a.to(torch.bfloat16).to(a.dtype) for a in card16[2]])),
            ("fp32 list", "bf16 with AMP's fp32 list empty (planted)",
             lambda: bert_recipe_result(net, ids, labels, "bfloat16",
                                        fp32_ops=[]))]

    def scale_fault():
        with planted_attention_scale(BF16_SCALE_FAULT):
            return bert_recipe_result(net, ids, labels, "bfloat16")

    if controls:
        runs.append(("scale", f"bf16 with the attention's scale off by "
                              f"{BF16_SCALE_FAULT - 1:g} (planted)",
                     scale_fault))
    r16 = out["bf16 readings"] = {}
    for key, what, run in runs:
        step = run()
        r = r16[key] = step_readings(step, cpu64, names, scales16)
        r["loss in bf16"] = is_bf16_value(step[0])
        log(f"  {what} vs the fp64 step, over the CPU's bf16 deviation: "
            f"worst {r['worst']:.3e} ({r['where']}), loss {r['loss']:.3e} "
            f"(relative gap {r['loss gap']:.3e}; the loss {step[0]!r} "
            f"{'is' if r['loss in bf16'] else 'is not'} a bf16 number), "
            f"median tensor {r['median']:.3e}")
    out["bf16"] = r16["bf16"]["worst"]
    log(f"  bound: worst {GLUON_BF16_NOISE_FACTOR:g}; the loss must not be "
        f"a bf16 number")
    if check_bounds:
        check(r16["bf16"]["worst"] <= GLUON_BF16_NOISE_FACTOR,
              f"bf16, {device} vs the fp64 step: deviation "
              f"{r16['bf16']['worst']:.3e} at {r16['bf16']['where']} "
              f"exceeds {GLUON_BF16_NOISE_FACTOR:g}")
        check(not r16["bf16"]["loss in bf16"],
              f"bf16, {device}: the loss {card16[0]!r} is a bf16 number "
              f"(AMP's fp32 list did not hold its reductions)")
        for key in ("fp16", "master"):
            check(r16[key]["worst"] > GLUON_BF16_NOISE_FACTOR,
                  f"the Gluon BERT check misses the planted {key} fault")
        check(r16["fp32 list"]["loss in bf16"],
              "the Gluon BERT check misses AMP's fp32 list dropped")
    return out


def loss_scale_check(seed, device="cuda", cfg=None, batch=BERT_CHECK_BATCH,
                     seq=BERT_SEQ):
    """(c) float16 dynamic loss scaling (``amp.init("float16")``,
    ``init_trainer`` with scale_window 2) on GluonNLP's BERT-base step
    (``cfg``, default BERT-base at dropout 0; the attention in the
    kernel's fp16 instance on the card): the first clean step leaves the
    scale as it is, the second doubles it; a step with inf planted in a
    gradient changes no weight (bit for bit) and halves it.  Returns the
    scales and flash_attn_fwd's launches over the three steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.language import bert
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    ctx = mx.gpu(0) if torch.device(device).type == "cuda" else mx.cpu()
    cfg = cfg or bert.BertConfig(dropout=0.0)
    net = init_bert(cfg, seed, ctx, seq)
    ids, labels = bert_batch(seed, batch, seq, cfg.vocab_size)
    mlm, nsp = bert_labels(labels)
    ids, mlm, nsp = (mx.nd.array(a, ctx=ctx, dtype="int32")
                     for a in (ids, mlm, nsp))
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    params = list(net.collect_params().values())
    amp.init("float16")
    try:
        trainer = bert_recipe_trainer(net)
        amp.init_trainer(trainer, amp.LossScaler(
            init_scale=GLUON_FP16_SCALE, scale_window=2))
        scales = []
        fa_mod._flash_fwd_cuda.launches = 0
        for step in range(3):
            with autograd.record():
                mlm_out, nsp_out = net(ids)
                loss = ce(mlm_out, mlm).mean() + ce(nsp_out, nsp).mean()
                with amp.scale_loss(loss, trainer) as scaled:
                    scaled.backward()
            if step == 2:
                params[0].grad()[0, 0] = float("inf")
            before = [p.data()._data.clone() for p in params]
            amp.unscale(trainer)
            trainer.step(1)
            scales.append(trainer._amp_loss_scaler.loss_scale)
            moved = [not torch.equal(b, p.data()._data)
                     for b, p in zip(before, params)]
            if step < 2:
                check(moved[0] and sum(moved) > len(moved) // 2,
                      f"fp16 step {step} moved {sum(moved)} of "
                      f"{len(moved)} tensors")
            else:
                check(not any(moved), "a step with an inf gradient changed "
                                      "the weights")
        launches = fa_mod._flash_fwd_cuda.launches
    finally:
        amp.disable()
    log(f"  fp16 loss scale after a clean step, a clean step, an inf "
        f"gradient: {scales} (start {GLUON_FP16_SCALE:g}, window 2); "
        f"the skipped step left every weight unchanged; flash_attn_fwd "
        f"launches {launches}")
    want = [GLUON_FP16_SCALE, 2 * GLUON_FP16_SCALE, GLUON_FP16_SCALE]
    check(scales == want, f"fp16 loss scales {scales}, expected {want}")
    check(trainer.step_count == 2, "the overflow step was counted")
    return scales, launches


def resnet_recipe_trainer(net):
    """GluonCV's ImageNet Trainer: NAG under a warm-up CosineScheduler, no
    weight decay on BatchNorm and biases."""
    from mxnet_tpu_torch import gluon, lr_scheduler

    net.collect_params(GLUON_NO_WD).setattr("wd_mult", 0.0)
    sched = lr_scheduler.CosineScheduler(
        base_lr=GLUON_CV_OPT["learning_rate"], **GLUON_CV_SCHEDULE)
    return gluon.Trainer(net.collect_params(), "nag",
                         dict(GLUON_CV_OPT, lr_scheduler=sched))


def resnet_recipe_result(net, x, y, classes=1000):
    """One step of GluonCV's ImageNet recipe on ``net`` (fresh Trainer:
    NAG under a warm-up CosineScheduler, no weight decay on BatchNorm and
    biases, label smoothing, TopKAccuracy(5)): (loss, before, after)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, metric

    params = net.collect_params()
    ctx = next(iter(params.values())).data().context
    dtype = next(iter(params.values())).data()._data.dtype
    trainer = resnet_recipe_trainer(net)
    eps = GLUON_LABEL_SMOOTHING
    smooth = np.full((len(y), classes), eps / classes)
    smooth[np.arange(len(y)), y] += 1 - eps
    X = mx.nd.array(torch.from_numpy(x).to(dtype), ctx=ctx)
    Y = mx.nd.array(torch.from_numpy(smooth).to(dtype), ctx=ctx)
    ce = gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)
    top5 = metric.TopKAccuracy(5)

    def run():
        with autograd.record():
            out = net(X)
            loss = ce(out, Y)
        loss.backward()
        trainer.step(len(x))
        top5.update([mx.nd.array(y, ctx=ctx)], [out])
        return loss.mean().asscalar()

    result = gluon_step_result(net, run, params)
    check(0.0 <= top5.get()[1] <= 1.0, "TopKAccuracy(5) out of range")
    return result


def resnet_recipe_check(make_net, seed, device="cuda", batch=CHECK_BATCH,
                        size=TRAIN_SIZE, classes=1000):
    """(e) GluonCV's ResNet recipe, one step at ``batch``: fp32 on
    ``device`` against the CPU's fp64 step within FP32_STEP_BOUND, and
    with the scheduler ignored (the base lr from the first update, no
    warm-up) beyond it.  Returns (ratio, fault ratio)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.optimizer import optimizer as opt_mod

    ctx = mx.gpu(0) if torch.device(device).type == "cuda" else mx.cpu()
    net = init_net(make_net, seed, ctx, size)
    names = list(net.collect_params())
    x, y = train_batch(seed, batch, size, classes)
    cpu_net = copy_net(net, make_net, mx.cpu(), size).double()
    t0 = time.perf_counter()
    cpu64 = resnet_recipe_result(cpu_net, x.astype(np.float64), y, classes)
    log(f"  CPU fp64 step: {time.perf_counter() - t0:.1f} s")
    del cpu_net
    card = resnet_recipe_result(net, x, y, classes)
    check(all(bool(torch.isfinite(t).all()) for t in card[2]),
          "non-finite parameters after the GluonCV step")
    ratio = check_steps(card, cpu64, names, f"fp32 {device} vs the fp64 "
                        f"CPU step (NAG, cosine warm-up, label smoothing)",
                        FP32_STEP_BOUND)
    no_sched = lambda self, index: self.lr * self._mult(   # noqa: E731
        index, "lr_mult", self.lr_mult)
    with patched(opt_mod.Optimizer, "_get_lr", no_sched):
        fault, where = compare_steps(resnet_recipe_result(net, x, y,
                                                          classes),
                                     cpu64, names)
    log(f"  with the scheduler ignored: {fault:.3e} at {where}")
    check(fault > FP32_STEP_BOUND, "the GluonCV check misses an ignored "
                                   "warm-up")
    return ratio, fault


def gluon_timed_run(seed, trainstep_samples_s=None):
    """(d) BERT-base at bench.py's batch, AMP bf16, dropout 0.1, the
    recipe (LAMB + poly warm-up + unscale + clip) with the MLM and NSP
    accuracies and the loss metric every step: GLUON_WARMUP +
    BERT_STEPS steps, samples/s, MFU, peak memory, a profile by kernel
    group with the optimizer and clip_global_norm apart.  Returns
    flash_attn_fwd's launches over the steps."""
    import types

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.language import bert
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    cfg = bert.BertConfig()
    net = init_bert(cfg, seed, mx.gpu(0))
    ids, labels = bert_batch(seed, BERT_BATCH, BERT_SEQ, cfg.vocab_size)
    mlm, nsp = bert_labels(labels)
    args = [mx.nd.array(a, ctx=mx.gpu(0), dtype="int32")
            for a in (ids, mlm, nsp)]
    trainer = bert_recipe_trainer(net, GLUON_TIMED_OPT, GLUON_TIMED_SCHEDULE)
    metrics = [metric.Accuracy(axis=-1, name="mlm_accuracy"),
               metric.Accuracy(name="nsp_accuracy"), metric.Loss()]
    amp.init()
    try:
        amp.init_trainer(trainer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa_mod._flash_fwd_cuda.launches = 0
        losses, norms = [], []
        t0 = time.perf_counter()
        for i in range(BERT_WARMUP + BERT_STEPS):
            if i == BERT_WARMUP:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            loss, norm = bert_recipe_step(net, trainer, *args, metrics)
            losses.append(loss)
            norms.append(norm)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches = fa_mod._flash_fwd_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        losses = [v.asscalar() for v in losses]
        log(f"  losses: {' '.join(f'{v:.4f}' for v in losses)}")
        log(f"  global norms before the clip: "
            f"{' '.join(f'{v:.3f}' for v in norms)}")
        log("  metrics: " + ", ".join(f"{n} {v:.4f}" for m in metrics
                                      for n, v in m.get_name_value()))
        check(all(math.isfinite(v) for v in losses), "non-finite loss")
        check(losses[-1] < losses[0], "the Gluon BERT loss did not fall")
        n_steps = BERT_WARMUP + BERT_STEPS
        check(launches == cfg.num_layers * n_steps,
              f"flash_attn_fwd launched {launches} times in {n_steps} "
              f"steps, expected {cfg.num_layers * n_steps}")
        samples_s = BERT_BATCH * BERT_STEPS / dt
        n_mm = matmul_params(types.SimpleNamespace(params={
            k: p.data()._data for k, p in net.collect_params().items()}))
        mfu = samples_s * 6.0 * n_mm * BERT_SEQ / \
            PEAK_FLOPS[torch.bfloat16]
        ts = "not run" if trainstep_samples_s is None else \
            f"{trainstep_samples_s:.1f} samples/s"
        log(f"  [{gpu_line()}] Gluon recipe (Trainer, LAMB, AMP bf16, "
            f"clip, metrics): {samples_s:.1f} samples/s, "
            f"{1e3 * dt / BERT_STEPS:.2f} ms/step over {BERT_STEPS} steps "
            f"(warm-up {BERT_WARMUP} steps {t1 - t0:.2f} s), MFU "
            f"{100 * mfu:.2f}% (bench.py's count), peak memory "
            f"{peak / 2**30:.3f} GiB; phase 6 (d)'s TrainStep-Adam in this "
            f"run: {ts}; flash_attn_fwd launches {launches}")
        ops = log_device_profile(
            lambda: [bert_recipe_step(net, trainer, *args, metrics)
                     for _ in range(3)],
            BERT_KERNEL_GROUPS, n_top=12, label=GLUON_RANGES, steps=3,
            step_ms=1e3 * dt / BERT_STEPS)
        if ops:
            n_params = len(trainer._params)
            log(f"  trainer.step: {ops[GLUON_RANGES[0]]:.1f} device ops a "
                f"step over {n_params} parameters = "
                f"{ops[GLUON_RANGES[0]] / n_params:.2f} a parameter")
        times = {}
        for _ in range(3):
            bert_recipe_step(net, trainer, *args, metrics, times)
        times.pop("start")
        log("  wall ms a step by part, the card synchronised between "
            "them (3 steps): " + ", ".join(
                f"{part} {ms / 3:.2f}" for part, ms in times.items()))
    finally:
        amp.disable()
    del net, trainer
    torch.cuda.empty_cache()
    return launches


def gluon_train_phase(seed, trainstep_samples_s=None):
    """Phase 9: (a) to (e); returns flash_attn_fwd's launches over (d)'s
    steps, the gluon_bert_lamb path."""
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    t0 = time.perf_counter()
    log(f"== gluon train 1: every registered optimizer, {GLUON_OPT_STEPS} "
        f"updates over {GLUON_OPT_SHAPES} fp32 ({GLUON_OPT_KW}, a warm-up "
        f"PolyScheduler, lr_mult {GLUON_OPT_LR_MULT}), card against CPU "
        f"within {OP_TOL:g}")
    devs = gluon_optimizer_checks(seed)
    for label, dev in devs.items():
        log(f"    {dev:.3e}  {label}")
    try:
        gluon_optimizer_checks(seed, fault="lamb_ratio_1", only="lamb")
    except SystemExit as e:
        log(f"  planted LAMB trust ratio 1: fails ({e})")
    else:
        check(False, "the optimizer check passed LAMB with its trust "
                     "ratio forced to 1")
    t1 = time.perf_counter()
    log(f"  (a) {t1 - t0:.1f} s")

    log(f"== gluon train 2: GluonNLP's BERT pretraining step through "
        f"gluon.Trainer (LAMB {GLUON_BERT_OPT}, PolyScheduler "
        f"{GLUON_BERT_SCHEDULE}, wd_mult 0 on {GLUON_NO_WD!r}, scale_loss "
        f"-> backward -> unscale -> clip_global_norm({GLUON_CLIP:g})), "
        f"batch {BERT_CHECK_BATCH} x {BERT_SEQ}, dropout 0")
    out = bert_recipe_check(bert.BertConfig(dropout=0.0), seed)
    log(f"  flash_attn_fwd launches in one recipe step: {out['launches']}")
    check(out["launches"] == bert.BertConfig().num_layers,
          f"flash_attn_fwd launched {out['launches']} times in a step")
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    log(f"  (b) {t2 - t1:.1f} s")

    log("== gluon train 3: float16 dynamic loss scaling on GluonNLP's "
        "BERT-base step (the attention in the kernel's fp16 instance)")
    _, n16 = loss_scale_check(seed)
    check(n16 == 3 * bert.BertConfig().num_layers,
          f"flash_attn_fwd launched {n16} times in 3 fp16 steps")
    t3 = time.perf_counter()
    log(f"  (c) {t3 - t2:.1f} s")

    log(f"== gluon train 4: the recipe timed, BertForPretraining at batch "
        f"{BERT_BATCH} x {BERT_SEQ}, AMP bf16, dropout 0.1, LAMB "
        f"{GLUON_TIMED_OPT}, metrics every step")
    launches = gluon_timed_run(seed, trainstep_samples_s)
    t4 = time.perf_counter()
    log(f"  (d) {t4 - t3:.1f} s")

    log(f"== gluon train 5: GluonCV's ResNet-50 v1 recipe through "
        f"gluon.Trainer (NAG {GLUON_CV_OPT}, CosineScheduler "
        f"{GLUON_CV_SCHEDULE}, wd_mult 0 on BatchNorm and biases, label "
        f"smoothing {GLUON_LABEL_SMOOTHING}, TopKAccuracy(5)), batch "
        f"{CHECK_BATCH}, {TRAIN_SIZE}x{TRAIN_SIZE}")
    resnet_recipe_check(resnet50, seed)
    torch.cuda.empty_cache()
    log(f"  (e) {time.perf_counter() - t4:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 10: persistence and preemption
# ---------------------------------------------------------------------------
# (a): the reference's type table and a 0-d array
PERSIST_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
                  torch.uint8, torch.int32, torch.int8, torch.int64,
                  torch.bool)
# (b), (c): GluonNLP's BERT-base recipe (bert_recipe_trainer and
# bert_recipe_step) under amp.init("float16") at batch 8 x 128, dropout
# 0.1.  The dynamic scaler starts at 2^10 (phase 9 (c)'s) with a window of
# 2, so that its scale doubles every 2 clean steps within the run:
# GluonNLP's 2^16 and 2000 would leave it at its start for 8 steps (or,
# after an overflow, back at it), and a lost scale would not show
RESUME_BATCH, RESUME_STEPS, RESUME_STOP = 8, 8, 4
RESUME_SAVES = (2,)            # async saves after these steps
RESUME_SCALE, RESUME_SCALE_WINDOW = GLUON_FP16_SCALE, 2
RESUME_SIGTERM_AFTER = 3       # (c): SIGTERM once the child logged 3 steps
RESUME_TIMEOUT = 600           # seconds: each child of (c)
# the CPU tests' BERT
RESUME_TINY = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, max_position=32)
RESUME_TINY_SEQ, RESUME_TINY_BATCH = 8, 2
# (d): TrainStep.run at bench.py's BERT configuration
RUN_STEPS, RUN_STOP_AFTER, RUN_PREFETCH = 8, 3, 2
# (e): Estimator.fit over GluonCV's ResNet-50 recipe, stopped after batch 2
FIT_BATCHES, FIT_STOP_AFTER = 4, 2


def persist_dtype_check(seed, device="cuda"):
    """(a) ``nd.save`` of every dtype and a 0-d array from tensors on
    ``device`` writes the bytes it writes from the same CPU tensors, and
    ``nd.load`` gives them back on ``device`` bit for bit.  Returns the
    file's size in bytes."""
    import mxnet_tpu_torch as mx

    g = torch.Generator().manual_seed(seed)
    host = {}
    for dt in PERSIST_DTYPES:
        if dt == torch.bool:
            host[str(dt)] = torch.rand(64, 33, generator=g) > 0.5
        elif dt.is_floating_point:
            host[str(dt)] = (100 * torch.randn(64, 33, generator=g)).to(dt)
        else:
            host[str(dt)] = torch.randint(0, 100, (64, 33), generator=g,
                                          dtype=torch.int64).to(dt)
    host["scalar"] = torch.tensor(3.25)
    ctx = mx.gpu(0) if torch.device(device).type == "cuda" else mx.cpu()
    d = tempfile.mkdtemp(prefix="persist_")
    try:
        on_dev = {k: mx.nd.NDArray._wrap(v.to(ctx.device))
                  for k, v in host.items()}
        mx.nd.save(os.path.join(d, "dev.params"), on_dev)
        mx.nd.save(os.path.join(d, "host.params"), host)
        blobs = [open(os.path.join(d, f), "rb").read()
                 for f in ("dev.params", "host.params")]
        check(blobs[0] == blobs[1], f"nd.save from {device} wrote other "
                                    f"bytes than from the CPU")
        back = mx.nd.load(os.path.join(d, "dev.params"), ctx=ctx)
        for k, v in host.items():
            got = back[k]._data
            check(got.device == ctx.device and got.dtype == v.dtype
                  and got.shape == v.shape and torch.equal(got.cpu(), v),
                  f"nd.load gave {k} back changed")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"  {len(host)} arrays ({', '.join(host)}): the same {len(blobs[0])}"
        f" bytes from {device} and from the CPU; loaded back on {device} "
        f"bit for bit")
    return len(blobs[0])


def resume_cfg(tiny=False):
    """(BertConfig, sequence, batch) of the resume recipe."""
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    if tiny:
        return (bert.BertConfig(dropout=0.1, **RESUME_TINY),
                RESUME_TINY_SEQ, RESUME_TINY_BATCH)
    return bert.BertConfig(dropout=0.1), BERT_SEQ, RESUME_BATCH


def _resume_ctx(device):
    import mxnet_tpu_torch as mx

    return mx.gpu(0) if torch.device(device).type == "cuda" else mx.cpu()


def resume_build(cfg, seq, init_seed, device):
    """The recipe's net from ``init_seed`` and its Trainer with AMP's
    dynamic LossScaler (``amp.init("float16")`` must be on)."""
    from mxnet_tpu_torch.contrib import amp

    net = init_bert(cfg, init_seed, _resume_ctx(device), seq)
    trainer = bert_recipe_trainer(net)
    amp.init_trainer(trainer, amp.LossScaler(
        init_scale=RESUME_SCALE, scale_window=RESUME_SCALE_WINDOW))
    return net, trainer


def resume_train(net, trainer, mgr, start, stop, data_seed, cfg, seq, batch,
                 device, record=None, on_step=None, seam_at=None,
                 times=None, saves=RESUME_SAVES):
    """Steps ``start`` + 1 .. ``stop`` of the recipe (step k's batch from
    ``data_seed`` and k, so a resumed run sees the same data).  Every step
    boundary polls ``lifecycle.check_stop()`` (with the
    ``lifecycle.sigterm`` seam armed at ``seam_at``); on a stop the final
    checkpoint is published at that step with the train state and
    GracefulExit raised.  With ``mgr``, an async save after each step of
    ``saves``.  ``record`` ({"losses": {}, "scales": {}}) gets each
    step's loss and the loss scale after it, and ``on_step(k, loss,
    scale)`` is called with them; ``times`` (a dict) gets the async
    saves' blocking seconds ("snapshot") and the final publish's ("sync
    save").  Returns ``record``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault, lifecycle

    ctx = _resume_ctx(device)
    scaler = trainer._amp_loss_scaler

    def state(k):
        return lifecycle.capture_train_state(k, scaler=scaler,
                                             trainer=trainer)

    record = {"losses": {}, "scales": {}} if record is None else record
    for step in range(start, stop):
        with fault.inject("lifecycle.sigterm") if seam_at == step \
                else contextlib.nullcontext():
            stopping = lifecycle.check_stop()
        if stopping:
            t0 = time.perf_counter()
            lifecycle.publish_final_checkpoint(mgr, step, net, trainer,
                                               train_state=state(step))
            if times is not None:
                times["sync save"] = time.perf_counter() - t0
                times["write/fsync"] = dict(mgr.last_save_timing)
            raise lifecycle.GracefulExit(lifecycle.stop_reason(), step=step)
        ids, labels = bert_batch(data_seed * 1000 + step, batch, seq,
                                 cfg.vocab_size)
        mlm, nsp = bert_labels(labels)
        args = [mx.nd.array(a, ctx=ctx, dtype="int32")
                for a in (ids, mlm, nsp)]
        loss, _ = bert_recipe_step(net, trainer, *args)
        k = step + 1
        record["losses"][k] = float(loss.asscalar())
        record["scales"][k] = scaler.loss_scale
        if on_step is not None:
            on_step(k, record["losses"][k], record["scales"][k])
        if mgr is not None and step + 1 in saves:
            t0 = time.perf_counter()
            mgr.save(step + 1, net, trainer, async_=True,
                     train_state=state(step + 1))
            if times is not None:
                times["snapshot"] = time.perf_counter() - t0
    return record


def resume_snapshot(net, trainer):
    """What an exact resume must carry, on the host: the parameters,
    LAMB's moments, the update count, the scheduler's next learning rate,
    the scaler's state and the random state."""
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.ndarray.serialization import host_copies

    params = list(net._collect_params_with_prefix().values())
    opt = trainer._optimizer
    states = trainer._updater.states
    moments = [t._data for i in sorted(states) for t in states[i]]
    return {"params": host_copies([p.data()._data for p in params]),
            "moments": host_copies(moments),
            "num_update": opt.num_update,
            "lr": opt.lr_scheduler(opt.num_update),
            "scaler": trainer._amp_loss_scaler.state_dict(),
            "rng": mx_random.get_state()}


def snapshot_mismatch(got, want):
    """The first part of two resume_snapshot()s that is not bit-equal, or
    None."""
    for key in ("params", "moments"):
        if len(got[key]) != len(want[key]) or not all(
                torch.equal(a, b) for a, b in zip(got[key], want[key])):
            return key
    for key in ("num_update", "lr", "scaler", "rng"):
        if got[key] != want[key]:
            return key
    return None


def resume_rule(u1, u2):
    """(b)'s rule from two uninterrupted runs' losses: bit equality when
    they repeat, else within 2 x their largest gap at any step.  Returns
    (the allowed gap, the largest U-to-U gap)."""
    gap = max(abs(u1[k] - u2[k]) for k in u1)
    return (0.0 if gap == 0 else 2 * gap), gap


def resume_verdict(run, u, allowed):
    """(largest gap of ``run``'s losses from ``u``'s, the steps beyond
    ``allowed``, whether the loss scale after every step and the update
    count equal U's)."""
    gaps = {k: abs(run["losses"][k] - u["losses"][k]) for k in u["losses"]}
    bad = [k for k, gap in gaps.items() if gap > allowed]
    same = run["scales"] == u["scales"] and \
        run.get("num_update", u["num_update"]) == u["num_update"]
    return max(gaps.values()), bad, same


def resume_u(cfg, seq, batch, seed, device):
    """Run U: RESUME_STEPS uninterrupted steps from ``seed``; returns its
    losses and loss scales by step, final scaler state and update
    count."""
    from mxnet_tpu_torch.contrib import amp

    amp.init("float16")
    try:
        net, trainer = resume_build(cfg, seq, seed, device)
        record = resume_train(net, trainer, None, 0, RESUME_STEPS, seed,
                              cfg, seq, batch, device)
        return dict(record, scaler=trainer._amp_loss_scaler.state_dict(),
                    num_update=trainer.step_count)
    finally:
        amp.disable()


def restore_from_host(net, trainer, host):
    """What ``CheckpointManager.restore`` loads into ``net`` and
    ``trainer`` (the parameters by structural name, the Trainer's states
    as ``Trainer.load_states`` reads them), from ``host``: the copy an
    earlier restore of the same step left (resume_r's "host")."""
    params = net._collect_params_with_prefix()
    for name, value in host["params"].items():
        params[name].set_data(value)
    trainer._updater.set_states(host["states"])
    trainer._optimizer = trainer._updater.optimizer
    trainer._optimizer.param_dict = dict(enumerate(trainer._params))


def resume_r(cfg, seq, batch, seed, device, directory, fault=None,
             first=None, host=None):
    """Run R: steps 1..RESUME_STOP from ``seed`` (async save after step 2,
    the sigterm seam at the step-RESUME_STOP boundary publishing the final
    checkpoint) into ``directory``; then a fresh net and Trainer from
    another init seed restore it and run the remaining steps.  ``first``
    (the result of an earlier call) reuses its first segment and
    checkpoint.  ``fault``: "no_train_state" skips restore_train_state;
    "scale_reset" sets the restored scale back to its initial value.
    ``host`` (an earlier call's "host") restores the net and Trainer from
    that host copy instead of the files: the faults test the check, not
    the files.  Returns the losses and scales of both segments, the final
    scaler state and update count, the snapshot at the stop and after the
    restore, the host copy of what the restore loaded, and times."""
    from mxnet_tpu_torch import lifecycle
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.contrib import amp

    amp.init("float16")
    try:
        if first is None:
            times, record = {}, {"losses": {}, "scales": {}}
            mgr = CheckpointManager(directory, max_to_keep=3)
            net, trainer = resume_build(cfg, seq, seed, device)
            try:
                resume_train(net, trainer, mgr, 0, RESUME_STEPS, seed, cfg,
                             seq, batch, device, record=record,
                             seam_at=RESUME_STOP, times=times)
                check(False, "run R did not stop at the seam")
            except lifecycle.GracefulExit as e:
                check(e.step == RESUME_STOP, f"R stopped at {e.step}")
            finally:
                lifecycle.reset()
            saved = resume_snapshot(net, trainer)
            del net, trainer
            first = dict(record, saved=saved, times=times)
        mgr = CheckpointManager(directory, max_to_keep=3)
        net, trainer = resume_build(cfg, seq, seed + 1, device)
        t0 = time.perf_counter()
        if host is None:
            step = mgr.restore(net, trainer)
            host = {"params": {n: _host(p.data()._data) for n, p in
                               net._collect_params_with_prefix().items()},
                    "states": trainer._states_blob()}
        else:
            restore_from_host(net, trainer, host)
            step = RESUME_STOP
        restore_s = time.perf_counter() - t0
        check(step == RESUME_STOP, f"restored step {step}, expected "
                                   f"{RESUME_STOP}")
        scaler = trainer._amp_loss_scaler
        if fault != "no_train_state":
            lifecycle.restore_train_state(mgr.read_train_state(step),
                                          scaler=scaler)
        if fault == "scale_reset":
            scaler.loss_scale = RESUME_SCALE
        restored = resume_snapshot(net, trainer)
        # no saves in the second segment: the directory keeps steps 2 and
        # 4 for the faults' resumes and the bit-flip
        second = resume_train(net, trainer, None, step, RESUME_STEPS, seed,
                              cfg, seq, batch, device)
        return dict(first, losses={**first["losses"], **second["losses"]},
                    scales={**first["scales"], **second["scales"]},
                    scaler=scaler.state_dict(),
                    num_update=trainer.step_count, restored=restored,
                    restore_s=restore_s, first=first, host=host)
    finally:
        amp.disable()



def resume_worker_main(args):
    """``--resume-worker``: the recipe under ``run_with_recovery`` to
    RESUME_STEPS, one JSON line per step ({"step", "loss", "launches"})
    to ``--resume-log``.  A SIGTERM stops it at the next step boundary
    with a final checkpoint: exit EXIT_PREEMPTED (43).  Run again, it
    resumes from the newest valid checkpoint and finishes: exit 0."""
    from mxnet_tpu_torch import lifecycle
    from mxnet_tpu_torch.checkpoint import CheckpointManager, \
        run_with_recovery
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = args.resume_device
    cfg, seq, batch = resume_cfg(args.resume_tiny)
    lifecycle.install_signal_handlers()
    mgr = CheckpointManager(args.resume_dir, max_to_keep=3)
    out = open(args.resume_log, "a")

    def on_step(k, loss, scale):
        out.write(json.dumps({"step": k, "loss": loss, "scale": scale,
                              "launches": fa_mod._flash_fwd_cuda.launches})
                  + "\n")
        out.flush()

    def train(start, manager):
        net, trainer = resume_build(cfg, seq, args.seed + (start > 0),
                                    device)
        if start:
            check(manager.restore(net, trainer) == start,
                  "the restore missed the start step")
            lifecycle.restore_train_state(manager.read_train_state(start),
                                          scaler=trainer._amp_loss_scaler)
        # no periodic saves: the stop's final publish is what the
        # relaunch resumes from ((b) tests the async save)
        return resume_train(net, trainer, manager, start, RESUME_STEPS,
                            args.seed, cfg, seq, batch, device,
                            on_step=on_step, saves=())

    amp.init("float16")
    try:
        run_with_recovery(train, mgr, max_restarts=1)
    except lifecycle.GracefulExit:
        return lifecycle.EXIT_PREEMPTED
    finally:
        amp.disable()
        out.close()
    return 0


def resume_worker_argv(seed, directory, log_path, device="cuda", tiny=False):
    """The command of one (c) child.  On the card it is this script; on
    the CPU (the tests) the same function through ``python -c``, since
    the script itself runs only on a card."""
    flags = ["--resume-worker", "--seed", str(seed), "--resume-dir",
             directory, "--resume-log", log_path, "--resume-device",
             device] + (["--resume-tiny"] if tiny else [])
    if torch.device(device).type == "cuda":
        return [sys.executable, os.path.abspath(__file__)] + flags
    return [sys.executable, "-c",
            "import sys, chip_smoke as c; sys.exit(c.resume_worker_main("
            "c.parse_args(sys.argv[1:])))"] + flags


def resume_sigterm_run(seed, directory, device="cuda", tiny=False,
                       sigterm_after=RESUME_SIGTERM_AFTER):
    """(c): a child runs the recipe and gets a real SIGTERM once it logged
    ``sigterm_after`` steps (it must exit 43), then a relaunch resumes
    and finishes (exit 0).  Returns {"losses", "scales"} joined over
    both, the step the first child stopped at, and the children's
    flash_attn_fwd launches."""
    os.makedirs(directory, exist_ok=True)
    log_path = os.path.join(directory, "steps.jsonl")
    ckpt = os.path.join(directory, "ckpt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    argv = resume_worker_argv(seed, ckpt, log_path, device, tiny)

    def lines():
        if not os.path.exists(log_path):
            return []
        with open(log_path) as f:
            return [json.loads(x) for x in f if x.strip()]

    def run(signal_after=None):
        err_path = os.path.join(directory, "stderr.txt")
        with open(err_path, "a") as err:
            child = subprocess.Popen(argv, env=env, stdout=err, stderr=err,
                                     cwd=os.path.dirname(
                                         os.path.abspath(__file__)))
        try:
            if signal_after is not None:
                deadline = time.monotonic() + RESUME_TIMEOUT
                while len(lines()) < signal_after:
                    check(child.poll() is None and time.monotonic()
                          < deadline, "the resume worker ended or stalled "
                                      "before its SIGTERM: " +
                          open(err_path).read()[-3000:])
                    time.sleep(0.05)
                child.send_signal(signal.SIGTERM)
            rc = child.wait(timeout=RESUME_TIMEOUT)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        return rc, err_path

    n0 = len(lines())
    rc, err_path = run(signal_after=n0 + sigterm_after)
    stopped_at = lines()[-1]["step"]
    check(rc == 43, f"the SIGTERMed worker exited {rc}, expected 43: " +
          open(err_path).read()[-3000:])
    launches = lines()[-1]["launches"]
    rc, err_path = run()
    check(rc == 0, f"the relaunched worker exited {rc}: " +
          open(err_path).read()[-3000:])
    joined = {"losses": {}, "scales": {}}
    for rec in lines()[n0:]:
        check(rec["step"] not in joined["losses"],
              f"step {rec['step']} ran twice")
        joined["losses"][rec["step"]] = rec["loss"]
        joined["scales"][rec["step"]] = rec["scale"]
    launches += lines()[-1]["launches"]
    check(sorted(joined["losses"]) == list(range(1, RESUME_STEPS + 1)),
          f"the joined log has steps {sorted(joined['losses'])}")
    return joined, stopped_at, launches


def run_batches(seed, n, batch, seq, vocab):
    """``n`` of bench.py's BERT batches (ids, labels) on the host."""
    return [bert_batch(seed * 1000 + i, batch, seq, vocab) for i in range(n)]


def trainstep_run_check(seed, device="cuda", cfg=None, batch=BERT_BATCH,
                        seq=BERT_SEQ, steps=RUN_STEPS):
    """(d) ``TrainStep.run`` at bench.py's BERT configuration (Adam,
    bf16, dropout 0.1): prefetch 0 and RUN_PREFETCH over the same
    batches, in turns (0, 2, 2, 0), give the same losses (bit for bit
    when the two prefetch-0 runs repeat, else within twice their gap),
    each run timed; then with the sigterm seam armed after step
    RUN_STOP_AFTER, ``run`` returns that many losses and
    ``stop_requested()`` is true.  Returns the times and flash_attn_fwd's
    launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault, lifecycle
    from mxnet_tpu_torch.gluon.model_zoo.language import bert
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch.parallel import TrainStep

    cfg = cfg or bert.BertConfig()
    ctx = _resume_ctx(device)
    net = init_bert(cfg, seed, ctx, seq)
    batches = run_batches(seed, steps, batch, seq, cfg.vocab_size)

    def run(prefetch, loss_fn=bert_loss, n=steps):
        mx.random.seed(seed)
        step = TrainStep(net, loss_fn, optimizer="adam",
                         optimizer_params=BERT_OPT, dtype="bfloat16",
                         device=device)
        t0 = time.perf_counter()
        losses = step.run(iter(batches[:n]), prefetch=prefetch)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return [v.item() for v in losses], time.perf_counter() - t0

    fa_mod._flash_fwd_cuda.launches = 0
    runs = [(p, *run(p)) for p in (0, RUN_PREFETCH, RUN_PREFETCH, 0)]
    launches = fa_mod._flash_fwd_cuda.launches
    base = [r for r in runs if r[0] == 0]
    allowed, gap = resume_rule(dict(enumerate(base[0][1])),
                               dict(enumerate(base[1][1])))
    worst = max(abs(a - b) for r in runs for a, b in zip(r[1], base[0][1]))
    times = {}
    for p, losses, secs in runs:
        times.setdefault(p, []).append(secs)
    log(f"  prefetch 0 vs {RUN_PREFETCH}: losses "
        f"{' '.join(f'{v:.6f}' for v in base[0][1])}; largest gap "
        f"{worst:.3e} (prefetch 0 against itself {gap:.3e}, allowed "
        f"{allowed:.3e}); seconds for {steps} steps: prefetch 0 "
        f"{times[0]}, prefetch {RUN_PREFETCH} {times[RUN_PREFETCH]}")
    check(all(len(r[1]) == steps for r in runs), "a run lost a batch")
    check(worst <= allowed, f"TrainStep.run with prefetch "
                            f"{RUN_PREFETCH} gives other losses "
                            f"({worst:.3e} > {allowed:.3e})")

    calls = [0]
    armed = []

    def arming_loss(out, y):
        calls[0] += 1
        if calls[0] == RUN_STOP_AFTER:
            armed.append(fault.inject("lifecycle.sigterm"))
            armed[0].__enter__()
        return bert_loss(out, y)

    try:
        losses, _ = run(RUN_PREFETCH, arming_loss)
        stopped = lifecycle.stop_requested()
    finally:
        if armed:
            armed[0].__exit__(None, None, None)
        lifecycle.reset()
    log(f"  the sigterm seam armed in step {RUN_STOP_AFTER}: run() returned "
        f"{len(losses)} losses, stop_requested() {stopped}")
    check(len(losses) == RUN_STOP_AFTER and stopped,
          f"TrainStep.run went on for {len(losses)} steps after the seam")
    check(max(abs(a - b) for a, b in zip(losses, base[0][1])) <= allowed,
          "the stopped run's losses differ")
    del net
    return times, launches


def estimator_stop_check(make_net, seed, device="cuda", batch=CHECK_BATCH,
                         size=TRAIN_SIZE, classes=1000):
    """(e) ``Estimator.fit`` over GluonCV's ResNet recipe with a
    ``checkpoint_manager``: the sigterm seam armed after batch
    FIT_STOP_AFTER stops it with GracefulExit at that step, whose
    checkpoint is published and restores into a fresh net bit for
    bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault, gluon, lifecycle
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.gluon.contrib import Estimator

    ctx = _resume_ctx(device)
    net = init_net(make_net, seed, ctx, size)
    trainer = resnet_recipe_trainer(net)
    est = Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                    train_metrics=["accuracy", "top_k_accuracy"],
                    trainer=trainer)
    data = [train_batch(seed * 1000 + i, batch, size, classes)
            for i in range(FIT_BATCHES)]

    def batches():
        for i, (x, y) in enumerate(data):
            item = (mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx))
            if i + 1 == FIT_STOP_AFTER:
                with fault.inject("lifecycle.sigterm"):
                    yield item
            else:
                yield item

    d = tempfile.mkdtemp(prefix="fit_")
    try:
        mgr = CheckpointManager(d)
        try:
            est.fit(batches(), epochs=1, checkpoint_manager=mgr)
            check(False, "Estimator.fit ran through the sigterm seam")
        except lifecycle.GracefulExit as e:
            step = e.step
        finally:
            lifecycle.reset()
        check(step == FIT_STOP_AFTER and mgr.latest_valid_step() == step,
              f"fit stopped at {step}, latest valid checkpoint "
              f"{mgr.latest_valid_step()}")
        other = init_net(make_net, seed + 1, ctx, size)
        check(mgr.restore(other) == step, "the fit checkpoint did not "
                                          "restore")
        want = net._collect_params_with_prefix()
        same = all(torch.equal(p.data()._data, want[k].data()._data)
                   for k, p in other._collect_params_with_prefix().items())
        check(same, "the fit checkpoint restored other weights")
        state = mgr.read_train_state(step)
        check(state["step"] == step and state["trainer"]["num_update"]
              == step, f"the fit train state reads {state}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"  Estimator.fit stopped at batch {step} by the sigterm seam; its "
        f"checkpoint (train state {sorted(state)}) restores bit for bit")
    return step


def checkpoint_bytes(directory, step):
    d = os.path.join(directory, f"step_{step:08d}")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def persistence_phase(seed):
    """Phase 10: (a) to (f); returns flash_attn_fwd's launches on the
    gluon_bert_resume path (R's two segments and (c)'s children)."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    t0 = time.perf_counter()
    log("== persistence 1: nd.save / nd.load of every dtype on the card")
    persist_dtype_check(seed)
    t1 = time.perf_counter()
    log(f"  (a) {t1 - t0:.1f} s")

    cfg, seq, batch = resume_cfg()
    log(f"== persistence 2: GluonNLP's BERT-base recipe (LAMB, warm-up "
        f"poly, clip {GLUON_CLIP:g}) under amp.init('float16') with the "
        f"dynamic LossScaler (from {RESUME_SCALE:g}, window "
        f"{RESUME_SCALE_WINDOW}), batch {batch} "
        f"x {seq}, dropout {cfg.dropout}: U {RESUME_STEPS} steps twice; R "
        f"{RESUME_STOP} steps (async save after {RESUME_SAVES[0]}, the "
        f"sigterm seam at the step-{RESUME_STOP} boundary), then a fresh "
        f"net from another seed restores and runs steps {RESUME_STOP + 1}"
        f"-{RESUME_STEPS}")
    work = tempfile.mkdtemp(prefix="resume_")
    try:
        u1 = resume_u(cfg, seq, batch, seed, "cuda")
        u2 = resume_u(cfg, seq, batch, seed, "cuda")
        allowed, gap = resume_rule(u1["losses"], u2["losses"])
        log(f"  U losses: {' '.join(f'{v:.7f}' for v in u1['losses'].values())}"
            f"; U against U: largest gap {gap:.3e} -> R's rule: "
            f"{'bit equality' if allowed == 0 else f'within {allowed:.3e}'}"
            f"; loss scales {list(u1['scales'].values())}, U's final "
            f"scaler {u1['scaler']}, updates {u1['num_update']}")
        torch.cuda.empty_cache()
        ckpt = os.path.join(work, "ckpt")
        fa_mod._flash_fwd_cuda.launches = 0        # this path's count
        r = resume_r(cfg, seq, batch, seed, "cuda", ckpt)
        launches = fa_mod._flash_fwd_cuda.launches
        bad_state = snapshot_mismatch(r["restored"], r["saved"])
        worst, bad, same_end = resume_verdict(r, u1, allowed)
        log(f"  R: restored state against the state at the stop: "
            f"{'bit for bit' if bad_state is None else 'differs in ' + bad_state}"
            f" (parameters, LAMB's moments, update count "
            f"{r['saved']['num_update']}, next lr {r['saved']['lr']:.6e}, "
            f"scaler {r['saved']['scaler']}, generators); losses "
            f"{' '.join(f'{v:.7f}' for v in r['losses'].values())}, largest "
            f"gap from U {worst:.3e}; loss scales and update count as U's: "
            f"{same_end}; flash_attn_fwd launches {launches}")
        faults = {}
        for fault in ("no_train_state", "scale_reset"):
            f = resume_r(cfg, seq, batch, seed, "cuda", ckpt, fault=fault,
                         first=r["first"], host=r["host"])
            faults[fault] = resume_verdict(f, u1, allowed)
            log(f"  planted {fault}: largest gap from U "
                f"{faults[fault][0]:.3e} (steps beyond the rule "
                f"{faults[fault][1]}), loss scales "
                f"{list(f['scales'].values())}, as U's: {faults[fault][2]}")
        check(bad_state is None, f"the restored {bad_state} differs from "
                                 f"what was saved")
        check(not bad and same_end, f"R's steps {bad} break the rule "
                                    f"(largest gap {worst:.3e})")
        for fault, (_, fbad, fsame) in faults.items():
            check(fbad or not fsame, f"the resume check misses {fault}")
        step_s = os.path.join(ckpt, f"step_{RESUME_STOP:08d}")
        nbytes = checkpoint_bytes(ckpt, RESUME_STOP)
        mgr = CheckpointManager(ckpt)
        t = time.perf_counter()
        check(mgr.verify(RESUME_STOP) is None, "the final checkpoint does "
                                               "not verify")
        verify_s = time.perf_counter() - t
        blob = bytearray(open(os.path.join(step_s, "model.params"),
                              "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(os.path.join(step_s, "model.params"), "wb").write(bytes(blob))
        mgr = CheckpointManager(ckpt)
        amp.init("float16")
        try:
            net, trainer = resume_build(cfg, seq, seed + 2, "cuda")
            back = mgr.restore(net, trainer)
        finally:
            amp.disable()
        latest = mgr.latest_valid_step()
        log(f"  one byte of step {RESUME_STOP}'s model.params flipped: "
            f"restore() fell back to step {back}, latest_valid_step() "
            f"{latest}")
        check(back == RESUME_SAVES[0] and latest == RESUME_SAVES[0],
              f"the bit-flip fell back to {back} / {latest}")
        del net, trainer
        times = r["times"]
        log(f"  [{gpu_line()}] at BERT-base ({cfg.num_layers} layers, "
            f"LAMB): checkpoint {nbytes} bytes; sync save (the final "
            f"publish) {times['sync save']:.3f} s, of which writing (each "
            f"file hashed as written) {times['write/fsync']['write_s']:.3f} "
            f"s and fsync {times['write/fsync']['fsync_s']:.3f} s; async "
            f"save's blocking "
            f"snapshot {times['snapshot']:.3f} s; sha256 verify "
            f"{verify_s:.3f} s; restore {r['restore_s']:.3f} s")
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        log(f"  (b) {t2 - t1:.1f} s")

        log(f"== persistence 3: a real SIGTERM: a child runs the recipe "
            f"under run_with_recovery, is SIGTERMed after "
            f"{RESUME_SIGTERM_AFTER} steps and relaunched")
        joined, stopped, child_launches = resume_sigterm_run(
            seed, os.path.join(work, "sigterm"))
        worst_c, bad_c, same_c = resume_verdict(joined, u1, allowed)
        log(f"  the child stopped after step {stopped} with exit 43; the "
            f"relaunch finished; joined losses' largest gap from U "
            f"{worst_c:.3e}, loss scales as U's: {same_c}; the children's "
            f"flash_attn_fwd launches {child_launches}")
        check(not bad_c and same_c, f"the SIGTERMed run's steps {bad_c} "
                                    f"break the rule, or its scales differ")
        launches += child_launches
        # a layer's launch per step, and one per layer for the forward
        # that settles each of the four nets' shapes (R's two, the
        # children's two)
        want = cfg.num_layers * (2 * RESUME_STEPS + 4)
        check(launches == want, f"flash_attn_fwd launched {launches} times "
                                f"over R's and the children's "
                                f"{2 * RESUME_STEPS} steps, expected {want}")
        t3 = time.perf_counter()
        log(f"  (c) {t3 - t2:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log(f"== persistence 4: TrainStep.run at bench.py's BERT configuration "
        f"(batch {BERT_BATCH}, Adam {BERT_OPT}, bf16, dropout 0.1)")
    run_times, run_launches = trainstep_run_check(seed)
    check(run_launches > 0, "TrainStep.run never launched flash_attn_fwd")
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    log(f"  [{gpu_line()}] TrainStep.run over {RUN_STEPS} steps: prefetch 0 "
        f"{min(run_times[0]):.3f} s, prefetch {RUN_PREFETCH} "
        f"{min(run_times[RUN_PREFETCH]):.3f} s (best of 2 each); (d) "
        f"{t4 - t3:.1f} s")

    log(f"== persistence 5: Estimator.fit over GluonCV's ResNet-50 recipe, "
        f"batch {CHECK_BATCH}, with a checkpoint_manager")
    estimator_stop_check(resnet50, seed)
    torch.cuda.empty_cache()
    t5 = time.perf_counter()
    log(f"  (e) {t5 - t4:.1f} s")
    log(f"  [{gpu_line()}] phase 10 took {t5 - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the Gluon frontend, hybridize() as CUDA graphs
# ---------------------------------------------------------------------------
# (a): card against CPU within FRONT_TOL of max(1, |CPU|), TF32 off; the
# gradient penalty through BERT-base's feed-forward widths at batch 64
FRONT_TOL = 1e-4
GP_WIDTHS, GP_BATCH = (768, 3072), 64
FLOW_SHAPE = (16, 64, 768)          # foreach / while_loop: (T, N, C)
# (b), (c): the families at their published widths, 1000 classes
ZOO = (("alexnet", 224, {}), ("vgg16_bn", 224, {}),
       ("squeezenet1_1", 224, {}), ("mobilenet1_0", 224, {}),
       ("mobilenet_v2_1_0", 224, {}), ("densenet121", 224, {}),
       ("resnet50_v1", 224, {"stem": "s2d"}), ("inceptionv3", 299, {}))
ZOO_BATCH, ZOO_CPU_BATCH = 8, 1
# a hybridized step against the eager step on the card, compare_steps's
# measure: the captured graph replays the eager kernels, so they agree to
# the nondeterminism of the backward's atomics.  An eager step against
# another eager step reads that nondeterminism (up to 5.478e-03 at
# VGG-16-bn's biases before BatchNorm, whose gradient is rounding noise,
# on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md, the frontend; the steps
# compared run cuDNN's deterministic algorithms): the bound is the larger
# of HYBRID_STEP_BOUND and HYBRID_NOISE_FACTOR x that reading
HYBRID_STEP_BOUND, HYBRID_NOISE_FACTOR = 1e-3, 3.0
# (c): GluonCV's NAG at lr 0.01 (no warm-up in 7 steps: VGG-16-bn at
# GluonCV's 0.1 diverges to a non-finite loss on the card); 5 timed steps
# a run (the phase's time against its 90 s aim)
ZOO_TIMED_BATCH, ZOO_WARMUP, ZOO_STEPS = 128, 2, 5
ZOO_TIMED_OPT = dict(GLUON_CV_OPT, learning_rate=0.01)
# (d): phase 8 (b)'s medium PTB LM through gluon.rnn; the cell unroll
# against the layer, fp32
UNROLL_TOL = 1e-5
LM_HYBRID_STEPS = 10
# (e): phase 9 (d)'s recipe, eager and hybridized; the CPU check at a cut
# batch (phase 9 (b)'s bound is relative to the CPU's own fp32 step)
FRONT_BERT_CHECK_BATCH, FRONT_BERT_STEPS = 2, 10


def _tensors(xs):
    return [x._data.detach().to("cpu", torch.float64) if hasattr(x, "_data")
            else x for x in xs]


def _worst(cand, ref):
    """max |cand - ref| / max(1, max |ref|) over pairs of tensors."""
    return max(((c.double() - r.double()).abs().max() /
                max(1.0, r.double().abs().max().item())).item()
               for c, r in zip(cand, ref))


def gp_mlp(widths, seed, ctx):
    """BERT's feed-forward block (Dense w0 -> w1, GELU, Dense w1 -> w0),
    weights from a numpy seed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    net.add(nn.Dense(widths[1], in_units=widths[0]), nn.GELU(),
            nn.Dense(widths[0], in_units=widths[1]))
    net.initialize(ctx=ctx)
    r = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(mx.nd.array(r.randn(*p.shape) / math.sqrt(p.shape[-1]),
                               ctx=ctx))
    return net


def gradient_penalty(net, x_np, ctx):
    """(plain autograd.grad of the output's weighted sum wrt the input and
    every parameter, the parameters' and the input's gradients of the
    penalty |d out / d x|^2 through create_graph=True), as host tensors."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    params = [p.data() for p in net.collect_params().values()]
    x = mx.nd.array(x_np, ctx=ctx)
    w = mx.nd.array(np.random.RandomState(7).randn(*x_np.shape), ctx=ctx)
    x.attach_grad()
    with autograd.record():
        out = net(x)
        head = (out * w).sum()
        plain = autograd.grad(head, [x] + params, retain_graph=True)
        g = autograd.grad(head, x, create_graph=True)[0]
        pen = (g * g).sum()
    pen.backward()
    return (_tensors(plain),
            _tensors([p.grad() for p in net.collect_params().values()]) +
            _tensors([x.grad]))


def _function_class():
    from mxnet_tpu_torch import autograd, nd

    class ScaledTanh(autograd.Function):
        """tanh(a) * b, its gradient written by hand."""

        def forward(self, a, b):
            y = nd.tanh(a)
            self.save_for_backward(y, b)
            return y * b

        def backward(self, dy):
            y, b = self.saved_tensors
            return dy * b * (1 - y * y), dy * y

    return ScaledTanh


def flow_results(ctx, shape, seed):
    """foreach, while_loop and cond over seeded inputs on ``ctx``: their
    outputs and the inputs' gradients of a weighted sum, host tensors."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    T, N, C = shape
    r = np.random.RandomState(seed)
    xs = mx.nd.array(r.randn(T, N, C) * 0.5, ctx=ctx)
    h0 = mx.nd.array(r.randn(N, C) * 0.5, ctx=ctx)
    w = mx.nd.array(r.randn(C) * 0.5, ctx=ctx)
    a = mx.nd.array(r.randn(N, C), ctx=ctx)
    b = mx.nd.array(r.randn(N, C), ctx=ctx)
    arrays = [xs, h0, w, a, b]
    for v in arrays:
        v.attach_grad()
    with autograd.record():
        outs, hT = nd.contrib.foreach(
            lambda x, h: (nd.tanh(x * w + h),) * 2, xs, h0)
        wl, (s, _) = nd.contrib.while_loop(
            lambda s, i: i.sum() < T // 2,
            lambda s, i: (nd.tanh(s * w), [s * 0.9 + nd.tanh(s * w),
                                           i + 1]),
            [h0, mx.nd.zeros((1,), ctx=ctx)], max_iterations=T)
        c1 = nd.contrib.cond(lambda a, b: (a * b).sum() > 0,
                             lambda a, b: a * b, lambda a, b: a - b, [a, b])
        c2 = nd.contrib.cond(lambda a, b: (a * b).sum() <= 0,
                             lambda a, b: a * b, lambda a, b: a - b, [a, b])
        f = _function_class()()(a, b)
        results = [outs, hT, wl, s, c1, c2, f]
        total = None
        for i, o in enumerate(results):
            wt = mx.nd.array(np.random.RandomState(100 + i).randn(*o.shape),
                             ctx=ctx)
            term = (o * wt).sum()
            total = term if total is None else total + term
    total.backward()
    return _tensors(results), _tensors([v.grad for v in arrays])


def autograd_checks(seed, device="cuda", widths=GP_WIDTHS, batch=GP_BATCH,
                    flow_shape=FLOW_SHAPE):
    """(a): autograd.grad (plain and create_graph=True, a gradient penalty
    through BERT's feed-forward widths), a custom Function, foreach,
    while_loop and cond on ``device`` against the CPU, within FRONT_TOL;
    the penalty through the hybridized block on ``device`` against its
    eager run (first-order gradients from the captured backward, the
    second order from the recomputed forward).  Returns the readings."""
    import mxnet_tpu_torch as mx

    ctx = mx.Context.from_device(torch.device(device))
    x = np.random.RandomState(seed).randn(batch, widths[0]) \
        .astype("float32")
    out = {}
    cpu_net, dev_net = gp_mlp(widths, seed, mx.cpu()), \
        gp_mlp(widths, seed, ctx)
    cpu = gradient_penalty(cpu_net, x, mx.cpu())
    dev = gradient_penalty(dev_net, x, ctx)
    out["grad"] = _worst(dev[0], cpu[0])
    out["create_graph"] = _worst(dev[1], cpu[1])
    dev_net.hybridize()
    gradient_penalty(dev_net, x, ctx)            # builds the cache entry
    hyb = gradient_penalty(dev_net, x, ctx)
    out["hybrid grad"] = _worst(hyb[0], dev[0])
    out["hybrid create_graph"] = _worst(hyb[1], dev[1])
    fc, gc = flow_results(mx.cpu(), flow_shape, seed)
    fd, gd = flow_results(ctx, flow_shape, seed)
    out["control flow and Function"] = max(_worst(fd, fc), _worst(gd, gc))
    for key, v in out.items():
        log(f"    {v:.3e}  {key}")
    bad = {k: v for k, v in out.items() if v > FRONT_TOL}
    check(not bad, f"(a) beyond {FRONT_TOL:g}: {bad}")
    return out


def memory_base():
    """Free what earlier runs left for the collector and reset the peak:
    the card's allocated bytes now, which a run's peak is read above (the
    run's own model, activations, optimizer state and graphs)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def zoo_net(name, size, kw, seed, ctx, classes=1000):
    """A zoo family from the device generator seeded with ``seed``
    (Xavier), its deferred shapes settled by a predict-mode call."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(seed)
    net = vision.get_model(name, classes=classes, **kw)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with autograd.predict_mode():
        net(mx.nd.zeros(zoo_shape(name, size, kw, 1), ctx=ctx))
    return net


def zoo_shape(name, size, kw, batch):
    return (batch, size, size, 3) if kw.get("layout") == "NHWC" else \
        (batch, 3, size, size)


def zoo_step(net, x, y, train, rng_seed, hybrid):
    """One record / backward / Trainer.step (GluonCV's SGD) of ``net``,
    hybridized or not, the generator seeded with ``rng_seed`` first (the
    same dropout masks for both; None: not seeded, for a predict-mode step
    that draws nothing): (loss, before, after), the weights put back
    after."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    if net._active != hybrid:
        net.hybridize(hybrid)
    ctx = next(iter(net.collect_params().values())).data().context
    X = mx.nd.array(x, ctx=ctx, dtype=x.dtype)
    Y = mx.nd.array(y, ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(CHECK_OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def run():
        if rng_seed is not None:
            mx.random.seed(rng_seed)
        with autograd.record(train_mode=train):
            loss = loss_fn(net(X), Y).mean()
        loss.backward()
        trainer.step(1)
        return loss.asscalar()

    return gluon_step_result(net, run)


def zoo_checks(seed, device="cuda", families=ZOO, batch=ZOO_BATCH,
               cpu_batch=ZOO_CPU_BATCH, classes=1000):
    """(b): each family on ``device``: the hybridized forward against the
    eager forward (predict mode, exact), a hybridized train-mode SGD step
    through Trainer against the eager step (HYBRID_STEP_BOUND, an eager
    step against another eager step read beside it), and the hybridized
    predict-mode step at ``cpu_batch`` against the CPU's fp64 step, in
    fp32 (FP32_STEP_BOUND) and fp64 (FP64_STEP_BOUND), phase 5's measure.
    Returns {family: readings}."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    ctx = mx.Context.from_device(torch.device(device))
    res = {}
    for name, size, kw in families:
        t0 = time.perf_counter()
        net = zoo_net(name, size, kw, seed, ctx, classes)
        names = list(net.collect_params())
        r = np.random.RandomState(seed)
        x = r.uniform(-1, 1, zoo_shape(name, size, kw, batch)) \
            .astype("float32")
        y = r.randint(0, classes, (batch,)).astype("int32")
        # the CPU's fp64 step (predict mode: no generator draws, no AMP)
        # runs on a thread beside the card's steps, from the weights the
        # card's steps start from (each puts them back after itself); the
        # autograd, trace and generator states are per thread
        xc, yc = x[:cpu_batch], y[:cpu_batch]
        cpu_net = zoo_net(name, size, kw, seed, mx.cpu(), classes)
        for p, q in zip(cpu_net.collect_params().values(),
                        net.collect_params().values()):
            p.set_data(q.data()._data.cpu())
        cpu_net.cast("float64")
        cpu_thread = in_thread(zoo_step, cpu_net, xc.astype("float64"), yc,
                               False, None, False)
        X = mx.nd.array(x, ctx=ctx)
        with autograd.predict_mode():
            eager = net(X).asnumpy()
            net.hybridize()
            net(X)
            hybrid = net(X).asnumpy()
        fwd = float(np.abs(hybrid - eager).max())
        # the steps compared run cuDNN's deterministic algorithms: with its
        # defaults two eager steps read 7.007e-04 to 5.478e-03 apart at
        # VGG-16-bn's biases before BatchNorm, so one such reading is no
        # measure of the next one's
        with patched(torch.backends.cudnn, "deterministic", True):
            e1 = zoo_step(net, x, y, True, seed + 1, False)
            e2 = zoo_step(net, x, y, True, seed + 1, False)
            zoo_step(net, x, y, True, seed + 1, True)      # builds the entry
            h = zoo_step(net, x, y, True, seed + 1, True)
        noise, _ = compare_steps(e2, e1, names)
        step, where = compare_steps(h, e1, names)
        # the card against the CPU: predict mode (no dropout draws, whose
        # streams differ by device), fp32 and fp64, hybridized on the card
        card32 = zoo_step(net, xc, yc, False, seed, True)
        net.cast("float64")
        card64 = zoo_step(net, xc.astype("float64"), yc, False, seed, True)
        cpu64 = joined(*cpu_thread, timeout=600)
        del cpu_net
        # predict mode leaves the running statistics as they were: their
        # deviation is read absolutely (scale 1), the rest by the update
        scales = [sc if sc > 0 else 1.0
                  for sc in update_scales(cpu64, names)]
        r32, w32 = compare_steps(card32, cpu64, names, scales)
        r64, w64 = compare_steps(card64, cpu64, names, scales)
        res[name] = {"forward": fwd, "step": step, "eager noise": noise,
                     "fp32": r32, "fp64": r64}
        log(f"  {name} at {size}x{size}: hybrid forward vs eager "
            f"{fwd:.3e} (max |diff|); hybrid step vs eager {step:.3e} of "
            f"the update ({where}; eager vs eager {noise:.3e}); the card's "
            f"hybridized step vs the CPU's fp64 step at batch {cpu_batch}: "
            f"fp32 {r32:.3e} ({w32}), fp64 {r64:.3e} ({w64}); "
            f"{time.perf_counter() - t0:.1f} s")
        check(fwd == 0.0, f"{name}: the hybridized forward differs from "
                          f"the eager one by {fwd:.3e}")
        bound = max(HYBRID_STEP_BOUND, HYBRID_NOISE_FACTOR * noise)
        check(step <= bound, f"{name}: the hybridized step strays "
                             f"{step:.3e} from the eager step at {where}, "
                             f"bound {bound:.3e}")
        check(r32 <= FP32_STEP_BOUND, f"{name}: fp32 step vs the CPU "
                                      f"{r32:.3e} at {w32}")
        check(r64 <= FP64_STEP_BOUND, f"{name}: fp64 step vs the CPU "
                                      f"{r64:.3e} at {w64}")
        del net
        if device != "cpu":
            torch.cuda.empty_cache()
    return res


def zoo_timing(seed, families=ZOO, batch=ZOO_TIMED_BATCH):
    """(c): GluonCV's train_imagenet.py loop for each family, eager and
    ``--mode hybrid`` (hybridize(static_alloc=True, static_shape=True)),
    AMP bf16, NAG (ZOO_TIMED_OPT), batch ``batch``: ZOO_WARMUP +
    ZOO_STEPS steps, img/s, ms a step, peak memory.  Returns {family: {mode: img/s}}."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.contrib import amp

    ctx = mx.gpu(0)
    out = {}
    for name, size, kw in families:
        out[name] = {}
        for mode in ("eager", "hybrid"):
            base = memory_base()
            net = zoo_net(name, size, kw, seed, ctx)
            if mode == "hybrid":
                net.hybridize(static_alloc=True, static_shape=True)
            r = np.random.RandomState(seed)
            X = mx.nd.array(r.uniform(-1, 1, zoo_shape(name, size, kw,
                                                       batch)), ctx=ctx)
            Y = mx.nd.array(r.randint(0, 1000, (batch,)), ctx=ctx)
            trainer = gluon.Trainer(net.collect_params(), "nag",
                                    dict(ZOO_TIMED_OPT))
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            amp.init()
            try:
                amp.init_trainer(trainer)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                losses = []
                for i in range(ZOO_WARMUP + ZOO_STEPS):
                    if i == ZOO_WARMUP:
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                    with autograd.record():
                        loss = loss_fn(net(X), Y)
                        with amp.scale_loss(loss, trainer) as scaled:
                            scaled.backward()
                    trainer.step(batch)
                    losses.append(loss)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t1
            finally:
                amp.disable()
            peak = torch.cuda.max_memory_allocated() - base
            vals = [v.mean().asscalar() for v in losses]
            check(all(math.isfinite(v) for v in vals),
                  f"{name} {mode}: non-finite loss")
            ips = batch * ZOO_STEPS / dt
            out[name][mode] = ips
            log(f"  [{gpu_line()}] {name} {mode}: {ips:.1f} img/s, "
                f"{1e3 * dt / ZOO_STEPS:.2f} ms/step, peak memory "
                f"{peak / 2**30:.3f} GiB over the run's start (bf16 AMP, batch {batch}, "
                f"{ZOO_STEPS} steps after {ZOO_WARMUP})")
            del net, trainer, X, Y, losses
            torch.cuda.empty_cache()
    return out


def lm_net(cfg, seed, ctx, dropout):
    """GluonNLP's word LM over gluon.rnn: Embedding -> Dropout -> LSTM ->
    Dropout -> Dense, weights uniform in [-0.05, 0.05] from a numpy seed
    (lm_init's distribution)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn

    class WordLM(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(cfg["vocab"], cfg["embed"])
            self.drop = nn.Dropout(dropout)
            self.encoder = gluon.rnn.LSTM(cfg["hidden"],
                                          num_layers=cfg["layers"],
                                          dropout=dropout,
                                          input_size=cfg["embed"])
            self.decoder = nn.Dense(cfg["vocab"], flatten=False,
                                    in_units=cfg["hidden"])

        def hybrid_forward(self, F, ids, h, c):
            x = self.drop(self.embedding(ids))
            out, (h, c) = self.encoder(x, [h, c])
            return self.decoder(self.drop(out)), h, c

    net = WordLM()
    net.initialize(ctx=ctx)
    r = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(mx.nd.array(r.uniform(-0.05, 0.05, p.shape), ctx=ctx))
    return net


def lm_batch(cfg, seed):
    r = np.random.RandomState(seed)
    toks = r.randint(0, cfg["vocab"], (cfg["steps"] + 1, cfg["batch"]))
    return toks[:-1].astype("int32"), toks[1:].astype("int32")


def lm_gluon_step(net, ids, labels, states, lr=LM_LR):
    """One SGD step of the word LM (mean cross entropy): (loss, before,
    after) over its parameters and the final states, weights put back."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    ctx = states[0].context
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    ids_nd, lab = mx.nd.array(ids, ctx=ctx), mx.nd.array(labels, ctx=ctx)
    final = []

    def run():
        with autograd.record():
            logits, h, c = net(ids_nd, *states)
            loss = loss_fn(logits, lab).mean()
        loss.backward()
        trainer.step(1)
        final[:] = [_host(h._data), _host(c._data)]
        return loss.asscalar()

    loss, before, after = gluon_step_result(net, run)
    zero = torch.zeros_like(final[0])
    return loss, before + [zero, zero], after + final


def lm_checks(seed, device="cuda", cfg=LM_CFG, fault=None):
    """(d): the hybridized word LM's fp32 step at dropout 0 on ``device``
    against the CPU's fp64 step (LM_BOUND, compare_steps), and the layer's
    weights in a SequentialRNNCell of LSTMCells: unroll against the layer
    within UNROLL_TOL.  ``fault`` (planted_lm_fault's) is planted in the
    step on ``device`` only.  Returns (ratio, unroll deviation)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    ctx = mx.Context.from_device(torch.device(device))
    ids, labels = lm_batch(cfg, seed)
    shape = (cfg["layers"], cfg["batch"], cfg["hidden"])
    cpu_net = lm_net(cfg, seed, mx.cpu(), 0.0)
    cpu_net.cast("float64")
    cpu_net.hybridize()
    ref = lm_gluon_step(cpu_net, ids, labels, [
        mx.nd.zeros(shape, ctx=mx.cpu(), dtype="float64")
        for _ in range(2)])
    del cpu_net
    net = lm_net(cfg, seed, ctx, 0.0)
    net.hybridize()
    states = [mx.nd.zeros(shape, ctx=ctx) for _ in range(2)]
    planted = planted_lm_fault(fault) if fault else \
        contextlib.nullcontext()
    with planted:
        lm_gluon_step(net, ids, labels, states)      # builds the entry
        cand = lm_gluon_step(net, ids, labels, states)
    names = list(net.collect_params()) + ["state_h", "state_c"]
    ratio, where = compare_steps(cand, ref, names)
    log(f"  hybridized fp32 step on {device} vs the CPU's fp64 step: "
        f"{ratio:.3e} of the update ({where}), bound {LM_BOUND:g}")
    check(ratio <= LM_BOUND, f"(d) LM step: {ratio:.3e} at {where}")
    # the cells: the layer's weights unrolled step by step
    seq = gluon.rnn.SequentialRNNCell()
    for i in range(cfg["layers"]):
        seq.add(gluon.rnn.LSTMCell(cfg["hidden"], input_size=cfg[
            "embed"] if i == 0 else cfg["hidden"]))
    seq.initialize(ctx=ctx)
    layer = dict(net.encoder.collect_params().items())
    for i, cell in enumerate(seq._children.values()):
        for suffix, p in cell.collect_params().items():
            key = next(k for k in layer
                       if k.endswith(f"l{i}_" + suffix.split("_", 1)[1]))
            p.set_data(layer[key].data())
    x = net.embedding(mx.nd.array(ids, ctx=ctx))
    out, _ = net.encoder(x, [mx.nd.zeros(shape, ctx=ctx)
                             for _ in range(2)])
    outs, _ = seq.unroll(cfg["steps"], x, layout="TNC")
    dev = _worst([_host(outs._data)], [_host(out._data)])
    log(f"  SequentialRNNCell(LSTMCell x {cfg['layers']}).unroll vs the "
        f"LSTM layer: {dev:.3e} of max(1, |out|), bound {UNROLL_TOL:g}")
    check(dev <= UNROLL_TOL, f"(d) unroll vs the layer: {dev:.3e}")
    return ratio, dev


def lm_hybrid_timing(seed, cfg=LM_CFG):
    """(d): the word LM at dropout cfg["dropout"], eager and hybridized,
    the state carried: tokens/s, ms a step, peak memory."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    ctx = mx.gpu(0)
    ids, labels = lm_batch(cfg, seed)
    shape = (cfg["layers"], cfg["batch"], cfg["hidden"])
    out = {}
    for mode in ("eager", "hybrid"):
        base = memory_base()
        net = lm_net(cfg, seed, ctx, cfg["dropout"])
        if mode == "hybrid":
            net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": LM_LR})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        ids_nd, lab = mx.nd.array(ids, ctx=ctx), mx.nd.array(labels, ctx=ctx)
        h, c = (mx.nd.zeros(shape, ctx=ctx) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for i in range(LM_WARMUP + LM_HYBRID_STEPS):
            if i == LM_WARMUP:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            with autograd.record():
                logits, h, c = net(ids_nd, h.detach(), c.detach())
                loss = loss_fn(logits, lab).mean()
            loss.backward()
            trainer.step(1)
            losses.append(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() - base
        vals = [v.asscalar() for v in losses]
        check(all(math.isfinite(v) for v in vals), f"LM {mode}: non-finite")
        tps = cfg["steps"] * cfg["batch"] * LM_HYBRID_STEPS / dt
        out[mode] = tps
        log(f"  [{gpu_line()}] word LM {mode}: {tps:.0f} tokens/s, "
            f"{1e3 * dt / LM_HYBRID_STEPS:.2f} ms/step, peak memory "
            f"{peak / 2**30:.3f} GiB over the run's start, losses {vals[0]:.4f} .. "
            f"{vals[-1]:.4f}")
        del net, trainer
        torch.cuda.empty_cache()
    return out


def bert_recipe_loss(net):
    """GluonNLP's pretraining loss over ``net`` as one HybridBlock: (the
    mean MLM plus NSP cross entropy, the MLM scores, the NSP scores)."""
    from mxnet_tpu_torch import gluon

    class BertRecipeLoss(gluon.HybridBlock):
        def __init__(self, model):
            super().__init__()
            self.model = model
            self.ce = gluon.loss.SoftmaxCrossEntropyLoss()

        def hybrid_forward(self, F, ids, mlm, nsp):
            mlm_out, nsp_out = self.model(ids)
            loss = self.ce(mlm_out, mlm).mean() + \
                self.ce(nsp_out, nsp).mean()
            return loss, mlm_out, nsp_out

    return BertRecipeLoss(net)


def bert_hybrid_result(net, ids, labels, hybrid):
    """One recipe step (fp32, a fresh Trainer) of ``net`` with the model
    and the loss hybridized or eager: (loss, before, after)."""
    import mxnet_tpu_torch as mx

    ctx = next(iter(net.collect_params().values())).data().context
    mlm, nsp = bert_labels(labels)
    args = [mx.nd.array(a, ctx=ctx, dtype="int32") for a in (ids, mlm, nsp)]
    block = bert_recipe_loss(net)
    block.hybridize(hybrid)

    def run():
        trainer = bert_recipe_trainer(net)
        return bert_recipe_step(net, trainer, *args,
                                loss_block=block)[0].asscalar()

    gluon_step_result(net, run)          # builds the hybridized entry
    return gluon_step_result(net, run)


def bert_hybrid_checks(seed, device="cuda", cfg=None,
                       batch=FRONT_BERT_CHECK_BATCH, seq=BERT_SEQ):
    """(e) at dropout 0: the hybridized recipe step on ``device`` against
    the eager one (HYBRID_STEP_BOUND, compare_steps), and against the
    CPU's fp64 step within phase 9 (b)'s bound (GLUON_FP32_NOISE_FACTOR of
    the CPU's fp32 deviation).  Each step is the second from the same
    weights, so that the hybridized one replays its graph."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    cfg = cfg or bert.BertConfig(dropout=0.0)
    ctx = mx.Context.from_device(torch.device(device))
    net = init_bert(cfg, seed, ctx, seq)
    names = list(net.collect_params())
    ids, labels = bert_batch(seed, batch, seq, cfg.vocab_size)
    eager = bert_hybrid_result(net, ids, labels, False)
    eager2 = bert_hybrid_result(net, ids, labels, False)
    hybrid = bert_hybrid_result(net, ids, labels, True)
    noise, _ = compare_steps(eager2, eager, names)
    step, where = compare_steps(hybrid, eager, names)
    bound = max(HYBRID_STEP_BOUND, HYBRID_NOISE_FACTOR * noise)
    log(f"  hybridized vs eager step on {device}: {step:.3e} of the update "
        f"({where}); eager vs eager {noise:.3e}; bound {bound:.3e}")
    check(step <= bound, f"(e) hybridized step vs eager: {step:.3e} at "
                         f"{where}")
    cpu_net = copy_bert(net, cfg, mx.cpu())
    info = {}
    cpu32 = bert_hybrid_result(cpu_net, ids, labels, True)
    cpu64 = bert_recipe_result(cpu_net.double(), ids, labels, info=info)
    del cpu_net
    scales32 = lamb_scales(noise_scales(cpu32, cpu64, names), info)
    ratio, where = compare_steps(hybrid, cpu64, names, scales32)
    log(f"  hybridized fp32 step on {device} vs the CPU's fp64 step: "
        f"{ratio:.3e} of the CPU's fp32 deviation ({where}), bound "
        f"{GLUON_FP32_NOISE_FACTOR:g} (phase 9 (b)'s)")
    check(ratio <= GLUON_FP32_NOISE_FACTOR,
          f"(e) hybridized step vs the CPU: {ratio:.3e} at {where}")
    return {"vs eager": step, "eager noise": noise, "vs CPU": ratio}


def bert_hybrid_timing(seed, steps=FRONT_BERT_STEPS):
    """(e): phase 9 (d)'s recipe (batch 64 x 128, AMP bf16, dropout 0.1,
    LAMB, clip) eager and with the model and loss hybridized: samples/s,
    ms a step, peak memory; flash_attn_fwd launched 12 a step from the
    graph (the count of the captured launches times the replays), and the
    profiler's count of the kernel over two replayed steps.  Returns the
    hybridized run's launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.language import bert
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    cfg = bert.BertConfig()
    ids, labels = bert_batch(seed, BERT_BATCH, BERT_SEQ, cfg.vocab_size)
    mlm, nsp = bert_labels(labels)
    res = {}
    for mode in ("eager", "hybrid"):
        base = memory_base()
        net = init_bert(cfg, seed, mx.gpu(0))
        args = [mx.nd.array(a, ctx=mx.gpu(0), dtype="int32")
                for a in (ids, mlm, nsp)]
        block = bert_recipe_loss(net)
        if mode == "hybrid":
            block.hybridize(static_alloc=True)
        trainer = bert_recipe_trainer(net, GLUON_TIMED_OPT,
                                      GLUON_TIMED_SCHEDULE)
        metrics = [metric.Accuracy(axis=-1, name="mlm_accuracy"),
                   metric.Accuracy(name="nsp_accuracy"), metric.Loss()]
        amp.init()
        try:
            amp.init_trainer(trainer)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = []
            for i in range(BERT_WARMUP + steps):
                if i == BERT_WARMUP:
                    torch.cuda.synchronize()
                    fa_mod._flash_fwd_cuda.launches = 0
                    t1 = time.perf_counter()
                loss, _ = bert_recipe_step(net, trainer, *args, metrics,
                                           loss_block=block)
                losses.append(loss)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            launches = fa_mod._flash_fwd_cuda.launches
            peak = torch.cuda.max_memory_allocated() - base
            vals = [v.asscalar() for v in losses]
            check(all(math.isfinite(v) for v in vals),
                  f"(e) {mode}: non-finite loss")
            check(vals[-1] < vals[0], f"(e) {mode}: the loss did not fall")
            check(launches == cfg.num_layers * steps,
                  f"(e) {mode}: flash_attn_fwd launched {launches} times in "
                  f"{steps} steps, expected {cfg.num_layers * steps}")
            sps = BERT_BATCH * steps / dt
            res[mode] = (sps, 1e3 * dt / steps, peak, launches)
            log(f"  [{gpu_line()}] recipe {mode}: {sps:.1f} samples/s, "
                f"{1e3 * dt / steps:.2f} ms/step, peak memory "
                f"{peak / 2**30:.3f} GiB over the run's start, "
                f"flash_attn_fwd launches "
                f"{launches} in {steps} steps; losses {vals[0]:.4f} .. "
                f"{vals[-1]:.4f}")
            if mode == "hybrid":
                # one profiled step before the two counted, so that the
                # tracer's start-up cannot drop a kernel of theirs
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=2,
                                               repeat=1)) as prof:
                    for _ in range(3):
                        bert_recipe_step(net, trainer, *args, metrics,
                                         loss_block=block)
                        torch.cuda.synchronize()
                        prof.step()
                n = sum(1 for ev in prof.events()
                        if ev.device_type == DeviceType.CUDA
                        and "fa_fwd" in ev.name)
                log(f"  profiler: {n} fa_fwd kernels over 2 replayed steps "
                    f"(expected {2 * cfg.num_layers})")
                check(n == 2 * cfg.num_layers,
                      f"(e) the profiler counts {n} fa_fwd kernels in 2 "
                      f"replayed steps, expected {2 * cfg.num_layers}")
        finally:
            amp.disable()
        del net, trainer, block
        torch.cuda.empty_cache()
    return res["hybrid"][3]


# planted faults of phase 11: each must fail its check
FRONT_FAULTS = ("static_output", "stale_cache", "eager_fallback",
                "stale_generator", "stale_grad_req", "one_capture")


@contextlib.contextmanager
def planted_frontend_fault(fault):
    """"static_output": a replay returns the graph's own output tensors;
    "stale_cache": nothing empties a cache (a parameter tensor replaced
    by another leaves the graph reading the old one); "eager_fallback": a forward that cannot be captured
    runs eagerly (no host-read guard, the capture's error swallowed);
    "stale_generator": reseeding leaves the graphs on the old
    generator; "stale_grad_req": a grad_req changed after the capture is
    not noticed (the graph keeps differentiating the old set);
    "one_capture": a recorded call replays the capture whose previous
    call's backward is still to run."""
    from mxnet_tpu_torch import random as rnd
    from mxnet_tpu_torch.gluon import _cached_op, block, parameter

    with contextlib.ExitStack() as stack:
        G = _cached_op.GraphForward
        if fault == "static_output":
            replay = G.replay

            def no_copy(self, inputs):
                replay(self, inputs)
                return list(self._static_out)

            stack.enter_context(patched(G, "replay", no_copy))
        elif fault == "stale_cache":
            stack.enter_context(patched(block.HybridBlock,
                                        "_bump_cache_version",
                                        lambda self: None))
            stack.enter_context(patched(
                block.HybridBlock, "_valid_params",
                lambda self: self._cached_plist or sorted(
                    self.collect_params().items())))
        elif fault == "eager_fallback":
            init = G.__init__

            def fallback(self, name, apply_fn, plist, leaves, spec, rec):
                try:
                    init(self, name, apply_fn, plist, leaves, spec, rec)
                except Exception:
                    self._fallback = _cached_op.FunctionalForward(
                        apply_fn, plist, spec)

            call = G.__call__

            def run(self, leaves, recording):
                fb = getattr(self, "_fallback", None)
                return fb(leaves, recording) if fb is not None else \
                    call(self, leaves, recording)

            stack.enter_context(patched(G, "__init__", fallback))
            stack.enter_context(patched(G, "__call__", run))
        elif fault == "stale_generator":
            stack.enter_context(patched(rnd, "epoch", lambda: 0))
        elif fault == "stale_grad_req":
            prop = parameter.Parameter.grad_req

            def unnoticed(self, req):
                n = parameter._REBINDS[0]
                prop.fset(self, req)
                parameter._REBINDS[0] = n

            stack.enter_context(patched(parameter.Parameter, "grad_req",
                                        property(prop.fget, unnoticed)))
        elif fault == "one_capture":
            stack.enter_context(patched(G, "_busy", lambda self: False))
        yield


def fault_net(ctx, seed):
    """A small net with Dropout for the planted-fault checks."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn

    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(256, in_units=128, activation="relu"), nn.Dropout(0.5),
            nn.Dense(64, in_units=256))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def hybrid_grad_gaps(ctx, seed):
    """The largest gaps, relative to max(1, |eager|), between the
    hybridized and the eager gradients of a 128 -> 256 -> 64 MLP in
    two recorded sequences: "grad_req" (a step with the first layer at
    grad_req 'null', then a step after it is set back to 'write', as
    when a frozen backbone is unfrozen) and "two calls" (two recorded
    calls of the block on different inputs, then one backward, as a
    discriminator run on real and on fake data)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn

    r = np.random.RandomState(seed + 5)
    x1 = mx.nd.array(r.randn(32, 128), ctx=ctx)
    x2 = mx.nd.array(r.randn(32, 128), ctx=ctx)
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(256, in_units=128, activation="relu"),
            nn.Dense(64, in_units=256))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    params = sorted(net.collect_params().items())

    def grads(hybrid, sequence):
        net.hybridize(hybrid)
        if sequence == "grad_req":
            for req in ("null", "write"):
                for p in net[0].collect_params().values():
                    p.grad_req = req
                with autograd.record():
                    loss = (net(x1) ** 2).sum()
                loss.backward()
        else:
            with autograd.record():
                y1 = net(x1)
                y2 = net(x2)
                loss = (y1 ** 2).sum() + (y1 * y2).sum() + y2.sum()
            loss.backward()
        return [p.grad().asnumpy() for _, p in params]

    gaps = {}
    for sequence in ("grad_req", "two calls"):
        got, want = grads(True, sequence), grads(False, sequence)
        gaps[sequence] = max(float(np.abs(g - w).max()) /
                             max(1.0, float(np.abs(w).max()))
                             for g, w in zip(got, want))
    return gaps


def frontend_fault_checks(seed, device="cuda", fault=None):
    """The six checks the planted faults must fail; returns the names of
    those that failed ({} on a sound port): "kept output" (an output kept
    across a later call stays as it was), "reload" (parameters moved to
    new tensors and rewritten after hybridize(): the cached forward
    follows them), "host read" (a block reading asscalar() in its forward
    raises MXNetError and returns nothing), "reseed" (after random.seed,
    the hybridized train-mode forward draws the masks an eager one draws
    after the same seed), and "grad_req" and "two calls"
    (:func:`hybrid_grad_gaps` within FRONT_TOL)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    ctx = mx.Context.from_device(torch.device(device))
    failed = {}
    planted = planted_frontend_fault(fault) if fault else \
        contextlib.nullcontext()
    with planted:
        net = fault_net(ctx, seed)
        net.hybridize()
        r = np.random.RandomState(seed)
        x1 = mx.nd.array(r.randn(32, 128), ctx=ctx)
        x2 = mx.nd.array(r.randn(32, 128), ctx=ctx)
        a = net(x1)
        kept = a.asnumpy().copy()
        net(x2)
        if not np.array_equal(a.asnumpy(), kept):
            failed["kept output"] = "a kept output changed on the next call"
        net.collect_params().reset_ctx(ctx)
        for p in net.collect_params().values():
            p.set_data(mx.nd.array(r.randn(*p.shape) * 0.1, ctx=ctx))
        got = net(x1).asnumpy()
        net.hybridize(False)
        want = net(x1).asnumpy()
        net.hybridize()
        if not np.array_equal(got, want):
            failed["reload"] = f"stale weights: {np.abs(got - want).max()}"

        class ReadsHost(gluon.HybridBlock):
            def hybrid_forward(self, F, x):
                return x * float(x.sum().asscalar())

        reads = ReadsHost()
        reads.hybridize()
        try:
            reads(x1)
            if torch.device(device).type == "cuda":
                failed["host read"] = "a host read ran (eagerly)"
        except mx.MXNetError:
            pass
        outs = []
        for hybrid in (True, False):
            net.hybridize(hybrid)
            with autograd.record():
                net(x1)                        # the entry, and some draws
            mx.random.seed(seed + 11)
            with autograd.record():
                outs.append(net(x1).asnumpy())
        if not np.array_equal(outs[0], outs[1]):
            failed["reseed"] = "a reseeded graph drew other masks"
        for name, gap in hybrid_grad_gaps(ctx, seed).items():
            if not gap <= FRONT_TOL:
                failed[name] = f"hybrid gradients off eager's by {gap:.3g}"
    return failed


def frontend_phase(seed):
    """Phase 11: (a) to (e) and the planted faults; returns flash_attn_fwd's
    launches over (e)'s hybridized steps, the gluon_bert_lamb_hybrid
    path."""
    t0 = time.perf_counter()
    log(f"== frontend 1: autograd.grad and create_graph (a gradient penalty "
        f"through {GP_WIDTHS[0]} -> {GP_WIDTHS[1]} -> {GP_WIDTHS[0]} at "
        f"batch {GP_BATCH}, eager and hybridized), a Function, foreach, "
        f"while_loop and cond at {FLOW_SHAPE}: card vs CPU within "
        f"{FRONT_TOL:g} of max(1, |CPU|)")
    autograd_checks(seed)
    t1 = time.perf_counter()
    log(f"  (a) {t1 - t0:.1f} s")

    log(f"== frontend 2: the vision zoo, eager against hybrid (CUDA graphs) "
        f"at batch {ZOO_BATCH}, fp32, 1000 classes, and the card's "
        f"hybridized step against the CPU's fp64 step at batch "
        f"{ZOO_CPU_BATCH}")
    zoo_checks(seed)
    t2 = time.perf_counter()
    log(f"  (b) {t2 - t1:.1f} s")

    log(f"== frontend 3: GluonCV's train_imagenet.py, eager and --mode "
        f"hybrid, bf16 AMP, batch {ZOO_TIMED_BATCH}, NAG")
    speed = zoo_timing(seed)
    log("  hybrid over eager, img/s: " + ", ".join(
        f"{n} {v['hybrid'] / v['eager']:.2f}x" for n, v in speed.items()))
    t3 = time.perf_counter()
    log(f"  (c) {t3 - t2:.1f} s")

    log(f"== frontend 4: GluonNLP's word LM through gluon.rnn (medium PTB "
        f"LSTM, {LM_CFG})")
    lm_checks(seed)
    lm_hybrid_timing(seed)
    t4 = time.perf_counter()
    log(f"  (d) {t4 - t3:.1f} s")

    log(f"== frontend 5: GluonNLP's BERT-base LAMB recipe with the model "
        f"and the loss hybridized")
    bert_hybrid_checks(seed)
    launches = bert_hybrid_timing(seed)
    t5 = time.perf_counter()
    log(f"  (e) {t5 - t4:.1f} s")

    log("== frontend 6: planted faults")
    import mxnet_tpu_torch as mx
    gaps = hybrid_grad_gaps(mx.gpu(0), seed)
    log("  hybridized gradients vs eager, of max(1, |eager|): " + ", ".join(
        f"{k} {v:.3e}" for k, v in gaps.items()) + f"; bound {FRONT_TOL:g}")
    check(not frontend_fault_checks(seed), "the sound port fails a "
          "planted-fault check")
    caught = {}
    for fault in FRONT_FAULTS:
        caught[fault] = frontend_fault_checks(seed, fault=fault)
        log(f"  planted {fault}: fails {sorted(caught[fault]) or 'nothing'}")
    check(all(caught.values()), f"a planted fault passes: "
          f"{[f for f, c in caught.items() if not c]}")
    log(f"  faults {time.perf_counter() - t5:.1f} s; phase 11 "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the data path (LibSVM -> CSR -> a factorization machine;
# RecordIO -> ImageRecordIter -> ResNet-50; DataLoader process workers ->
# the BERT-LAMB recipe)
# ---------------------------------------------------------------------------
# (a) a Criteo-shaped factorization machine: 13 integer and 26 categorical
# fields a row, hashed into 2^20 features (the hashing space of the FM
# examples on Criteo), rank 16, batch 1024, SGD's lazy update
FM_FEATURES = 2 ** 20
FM_FIELDS = (13, 26)
FM_RANK, FM_BATCH, FM_STEPS, FM_CPU_STEPS = 16, 1024, 20, 5
FM_LR = 0.05
DATA_TOL = 1e-4
# (b) ImageNet-shaped records: 11 batches of 256 images, each a 256 x 256 x 3
# uint8 .npy (the machine with the card has no PIL: no JPEG, no resize),
# read at ResNet-50's 224 x 224 with a random crop and mirror
REC_BATCH, REC_BATCHES, REC_SIDE = 256, 11, 256
REC_SHAPE = (3, 224, 224)
IMAGENET_NORM = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53,
                     std_r=58.395, std_g=57.12, std_b=57.375)
REC_PREFETCH = 2
# (c) BERT-base pretraining samples through DataLoader process workers into
# phase 9 (d)'s recipe: 10 steps of 64 x 128, resumed after step 5
DL_BATCH, DL_STEPS, DL_WORKERS, DL_RESUME_AT = 64, 10, 4, 5


def _load_example(name, rel):
    """A module of the repository's ``example/`` tree, by file path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fm_example():
    return _load_example("fm_torch",
                         "example/sparse/factorization_machine_torch.py")


def write_criteo_libsvm(path, rows, seed, features=FM_FEATURES,
                        fields=FM_FIELDS):
    """``rows`` Criteo-shaped LibSVM lines from ``seed``: each integer
    field a count (geometric) at its own hashed slot, valued log(1 +
    count); each categorical field a heavy-tailed (Zipf) category hashed
    with its field into ``features`` slots, valued 1; the label from a
    planted linear model, so half the rows are clicks."""
    r = np.random.RandomState(seed)
    n_int, n_cat = fields
    u64 = np.uint64
    ivals = np.log1p(r.geometric(0.15, size=(rows, n_int)) - 1).astype("f")
    islot = ((np.arange(n_int, dtype=u64) + u64(1)) * u64(0x9E3779B1)) \
        % u64(features)
    cats = (r.zipf(1.3, size=(rows, n_cat)) % 1000003).astype(u64)
    field = np.arange(n_cat, dtype=u64)[None, :] + u64(n_int + 1)
    cslot = ((field * u64(0x9E3779B1)) ^ (cats * u64(0x85EBCA77))) \
        % u64(features)
    idx = np.concatenate([np.broadcast_to(islot, (rows, n_int)), cslot],
                         axis=1).astype(np.int64)
    vals = np.concatenate([ivals, np.ones((rows, n_cat), "f")], axis=1)
    w_true = r.randn(features).astype("f") * 0.5
    logit = (vals * w_true[idx]).sum(axis=1) + 0.5 * r.randn(rows)
    labels = (logit > np.median(logit)).astype(int)
    with open(path, "w") as f:
        for k in range(rows):
            f.write(f"{labels[k]} " + " ".join(
                f"{i}:{v:.6g}" for i, v in zip(idx[k], vals[k])) + "\n")


def deviation(cand, ref):
    """max |cand - ref| / max(1, |ref|), over every element (ref on the
    CPU)."""
    cand = cand.detach().to("cpu", torch.float64)
    ref = ref.detach().to("cpu", torch.float64)
    return float(((cand - ref).abs() / ref.abs().clamp(min=1)).max())


def shifted_indptr(csr, row=None):
    """The planted fault of (a): ``csr`` with one row pointer moved on by
    one, so a nonzero changes rows."""
    from mxnet_tpu_torch.ndarray.sparse import CSRNDArray

    indptr = csr.indptr._data.clone()
    row = csr.shape[0] // 2 if row is None else row
    indptr[row] += 1
    return CSRNDArray.create(csr.data._data, csr.indices._data, indptr,
                             csr.shape, csr.context)


def csr_dot_results(csr, dense, tdense, head):
    """(dot(csr, dense), dot(csr, tdense, transpose_a=True), the gradient
    of sum(dot(csr, dense) * head) to ``dense``), as tensors."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    ctx = csr.context
    v = mx.nd.array(dense, ctx=ctx)
    v.attach_grad()
    with autograd.record():
        y = mx.nd.dot(csr, v)
        loss = (y * mx.nd.array(head, ctx=ctx)).sum()
    loss.backward()
    yt = mx.nd.dot(csr, mx.nd.array(tdense, ctx=ctx), transpose_a=True)
    return y._data, yt._data, v.grad._data


def csr_dot_check(cand_csr, ref_csr, seed, rank=FM_RANK):
    """(a)'s products on ``cand_csr``'s device against ``ref_csr``'s (the
    CPU): {name: deviation}."""
    r = np.random.RandomState(seed)
    rows, cols = ref_csr.shape
    dense = r.randn(cols, rank).astype("f")
    tdense = r.randn(rows, rank).astype("f")
    head = r.randn(rows, rank).astype("f")
    cand = csr_dot_results(cand_csr, dense, tdense, head)
    ref = csr_dot_results(ref_csr, dense, tdense, head)
    return {name: deviation(c, w) for name, c, w in zip(
        ("dot", "dot transpose_a", "gradient to the dense operand"),
        cand, ref)}


def fm_run(it, ctx, steps, seed, rank=FM_RANK, lr=FM_LR):
    """The FM example's local mode over the LibSVMIter ``it`` (made on
    ``ctx``) from its start, SGD's lazy update: (losses, ms a step, the
    batches' nonzeros)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer

    fm = fm_example()
    rs = np.random.RandomState(seed)
    features = it.data_shape[0]
    it.reset()
    with ctx:
        w0 = mx.nd.zeros((1,))
        w0.attach_grad()
        w = mx.nd.zeros((features, 1))
        V = mx.nd.array((rs.randn(features, rank) * 0.01).astype("f"))
        for p in (w, V):
            p.attach_grad()
    updater = optimizer.get_updater(optimizer.create(
        "sgd", learning_rate=lr, lazy_update=True))
    batches = []
    for b in it:
        batches.append((b.data[0], b.label[0]))
        if len(batches) == steps:
            break
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [fm.sgd_step(x, y, w0, (w, V), lr, updater) for x, y in batches]
    losses = [v.asscalar() for v in losses]
    ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    return losses, ms, sum(int(x.data.shape[0]) for x, _ in batches)


def data_fm(seed, device="cuda", features=FM_FEATURES, batch=FM_BATCH,
            steps=FM_STEPS, cpu_steps=FM_CPU_STEPS, directory=None):
    """(a): the LibSVM file written, read by LibSVMIter on the card and on
    the CPU; the CSR products and the gradient card against CPU within
    DATA_TOL of max(1, |CPU|), a shifted row pointer beyond it; ``steps``
    lazy-SGD steps of the FM example's local mode on the card, the loss
    falling, the first ``cpu_steps`` within DATA_TOL of the CPU's.
    Returns the figures."""
    import mxnet_tpu_torch as mx

    card = mx.Context.from_device(torch.device(device))
    with tempfile.TemporaryDirectory(dir=directory) as tmp:
        path = os.path.join(tmp, "criteo.libsvm")
        t0 = time.perf_counter()
        write_criteo_libsvm(path, batch * steps, seed, features)
        t1 = time.perf_counter()
        its = []
        for ctx in (card, mx.cpu()):
            with ctx:
                its.append(mx.io.LibSVMIter(data_libsvm=path,
                                            data_shape=(features,),
                                            batch_size=batch))
        first, first_cpu = (next(it) for it in its)
        csr = first.data[0]
        check(csr.stype == "csr" and csr.context == card,
              "LibSVMIter's batch is not a CSR array on the card")
        devs = csr_dot_check(csr, first_cpu.data[0], seed)
        fault = max(csr_dot_check(shifted_indptr(csr), first_cpu.data[0],
                                  seed).values())
        losses, ms, nnz = fm_run(its[0], card, steps, seed)
        cpu_losses, cpu_ms, _ = fm_run(its[1], mx.cpu(), cpu_steps, seed)
    gaps = [abs(a - b) / max(1.0, abs(b))
            for a, b in zip(losses, cpu_losses)]
    return {"devs": devs, "fault": fault, "losses": losses,
            "cpu_losses": cpu_losses, "gaps": gaps, "ms": ms,
            "cpu_ms": cpu_ms, "nnz": nnz, "write_s": t1 - t0,
            "nnz_first": int(csr.data.shape[0])}


def write_image_records(directory, count, side, seed):
    """``count`` random ``side`` x ``side`` x 3 uint8 images as .npy
    records (``recordio.pack_img``'s default) with an index; returns the
    .rec path and its bytes."""
    from mxnet_tpu_torch import recordio

    rec = os.path.join(directory, "images.rec")
    w = recordio.MXIndexedRecordIO(os.path.join(directory, "images.idx"),
                                   rec, "w")
    r = np.random.RandomState(seed)
    for i in range(count):
        img = np.frombuffer(r.bytes(side * side * 3), np.uint8).reshape(
            side, side, 3)
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % 1000), i, 0), img))
    w.close()
    return rec, os.path.getsize(rec)


def image_iter(rec, threads, batch=REC_BATCH, shape=REC_SHAPE, seed=0):
    """ImageRecordIter as a ResNet-50 ImageNet job reads: shuffled, random
    crop and mirror, ImageNet's mean and std, no resize."""
    import mxnet_tpu_torch as mx

    return mx.io.ImageRecordIter(
        path_imgrec=rec, data_shape=shape, batch_size=batch, shuffle=True,
        rand_crop=True, rand_mirror=True, resize=-1, seed=seed,
        preprocess_threads=threads, **IMAGENET_NORM)


def decoded_batch_oracle(rec, batch=REC_BATCH, shape=REC_SHAPE, seed=0):
    """The first batch of :func:`image_iter`, decoded here from the native
    reader's payloads with the per-record seeding written out (numpy
    only, no iterator)."""
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.native import NativeRecordReader

    reader = NativeRecordReader(rec, batch, shuffle=True, seed=seed)
    payloads = reader.next_batch()
    reader.close()
    c, h, w = shape
    mean = np.array([IMAGENET_NORM[f"mean_{k}"] for k in "rgb"], "f")
    std = np.array([IMAGENET_NORM[f"std_{k}"] for k in "rgb"], "f")
    out = []
    for index, payload in enumerate(payloads):
        rng = np.random.RandomState((seed * 1000003 + index) % (2 ** 31))
        img = recordio.unpack_img(payload)[1]
        y0 = rng.randint(0, img.shape[0] - h + 1)
        x0 = rng.randint(0, img.shape[1] - w + 1)
        img = img[y0:y0 + h, x0:x0 + w]
        if rng.rand() < 0.5:
            img = img[:, ::-1]
        out.append(((img.astype("f") - mean) / std).transpose(2, 0, 1))
    return np.stack(out)


@contextlib.contextmanager
def planted_decode_fault():
    """(b)'s planted fault: every record's crop and mirror drawn from one
    shared stream instead of the record's own seed."""
    from mxnet_tpu_torch import io as mio

    shared = np.random.RandomState(0)

    def decode(self, payload, index, out=None):
        header, img = self._rio.unpack_img(payload)
        return self._augment(img, shared, out), header.label

    with patched(mio.ImageRecordIter, "_decode", decode):
        yield


def record_batch_checks(rec, threads, batch=REC_BATCH, shape=REC_SHAPE,
                        one_thread=True):
    """The first batch at 1 decode thread and at ``threads``, and the
    oracle's: (1 == N bit for bit, or None without ``one_thread``; N ==
    oracle bit for bit)."""
    import mxnet_tpu_torch as mx

    firsts = []
    for n in ((1, threads) if one_thread else (threads,)):
        with mx.cpu():
            it = image_iter(rec, n, batch, shape)
            firsts.append(next(it).data[0].asnumpy())
        it.close()
    oracle = decoded_batch_oracle(rec, batch, shape)
    return (bool(np.array_equal(firsts[0], firsts[1])) if one_thread
            else None, bool(np.array_equal(firsts[-1], oracle)))


def loader_img_s(rec, threads, batch=REC_BATCH, shape=REC_SHAPE):
    """ImageRecordIter alone: one epoch on the host, img/s."""
    import mxnet_tpu_torch as mx

    with mx.cpu():
        it = image_iter(rec, threads, batch, shape)
        t0 = time.perf_counter()
        n = sum(b.data[0].shape[0] - b.pad for b in it)
        dt = time.perf_counter() - t0
    it.close()
    return n / dt, n


def nchw_front(net):
    """``net`` (NHWC) behind a transpose from the iterator's NCHW, on the
    card, so the loader's batches feed bench.py's NHWC ResNet-50."""
    from mxnet_tpu_torch.gluon import HybridBlock

    class NCHWFront(HybridBlock):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def hybrid_forward(self, F, x):
            return self.inner(F.transpose(x, axes=(0, 2, 3, 1)))

    return NCHWFront(net)


def record_training_runs(rec, net, threads, order, device="cuda",
                         profile=False):
    """One epoch of ``rec`` through ``TrainStep.run`` (SGD 0.1 / 0.9, bf16)
    for each prefetch depth in ``order``, each run from ``net``'s weights
    and a fresh iterator (the same batches): [(prefetch, losses, seconds,
    images)].  ``profile``: under the profiler (its busy share)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep

    out = []
    for prefetch in order:
        step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                         optimizer="sgd", optimizer_params=TRAIN_OPT,
                         dtype="bfloat16", device=device)
        with mx.cpu():      # host batches: TrainStep stages them
            it = image_iter(rec, threads)
        batches = ((b.data[0], b.label[0]) for b in it)

        def run():
            return step.run(batches, prefetch=prefetch)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile:
            holder = []
            log(f"  prefetch {prefetch}, profiled:")
            log_device_profile(lambda: holder.append(run()),
                               TRAIN_KERNEL_GROUPS, n_top=4)
            losses = holder[0]
        else:
            losses = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        it.close()
        out.append((prefetch, [v.item() for v in losses], dt,
                    REC_BATCH * len(losses)))
        del step
    return out


def synthetic_img_s(net, steps=10, warmup=2):
    """bench.py's configuration on one synthetic batch already on the card
    (phase 5 (4)'s measure, fewer steps)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep

    x, y = train_batch(0, REC_BATCH)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().cuda()
    yt = torch.from_numpy(y).cuda()
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd", optimizer_params=TRAIN_OPT,
                     dtype="bfloat16")
    for _ in range(warmup):
        step(xt, yt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(xt, yt)
    torch.cuda.synchronize()
    return REC_BATCH * steps / (time.perf_counter() - t0)


def data_records(seed, synthetic_phase5=None):
    """(b): the records written, their first batch at 1 thread and at
    os.cpu_count() equal bit for bit and equal to the oracle (a planted
    shared-stream decode must fail it), the iterator's img/s alone, then
    ResNet-50 v1 (bench.py's bf16 configuration) through TrainStep.run at
    prefetch 0 and REC_PREFETCH in turns (0, 2, 2, 0) over the same
    batches, each run's img/s beside the synthetic batch's, the losses
    equal, and a profiled run of each for the card's busy share."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    threads = os.cpu_count() or 1
    out = {"threads": threads}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rec, nbytes = write_image_records(tmp, REC_BATCH * REC_BATCHES,
                                          REC_SIDE, seed)
        out["write_s"], out["bytes"] = time.perf_counter() - t0, nbytes
        log(f"  {REC_BATCH * REC_BATCHES} records of {REC_SIDE}x{REC_SIDE}"
            f"x3 uint8 .npy, {nbytes / 1e6:.1f} MB, written in "
            f"{out['write_s']:.2f} s")
        t1 = time.perf_counter()
        same, oracle = record_batch_checks(rec, threads)
        log(f"  first batch: 1 thread == {threads} threads bit for bit: "
            f"{same}; == the oracle (per-record seeds written out): "
            f"{oracle}")
        check(same and oracle, "ImageRecordIter's batch depends on its "
                               "thread count or differs from the oracle")
        with planted_decode_fault():
            f_oracle = record_batch_checks(rec, threads,
                                           one_thread=False)[1]
        log(f"  planted shared-stream decode: {threads} threads == the "
            f"oracle {f_oracle}")
        check(not f_oracle, "the record check passes a shared-stream "
                            "decode")
        t2 = time.perf_counter()
        out["loader_img_s"], n = loader_img_s(rec, threads)
        log(f"  [{gpu_line()}] ImageRecordIter alone ({threads} decode "
            f"threads, batches on the host): {out['loader_img_s']:.1f} "
            f"img/s over {n} images")

        t3 = time.perf_counter()
        net = init_net(resnet50, seed, mx.gpu(0))
        front = nchw_front(net)
        fa_mod._flash_fwd_cuda.launches = 0
        out["synthetic_img_s"] = synthetic_img_s(front)
        t4 = time.perf_counter()
        runs = record_training_runs(rec, front, threads,
                                    (0, REC_PREFETCH, REC_PREFETCH, 0))
        t5 = time.perf_counter()
        record_training_runs(rec, front, threads, (0, REC_PREFETCH),
                             profile=True)
        out["launches"] = fa_mod._flash_fwd_cuda.launches
        log(f"  seconds: the checks {t2 - t1:.1f}, the iterator alone "
            f"{t3 - t2:.1f}, the net and the synthetic batch {t4 - t3:.1f}, "
            f"4 runs {t5 - t4:.1f}, 2 profiled {time.perf_counter() - t5:.1f}")
    base = [r for r in runs if r[0] == 0]
    allowed, gap = resume_rule(dict(enumerate(base[0][1])),
                               dict(enumerate(base[1][1])))
    worst = max(abs(a - b) for r in runs for a, b in zip(r[1], base[0][1]))
    out["img_s"] = {}
    for p, losses, secs, n in runs:
        out["img_s"].setdefault(p, []).append(n / secs)
    ph5 = "not run" if synthetic_phase5 is None else \
        f"{synthetic_phase5:.1f}"
    log(f"  losses (prefetch 0): {' '.join(f'{v:.4f}' for v in base[0][1])}"
        f"; largest gap between runs {worst:.3e} (prefetch 0 against "
        f"itself {gap:.3e}, allowed {allowed:.3e})")
    log(f"  [{gpu_line()}] ResNet-50 bf16 from the records, img/s: "
        + ", ".join(f"prefetch {p} " + " / ".join(f"{v:.1f}" for v in vs)
                    for p, vs in out["img_s"].items())
        + f"; synthetic batch on the card {out['synthetic_img_s']:.1f} "
          f"(phase 5 in this run: {ph5})")
    check(all(len(r[1]) == REC_BATCHES for r in runs), "a run lost a batch")
    check(all(math.isfinite(v) for r in runs for v in r[1]),
          "non-finite loss from the records")
    check(worst <= allowed, f"TrainStep.run with prefetch {REC_PREFETCH} "
                            f"gives other losses ({worst:.3e} > "
                            f"{allowed:.3e})")
    check(out["launches"] == 0, "the record path launched flash_attn_fwd")
    del net, front
    torch.cuda.empty_cache()
    return out


class BertSamples:
    """BERT-base pretraining samples (ids, MLM labels, NSP label) as a
    Dataset; each item also records whether its process had initialised
    CUDA (``torch.cuda.is_initialized()``), the field (c) reads from the
    workers.  ``touch_card`` makes the item reach for the card (the
    check that such a worker fails loudly)."""

    def __init__(self, ids, mlm, nsp, touch_card=False):
        self.ids, self.mlm, self.nsp = ids, mlm, nsp
        self.touch_card = touch_card

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        if self.touch_card:
            torch.zeros(1, device="cuda")
        return (self.ids[i], self.mlm[i], self.nsp[i],
                torch.cuda.is_initialized())


def bert_samples(seed, n, seq, vocab):
    ids, labels = bert_batch(seed, n, seq, vocab)
    mlm, nsp = bert_labels(labels)
    return ids, mlm, nsp


def bert_loader(samples, seed, workers, device, batch=DL_BATCH):
    """The DataLoader of (c): shuffled from ``seed``, ``workers`` spawned
    process workers, batches prefetched to ``device``."""
    from mxnet_tpu_torch.gluon import data

    return data.DataLoader(
        samples, batch_size=batch,
        sampler=data.RandomSampler(len(samples), seed=seed),
        num_workers=workers, thread_pool=False,
        prefetch_to_device=torch.device(device))


def _host_batch(batch):
    return tuple(a.asnumpy() for a in batch[:3])


def dataloader_recipe(seed, device="cuda", cfg=None, steps=DL_STEPS,
                      workers=DL_WORKERS, seq=BERT_SEQ, batch=DL_BATCH,
                      resume_at=DL_RESUME_AT):
    """(c): phase 9 (d)'s recipe (AMP bf16, dropout 0.1, LAMB, clip) for
    ``steps`` steps fed by the DataLoader, and again fed the same batches
    from a list; then the loader's next epoch, its state captured by
    ``capture_train_state`` after DL_RESUME_AT batches and the batches
    after it kept (``resume_at`` of them).  Returns the figures."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import lifecycle
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.language import bert
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    cfg = cfg or bert.BertConfig()
    ctx = mx.Context.from_device(torch.device(device))
    samples = BertSamples(*bert_samples(seed, batch * steps, seq,
                                        cfg.vocab_size))
    order = np.random.RandomState(seed).permutation(len(samples))

    def recipe(feed, timed=False):
        """(losses, batches, flash_attn_fwd launches over the steps, the
        seconds to the first batch and for the steps after it)."""
        net = init_bert(cfg, seed, ctx, seq)
        trainer = bert_recipe_trainer(net, GLUON_TIMED_OPT,
                                      GLUON_TIMED_SCHEDULE)
        amp.init()
        try:
            amp.init_trainer(trainer)
            mx.random.seed(seed + 1)
            fa_mod._flash_fwd_cuda.launches = 0
            losses, batches, t = [], [], [time.perf_counter()]
            for b in feed:
                if not batches:
                    t.append(time.perf_counter())
                batches.append(b)
                losses.append(bert_recipe_step(net, trainer, *b[:3])[0])
                if len(losses) == steps:
                    break
            losses = [v.asscalar() for v in losses]
            t.append(time.perf_counter())
            return (losses, batches, fa_mod._flash_fwd_cuda.launches,
                    t[1] - t[0], t[2] - t[1])
        finally:
            amp.disable()

    as_list = [tuple(mx.nd.array(a[order[k * batch:(k + 1) * batch]],
                                 ctx=ctx, dtype="int32")
                     for a in (samples.ids, samples.mlm, samples.nsp))
               for k in range(steps)]
    want, _, _, _, list_secs = recipe(as_list)
    loader = bert_loader(samples, seed, workers, device, batch)
    with loader:
        feed = iter(loader)
        got, batches, launches, first_secs, secs = recipe(feed)
        feed.close()
        inited = [bool(v) for b in batches for v in b[3].asnumpy()]
        on_card = all(a.context == ctx for b in batches for a in b)
        it = iter(loader)
        for _ in range(resume_at):
            next(it)
        state = lifecycle.capture_train_state(step=resume_at,
                                              dataloader=loader)
        tail = [_host_batch(b) for b in it]
    return {"losses": got, "list_losses": want, "launches": launches,
            "seconds": secs, "list_seconds": list_secs,
            "first_seconds": first_secs, "inited": inited,
            "on_card": on_card,
            "state": state, "tail": tail, "samples": samples,
            "batch": batch}


def resume_checks(out, seed, device="cuda", workers=DL_WORKERS):
    """A fresh loader (another sampler seed, as a relaunched job makes
    it) against the batches of (c)'s first loader after the capture: its
    first epoch as it comes (the planted fault: the restore skipped), then
    after ``restore_train_state`` of the captured state.  Returns (the
    unrestored batches equal, the restored ones equal), bit for bit; one
    pool serves both."""
    from mxnet_tpu_torch import lifecycle

    def equal(loader):
        got = [_host_batch(b) for b in loader][:len(out["tail"])]
        return len(got) == len(out["tail"]) > 0 and all(
            np.array_equal(a, b) for r, t in zip(got, out["tail"])
            for a, b in zip(r, t))

    with bert_loader(out["samples"], seed + 17, workers, device,
                     out["batch"]) as fresh:
        unrestored = equal(fresh)
        lifecycle.restore_train_state(out["state"], dataloader=fresh)
        return unrestored, equal(fresh)


def touching_worker_fails(seed, device="cuda", vocab=30522, seq=BERT_SEQ):
    """A dataset that reaches for the card inside a worker: the loader
    raises MXNetError (the worker sees no card), naming the batch."""
    import mxnet_tpu_torch as mx

    samples = BertSamples(*bert_samples(seed, DL_BATCH, seq, vocab),
                          touch_card=True)
    loader = bert_loader(samples, seed, 1, device)
    try:
        with loader:
            next(iter(loader))
    except mx.MXNetError as e:
        return str(e).splitlines()[0]
    return None


def data_phase(seed, synthetic_phase5=None):
    """Phase 12: (a) to (c); returns flash_attn_fwd's launches over (c)'s
    loader-fed steps, the gluon_bert_dataloader path."""
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    t0 = time.perf_counter()
    log(f"== data 1: a Criteo-shaped factorization machine ({FM_FIELDS[0]} "
        f"integer + {FM_FIELDS[1]} categorical fields hashed into "
        f"{FM_FEATURES} features, rank {FM_RANK}, batch {FM_BATCH}): "
        f"LibSVM -> LibSVMIter -> CSR -> nd.dot -> SGD's lazy update")
    fm = data_fm(seed)
    log(f"  LibSVM file of {FM_BATCH * FM_STEPS} rows written in "
        f"{fm['write_s']:.2f} s; the first batch {fm['nnz_first']} "
        f"nonzeros")
    log("  card vs CPU, of max(1, |CPU|): " + ", ".join(
        f"{k} {v:.3e}" for k, v in fm["devs"].items())
        + f"; bound {DATA_TOL:g}; a shifted row pointer: "
          f"{fm['fault']:.3e}")
    check(max(fm["devs"].values()) <= DATA_TOL,
          "the CSR product on the card is off the CPU's")
    check(fm["fault"] > DATA_TOL, "the CSR check misses a shifted row "
                                  "pointer")
    log(f"  losses: {' '.join(f'{v:.4f}' for v in fm['losses'])}")
    log(f"  the first {FM_CPU_STEPS} against the CPU's: " + " ".join(
        f"{g:.2e}" for g in fm["gaps"]) + f"; bound {DATA_TOL:g}")
    check(all(math.isfinite(v) for v in fm["losses"]), "non-finite FM loss")
    check(fm["losses"][-1] < fm["losses"][0], "the FM loss did not fall")
    check(max(fm["gaps"]) <= DATA_TOL, "the FM steps on the card are off "
                                       "the CPU's")
    log(f"  [{gpu_line()}] {fm['ms']:.2f} ms a step on the card over "
        f"{FM_STEPS} steps ({fm['nnz']} nonzeros), the CPU "
        f"{fm['cpu_ms']:.2f} ms")
    t1 = time.perf_counter()
    log(f"  (a) {t1 - t0:.1f} s")

    log(f"== data 2: {REC_BATCHES} batches of {REC_BATCH} ImageNet-shaped "
        f"records -> ImageRecordIter {REC_SHAPE} (shuffle, crop, mirror, "
        f"ImageNet mean/std) -> ResNet-50 v1 bf16 through TrainStep.run")
    data_records(seed, synthetic_phase5)
    t2 = time.perf_counter()
    log(f"  (b) {t2 - t1:.1f} s")

    cfg = bert.BertConfig()
    log(f"== data 3: BERT-base samples ({DL_BATCH} x {BERT_SEQ} a batch) "
        f"through DataLoader({DL_WORKERS} spawned process workers, "
        f"prefetch_to_device) into phase 9 (d)'s recipe, {DL_STEPS} steps")

    def touching():
        t = time.perf_counter()
        return touching_worker_fails(seed), time.perf_counter() - t

    # the loader whose worker reaches for the card starts its own pool
    # (~12 s of spawn and import) beside the recipe's
    touch = in_thread(touching)
    out = dataloader_recipe(seed, cfg=cfg)
    t3 = time.perf_counter()
    planted, same_tail = resume_checks(out, seed)
    t4 = time.perf_counter()
    gap = max(abs(a - b) for a, b in zip(out["losses"], out["list_losses"]))
    log(f"  losses: {' '.join(f'{v:.6f}' for v in out['losses'])}; fed "
        f"from a list: largest gap {gap:.3e}")
    log(f"  workers' torch.cuda.is_initialized(): {sorted(set(out['inited']))}"
        f" over {len(out['inited'])} samples; batches on the card: "
        f"{out['on_card']}; flash_attn_fwd launches {out['launches']}; "
        f"the first batch after {out['first_seconds']:.2f} s (the pool's "
        f"start), the steps after it {out['seconds']:.2f} s (fed from a "
        f"list {out['list_seconds']:.2f} s)")
    check(gap == 0, "the loader-fed recipe's losses differ from the "
                    "list-fed ones")
    check(out["inited"] and not any(out["inited"]),
          "a DataLoader worker initialised CUDA")
    check(out["on_card"], "the loader's batches are not on the card")
    check(out["launches"] == cfg.num_layers * DL_STEPS,
          f"flash_attn_fwd launched {out['launches']} times in {DL_STEPS} "
          f"steps, expected {cfg.num_layers * DL_STEPS}")
    log(f"  resume after step {DL_RESUME_AT}: a fresh loader restored by "
        f"restore_train_state gives the next {DL_STEPS - DL_RESUME_AT} "
        f"batches bit for bit: {same_tail}; planted, the restore skipped: "
        f"{planted} (state {json.dumps(out['state']['dataloader'])}; "
        f"{t4 - t3:.1f} s)")
    check(same_tail, "the restored loader's batches differ")
    check(not planted, "the resume check passes a loader that was not "
                       "restored")
    err, secs = joined(*touch)
    log(f"  a dataset that reaches for the card in a worker: "
        f"{err or 'no error'} ({secs:.1f} s, on a thread beside the "
        f"recipe)")
    check(err is not None, "a worker reached the card without an error")
    log(f"  (c) {time.perf_counter() - t2:.1f} s; phase 12 "
        f"{time.perf_counter() - t0:.1f} s")
    return out["launches"]


# ---------------------------------------------------------------------------
# phase 13: the runtime planes
# ---------------------------------------------------------------------------
PLANES_PROFILED_STEPS = 3       # (a): 3 profiled steps, 12 launches each
PLANES_MFU_STEPS = 100          # (b): timed hybridized steps (gauge window)
PLANES_FLOP_TOL = 0.01          # (b): counted FLOPs vs the analytic count
PLANES_MFU_TOL = 0.02           # (b): the gauge vs FLOPs x steps / window
PLANES_GUARD_STEPS, PLANES_NAN_AT, PLANES_SPIKE_AT = 10, 9, 10   # (c)
PLANES_SPIKE = 1e3              # (c): the planted loss spike's factor
# (c) rewind: a checkpoint after step 3, a persistent NaN weight from step
# 5 on, GuardRewind at the second anomalous step (rewind_after 2)
PLANES_REWIND_STEPS, PLANES_SAVE_AT, PLANES_FAULT_AT = 6, 3, 5
PLANES_REWIND_AFTER = 2
# (d): the watchdog child's deadline and poll, the step that arms the seam
PLANES_WD_TIMEOUT, PLANES_WD_POLL, PLANES_WD_ARM_AT = 5.0, 0.25, 3
PLANES_WD_STEPS = 40
# the child's recipe at its tiny size (head dim 32, which the kernel takes)
PLANES_WD_TINY = dict(vocab_size=96, hidden_size=64, num_layers=2,
                      num_heads=2, intermediate_size=128, max_position=32)
PLANES_WD_TINY_SEQ, PLANES_WD_TINY_BATCH = 16, 2
# (e): the shapes the tiles are tuned at (BERT's attention, bf16, and a
# causal GQA prefill at L 2048), and the shapes every tile is checked at
PLANES_TUNE_SHAPES = {"bert": BERT_SHAPE,
                      "l2048": (1, 32, 8, 2048, 2048, 128, True, False)}
PLANES_TILE_CASES = [BERT_SHAPE, PLANES_TUNE_SHAPES["l2048"],
                     (1, 32, 8, 1000, 1000, 128, True, False),
                     (1, 32, 8, 100, 1100, 128, True, False),
                     (2, 32, 8, 300, 700, 128, True, True),
                     (2, 12, 12, 384, 384, 64, True, True),
                     (1, 8, 2, 200, 300, 64, False, False)]
PLANES_TUNE_ITERS = 10          # graph replays a unit of search budget


def planes_build(cfg, seed, device, seq):
    """Phase 9 (d)'s recipe (LAMB under its timed schedule, clip, bf16 AMP
    on the card: ``amp.init()`` must be on there) on a net from ``seed``;
    the steps' dropout stream seeded from ``seed`` + 1, so two builds run
    the same steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp

    net = init_bert(cfg, seed, _resume_ctx(device), seq)
    trainer = bert_recipe_trainer(net, GLUON_TIMED_OPT, GLUON_TIMED_SCHEDULE)
    if torch.device(device).type == "cuda":
        amp.init_trainer(trainer)
    mx.random.seed(seed + 1)
    return net, trainer


def planes_args(seed, k, batch, seq, vocab, device):
    """Step ``k``'s batch (ids, MLM labels, NSP labels) on the device."""
    import mxnet_tpu_torch as mx

    ids, labels = bert_batch(seed * 1000 + k, batch, seq, vocab)
    mlm, nsp = bert_labels(labels)
    return [mx.nd.array(a, ctx=_resume_ctx(device), dtype="int32")
            for a in (ids, mlm, nsp)]


def planes_steps(net, trainer, seed, first, last, cfg, batch, seq, device,
                 before_step=None, after_step=None, loss_block=None,
                 guarded=False):
    """Steps ``first``..``last`` of the recipe; returns their losses
    (NDArrays, read by the caller).  ``before_step(k, loss)`` runs between
    the clip and ``trainer.step``, ``after_step(k, loss)`` after it.
    ``guarded``: the clip's finiteness check is off, the guard owns the
    verdict."""
    losses = {}
    for k in range(first, last + 1):
        args = planes_args(seed, k, batch, seq, cfg.vocab_size, device)
        hook = None if before_step is None else \
            (lambda loss, k=k: before_step(k, loss))
        losses[k], _ = bert_recipe_step(
            net, trainer, *args, before_step=hook, loss_block=loss_block,
            clip_check=False if guarded else None)
        if after_step is not None:
            after_step(k, losses[k])
    return losses


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def planes_timed(net, trainer, seed, first, last, cfg, batch, seq, device,
                 **kw):
    """planes_steps timed: (losses as floats, ms a step); the card is
    synchronised before and after."""
    _sync(device)
    t0 = time.perf_counter()
    losses = planes_steps(net, trainer, seed, first, last, cfg, batch, seq,
                          device, **kw)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / (last - first + 1)
    return {k: float(v.asscalar()) for k, v in losses.items()}, ms


def _dumps_rows(table):
    """{op name: count} of the profiler's dumps() op rows."""
    rows = {}
    for line in table.splitlines()[2:]:
        parts = line.split()
        if len(parts) < 7 or not parts[1].isdigit():
            break
        rows[parts[0]] = int(parts[1])
    return rows


def planes_profiler(seed, directory, device="cuda", cfg=None,
                    batch=BERT_BATCH, seq=BERT_SEQ,
                    steps=PLANES_PROFILED_STEPS):
    """(a) The recipe's steps 2..1+steps twice from the same weights and
    dropout stream: plain, then under ``profiler`` with profile_all (the
    device trace on the card).  The Chrome dump holds one device event of
    flash_attn_fwd's kernel per launch counted over the profiled steps,
    the op spans, a marker and a counter; ``dumps()`` has a row for every
    op the steps invoked, with its count; the profiled losses equal the
    plain ones bit for bit.  Returns the numbers."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels, profiler
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    cfg = cfg or bert.BertConfig()
    cuda = torch.device(device).type == "cuda"
    out = {}
    for profiled in (False, True):
        net, trainer = planes_build(cfg, seed, device, seq)
        planes_timed(net, trainer, seed, 1, 1, cfg, batch, seq, device)
        if profiled:
            path = os.path.join(directory, "profile.json")
            profiler.set_config(profile_all=True, filename=path,
                                device_trace=cuda)
            profiler.dumps(reset=True)
            mx.nd.reset_dispatch_stats()
            before = _kernels.launch_counts().get("flash_attn_fwd", 0)
            profiler.start()
        try:
            losses, ms = planes_timed(net, trainer, seed, 2, 1 + steps, cfg,
                                      batch, seq, device)
            if profiled:
                profiler.Marker(name="planes_steps_done").mark()
                profiler.Counter(name="planes_steps", value=steps)
        finally:
            if profiled:
                profiler.stop()
        if profiled:
            launches = _kernels.launch_counts().get("flash_attn_fwd",
                                                    0) - before
            trace = json.load(open(profiler.dump()))
            rows = _dumps_rows(profiler.dumps(reset=True))
            calls = {name: c["calls"] for name, c in
                     mx.nd.dispatch_stats()["per_op"].items()}
            profiler.set_config()
            evs = trace["traceEvents"]
            kernels = [e for e in evs if e.get("cat") == "kernel"]
            attn = [e for e in kernels if "fa_fwd_wgmma" in e["name"]]
            out.update(
                profiled_losses=losses, profiled_ms=ms, launches=launches,
                attention_events=len(attn), kernel_events=len(kernels),
                attention_device_ms=sum(e["dur"] for e in attn) / 1e3,
                op_events=sum(e.get("cat") == "operator" for e in evs),
                markers=[e["name"] for e in evs if e.get("ph") == "i"],
                counters=[e["name"] for e in evs if e.get("ph") == "C"],
                rows=rows, calls=calls, bytes=os.path.getsize(path))
        else:
            out.update(losses=losses, ms=ms)
        del net, trainer
    return out


def check_planes_profiler(out, cfg, steps=PLANES_PROFILED_STEPS,
                          cuda=True):
    log(f"  [{gpu_line() if cuda else 'cpu'}] profiled steps: "
        f"{out['profiled_ms']:.2f} ms a step against {out['ms']:.2f} "
        f"without the profiler ({out['profiled_ms'] / out['ms']:.2f}x: "
        f"profile_all syncs the card after every op); trace "
        f"{out['bytes'] / 1e6:.2f} MB, {out['op_events']} op spans, "
        f"{out['kernel_events']} device events, "
        f"{out['attention_events']} of flash_attn_fwd's kernel "
        f"({out['attention_device_ms']:.3f} ms of device time); "
        f"launches counted {out['launches']}; {len(out['rows'])} dumps() "
        f"rows")
    check(out["profiled_losses"] == out["losses"],
          f"(a) the profiled losses {out['profiled_losses']} differ from "
          f"the plain ones {out['losses']}")
    if cuda:
        check(out["launches"] == cfg.num_layers * steps,
              f"(a) flash_attn_fwd launched {out['launches']} times over "
              f"{steps} steps, expected {cfg.num_layers * steps}")
        check(out["attention_events"] == out["launches"],
              f"(a) {out['attention_events']} device events of the "
              f"kernel in the trace, {out['launches']} launches")
    check(out["op_events"] > 0 and out["markers"] == ["planes_steps_done"]
          and "planes_steps" in out["counters"],
          "(a) the trace lacks op spans, the marker or the counter")
    check(out["rows"] == out["calls"],
          "(a) dumps() rows differ from the ops the steps invoked: "
          f"{sorted(set(out['rows']) ^ set(out['calls']))}")


def planes_flops(seed, device="cuda", cfg=None, batch=BERT_BATCH,
                 seq=BERT_SEQ, steps=PLANES_MFU_STEPS):
    """(b) One recipe step's FLOPs counted (``introspection.counting``)
    against ``bert_step_flops``, and with the attention's report left out
    (planted).  On the card, the recipe with the model and the loss
    hybridized: its graphs' counts (taken once, at the capture) against
    the eager count, then ``steps`` timed steps with the window reset:
    the MFU gauge against FLOPs x steps / (window x peak), and bench.py's
    MFU.  Returns the numbers."""
    from mxnet_tpu_torch import introspection
    from mxnet_tpu_torch.gluon.model_zoo.language import bert
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    cfg = cfg or bert.BertConfig()
    net, trainer = planes_build(cfg, seed, device, seq)
    args = planes_args(seed, 1, batch, seq, cfg.vocab_size, device)
    with introspection.counting() as rec:
        bert_recipe_step(net, trainer, *args)
    with patched(fa_mod, "_report", lambda *a, **k: None):
        with introspection.counting() as planted:
            bert_recipe_step(net, trainer, *args)
    out = {"want": bert_step_flops(cfg, batch, seq), "eager": rec["flops"],
           "attention": rec["reported"].get("attention", 0.0),
           "planted": planted["flops"]}
    if torch.device(device).type != "cuda":
        return out
    block = bert_recipe_loss(net)
    block.hybridize()
    introspection.reset()
    planes_steps(net, trainer, seed, 2, 4, cfg, batch, seq, device,
                 loss_block=block)
    _sync(device)
    warm_passes = introspection.count_passes()
    introspection.reset()
    t0 = time.perf_counter()
    planes_steps(net, trainer, seed, 5, 4 + steps, cfg, batch, seq, device,
                 loss_block=block)
    _sync(device)
    window = time.perf_counter() - t0
    ws = introspection.window_stats()
    gauge = metric_total("mxnet_model_flops_utilization")
    n_mm = sum(p.data()._data.numel()
               for k, p in net.collect_params().items()
               if "embed" not in k and p.data()._data.dim() >= 2)
    out.update(warm_passes=warm_passes,
               passes=introspection.count_passes(),
               graph=ws["flops"] / steps, events=ws["events"],
               window=window, steps=steps, peak=ws["peak"], gauge=gauge,
               util_now=introspection.utilization(),
               expected=ws["flops"] / (window * ws["peak"]),
               bench_mfu=batch * steps / window * 6.0 * n_mm * seq
               / ws["peak"])
    del net, trainer, block
    return out


def check_planes_flops(out, cuda=True):
    dev = abs(out["eager"] - out["want"]) / out["want"]
    miss = abs(out["planted"] - out["want"]) / out["want"]
    log(f"  one step counted: {out['eager'] / 1e9:.6g} GFLOP (attention "
        f"{out['attention'] / 1e9:.6g} of it, reported by the op) against "
        f"the analytic {out['want'] / 1e9:.6g} GFLOP: {dev:.2e} apart "
        f"(bound {PLANES_FLOP_TOL:g}); the report left out (planted): "
        f"{out['planted'] / 1e9:.6g} GFLOP, {miss:.2e} apart")
    check(dev <= PLANES_FLOP_TOL, f"(b) the counted step is {dev:.3e} from "
                                  f"the analytic count")
    check(miss > PLANES_FLOP_TOL, f"(b) the planted omission is within the "
                                  f"bound ({miss:.3e})")
    if not cuda:
        return
    gdev = abs(out["graph"] - out["eager"]) / out["eager"]
    gauge_dev = abs(out["gauge"] / out["expected"] - 1)
    log(f"  [{gpu_line()}] hybridized: the graphs' count "
        f"{out['graph'] / 1e9:.6g} GFLOP a step ({gdev:.2e} from the "
        f"eager count), taken in {out['warm_passes']} pass over the 3 "
        f"warm-up steps (the capture) and {out['passes']} over the "
        f"{out['steps']} timed ones ({out['events']} accounted events); "
        f"{out['steps']} steps in {out['window']:.3f} s: MFU gauge "
        f"{100 * out['gauge']:.3f}%, counted FLOPs x steps / (window x "
        f"peak {out['peak'] / 1e12:.0f} TFLOP/s) {100 * out['expected']:.3f}"
        f"% ({gauge_dev:.2e} apart, bound {PLANES_MFU_TOL:g}); "
        f"utilization() read after the sync {100 * out['util_now']:.3f}%; "
        f"bench.py's MFU {100 * out['bench_mfu']:.3f}% (6 x matmul "
        f"parameters x tokens: no attention products, and the pooler and "
        f"NSP head over every token where they run over the batch)")
    check(out["gauge"] > 0, "(b) the MFU gauge is absent on the card")
    check(gdev <= PLANES_FLOP_TOL, f"(b) the graphs' count is {gdev:.3e} "
                                   f"from the eager count")
    check(out["warm_passes"] == 1 and out["passes"] == 0,
          f"(b) FLOPs counted in {out['warm_passes']} + {out['passes']} "
          f"passes, expected once")
    check(gauge_dev <= PLANES_MFU_TOL, f"(b) the gauge is {gauge_dev:.3e} "
                                       f"from FLOPs x steps / window")


def llama_serving_flops(cfg, key, page_size):
    """The analytic FLOPs of one serving call of the signature ``key``
    (``ServingEngine._exec_calls``' keys): a prefill at bucket Lb (every
    projection over Lb rows, the attention's 4 x D per (query, key) pair
    and head over Lb x Lb, the LM head at the last position), a decode of
    B rows over P pages (the projections over B rows, the attention over
    P x page_size keys, the LM head over B rows); sampling multiplies
    nothing."""
    h, hd = cfg.hidden_size, cfg.head_dim
    per_row = cfg.num_layers * (
        2 * h * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
        + 2 * cfg.num_heads * hd * h + 6 * h * cfg.intermediate_size)
    head = 2 * h * cfg.vocab_size
    if key[0] == "prefill":
        lb = key[1]
        return lb * per_row + cfg.num_layers * 4 * cfg.num_heads * lb * \
            lb * hd + head
    if key[0] == "decode":
        b, s = key[1], key[2] * page_size
        return b * per_row + cfg.num_layers * 4 * b * cfg.num_heads * s * \
            hd + b * head
    return 0


def serving_flops_check(engine, cfg, before):
    """(b)'s serving half: ``mxnet_executable_flops_total`` for prefill and
    decode since ``before`` (a dict of the two totals) against the
    analytic FLOPs of the calls the engine made, by signature, within
    PLANES_FLOP_TOL; each signature counted once."""
    out = {}
    for kind in ("prefill", "decode"):
        got = metric_total("mxnet_executable_flops_total",
                           kind=f"serving_{kind}") - before[kind]
        want = sum(n * llama_serving_flops(cfg, key, engine._page_size)
                   for key, n in engine._exec_calls.items()
                   if key[0] == kind)
        calls = sum(n for key, n in engine._exec_calls.items()
                    if key[0] == kind)
        sigs = sum(1 for key in engine._exec_flops if key[0] == kind)
        dev = abs(got - want) / want
        log(f"  serving {kind}: {got / 1e9:.6g} GFLOP accounted over "
            f"{calls} calls of {sigs} signatures, analytic "
            f"{want / 1e9:.6g}: {dev:.2e} apart (bound "
            f"{PLANES_FLOP_TOL:g})")
        check(dev <= PLANES_FLOP_TOL, f"(b) serving {kind} FLOPs "
                                      f"{dev:.3e} from the analytic count")
        out[kind] = dev
    return out


def serving_flops_totals():
    return {kind: metric_total("mxnet_executable_flops_total",
                               kind=f"serving_{kind}")
            for kind in ("prefill", "decode")}


def planes_serving(seed, device="cuda", layers=2, cfg_kw=None):
    """(b)'s serving half on its own (``--planes`` alone): the 8 requests
    of phase 4 at Llama-3-8B widths cut to ``layers`` layers."""
    from mxnet_tpu_torch.gluon.model_zoo.language import llama
    from mxnet_tpu_torch.serving import ServingEngine

    cuda = torch.device(device).type == "cuda"
    if cuda:
        net = llama.init_random_(llama.llama3_8b(
            dtype="bfloat16", num_layers=layers, **(cfg_kw or {})), seed)
        kw = SERVING_ENGINE_KW
    else:
        net = llama.llama_tiny(device=device, num_layers=layers,
                               **(cfg_kw or {}))
        kw = dict(prefill_buckets=[16, 32, 64], page_size=8, kv_pages=64)
    engine = ServingEngine(net, device=device, **kw).start()
    try:
        prompts = make_prompts(seed, net.config.vocab_size)
        if not cuda:
            prompts = [p[:2 + p.size % 60] for p in prompts]
        before = serving_flops_totals()
        serve(engine, prompts, [0.0] * len(prompts), seed)
        return serving_flops_check(engine, net.config, before)
    finally:
        engine.close()


def planes_snapshot(net, trainer):
    """Host copies of the parameters and the optimizer's states."""
    from mxnet_tpu_torch.ndarray.serialization import host_copies

    states = trainer._updater.states
    moments = [t._data for i in sorted(states) for t in states[i]]
    return (host_copies([p.data()._data
                         for p in net.collect_params().values()]),
            host_copies(moments), trainer.step_count)


def planes_guard(seed, device="cuda", cfg=None, batch=BERT_BATCH,
                 seq=BERT_SEQ, steps=PLANES_GUARD_STEPS, nan_at=PLANES_NAN_AT,
                 spike_at=PLANES_SPIKE_AT):
    """(c) The recipe without the guard (U), then with ``guard.attach``:
    the clean steps before ``nan_at`` give U's losses bit for bit (ms a
    step beside U's); a NaN planted in one gradient at ``nan_at`` gives
    ``nonfinite`` and a skipped step (the parameters, LAMB's moments and
    the update count as before it, bit for bit); the loss staged x
    PLANES_SPIKE at ``spike_at`` gives ``loss_spike``.  The planted guard
    fault: the integrity vector without the poisoned parameter misses the
    NaN.  Returns U's losses and the readings."""
    from mxnet_tpu_torch import guard
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    cfg = cfg or bert.BertConfig()
    net, trainer = planes_build(cfg, seed, device, seq)
    # step 1 (the optimizer's states, first launches) is not timed
    u_losses, _ = planes_timed(net, trainer, seed, 1, 1, cfg, batch, seq,
                               device)
    mid, u_ms = planes_timed(net, trainer, seed, 2, nan_at - 1, cfg, batch,
                             seq, device)
    rest, _ = planes_timed(net, trainer, seed, nan_at, steps, cfg, batch,
                           seq, device)
    u_losses.update(mid)
    u_losses.update(rest)
    del net, trainer
    net, trainer = planes_build(cfg, seed, device, seq)
    g = guard.attach(trainer, guard.Guard())._guard
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    out = {"u_losses": u_losses, "u_ms": u_ms, "verdicts": {}}

    def before(k, loss):
        staged = loss.mean()
        if k == spike_at:
            staged = staged * PLANES_SPIKE
        trainer._guard.observe_loss(staged)
        if k == nan_at:
            out["before"] = planes_snapshot(net, trainer)
            params[0].grad()._data.view(-1)[0] = float("nan")
            full = guard.integrity_stats(params)
            skipped = guard.integrity_stats(params[1:])
            out["nf_full"] = float(full[0].item())
            out["nf_planted"] = float(skipped[0].item())

    def after(k, loss):
        out["verdicts"][k] = g._agreed
        out["last_loss"] = loss
        if k in (nan_at, spike_at):
            out[f"after_{k}"] = planes_snapshot(net, trainer)

    g_losses, _ = planes_timed(net, trainer, seed, 1, 1, cfg, batch, seq,
                               device, before_step=before, after_step=after,
                               guarded=True)
    mid, g_ms = planes_timed(net, trainer, seed, 2, nan_at - 1, cfg, batch,
                             seq, device, before_step=before,
                             after_step=after, guarded=True)
    g_losses.update(mid)
    # the check's own cost: the integrity pass over step 8's gradients and
    # loss, and its one host read
    loss = out.pop("last_loss")
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(20):
        guard.integrity_stats(params, loss).cpu()
    out["check_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    planes_timed(net, trainer, seed, nan_at, steps, cfg, batch, seq, device,
                 before_step=before, after_step=after, guarded=True)
    out.update(g_losses=g_losses, g_ms=g_ms)
    del net, trainer
    return out


def _same_snapshot(a, b):
    return a[2] == b[2] and all(
        len(x) == len(y) and all(torch.equal(s, t) for s, t in zip(x, y))
        for x, y in zip(a[:2], b[:2]))


def check_planes_guard(out, nan_at=PLANES_NAN_AT, spike_at=PLANES_SPIKE_AT,
                       cuda=True):
    clean = {k: v for k, v in out["u_losses"].items() if k < nan_at}
    log(f"  [{gpu_line() if cuda else 'cpu'}] guarded clean steps 2-"
        f"{nan_at - 1} {out['g_ms']:.2f} ms a step against "
        f"{out['u_ms']:.2f} without the guard; the check alone (the "
        f"integrity pass and its host read) {out['check_ms']:.3f} ms; "
        f"verdicts "
        + ", ".join(f"{k}: {v}" for k, v in out["verdicts"].items()
                    if v != "ok") + f"; the planted guard fault (one "
        f"parameter skipped) reads {out['nf_planted']:.0f} non-finite "
        f"elements where the full pass reads {out['nf_full']:.0f}: it "
        f"misses the NaN, as a fault must")
    check(out["g_losses"] == clean, "(c) the guarded clean losses differ "
                                    "from the unguarded ones")
    check(out["verdicts"].get(nan_at) == "nonfinite",
          f"(c) the planted NaN gave {out['verdicts'].get(nan_at)}")
    check(out["verdicts"].get(spike_at) == "loss_spike",
          f"(c) the planted spike gave {out['verdicts'].get(spike_at)}")
    check(all(v == "ok" for k, v in out["verdicts"].items()
              if k not in (nan_at, spike_at)), "(c) a clean step's verdict "
                                               "is not ok")
    check(_same_snapshot(out[f"after_{nan_at}"], out["before"]),
          "(c) the skipped step moved a parameter, a moment or the update "
          "count")
    check(out["nf_full"] == 1 and out["nf_planted"] == 0,
          f"(c) the planted guard fault read {out['nf_planted']} (the "
          f"full pass {out['nf_full']})")


def planes_rewind(seed, directory, u_losses, device="cuda", cfg=None,
                  batch=BERT_BATCH, seq=BERT_SEQ):
    """(c) rewind: the recipe under ``run_with_recovery`` with a
    CheckpointManager, a synchronous checkpoint after step PLANES_SAVE_AT,
    the loss sentinel (``Guard.poll_loss``) after every step, and a
    persistent fault from step PLANES_FAULT_AT on (an element of the first
    Dense weight set to NaN, first attempt only): the ladder climbs to ``GuardRewind``,
    run_with_recovery restores the checkpoint and charges the ``rewind``
    bucket (not ``restart``), and the steps after it give U's losses (the
    rule of phase 10: bit for bit, as U repeats)."""
    from mxnet_tpu_torch import guard, lifecycle, telemetry
    from mxnet_tpu_torch.checkpoint import CheckpointManager, \
        run_with_recovery
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    cfg = cfg or bert.BertConfig()
    mgr = CheckpointManager(directory, max_to_keep=2)
    g = guard.Guard(rewind_after=PLANES_REWIND_AFTER)
    attempts, raised = [], []

    def train_fn(start, manager):
        attempts.append(start)
        net, trainer = planes_build(cfg, seed, device, seq)
        scaler = getattr(trainer, "_amp_loss_scaler", None)
        if start:
            check(manager.restore(net, trainer) == start,
                  "(c) the rewind restored another step")
            lifecycle.restore_train_state(manager.read_train_state(start),
                                          scaler=scaler, guard=g)
        losses = {}
        for k in range(start + 1, PLANES_REWIND_STEPS + 1):
            if len(attempts) == 1 and k == PLANES_FAULT_AT:
                w = next(p for name, p in net.collect_params().items()
                         if "dense" in name).data()._data
                with torch.no_grad():
                    w.view(-1)[0] = float("nan")
            loss = planes_steps(net, trainer, seed, k, k, cfg, batch, seq,
                                device, guarded=True)[k]
            losses[k] = loss
            try:
                g.poll_loss(loss._data, step=k)
            except guard.GuardRewind:
                raised.append(k)
                raise
            if k == PLANES_SAVE_AT:
                manager.save(k, net, trainer, async_=False,
                             train_state=lifecycle.capture_train_state(
                                 k, scaler=scaler, trainer=trainer,
                                 guard=g))
        return {k: float(v.asscalar()) for k, v in losses.items()}

    before = dict(telemetry.goodput_summary()["buckets"])
    t0 = time.perf_counter()
    losses = run_with_recovery(train_fn, mgr, max_restarts=1, backoff_ms=0)
    secs = time.perf_counter() - t0
    after = telemetry.goodput_summary()["buckets"]
    return {"attempts": attempts, "raised": raised, "losses": losses,
            "u": {k: u_losses[k] for k in losses}, "secs": secs,
            "rewind_s": after.get("rewind", 0) - before.get("rewind", 0),
            "restart_s": after.get("restart", 0) - before.get("restart", 0)}


def check_planes_rewind(out):
    log(f"  rewind: GuardRewind at step {out['raised']}, attempts from "
        f"steps {out['attempts']}, rewind bucket +{out['rewind_s']:.3f} s, "
        f"restart +{out['restart_s']:.3f} s; steps after the rewind "
        + ", ".join(f"{k}: {v:.6f} (U {out['u'][k]:.6f})"
                    for k, v in out["losses"].items())
        + f"; {out['secs']:.1f} s in all")
    check(out["raised"] == [PLANES_FAULT_AT + PLANES_REWIND_AFTER - 1],
          f"(c) GuardRewind at {out['raised']}")
    check(out["attempts"] == [0, PLANES_SAVE_AT],
          f"(c) attempts from {out['attempts']}")
    check(out["rewind_s"] > 0 and out["restart_s"] == 0,
          "(c) the rewind was not charged to the rewind bucket alone")
    check(out["losses"] == out["u"], "(c) the losses after the rewind "
                                     "differ from U's")


def watchdog_worker_main(args):
    """``--watchdog-worker``: the recipe (phase 10's batch, or with
    ``--resume-tiny`` PLANES_WD_TINY) with the stall watchdog
    (PLANES_WD_TIMEOUT, PLANES_WD_POLL) fed by ``check_stop`` at each step
    boundary; after step PLANES_WD_ARM_AT it arms the ``watchdog.stall``
    seam and writes the time to ``--watchdog-dir``/armed.txt.  The
    watchdog must end it with 45 and a black box in the same directory;
    returning is a failure (exit 1)."""
    from mxnet_tpu_torch import fault, lifecycle
    from mxnet_tpu_torch.contrib import amp

    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    device = args.resume_device
    if args.resume_tiny:
        cfg = bert.BertConfig(dropout=0.1, **PLANES_WD_TINY)
        seq, batch = PLANES_WD_TINY_SEQ, PLANES_WD_TINY_BATCH
    else:
        cfg, seq, batch = resume_cfg()
    if torch.device(device).type == "cuda":
        amp.init()
    net, trainer = planes_build(cfg, args.seed, device, seq)
    # the first step (cuBLAS's set-up, the optimizer's states) before the
    # deadline applies: it is not a stall
    planes_steps(net, trainer, args.seed, 0, 0, cfg, batch, seq,
                 device)[0].asscalar()
    lifecycle.start_watchdog(timeout_s=PLANES_WD_TIMEOUT,
                             poll_s=PLANES_WD_POLL,
                             dump_dir=args.watchdog_dir)
    armed = fault.inject("watchdog.stall")
    for k in range(1, PLANES_WD_STEPS + 1):
        lifecycle.check_stop()
        planes_steps(net, trainer, args.seed, k, k, cfg, batch, seq,
                     device)[k].asscalar()
        if k == PLANES_WD_ARM_AT:
            # armed from here on: the watchdog thread's next poll trips it
            armed.__enter__()
            with open(os.path.join(args.watchdog_dir, "armed.txt"),
                      "w") as f:
                f.write(repr(time.time()))
    return 1


def watchdog_worker_argv(seed, directory, device="cuda", tiny=False):
    flags = ["--watchdog-worker", "--seed", str(seed), "--watchdog-dir",
             directory, "--resume-device", device] + \
        (["--resume-tiny"] if tiny else [])
    if torch.device(device).type == "cuda":
        return [sys.executable, os.path.abspath(__file__)] + flags
    return [sys.executable, "-c",
            "import sys, chip_smoke as c; sys.exit(c.watchdog_worker_main("
            "c.parse_args(sys.argv[1:])))"] + flags


def planes_watchdog_start(seed, directory, device="cuda", tiny=False):
    """(d) Start a child that runs the recipe with the watchdog and arms
    its ``watchdog.stall`` seam (it runs while the parent goes on)."""
    os.makedirs(directory, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MXNET_FLIGHT_DIR=directory,
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    err_path = os.path.join(directory, "stderr.txt")
    with open(err_path, "w") as err:
        child = subprocess.Popen(
            watchdog_worker_argv(seed, directory, device, tiny), env=env,
            stdout=err, stderr=err, cwd=here)
    return {"child": child, "t0": time.time(), "directory": directory,
            "err_path": err_path}


def planes_watchdog_finish(run):
    """(d) The child's exit code, the seconds from its arming to the
    watchdog's fire (the black box's time, written just before the exit),
    the black box's reason and the child's stderr."""
    child = run["child"]
    try:
        rc = child.wait(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    armed = os.path.join(run["directory"], "armed.txt")
    box = os.path.join(run["directory"], "blackbox.rank0.json")
    doc = json.load(open(box)) if os.path.exists(box) else {}
    return {"rc": rc, "total_s": time.time() - run["t0"],
            "after_arm_s": doc["time"] - float(open(armed).read())
            if doc and os.path.exists(armed) else None,
            "reason": doc.get("reason"),
            "stderr": open(run["err_path"]).read()[-3000:]}


def planes_watchdog(seed, directory, device="cuda", tiny=False):
    """(d) The child, start to finish: it must exit 45 within the deadline
    plus one poll of the arming, with ``blackbox.rank0.json`` written."""
    return planes_watchdog_finish(
        planes_watchdog_start(seed, directory, device, tiny))


def watchdog_poll_us(n=2000):
    """The host cost of one watchdog poll (a heartbeat read, a seam check),
    in microseconds: a Watchdog that is never started, polled by hand."""
    from mxnet_tpu_torch import lifecycle, telemetry

    wd = lifecycle.Watchdog(timeout_s=60.0, abort=False)
    telemetry.heartbeat()
    t0 = time.perf_counter()
    for _ in range(n):
        wd.poll()
    return 1e6 * (time.perf_counter() - t0) / n


def check_planes_watchdog(out):
    bound = PLANES_WD_TIMEOUT + PLANES_WD_POLL
    check(out["after_arm_s"] is not None,
          f"(d) the watchdog child exited {out['rc']} before arming the "
          f"seam: " + out["stderr"])
    log(f"  watchdog child: exit {out['rc']}, fired "
        f"{out['after_arm_s']:.3f} s after arming watchdog.stall (bound: "
        f"the deadline "
        f"{PLANES_WD_TIMEOUT:g} s + one poll {PLANES_WD_POLL:g} s), "
        f"black box reason {out['reason']!r}; {out['total_s']:.1f} s in "
        f"all; a poll costs the host {watchdog_poll_us():.2f} us")
    check(out["rc"] == 45, f"(d) the watchdog child exited {out['rc']}: "
                           + out["stderr"])
    check(out["after_arm_s"] is not None and out["after_arm_s"] <= bound,
          f"(d) the child exited {out['after_arm_s']} s after arming")
    check(out["reason"] == "watchdog_stall",
          f"(d) the black box's reason is {out['reason']!r}")


def check_tiles(gen, shapes, dtypes=(torch.bfloat16, torch.float16)):
    """Every tile instance but the default at ``shapes`` (D = 64 or 128)
    against the plain version, with phase 3's bounds: bf16 BF16_TOL and
    LSE_TOL, fp16 within FP16_NOISE_FACTOR x the plain fp16 version's
    deviation.  Returns the worst o error."""
    from mxnet_tpu_torch.ops.flash_attention import (KERNEL_TILES,
                                                     _flash_fwd_cuda,
                                                     _mha_with_lse)

    worst = 0.0
    for shape in shapes:
        b, hq, hkv, lq, lk, d, causal, views = shape
        for dtype in dtypes:
            q, k, v = make_qkv(shape, dtype, gen)
            scale = 1.0 / math.sqrt(d)
            o_ref, lse_ref = _mha_with_lse(q.float(), k.float(), v.float(),
                                           causal, scale)
            plain = (_mha_with_lse(q, k, v, causal, scale)[0].float()
                     - o_ref).abs().max().item()
            errs = []
            for tile in KERNEL_TILES[d][1:]:
                o, lse = _flash_fwd_cuda(q, k, v, causal, scale, tile=tile)
                err_o = (o.float() - o_ref).abs().max().item()
                err_l = (lse - lse_ref).abs().max().item()
                ok = err_l <= LSE_TOL and (
                    torch.allclose(o.float(), o_ref, **BF16_TOL)
                    if dtype == torch.bfloat16
                    else err_o <= FP16_NOISE_FACTOR * plain)
                worst = max(worst, err_o)
                errs.append(f"{tile[0]}x{tile[1]} {err_o:.3e}/{err_l:.3e}")
                check(ok, f"flash_attn_fwd tile {tile} {dtype} {shape} "
                          f"disagrees with _mha_with_lse")
                check(bool(torch.isfinite(o).all()),
                      f"non-finite o at tile {tile} {shape}")
            log(f"  tiles {str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} Lq={lq} "
                f"Lk={lk} D={d} causal={causal}"
                f"{' views' if views else ''}: max|o err|/max|lse err| "
                + ", ".join(errs) + f" (plain {str(dtype)[6:]} "
                f"{plain:.3e}) ok")
            del q, k, v, o_ref, lse_ref
    return worst


def planes_tuning(gen, directory):
    """(e) successive halving over the four tile pairs at each of
    PLANES_TUNE_SHAPES (bf16), scored by CUDA-graph replay time (the
    query tile through ``tune_knob``; each of its trials times both key
    tiles; then the key tile under the query winner), winners to a DB in
    ``directory``; every pair timed again beside the bound.  Returns
    {name: {"winner", "times", "bound", "trials"}}."""
    from mxnet_tpu_torch import tuning
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch.ops.flash_attention import (KERNEL_TILES,
                                                     _flash_fwd_cuda)

    db = tuning.TuningDB(directory)
    out = {}
    for name, shape in PLANES_TUNE_SHAPES.items():
        b, hq, hkv, lq, lk, d, causal, _ = shape
        q, k, v = make_qkv(shape, torch.bfloat16, gen)
        scale = 1.0 / math.sqrt(d)
        sig = fa_mod.tile_signature(q, k, causal)

        def timed(budget):
            return graph_time_ms(
                lambda: _flash_fwd_cuda(q, k, v, causal, scale),
                iters=PLANES_TUNE_ITERS * budget)

        def measure_q(bq, budget):
            best = float("inf")
            for bk in tuning.get_knob("flash_block_kv").grid:
                with tuning.trial_override("flash_block_kv", bk):
                    best = min(best, timed(budget))
            return best

        rq = tuning.tune_knob("flash_block_q", measure_q, db=db,
                              signature=sig, unit="ms")
        with tuning.trial_override("flash_block_q", rq["winner"]):
            rk = tuning.tune_knob("flash_block_kv",
                                  lambda bk, budget: timed(budget), db=db,
                                  signature=sig, unit="ms")
        times = {}
        for tile in KERNEL_TILES[d]:
            times[f"{tile[0]}x{tile[1]}"] = graph_time_ms(
                lambda: _flash_fwd_cuda(q, k, v, causal, scale, tile=tile))
        bound, by = bound_ms(shape, torch.bfloat16)
        out[name] = {"shape": list(shape[:7]),
                     "winner": [rq["winner"], rk["winner"]],
                     "times": times, "bound_ms": bound, "bound_by": by,
                     "trials": rq["trials"] + rk["trials"],
                     "stored": bool(rq.get("stored")) and
                     bool(rk.get("stored"))}
        del q, k, v
    return out


def check_planes_tuning(out):
    for name, r in out.items():
        log(f"  [{gpu_line()}] tuned {name} {r['shape']} bf16: winner "
            f"{r['winner'][0]}x{r['winner'][1]} after {r['trials']} trials; "
            + ", ".join(f"{t} {ms:.4f} ms" for t, ms in r["times"].items())
            + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        check(r["stored"], f"(e) the {name} winners were not stored")


def tune_replay_main(args):
    """``--tune-replay``: with MXNET_TUNE=1 and MXNET_TUNE_DB_DIR set by
    the caller, launch the kernel once at each of PLANES_TUNE_SHAPES and
    print one JSON line: the tile each launch took, the knobs' sources and
    the search trials this process ran (a replay runs none)."""
    from mxnet_tpu_torch import tuning
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    out = {"tiles": {}, "sources": {}}
    for name, shape in PLANES_TUNE_SHAPES.items():
        q, k, v = make_qkv(shape, torch.bfloat16, gen)
        sig = fa_mod.tile_signature(q, k, shape[6])
        fa_mod._flash_fwd_cuda.launches_by_tile = {}
        fa_mod._flash_fwd_cuda(q, k, v, shape[6], 1.0 / math.sqrt(shape[5]))
        torch.cuda.synchronize()
        (tile,) = fa_mod._flash_fwd_cuda.launches_by_tile
        out["tiles"][name] = list(tile)
        out["sources"][name] = [tuning.resolve_info(knob, signature=sig)[1]
                                for knob in ("flash_block_q",
                                             "flash_block_kv")]
    out["trials"] = metric_total("mxnet_tuning_trials_total")
    print(json.dumps(out), flush=True)
    return 0


def planes_replay_start(seed, directory):
    """(e) Start a second process that replays the stored winners
    (MXNET_TUNE=1); it runs while the parent goes on."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MXNET_TUNE="1", MXNET_TUNE_DB_DIR=directory)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--tune-replay", "--seed", str(seed)],
                            env=env, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def planes_replay_finish(proc):
    out, err = proc.communicate(timeout=300)
    check(proc.returncode == 0, "(e) the replay process failed: "
                                + err[-3000:])
    return json.loads(out.strip().splitlines()[-1])


def check_planes_replay(replay, tuned):
    log(f"  replay in a second process: tiles {replay['tiles']} (sources "
        f"{replay['sources']}), {replay['trials']:g} search trials")
    for name, r in tuned.items():
        check(replay["tiles"][name] == r["winner"],
              f"(e) the replay of {name} took {replay['tiles'][name]}, the "
              f"winner is {r['winner']}")
        check(replay["sources"][name] == ["tuned", "tuned"],
              f"(e) the replay of {name} resolved from "
              f"{replay['sources'][name]}")
    check(replay["trials"] == 0, "(e) the replay ran search trials")


def planes_agg(directory):
    """(f) Rank 0 publishes its snapshot and merges the directory (the
    ranks of a job share it; two ranks are the CPU tests' case)."""
    from mxnet_tpu_torch import telemetry_agg

    telemetry_agg.configure(directory=directory, every=1, rank=0, world=1)
    try:
        doc = telemetry_agg.tick()
        code, _, body = telemetry_agg._http_agg("GET", "/agg", {}, b"")
        files = sorted(os.listdir(directory))
    finally:
        telemetry_agg.reset()
    log(f"  aggregation: published {files}, merged ranks {doc['ranks']} "
        f"({len(doc['metrics'])} families, skew step "
        f"{doc['skew']['step']}), /agg {code} ({len(body)} bytes)")
    check(doc["ranks"] == [0] and files == ["rank0.json"] and code == 200,
          "(f) rank 0's publish and merge")
    return doc


def planes_phase(seed, gen=None, tile_checks=True):
    """Phase 13: (a)-(f) on the card (``tile_checks=False``: the kernel
    phase already held every tile); returns (flash_attn_fwd's launches
    over (a)'s profiled steps, the kernels line's tile entries)."""
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    cfg = bert.BertConfig()
    if gen is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_planes_")
    t0 = time.perf_counter()
    laps, last, children = {}, [t0], []

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    try:
        log("== planes (e): flash_attn_fwd's tiles as tuning knobs")
        if tile_checks:
            check_tiles(gen, PLANES_TILE_CASES)
        tuned = planes_tuning(gen, os.path.join(tmp, "tune"))
        check_planes_tuning(tuned)
        lap("(e) tuning")
        amp.init()
        try:
            log("== planes (a): mx.profiler over torch.profiler")
            prof = planes_profiler(seed, tmp)
            check_planes_profiler(prof, cfg)
            lap("(a)")
            # the two children run beside (b) and (c): each is mostly a
            # fresh interpreter's start, on the host
            replay = planes_replay_start(seed, os.path.join(tmp, "tune"))
            watchdog = planes_watchdog_start(
                seed, os.path.join(tmp, "watchdog"), tiny=True)
            children += [replay, watchdog["child"]]
            log("== planes (b): FLOPs counted once, the MFU gauge")
            check_planes_flops(planes_flops(seed))
            torch.cuda.empty_cache()
            lap("(b)")
            log("== planes (c): the numerical-integrity guard")
            gd = planes_guard(seed)
            check_planes_guard(gd)
            check_planes_rewind(planes_rewind(
                seed, os.path.join(tmp, "ckpt"), gd["u_losses"]))
            torch.cuda.empty_cache()
            lap("(c)")
        finally:
            amp.disable()
        log("== planes (d): the stall watchdog (a child, the recipe at "
            "phase 10's tiny size)")
        check_planes_watchdog(planes_watchdog_finish(watchdog))
        log("== planes (e): the winners replayed in a second process")
        check_planes_replay(planes_replay_finish(replay), tuned)
        lap("(d) and the replay, after (c)")
        log("== planes (f): telemetry aggregation")
        planes_agg(os.path.join(tmp, "agg"))
        lap("(f)")
    finally:
        for child in children:       # left running only by a failed check
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log("  planes phase by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items()))
    log(f"  planes phase took {time.perf_counter() - t0:.1f} s")
    return prof["launches"], {"tiles": {n: r["times"]
                                        for n, r in tuned.items()},
                              "tuned": {n: r["winner"]
                                        for n, r in tuned.items()}}


# ---------------------------------------------------------------------------
# phase 14: the symbolic half: HybridBlock.export, SymbolBlock.imports,
# mx.mod.Module and test_utils on the card
# ---------------------------------------------------------------------------
# (b): the Module's check batch and step (phase 5's CHECK_OPT), the fit's
# batches, the timed run (phase 5's bench.py configuration)
SYM_MODULE_BATCH, SYM_FIT_BATCHES = 32, 8
# (a): timed forwards of the imported BERT-base at bench.py's batch
SYM_WARMUP, SYM_FORWARDS = 2, 10
# (c): the attention's fp32 kernel against the CPU's plain version within
# phase 3's fp32 bound
SYM_ATTENTION_TOL = F32_TOL


def sym_outputs(out):
    return out if isinstance(out, (list, tuple)) else [out]


def sym_same(got, want):
    """Whether two forwards' outputs are equal bit for bit, and the largest
    |difference|."""
    got, want = sym_outputs(got), sym_outputs(want)
    worst = max((a._data.double() - b._data.double()).abs().max().item()
                for a, b in zip(got, want))
    same = all(torch.equal(a._data, b._data) for a, b in zip(got, want))
    return same, worst


def sym_import(prefix, ctx, symbol_file=None):
    import mxnet_tpu_torch as mx

    return mx.gluon.SymbolBlock.imports(
        symbol_file or prefix + "-symbol.json", ["data"],
        prefix + "-0000.params", ctx=ctx)


def planted_export(prefix, fault, work):
    """A copy of the deploy files ``prefix`` with ``fault`` planted:
    "swap_qk" (layer 0's query and key weights swapped in the params
    file) or "sm_scale" (the first attention node's scale off by
    BF16_SCALE_FAULT in the symbol file).  Returns the copy's prefix."""
    import mxnet_tpu_torch as mx

    out = os.path.join(work, f"planted_{fault}")
    shutil.copy(prefix + "-symbol.json", out + "-symbol.json")
    shutil.copy(prefix + "-0000.params", out + "-0000.params")
    if fault == "swap_qk":
        params = mx.nd.load(prefix + "-0000.params", ctx=mx.cpu())
        q = next(k for k in params if k.endswith("0.attention.query.weight"))
        k = q.replace("query", "key")
        params[q], params[k] = params[k], params[q]
        mx.nd.save(out + "-0000.params", params)
    else:
        with open(prefix + "-symbol.json") as f:
            js = json.load(f)
        node = next(n for n in js["nodes"]
                    if n["op"] == "_contrib_flash_attention")
        node["attrs"]["sm_scale"] = repr(
            float(node["attrs"]["sm_scale"]) * BF16_SCALE_FAULT)
        with open(out + "-symbol.json", "w") as f:
            json.dump(js, f)
    return out


def sym_forward_ms(fn, x, repeats=SYM_FORWARDS):
    """ms a forward (host clock ending in a sync) after SYM_WARMUP, and the
    peak memory above the run's start (GiB)."""
    base = memory_base()
    for _ in range(SYM_WARMUP):
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(x)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / repeats
    del out
    return ms, (torch.cuda.max_memory_allocated() - base) / 2**30


def symbolic_bert(seed, work, ctx=None, cfg=None, batch=BERT_BATCH,
                  check_batch=BERT_CHECK_BATCH, seq=BERT_SEQ, timed=True):
    """(a): BERT-base exported and imported.  Returns flash_attn_fwd's
    launches over the imported block's forwards and its bf16 times."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    ctx = ctx or mx.gpu(0)
    cuda = ctx.device_type == "gpu"
    cfg = cfg or bert.BertConfig(dropout=0.0)
    net = init_bert(cfg, seed, ctx, seq)
    ids, _ = bert_batch(seed, batch, seq, cfg.vocab_size)
    X = mx.nd.array(ids, ctx=ctx, dtype="int32")
    want = net(X)
    prefix = os.path.join(work, "bert")
    t0 = time.perf_counter()
    sym, arg_params, aux_params = net._trace_to_symbol(X)
    trace_s = time.perf_counter() - t0
    mx.model.save_checkpoint(prefix, 0, sym, arg_params, aux_params)
    del sym, arg_params, aux_params
    t1 = time.perf_counter()
    blk = sym_import(prefix, ctx)
    t2 = time.perf_counter()
    ops = [n["op"] for n in json.load(open(prefix + "-symbol.json"))["nodes"]]
    log(f"  exported BertForPretraining ({cfg.num_layers} layers, "
        f"{cfg.hidden_size} wide) at {batch} x {seq}: {len(ops)} nodes, "
        f"{ops.count('_contrib_flash_attention')} attention nodes; export "
        f"{t1 - t0:.1f} s (the trace {trace_s:.1f} s; as net.export), "
        f"imports {t2 - t1:.1f} s")
    check(ops.count("_contrib_flash_attention") == cfg.num_layers,
          "the export lost attention nodes")
    def launches():
        return _kernels.launch_counts().get("flash_attn_fwd", 0) \
            if cuda else 0

    # this path's count: the imported blocks' launches from here on, the
    # Gluon net's own (its batch-8 forward, its timed forwards) taken out
    n0 = launches()
    gluon = 0
    got = blk(X)
    n1 = launches()
    same, worst = sym_same(got, want)
    log(f"  imported fp32 forward against the Gluon net's: "
        f"{'bit for bit' if same else f'max |difference| {worst:.3e}'}; "
        f"flash_attn_fwd launches in the forward: {n1 - n0}")
    check(same, f"the imported forward differs from the Gluon net's by "
                f"{worst:.3e}")
    if cuda:
        check(n1 - n0 == cfg.num_layers,
              f"flash_attn_fwd launched {n1 - n0} times in the imported "
              f"forward, expected {cfg.num_layers}")
    blk.hybridize()
    for _ in range(2):          # the capture, then a replay
        same, worst = sym_same(blk(X), got)
        check(same, f"the hybridized imported block differs from the "
                    f"eager one by {worst:.3e}")
    log("  hybridized imported block (capture and replay) against the "
        "eager one: bit for bit")
    del got, want

    log(f"== symbolic 2: an SGD fine-tuning step through the imported block "
        f"at batch {check_batch}, dropout 0, against the CPU's fp64 step")
    ids8, labels8 = bert_batch(seed + 1, check_batch, seq, cfg.vocab_size)
    X8 = mx.nd.array(ids8, ctx=ctx, dtype="int32")
    prefix8 = os.path.join(work, "bert8")
    net.export(prefix8, 0, X8)
    c = launches()
    want8 = net(X8)
    gluon += launches() - c
    blk8 = sym_import(prefix8, ctx)
    same, worst = sym_same(blk8(X8), want8)
    check(same, f"the imported batch-{check_batch} forward differs by "
                f"{worst:.3e}")
    names = list(blk8.collect_params())

    def cpu_step(dtype=None):
        cpu_blk = sym_import(prefix8, mx.cpu())
        if dtype == "float64":
            cpu_blk.cast("float64")
            dtype = None
        return trainstep_result(cpu_blk, ids8, labels8, "cpu",
                                BERT_CHECK_OPT, dtype, bert_loss)

    # the CPU's fp64 step on a thread, beside the card's work that runs
    # without AMP (whose policy is global)
    t0 = time.perf_counter()
    cpu64_run = in_thread(cpu_step, "float64")
    for fault in ("swap_qk", "sm_scale"):
        bad = sym_import(planted_export(prefix8, fault, work), ctx)
        same, worst = sym_same(bad(X8), want8)
        log(f"  planted {fault}: the imported forward differs by "
            f"{worst:.3e}")
        check(not same, f"the equality check misses the planted {fault}")
        del bad
    card = trainstep_result(blk8, ids8, labels8, ctx.device.type,
                            BERT_CHECK_OPT, None, bert_loss)
    cpu64 = joined(*cpu64_run)
    t1 = time.perf_counter()
    cpu16 = cpu_step("bfloat16")
    log(f"  CPU steps: fp64 (beside the card's) {t1 - t0:.1f} s, bf16 "
        f"{time.perf_counter() - t1:.1f} s")
    check(all(bool(torch.isfinite(t).all()) for t in card[2]),
          "non-finite parameters after the imported block's step")
    check_steps(card, cpu64, names, "fp32 imported step vs the CPU's fp64 "
                "step", BERT_FP32_BOUND)
    card16 = trainstep_result(blk8, ids8, labels8, ctx.device.type,
                              BERT_CHECK_OPT, "bfloat16", bert_loss)
    check_steps(card16, cpu64, names, "bf16 imported step vs the fp64 step",
                BF16_NOISE_FACTOR, noise_scales(cpu16, cpu64, names),
                "of the CPU's bf16 deviation")
    del blk8, card, card16, cpu16, cpu64, want8
    if not timed:
        return launches() - n0 - gluon, {}

    log(f"== symbolic 3: bf16 forwards (amp.init()) at {batch} x {seq}: the "
        f"imported block eager and hybridized, the Gluon net hybridized")
    times = {}
    amp.init()
    try:
        blk.hybridize(False)
        times["imported eager"] = sym_forward_ms(blk, X)
        blk.hybridize()
        times["imported hybridized"] = sym_forward_ms(blk, X)
        net.hybridize()
        c = launches()
        times["gluon hybridized"] = sym_forward_ms(net, X)
        gluon += launches() - c
    finally:
        amp.disable()
    for what, (ms, peak) in times.items():
        log(f"  [{gpu_line()}] {what}: {ms:.3f} ms a forward, peak memory "
            f"{peak:.3f} GiB over the run's start ({SYM_FORWARDS} forwards "
            f"after {SYM_WARMUP})")
    n_launch = launches() - n0 - gluon
    log(f"  flash_attn_fwd launches of the imported blocks over (a): "
        f"{n_launch} (the Gluon net's {gluon} left out)")
    del net, blk
    return n_launch, times


def module_result(mod, x, y, names):
    """One forward_backward + update of ``mod``: (cross-entropy of its
    softmax output, the arrays before, after) in ``names`` order, on the
    host, in the module's dtype."""
    import mxnet_tpu_torch as mx

    ex = mod._exec
    arrays = dict(ex.arg_dict, **ex.aux_dict)
    ctx = mod._context
    before = [_host(arrays[n]._data) for n in names]
    dtype = next(iter(ex.arg_dict.values())).dtype
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=ctx, dtype=dtype)],
                            label=[mx.nd.array(y, ctx=ctx, dtype=dtype)])
    mod.forward_backward(batch)
    probs = mod.get_outputs()[0]._data.double()
    loss = -probs[torch.arange(len(y)), torch.as_tensor(
        y, dtype=torch.long, device=probs.device)].log().mean().item()
    mod.update()
    return loss, before, [_host(arrays[n]._data) for n in names]


def bound_module(prefix, ctx, batch, dtype="float32", opt=CHECK_OPT,
                 size=TRAIN_SIZE):
    """``Module.load(prefix, 0)`` bound for training at ``batch`` in
    ``dtype``, with SGD ``opt``."""
    import mxnet_tpu_torch as mx

    mod = mx.mod.Module.load(prefix, 0, context=ctx)
    mod.bind(data_shapes=[mx.io.DataDesc("data", (batch, size, size, 3),
                                         dtype)],
             label_shapes=[mx.io.DataDesc("softmax_label", (batch,), dtype)])
    mod.init_optimizer(optimizer="sgd", optimizer_params=tuple(opt.items()))
    return mod


def symbolic_module(seed, work, ctx=None, make_net=resnet50,
                    batch=SYM_MODULE_BATCH, size=TRAIN_SIZE,
                    fit_batches=SYM_FIT_BATCHES, timed_batch=TRAIN_BATCH,
                    timed=True, classes=1000):
    """(b): ResNet-50 v1 exported, its symbol given a SoftmaxOutput head
    and trained through mx.mod.Module.  Returns the timed img/s."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp

    ctx = ctx or mx.gpu(0)
    net = init_net(make_net, seed, ctx, size)
    x, y = train_batch(seed, batch, size, classes)
    prefix = os.path.join(work, "resnet")
    net.export(prefix, 0, mx.nd.array(x, ctx=ctx))
    sym, arg, aux = mx.model.load_checkpoint(prefix, 0)
    train_sym = mx.sym.SoftmaxOutput(sym, mx.sym.var("softmax_label"),
                                     name="softmax", normalization="batch")
    mx.model.save_checkpoint(prefix + "-train", 0, train_sym, arg, aux)
    prefix += "-train"
    names = list(arg) + list(aux)
    log(f"  exported {len(arg)} arguments and {len(aux)} aux states; "
        f"Module.load of the checkpoint with a SoftmaxOutput head")
    def cpu_steps():
        t0 = time.perf_counter()
        out = [module_result(bound_module(prefix, mx.cpu(), batch, dtype,
                                          size=size), x, y, names)
               for dtype in ("float32", "float64")]
        return out, time.perf_counter() - t0

    # the CPU's steps on a thread, beside the card's untimed work (no AMP)
    cpu_run = in_thread(cpu_steps)
    card = module_result(bound_module(prefix, ctx, batch, size=size), x, y,
                         names)
    card64 = module_result(bound_module(prefix, ctx, batch, "float64",
                                        size=size), x, y, names)
    stats = [i for i, n in enumerate(names) if _kind(n) == "stats"]
    moved = sum(not torch.equal(card[1][i], card[2][i]) for i in stats)
    log(f"  BatchNorm running stats written back by the step: {moved} of "
        f"{len(stats)}")
    check(moved == len(stats), "the Module step left running stats as "
                               "they were")
    # the same step through gluon.Trainer on the net itself, whose
    # parameters map to the exported names by structure
    structural = {id(p): n for n, p in
                  net._collect_params_with_prefix().items()}
    order = [structural[id(p)] for p in net.collect_params().values()]
    pos = {n: i for i, n in enumerate(names)}
    card_gluon_order = (card[0], [card[1][pos[n]] for n in order],
                        [card[2][pos[n]] for n in order])
    loop = gluon_loop_result(net, x, y)
    del net

    log(f"== symbolic 5: Module.fit over {fit_batches} seed-made batches of "
        f"{batch} (NDArrayIter) with callback.do_checkpoint, then "
        f"Module.load of the checkpoint and score")
    data = [train_batch(seed + 1 + i, batch, size, classes)
            for i in range(fit_batches)]
    with ctx:
        it = mx.io.NDArrayIter(np.concatenate([d[0] for d in data]),
                               np.concatenate([d[1] for d in data]),
                               batch_size=batch, label_name="softmax_label")
    mod = mx.mod.Module.load(prefix, 0, context=ctx)
    fit = os.path.join(work, "fit")
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer_params=tuple(TRAIN_OPT.items()),
            epoch_end_callback=mx.callback.do_checkpoint(fit))
    fit_s = time.perf_counter() - t0
    score = mod.score(it, "acc")
    pred = mod.predict(it)
    loaded = mx.mod.Module.load(fit, 1, context=ctx)
    loaded.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                for_training=False)
    loaded_score = loaded.score(it, "acc")
    same, worst = sym_same(loaded.predict(it), pred)
    log(f"  fit {fit_s:.1f} s; score {score} against the loaded "
        f"checkpoint's {loaded_score}; predictions "
        f"{'bit for bit' if same else f'differ by {worst:.3e}'}")
    check(score == loaded_score and same, "the loaded checkpoint scores "
                                          "differently")
    check(all(math.isfinite(float(v)) for v in pred.asnumpy().ravel()[:100]),
          "non-finite predictions")
    del mod, loaded, it, pred
    (cpu32, cpu64), cpu_s = joined(*cpu_run)
    log(f"  CPU Module steps (beside the card's): fp32 and fp64 "
        f"{cpu_s:.1f} s")
    check_steps(card, cpu32, names, "fp32 Module step, card vs CPU",
                FP32_STEP_BOUND)
    check_steps(card64, cpu64, names, "fp64 Module step, card vs CPU",
                FP64_STEP_BOUND)
    check_steps(loop, card_gluon_order, order,
                "gluon.Trainer step vs the Module step", LOOP_BOUND)
    if not timed:
        return None

    log(f"== symbolic 6: 20 Module steps at batch {timed_batch}, bf16 "
        f"(amp.init()), SGD {TRAIN_OPT}")
    base = memory_base()
    mod = bound_module(prefix, ctx, timed_batch, opt=TRAIN_OPT, size=size)
    xb, yb = train_batch(seed, timed_batch, size, classes)
    batch_nd = mx.io.DataBatch(data=[mx.nd.array(xb, ctx=ctx)],
                               label=[mx.nd.array(yb.astype("float32"),
                                                  ctx=ctx)])
    amp.init()
    try:
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            mod.forward_backward(batch_nd)
            mod.update()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        amp.disable()
    probs = mod.get_outputs()[0]._data.float()
    check(bool(torch.isfinite(probs).all()), "non-finite Module outputs")
    img_s = timed_batch * TRAIN_STEPS / dt
    log(f"  [{gpu_line()}] Module: {img_s:.1f} img/s, "
        f"{1e3 * dt / TRAIN_STEPS:.2f} ms/step over {TRAIN_STEPS} steps, "
        f"peak memory {(torch.cuda.max_memory_allocated() - base) / 2**30:.3f}"
        f" GiB over the run's start")
    del mod, batch_nd
    return img_s


def symbolic_consistency(seed, ctx_list=None, shape=BERT_SHAPE,
                         conv_batch=CHECK_BATCH):
    """(c): test_utils.check_consistency across ``ctx_list`` on the
    attention symbol at BERT's shape and on a conv + BatchNorm symbol; an
    offset planted on the last context's weight must raise."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import test_utils

    ctx_list = ctx_list or [mx.cpu(), mx.gpu(0)]
    b, h, _, lq, _, d = shape[:6]
    r = np.random.RandomState(seed)
    att = mx.sym.flash_attention(*(mx.sym.var(n) for n in "qkv"),
                                 causal=False, sm_scale=1.0 / math.sqrt(d),
                                 name="attention")
    qkv = [r.randn(b, h, lq, d).astype("float32") for _ in range(3)]
    test_utils.check_consistency(att, qkv, ctx_list=ctx_list,
                                 rtol=SYM_ATTENTION_TOL,
                                 atol=SYM_ATTENTION_TOL)
    data = mx.sym.var("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=64,
                             pad=(1, 1), name="conv")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn")
    conv = mx.sym.Activation(net, act_type="relu", name="relu")
    shapes, _, aux_shapes = conv.infer_shape(data=(conv_batch, 3, 56, 56))
    inputs = [r.randn(*s).astype("float32") * 0.5 for s in shapes] + \
        [r.rand(*s).astype("float32") + 0.5 for s in aux_shapes]
    test_utils.check_consistency(conv, inputs, ctx_list=ctx_list)
    forward = test_utils.symbol_forward(conv)
    calls = []

    def planted(*nds):
        # one call a context, in ctx_list's order: the last context's
        # call gets the offset
        calls.append(nds[0].context)
        if len(calls) == len(ctx_list):
            nds = list(nds)
            nds[1] = nds[1] + 1e-3
        return forward(*nds)

    try:
        test_utils.check_consistency(planted, inputs, ctx_list=ctx_list)
        caught = False
    except AssertionError:
        caught = True
    log(f"  check_consistency over {ctx_list}: the attention symbol at "
        f"{(b, h, lq, d)} (within {SYM_ATTENTION_TOL:g}) and conv + "
        f"BatchNorm at ({conv_batch}, 3, 56, 56) consistent; an offset of "
        f"1e-3 planted on the last context's weight raised: {caught}")
    check(caught, "check_consistency misses an offset on the card's weight")


def symbolic_phase(seed, trainstep_img_s=None):
    """Phase 14: (a) BERT-base, (b) ResNet-50 through Module, (c)
    check_consistency.  Returns flash_attn_fwd's launches on the
    symbol_block_bert path."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="symbolic_")
    try:
        log("== symbolic 1: BERT-base (bench.py's configuration, dropout 0) "
            "exported and SymbolBlock.imports(..., ctx=mx.gpu())")
        launches, _ = symbolic_bert(seed, work)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        log(f"  (a) {t1 - t0:.1f} s")
        log(f"== symbolic 4: ResNet-50 v1 (bench.py's net) exported, "
            f"mx.mod.Module.load on mx.gpu() at batch {SYM_MODULE_BATCH}, "
            f"SGD {CHECK_OPT}: one step against the CPU's, fp32 and fp64")
        img_s = symbolic_module(seed, work)
        if trainstep_img_s is not None:
            log(f"  [{gpu_line()}] Module {img_s:.1f} img/s against "
                f"phase 5's TrainStep {trainstep_img_s:.1f} img/s in this run "
                f"({img_s / trainstep_img_s:.3f}x)")
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        log(f"  (b) {t2 - t1:.1f} s")
        log("== symbolic 7: test_utils.check_consistency over [mx.cpu(), "
            "mx.gpu()]")
        symbolic_consistency(seed)
        t3 = time.perf_counter()
        log(f"  (c) {t3 - t2:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  [{gpu_line()}] phase 14 took {time.perf_counter() - t0:.1f} s")
    return launches


def bert_step_flops(cfg, batch, seq, attention=True):
    """The analytic FLOPs of one BertForPretraining training step's
    products: each Dense layer 6 x rows x in x out (forward, the input's
    and the weight's gradient; every layer's input needs its gradient),
    and with ``attention`` the attention's 14 x D per (query, key) pair
    and head (4 forward, 10 in the blockwise backward).  The MLM head runs
    over every position, the pooler and NSP head over the batch."""
    t, h, i = batch * seq, cfg.hidden_size, cfg.intermediate_size
    dense = 6 * (cfg.num_layers * t * (4 * h * h + 2 * h * i)
                 + batch * h * h + t * h * h + t * h * cfg.vocab_size
                 + batch * h * 2)
    att = 14 * cfg.num_layers * batch * cfg.num_heads * seq * seq * \
        (h // cfg.num_heads)
    return dense + (att if attention else 0)


# ---------------------------------------------------------------------------
# phase 15: data parallelism across processes
# ---------------------------------------------------------------------------
# (a) runs in this process over a one-rank NCCL group (HashStore); (b) and
# (c) in two processes that share cuda:0, started through the repo's
# tools/launch.py, over the host-reduced dist_sync store (gloo): NCCL puts
# no two ranks of one communicator on one device.
DP_STEPS, DP_TIMED, DP_WARMUP = 3, 10, 2
# (b) and (c): BERT-base widths at this depth (the phase's time: the two
# ranks' steps move every gradient and parameter through host copies)
DP_RANK_LAYERS = 4
DP_ADAM = {"learning_rate": 1e-4, "epsilon": 1e-6}
DP_SGD = {"learning_rate": 0.1, "momentum": 0.9}
# the CPU check of (b) and (c) (tests/test_torch_chip_smoke_dist.py):
# a 2-layer BERT at batch 8 x 16
DP_TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position=32, dropout=0.0)
DP_TINY_BATCH, DP_TINY_SEQ = 8, 16
# (b): the two-process fp32 steps against the one-process fp32 step at
# the whole batch differ only by the order of the sums over the batch
# (two half-batch sums added, against one); with SGD, at most this share
# of the largest update entry after DP_STEPS steps; with Adam (which
# divides each entry by its own size, so rounding on near-zero entries
# moves them by up to lr) the L2 norm of the difference at most this
# share of the update's
DP_SGD_BOUND = 1e-3
DP_ADAM_BOUND = 1e-2
# (b): each rank's ZeRO optimizer state against (a)'s one-rank state
DP_ZERO_SHARE = (0.49, 0.51)
DP_WORKER_TIMEOUT = 420


def _dp_steps(net, trainer, ids, labels, steps, world=1):
    """``steps`` Gluon steps of BertForPretraining: record, the MLM + NSP
    loss (each a mean over this process's batch), backward,
    ``trainer.step(world)``: with ``world`` processes the summed gradients
    are those of the mean over the whole batch.  Returns the losses."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    ctx = next(iter(net.collect_params().values())).data().context
    mlm, nsp = bert_labels(labels)
    a = [mx.nd.array(x, ctx=ctx, dtype="int32") for x in (ids, mlm, nsp)]
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with autograd.record():
            m_out, n_out = net(a[0])
            loss = ce(m_out, a[1]).mean() + ce(n_out, a[2]).mean()
        loss.backward()
        trainer.step(world)
        losses.append(loss)
    return [float(v.asscalar()) for v in losses]


def _host_params(tensors):
    return [t.detach().to("cpu", torch.float32, copy=True) for t in tensors]


def _dp_diff(got, want, init):
    """(max |got - want| / max |want - init|, the same in L2 norms)."""
    num_max = max((g - w).abs().max().item() for g, w in zip(got, want))
    den_max = max((w - i).abs().max().item() for w, i in zip(want, init))
    num_l2 = math.sqrt(sum(((g - w).double() ** 2).sum().item()
                           for g, w in zip(got, want)))
    den_l2 = math.sqrt(sum(((w - i).double() ** 2).sum().item()
                           for w, i in zip(want, init)))
    return num_max / den_max, num_l2 / den_l2


def _dp_bit_equal(name, runs, other):
    """(a): a one-rank all-reduce is the identity, so ``other`` must be
    the plain step bit for bit; ``runs`` (two runs of the plain step)
    must repeat each other first, or bit equality would mean nothing."""
    same = [all(torch.equal(a, b) for a, b in zip(runs[0]["params"],
                                                   r["params"]))
            for r in (runs[1], other)]
    log(f"  {name}: the plain step repeats itself bit for bit: {same[0]}; "
        f"{name} equals it bit for bit: {same[1]}")
    check(all(same), f"{name} at world size 1 is not the plain step")


def dp_nccl_phase(seed, cfg, ids, labels, bert_samples_s):
    """Phase 15 (a): world size 1 over a real NCCL communicator (this
    process is rank 0 of a one-rank group the caller made).  BERT-base at
    64 x 128 bf16: TrainStep(mesh=make_mesh()) against TrainStep, and
    Trainer over dist_device_sync (the per-key sharded Adam) and under
    MXNET_ZERO=1 (the bucket engine) against Trainer without a store.  A
    one-rank all-reduce is the identity, so each equals its plain step bit
    for bit (the plain step is run twice to show it repeats itself).
    Returns (flash_attn_fwd's launches on the mesh
    path, the ZeRO state bytes)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch.parallel import TrainStep, collectives, make_mesh

    ids_t = torch.from_numpy(ids).cuda()
    labels_t = torch.from_numpy(labels).cuda()
    n_layers = cfg.num_layers

    def trainstep(mesh, timed=True):
        net = init_bert(cfg, seed, mx.gpu(0))
        step = TrainStep(net, bert_loss, optimizer="adam",
                         optimizer_params=BERT_OPT, dtype="bfloat16",
                         mesh=mesh)
        # the net's own order (train_params' follows the names, whose
        # block counters differ between nets)
        order = [n for n in net.collect_params() if n in step.train_params]
        fa_mod._flash_fwd_cuda.launches = 0
        collectives.reset_issued()
        losses = [step(ids_t, labels_t) for _ in range(DP_STEPS)]
        torch.cuda.synchronize()
        params = _host_params(step.train_params[n] for n in order)
        out = {"losses": [v.item() for v in losses], "params": params,
               "launches": fa_mod._flash_fwd_cuda.launches,
               "issued": collectives.issued()}
        if not timed:              # the repeat of the plain step
            del step, net
            torch.cuda.empty_cache()
            return out
        for _ in range(DP_WARMUP):
            step(ids_t, labels_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED):
            step(ids_t, labels_t)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        samples_s = BERT_BATCH * DP_TIMED / dt
        log(f"  {'TrainStep(mesh=)' if mesh else 'TrainStep'}'s profile:")
        log_device_profile(lambda: [step(ids_t, labels_t) for _ in range(3)],
                           BERT_KERNEL_GROUPS, n_top=6, steps=3,
                           step_ms=1e3 * dt / DP_TIMED)
        out.update(samples_s=samples_s,
                   launches=fa_mod._flash_fwd_cuda.launches,
                   issued=collectives.issued())
        del step, net
        torch.cuda.empty_cache()
        return out

    log("== distributed (a): world size 1 over NCCL, BERT-base 64 x 128 "
        "bf16, dropout 0")
    base = [trainstep(None), trainstep(None, timed=False)]
    mesh = trainstep(make_mesh())
    n_steps = DP_STEPS + DP_WARMUP + DP_TIMED + 3
    for name, run in (("TrainStep", base[0]), ("TrainStep(mesh=)", mesh)):
        log(f"  {name}: losses {' '.join(f'{v:.5f}' for v in run['losses'])}"
            f"; [{gpu_line()}] {run['samples_s']:.1f} samples/s over "
            f"{DP_TIMED} steps; flash_attn_fwd launches {run['launches']}; "
            f"collectives {run['issued']}")
    log(f"  phase 6's TrainStep at the same configuration: "
        f"{bert_samples_s:.1f} samples/s")
    # what the mesh step adds: its all-reduce of the gradients, timed
    # alone at their size (one flat fp32 buffer) on the one-rank group
    n_grad = sum(t.numel() for t in mesh["params"])
    flat = torch.ones(n_grad, device="cuda")
    ms = cuda_time_ms(lambda: collectives.psum_(flat, ("dp", "fsdp"),
                                                make_mesh()), iters=10)
    log(f"  [{gpu_line()}] one-rank NCCL all-reduce of the "
        f"{4 * n_grad / 1e6:.1f} MB of gradients: {ms:.3f} ms "
        f"({4 * n_grad / ms / 1e6:.1f} GB/s)")
    del flat
    _dp_bit_equal("TrainStep(mesh=)", base, mesh)
    check(mesh["launches"] == n_layers * n_steps,
          f"flash_attn_fwd launched {mesh['launches']} times on the mesh "
          f"path, expected {n_layers * n_steps}")
    check(mesh["issued"].get("psum", 0) > 0 and not base[0]["issued"],
          f"the mesh step issued no collective: {mesh['issued']}")

    def trainer_run(kvstore, zero, update_on_kvstore=None):
        os.environ["MXNET_ZERO"] = "1" if zero else "0"
        net = init_bert(cfg, seed, mx.gpu(0))
        tr = gluon.Trainer(net.collect_params(), "adam", dict(BERT_OPT),
                           kvstore=kvstore,
                           update_on_kvstore=update_on_kvstore)
        collectives.reset_issued()
        amp.init("bfloat16")
        try:
            losses = _dp_steps(net, tr, ids, labels, DP_STEPS)
        finally:
            amp.disable()
            os.environ.pop("MXNET_ZERO", None)
        out = {"losses": losses, "issued": collectives.issued(),
               "params": _host_params(p.data()._data for p in
                                      net.collect_params().values()
                                      if p.grad_req != "null"),
               "zero_bytes": tr._zero.state_bytes() if tr._zero else 0}
        del tr, net
        torch.cuda.empty_cache()
        return out

    plain = [trainer_run(None, False) for _ in range(2)]
    sharded = trainer_run("dist_device_sync", False)
    zero = trainer_run("dist_device_sync", True, update_on_kvstore=False)
    for name, run in (("Trainer", plain[0]),
                      ("Trainer(kvstore='dist_device_sync')", sharded),
                      ("the same, MXNET_ZERO=1", zero)):
        log(f"  {name}: losses {' '.join(f'{v:.5f}' for v in run['losses'])}"
            f"; collectives {run['issued']}")
    for name, run in (("Trainer(kvstore='dist_device_sync')", sharded),
                      ("Trainer under MXNET_ZERO=1", zero)):
        _dp_bit_equal(name, plain, run)
    check(sharded["issued"].get("reduce_scatter", 0) > 0 and
          zero["issued"].get("reduce_scatter", 0) > 0,
          "a store's run issued no reduce-scatter")
    n_values = sum(t.numel() for t in zero["params"])
    log(f"  ZeRO optimizer state at world size 1: "
        f"{zero['zero_bytes'] / 2**20:.1f} MiB, "
        f"{zero['zero_bytes'] / n_values:g} bytes a value (Adam's two fp32 "
        f"moments)")
    check(zero["zero_bytes"] == 8 * n_values,
          "the one-rank ZeRO state is not two fp32 moments a value")
    return mesh["launches"], zero["zero_bytes"]


def dp_worker_main(args):
    """A rank of phase 15 (b) and (c), started by tools/launch.py: joins
    the group from the launcher's environment (both ranks on cuda:0,
    reducing through gloo), trains BERT-base widths (DP_RANK_LAYERS
    layers) in fp32 on its half of the
    batch through Trainer(kvstore="dist_sync"): SGD updated on the store
    (per key) and in the Trainer's flat buckets, Adam under MXNET_ZERO=1,
    and the per-key and ZeRO runs again with a planted fault (rank 1
    trains on rank 0's half); then runs the agreements.  Writes
    rank<N>.json (and, on rank 0, the parameters) to --dp-dir."""
    import zlib

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, lifecycle, nd
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm
    from mxnet_tpu_torch.gluon.model_zoo.language import bert
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch.parallel import collectives, distributed

    tiny = args.dp_tiny
    check(distributed.init(local_device_ids=[0],
                           device="cpu" if tiny else None),
          "distributed.init did not join a group")
    rank, world = collectives.rank(), collectives.world_size()
    out_dir = args.dp_dir
    cfg = bert.BertConfig(**DP_TINY) if tiny else \
        bert.BertConfig(dropout=0.0, num_layers=DP_RANK_LAYERS)
    batch, seq = (DP_TINY_BATCH, DP_TINY_SEQ) if tiny else \
        (BERT_BATCH, BERT_SEQ)
    ids, labels = bert_batch(args.seed, batch, seq, cfg.vocab_size)
    per = batch // world
    ctx = mx.cpu() if tiny else mx.gpu(0)
    res = {"rank": rank, "world": world}

    def run(name, optimizer, opt, zero=False, bucketed=False, fault=False):
        os.environ["MXNET_ZERO"] = "1" if zero else "0"
        net = init_bert(cfg, args.seed, ctx, seq)
        net.load_parameters(os.path.join(out_dir, "init.params"), ctx=ctx)
        # update on the store (dist_sync's default: per-key
        # reduce-scatter, update, all-gather), or reduce the gradients in
        # the Trainer's flat buckets (bucketed, and ZeRO's buckets)
        tr = gluon.Trainer(net.collect_params(), optimizer, dict(opt),
                           kvstore="dist_sync",
                           update_on_kvstore=False if zero or bucketed
                           else None)
        src = 0 if fault else rank
        rows = slice(src * per, (src + 1) * per)
        fa_mod._flash_fwd_cuda.launches = 0
        collectives.reset_issued()
        t0 = time.perf_counter()
        losses = _dp_steps(net, tr, ids[rows], labels[rows], DP_STEPS, world)
        if not tiny:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        params = _host_params(p.data()._data for p in
                              net.collect_params().values())
        crc = 0
        for p in params:
            crc = zlib.crc32(p.numpy().tobytes(), crc)
        if rank == 0:
            torch.save(params, os.path.join(out_dir, f"{name}.pt"))
        res[name] = {"losses": losses, "crc": crc, "seconds": dt,
                     "launches": fa_mod._flash_fwd_cuda.launches,
                     "issued": collectives.issued(),
                     "zero_bytes": tr._zero.state_bytes() if tr._zero
                     else 0}
        os.environ.pop("MXNET_ZERO", None)
        del tr, net
        if not tiny:
            torch.cuda.empty_cache()
        collectives.barrier()

    run("sgd", "sgd", DP_SGD)
    run("sgd_fault", "sgd", DP_SGD, fault=True)
    run("sgd_bucketed", "sgd", DP_SGD, bucketed=True)
    run("zero_adam", "adam", DP_ADAM, zero=True)
    run("zero_adam_fault", "adam", DP_ADAM, zero=True, fault=True)

    # (c) the agreements across the two ranks
    lifecycle.reset()
    lifecycle.coordinate_stops(True)
    left = None
    for step in range(8):
        if rank == 1 and step == 2:
            lifecycle.request_stop("planted on rank 1")
        if lifecycle.check_stop():
            left = step
            break
        collectives.allreduce_hosts(np.ones(1, "f"))    # the step's work
    res["stop_step"] = left
    lifecycle.reset()

    small = gluon.nn.Dense(4, in_units=8)
    small.initialize(mx.init.Xavier(), ctx=ctx)
    rs = np.random.RandomState(args.seed)
    for p in small.collect_params().values():
        p.set_data(nd.array(rs.randn(*p.shape).astype("f"), ctx=ctx))
    before = [p.data().asnumpy() for p in small.collect_params().values()]
    tr = gluon.Trainer(small.collect_params(), "sgd",
                       {"learning_rate": 0.1}, kvstore="dist_sync",
                       update_on_kvstore=False)
    amp.init("float16", target_dtype_ops=[], fp32_ops=[])
    try:
        amp.init_trainer(tr)
        x = nd.array(rs.randn(4, 8).astype("f"), ctx=ctx)
        with autograd.record():
            loss = (small(x) ** 2).sum()
        loss.backward()
        if rank == 1:
            small.weight.grad()._data[0, 0] = float("inf")
        tr.step(8)
        res["overflow_skipped"] = all(
            np.array_equal(b, p.data().asnumpy()) for b, p in
            zip(before, small.collect_params().values()))
        res["loss_scale"] = tr._amp_loss_scaler.loss_scale
    finally:
        amp.disable()

    xg = rs.randn(8, 4, 3, 3).astype("f")
    bn = SyncBatchNorm(in_channels=4)
    bn.initialize(ctx=ctx)
    xs = nd.array(xg[rank * 4:(rank + 1) * 4], ctx=ctx)
    with autograd.record():
        bn(xs)
    res["sync_bn_err"] = max(
        float(np.abs(bn.running_mean.data().asnumpy()
                     - 0.1 * xg.mean(axis=(0, 2, 3))).max()),
        float(np.abs(bn.running_var.data().asnumpy()
                     - (0.9 + 0.1 * xg.var(axis=(0, 2, 3)))).max()))

    ckpt = os.path.join(out_dir, "ckpt")
    mgr = CheckpointManager(ckpt, max_to_keep=2)
    mgr.save(1, small, tr)
    res["ckpt_listing"] = sorted(os.listdir(ckpt))
    res["ckpt_wrote"] = hasattr(mgr, "last_save_timing")
    other = gluon.Trainer(small.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore="dist_sync",
                          update_on_kvstore=False)
    res["ckpt_restored"] = mgr.restore(small, other)
    collectives.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def dp_two_process_phase(seed, cfg, ids, labels, zero_bytes_1, tiny=False):
    """Phase 15 (b) and (c): two processes sharing cuda:0 through
    ``tools/launch.py -n 2`` and the dist_sync store, held against this
    process's one-rank fp32 steps at the whole batch.  Returns
    flash_attn_fwd's launches on rank 0's dist_sync run.  ``tiny`` runs
    the same on the CPU at DP_TINY (the ranks too), where no kernel
    launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    batch, seq = ids.shape
    ctx = mx.cpu() if tiny else mx.gpu(0)
    log("== distributed (b): two processes on cuda:0 through "
        "tools/launch.py -n 2, Trainer(kvstore='dist_sync'), BERT-base "
        f"widths at {cfg.num_layers} layers, fp32, {batch // 2} x {seq} a "
        f"rank")
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="mxnet_dp_")
    try:
        net = init_bert(cfg, seed, ctx, seq)
        net.save_parameters(os.path.join(work, "init.params"))
        init = _host_params(p.data()._data for p in
                            net.collect_params().values())
        del net

        def one_rank(optimizer, opt):
            net = init_bert(cfg, seed, ctx, seq)
            net.load_parameters(os.path.join(work, "init.params"),
                                ctx=ctx)
            tr = gluon.Trainer(net.collect_params(), optimizer, dict(opt),
                               kvstore=None)
            losses = _dp_steps(net, tr, ids, labels, DP_STEPS)
            params = _host_params(p.data()._data for p in
                                  net.collect_params().values())
            del tr, net
            return losses, params

        t0 = time.perf_counter()
        want = {"sgd": one_rank("sgd", DP_SGD),
                "zero_adam": one_rank("adam", DP_ADAM)}
        log(f"  the one-rank fp32 steps at {batch} x {seq}: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cmd = [sys.executable, os.path.join(here, "tools", "launch.py"),
               "-n", "2", "--launcher", "local", "--",
               sys.executable, os.path.join(here, "chip_smoke.py"),
               "--dp-worker", "--dp-dir", work, "--seed", str(seed)] + \
            (["--dp-tiny"] if tiny else [])
        env = dict(os.environ, PYTHONPATH=here)
        proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                              text=True, timeout=DP_WORKER_TIMEOUT)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            log(proc.stdout[-6000:])
            log(proc.stderr[-6000:])
        check(proc.returncode == 0,
              f"the two dist_sync ranks exited {proc.returncode}")
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        log(f"  the two ranks ran in {wall:.1f} s (start-up included)")
        for name in ("sgd", "sgd_fault", "sgd_bucketed", "zero_adam",
                     "zero_adam_fault"):
            got = torch.load(os.path.join(work, f"{name}.pt"))
            key = "zero_adam" if name.startswith("zero_adam") else "sgd"
            losses, ref = want[key]
            r_max, r_l2 = _dp_diff(got, ref, init)
            same = ranks[0][name]["crc"] == ranks[1][name]["crc"]
            log(f"  {name}: rank losses {ranks[0][name]['losses']} / "
                f"{ranks[1][name]['losses']}, one rank {losses}; |diff| / "
                f"|update|: max {r_max:.3e}, L2 {r_l2:.3e}; ranks bit-equal "
                f"{same}; {ranks[0][name]['seconds']:.2f} s for "
                f"{DP_STEPS} steps; collectives {ranks[0][name]['issued']}")
            if name in ("sgd", "sgd_bucketed"):
                check(same and r_max <= DP_SGD_BOUND,
                      f"two-rank dist_sync SGD ({name}) off the one-rank "
                      f"step: {r_max:.3e} > {DP_SGD_BOUND:g}")
            elif name == "sgd_fault":
                check(r_max > DP_SGD_BOUND,
                      f"the planted data fault passes the per-key SGD "
                      f"bound: {r_max:.3e}")
            elif name == "zero_adam":
                check(same and r_l2 <= DP_ADAM_BOUND,
                      f"two-rank ZeRO Adam off the one-rank step: "
                      f"{r_l2:.3e} > {DP_ADAM_BOUND:g}")
            else:
                check(r_l2 > DP_ADAM_BOUND,
                      f"the planted data fault passes the ZeRO Adam "
                      f"bound: {r_l2:.3e}")
        shares = [r["zero_adam"]["zero_bytes"] / zero_bytes_1 for r in ranks]
        log(f"  ZeRO optimizer state a rank: "
            f"{[r['zero_adam']['zero_bytes'] / 2**20 for r in ranks]} MiB, "
            f"{shares} of world size 1's")
        check(all(DP_ZERO_SHARE[0] <= s <= DP_ZERO_SHARE[1]
                  for s in shares), f"ZeRO state shares {shares}")
        launches = ranks[0]["sgd"]["launches"]
        check(tiny or launches == cfg.num_layers * DP_STEPS,
              f"flash_attn_fwd launched {launches} times on a dist_sync "
              f"rank, expected {cfg.num_layers * DP_STEPS}")

        log("== distributed (c): the agreements across the two ranks")
        for r in ranks:
            log(f"  rank {r['rank']}: stop at step {r['stop_step']}, "
                f"overflow skipped {r['overflow_skipped']} (scale "
                f"{r['loss_scale']:g}), SyncBatchNorm stats vs the global "
                f"batch {r['sync_bn_err']:.2e}, checkpoint listing "
                f"{r['ckpt_listing']} (wrote: {r['ckpt_wrote']}), "
                f"restored step {r['ckpt_restored']}")
        check([r["stop_step"] for r in ranks] == [2, 2],
              "a stop on rank 1 did not end both ranks at step 2")
        check(all(r["overflow_skipped"] for r in ranks) and
              len({r["loss_scale"] for r in ranks}) == 1,
              "an overflow on rank 1 did not make both ranks skip")
        check(all(r["sync_bn_err"] <= 1e-5 for r in ranks),
              "SyncBatchNorm's statistics are not the global batch's")
        check([r["ckpt_wrote"] for r in ranks] == [True, False] and
              all(r["ckpt_listing"] == ["step_00000001"] and
                  r["ckpt_restored"] == 1 for r in ranks),
              "the checkpoint was not published once by one writer")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def distributed_phase(seed, bert_samples_s):
    """Phase 15; returns flash_attn_fwd's launches by path."""
    import torch.distributed as dist

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    cfg = bert.BertConfig(dropout=0.0)
    ids, labels = bert_batch(seed, BERT_BATCH, BERT_SEQ, cfg.vocab_size)
    # init() is a no-op for one process, as the reference's: the one-rank
    # group over a real NCCL communicator is made here
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    try:
        launches_nccl, _ = dp_nccl_phase(seed, cfg, ids, labels,
                                         bert_samples_s)
        # (b) at DP_RANK_LAYERS: its one-rank ZeRO state is (a)'s measure,
        # two fp32 moments a value, of that net
        cfg_b = bert.BertConfig(dropout=0.0, num_layers=DP_RANK_LAYERS)
        net = init_bert(cfg_b, seed, mx.cpu(), BERT_SEQ)
        zero_bytes = 8 * sum(p.data().size
                             for p in net.collect_params().values())
        del net
        launches_sync = dp_two_process_phase(seed, cfg_b, ids, labels,
                                             zero_bytes)
    finally:
        dist.destroy_process_group()
    return {"dp_bert_nccl": launches_nccl,
            "dp_bert_dist_sync": launches_sync}


# ---------------------------------------------------------------------------
# phase 16: the sharded training step
# ---------------------------------------------------------------------------
# (b)-(d) run in one pair of ranks started as children of this script
# (``--mp-rank``), both on cuda:0 over gloo (NCCL puts no two ranks of one
# communicator on one device), the collectives through host copies; each
# check in turn, start-up paid once.  (a) runs after them in this process
# over a one-rank NCCL group, (e) while they run.  Llama-3-8B widths
# (hidden 4096, 32/8 heads of 128, FFN 14336, vocab 128256) in fp32, TF32
# off; the depth cut to 1 layer for (a) and (b) and 2 for (c) (one a
# stage), so that each rank holds the net, the one-rank step it is held
# to and its own sharded step on the one card.
MP_STEPS = 2
MP_SEQ = 256
MP_SGD = {"learning_rate": 0.1}
MP_PP_M, MP_PP_BATCH = 4, 4
MP_RULES = ("replicated", "fsdp", "megatron", "megatron+fsdp")
# (d): B, H, L, D of the long causal sequence, and the bound of ring and
# Ulysses attention against the plain attention over the whole sequence
MP_SP_SHAPE = (1, 32, 8192, 128)
MP_SP_BOUND = 1e-5
# (b), (c): max |sharded - one-rank| / max |one-rank update| of the fp32
# SGD steps (phase 15 (b)'s measure).  On the CPU (the tiny check,
# tests/test_torch_chip_smoke_sharded.py) tp = 2 reads 1.7e-6 and GPipe
# and 1F1B 3.9e-7, the planted faults 0.75 (row-parallel all-reduce left
# out), 3.7 (kv heads) and 0.95 (reversed backward); (d)'s ring 4.2e-7,
# Ulysses 0.0, the source-shard fault 2.9
MP_TP_BOUND = 1e-3
MP_PP_BOUND = 1e-3
# the CPU check: Llama at llama_tiny-like widths, and a short sequence
MP_TINY = dict(vocab_size=96, hidden_size=64, num_heads=4, num_kv_heads=2,
               intermediate_size=128, max_seq_len=64)
MP_TINY_SEQ, MP_TINY_SP = 16, (1, 4, 64, 16)
MP_WORKER_TIMEOUT = 420
# the planner's check of (e): Llama-3-8B at full depth over 8 cards
MP_PLAN_DEVICES = 8
MP_PLAN_ROWS = 8 * 2048


def _mp_cfg(tiny, layers):
    from mxnet_tpu_torch.gluon.model_zoo.language import llama

    return llama.LlamaConfig(num_layers=layers, **(MP_TINY if tiny else {}))


def _mp_ratio(step, want, init):
    """(max |this rank's tiles - the one-rank step's|, max |the one-rank
    step's update|) over every parameter this rank holds, the one-rank
    values cut to the same tiles."""
    num = den = 0.0
    for k, t in step.params.items():
        if k not in step.train_params:
            continue
        pl = step._place.get(k)
        w = pl.shard(want[k]) if pl is not None else want[k]
        i = pl.shard(init[k]) if pl is not None else init[k]
        num = max(num, (t.detach() - w).abs().max().item())
        den = max(den, (w - i).abs().max().item())
    return num, den


def _mp_combine(pairs, device):
    """Each rank's (num, den) pairs maxed over the ranks: the ratios."""
    from mxnet_tpu_torch.parallel import collectives

    t = torch.tensor([v for p in pairs for v in p], dtype=torch.float64,
                     device=device)
    t = collectives.pmax(t, "world", host=collectives.needs_host(t))
    return [t[2 * i].item() / t[2 * i + 1].item() for i in range(len(pairs))]


@contextlib.contextmanager
def _mp_fault(fault):
    """Plant one fault of phase 16: the row-parallel all-reduce left out,
    or the last pipeline stage seeding each microbatch's backward with the
    reversed microbatch's cotangent, or the ring taking its neighbour's
    source shard (the kv-head fault is planted on the step's tiles)."""
    from mxnet_tpu_torch.parallel import context_parallel as cp
    from mxnet_tpu_torch.parallel import pipeline_parallel as pp
    from mxnet_tpu_torch.parallel import tensor_parallel as tp

    saved = tp.reduce_from_tp, pp._cotangent, cp._source
    if fault == "no_row_reduce":
        tp.reduce_from_tp = lambda x: x
    elif fault == "reversed_backward":
        pp._cotangent = lambda d, m: d[d.shape[0] - 1 - m]
    elif fault == "ring_source":
        cp._source = lambda my, i, n: (my - i + 1) % n
    try:
        yield
    finally:
        tp.reduce_from_tp, pp._cotangent, cp._source = saved


def _mp_split_kv(step):
    """The kv-head fault: each rank's k/v tiles replaced by the next
    rank's, so that its query heads meet another group's keys."""
    for name, pl in step._place.items():
        if "k_proj" in name or "v_proj" in name:
            t = step.train_params[name]
            n, i = pl.mesh.axis_size("tp"), pl.mesh.axis_index("tp")
            tiles = pl.gather(t.detach(), host=step._host).chunk(n, 0)
            with torch.no_grad():
                t.copy_(tiles[(i + 1) % n])


@contextlib.contextmanager
def _mp_launch_shapes():
    """Record the (q, k) shapes the attention is called with (its shape
    check, which the op and the kernel's launcher both run)."""
    from mxnet_tpu_torch.ops import flash_attention as fa_mod

    orig, shapes = fa_mod._check_shapes, []

    def check_shapes(q, k, *a, **kw):
        shapes.append((list(q.shape), list(k.shape)))
        return orig(q, k, *a, **kw)

    fa_mod._check_shapes = check_shapes
    try:
        yield shapes
    finally:
        fa_mod._check_shapes = orig


def _mp_sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def mp_tp_checks(seed, tiny, device, out):
    """(b) tp = 2: the megatron plan's step against the one-rank step,
    clean and with the two planted faults; flash_attn_fwd's launches and
    their shapes on this rank; the plan's HBM estimate beside the
    measured peak."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch.parallel import TrainStep, collectives, planner

    ctx = mx.cpu() if tiny else mx.gpu(0)
    kern = fa_mod._flash_fwd_cuda
    cfg = _mp_cfg(tiny, 1)
    seq = MP_TINY_SEQ if tiny else MP_SEQ
    t0 = time.perf_counter()
    net = init_llama(cfg, seed, ctx)
    ids, labels = llama_batch(seed, 1, seq, cfg.vocab_size)
    x, y = torch.from_numpy(ids).to(device), torch.from_numpy(labels).to(device)
    init = {k: p.data()._data for k, p in net.collect_params().items()}
    plain = TrainStep(net, llama_loss, "sgd", MP_SGD, device=device)
    for _ in range(MP_STEPS):
        plain(x, y)
    want = dict(plain.params)
    del plain
    sig = planner.signature_of(net)
    plan = planner.plan_sharding(planner.PlannerConfig(
        mesh={"tp": 2}, rules="megatron", batch_rows=seq), sig, 2)
    pairs = []
    for fault in (None, "no_row_reduce", "kv_split"):
        if device == "cuda":
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with _mp_fault(fault), _mp_launch_shapes() as shapes:
            step = TrainStep(net, llama_loss, "sgd", MP_SGD, device=device,
                             plan=plan)
            if fault == "kv_split":
                _mp_split_kv(step)
            kern.launches = 0
            collectives.reset_issued()
            t1 = time.perf_counter()
            losses = [step(x, y).item() for _ in range(MP_STEPS)]
            _mp_sync(device)
            secs = time.perf_counter() - t1
        pairs.append(_mp_ratio(step, want, init))
        if fault is None:
            out["tp"] = {"losses": losses, "seconds": secs,
                         "launches": kern.launches,
                         "shapes": shapes, "issued": collectives.issued(),
                         "execution": sorted(set(step.execution.values())),
                         "estimate": plan.hbm["total"],
                         "peak": (torch.cuda.max_memory_allocated() - base)
                         if device == "cuda" else 0}
        del step
    ratios = _mp_combine(pairs, device)
    out["tp"]["ratio"] = ratios[0]
    out["tp"]["faults"] = {"no_row_reduce": ratios[1], "kv_split": ratios[2]}
    out["tp"]["build_s"] = time.perf_counter() - t0
    del net, init, want


def mp_pp_checks(seed, tiny, device, out):
    """(c) pp = 2, M = 4: GPipe and 1F1B against the one-rank step, and
    1F1B with the microbatches reversed in the backward."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import flash_attention as fa_mod
    from mxnet_tpu_torch.parallel import TrainStep, collectives, make_mesh

    ctx = mx.cpu() if tiny else mx.gpu(0)
    kern = fa_mod._flash_fwd_cuda
    cfg = _mp_cfg(tiny, 2)
    seq = MP_TINY_SEQ if tiny else MP_SEQ
    net = init_llama(cfg, seed + 1, ctx)
    ids, labels = llama_batch(seed + 1, MP_PP_BATCH, seq, cfg.vocab_size)
    x, y = torch.from_numpy(ids).to(device), torch.from_numpy(labels).to(device)
    init = {k: p.data()._data for k, p in net.collect_params().items()}
    plain = TrainStep(net, llama_loss, "sgd", MP_SGD, device=device)
    for _ in range(MP_STEPS):
        plain(x, y)
    want = dict(plain.params)
    del plain
    mesh = make_mesh(pp=2)
    pairs, runs = [], {}
    for schedule, fault in (("gpipe", None), ("1f1b", None),
                            ("1f1b", "reversed_backward")):
        if device == "cuda":
            torch.cuda.empty_cache()
        with _mp_fault(fault), _mp_launch_shapes() as shapes:
            step = TrainStep(net, llama_loss, "sgd", MP_SGD, device=device,
                             mesh=mesh, pipeline={
                                 "num_microbatches": MP_PP_M,
                                 "schedule": schedule})
            kern.launches = 0
            collectives.reset_issued()
            t1 = time.perf_counter()
            losses = [step(x, y).item() for _ in range(MP_STEPS)]
            _mp_sync(device)
            secs = time.perf_counter() - t1
        pairs.append(_mp_ratio(step, want, init))
        if fault is None:
            runs[schedule] = {"losses": losses, "seconds": secs,
                              "launches": kern.launches,
                              "shapes": shapes[:1],
                              "issued": collectives.issued()}
        del step
    ratios = _mp_combine(pairs, device)
    runs["gpipe"]["ratio"], runs["1f1b"]["ratio"] = ratios[:2]
    runs["fault"] = ratios[2]
    out["pp"] = runs
    del net, init, want


def _plain_attention(q, k, v, heads=4):
    """The plain attention (``_mha_with_lse``) over the whole sequence, a
    few heads at a time (one (L, L) fp32 score matrix a head)."""
    from mxnet_tpu_torch.ops.flash_attention import _mha_with_lse

    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.cat([_mha_with_lse(q[:, h:h + heads], k[:, h:h + heads],
                                    v[:, h:h + heads], True, scale)[0]
                      for h in range(0, q.shape[1], heads)], dim=1)


def mp_sp_checks(seed, tiny, device, out):
    """(d) sp = 2: ring and Ulysses attention at a long causal sequence
    against the plain attention over the whole sequence, and the ring with
    an off-by-one in its source shard."""
    from mxnet_tpu_torch.parallel import collectives, make_mesh
    from mxnet_tpu_torch.parallel import context_parallel as cp

    shape = MP_TINY_SP if tiny else MP_SP_SHAPE
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=device)
               for _ in range(3))
    with torch.no_grad():
        ref = _plain_attention(q, k, v)
        mesh = make_mesh(sp=2)
        res = {}
        for which, fault in (("ring", None), ("ulysses", None),
                             ("ring", "ring_source")):
            fn = cp.context_parallel_attention if which == "ring" else \
                cp.ulysses_context_parallel_attention
            collectives.reset_issued()
            with _mp_fault(fault):
                t1 = time.perf_counter()
                o = fn(q, k, v, mesh, causal=True)
                _mp_sync(device)
                secs = time.perf_counter() - t1
            err = (o - ref).abs().max().item()
            if fault:
                res["fault"] = err
            else:
                res[which] = {"err": err, "seconds": secs,
                              "issued": collectives.issued()}
            del o
    out["sp"] = res


def mp_rank_checks(rank, seed, tiny):
    """Phase 16 (b)-(d) on this rank of the pair; returns the readings."""
    device = "cpu" if tiny else "cuda"
    out = {"rank": rank}
    t0 = time.perf_counter()
    mp_tp_checks(seed, tiny, device, out)
    t1 = time.perf_counter()
    mp_pp_checks(seed, tiny, device, out)
    t2 = time.perf_counter()
    mp_sp_checks(seed, tiny, device, out)
    out["phase_s"] = {"tp": t1 - t0, "pp": t2 - t1,
                      "sp": time.perf_counter() - t2}
    return out


def mp_worker_main(args):
    """A rank of phase 16's pair: joins the two-rank gloo group through a
    FileStore in --mp-dir, runs the checks and writes rank<N>.json
    there."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mp_tiny:
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(args.mp_dir, "store"), 2)
    dist.init_process_group("gloo", store=store, rank=args.mp_rank,
                            world_size=2)
    try:
        res = mp_rank_checks(args.mp_rank, args.seed, args.mp_tiny)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.mp_dir, f"rank{args.mp_rank}.json"),
              "w") as f:
        json.dump(res, f)
    return 0


def mp_start_ranks(seed, work, tiny=False):
    """Start the pair (this script, ``--mp-rank 0`` and ``1``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    procs = []
    for r in range(2):
        cmd = [sys.executable, os.path.join(here, "chip_smoke.py"),
               "--mp-rank", str(r), "--mp-dir", work, "--seed", str(seed)]
        if tiny:
            cmd.append("--mp-tiny")
        log_f = open(os.path.join(work, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(cmd, cwd=here, env=env,
                                       stdout=log_f, stderr=subprocess.STDOUT),
                      log_f))
    return procs


def mp_finish_ranks(procs, work, t0):
    """Wait for the pair; returns both ranks' readings."""
    deadline = t0 + MP_WORKER_TIMEOUT
    rcs = []
    for p, log_f in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
        log_f.close()
    if any(rcs):
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                log(f"  rank {r}'s log:\n" + f.read()[-6000:])
    check(not any(rcs), f"the pair of phase 16 exited {rcs}")
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def mp_check_ranks(ranks, cfg, tiny):
    """Phase 16 (b)-(d)'s checks on the pair's readings; returns
    flash_attn_fwd's launches on rank 0 by path."""
    tp = ranks[0]["tp"]
    seq = MP_TINY_SEQ if tiny else MP_SEQ
    where = "the CPU" if tiny else gpu_line()
    hq, hkv = cfg.num_heads // 2, cfg.num_kv_heads // 2
    local = ([1, hq, seq, cfg.head_dim], [1, hkv, seq, cfg.head_dim])
    log(f"== model parallel (b): tp = 2, megatron plan, 1 layer, "
        f"{MP_STEPS} SGD steps, 1 x {seq}")
    for r in ranks:
        t = r["tp"]
        log(f"  rank {r['rank']}: losses {t['losses']}; execution "
            f"{t['execution']}; {t['seconds']:.2f} s for {MP_STEPS} steps "
            f"({t['build_s']:.1f} s with the one-rank step and the faults); "
            f"flash_attn_fwd {t['launches']} launches at {t['shapes'][:1]}; "
            f"collectives {t['issued']}")
    log(f"  [{where}] |diff| / |update| against the one-rank step: "
        f"{tp['ratio']:.3e} (bound {MP_TP_BOUND:g}); planted: row-parallel "
        f"all-reduce left out {tp['faults']['no_row_reduce']:.3e}, kv heads "
        f"off their query group {tp['faults']['kv_split']:.3e}")
    check(tp["ratio"] <= MP_TP_BOUND,
          f"tp = 2 off the one-rank step: {tp['ratio']:.3e}")
    for fault, v in tp["faults"].items():
        check(v > MP_TP_BOUND, f"the tp check misses the planted {fault}: "
                               f"{v:.3e}")
    check(ranks[0]["tp"]["losses"] == ranks[1]["tp"]["losses"],
          "the two tp ranks' losses differ")
    check("tp" in tp["execution"], f"no parameter ran as tp: "
                                   f"{tp['execution']}")
    check(tp["issued"].get("psum", 0) > 0,
          f"the tp step issued no all-reduce: {tp['issued']}")
    if not tiny:
        for r in ranks:
            t = r["tp"]
            check(t["launches"] == cfg.num_layers * MP_STEPS,
                  f"rank {r['rank']}: flash_attn_fwd launched "
                  f"{t['launches']} times, expected layers x steps = "
                  f"{cfg.num_layers * MP_STEPS}")
            check(all(tuple(map(tuple, s)) == tuple(map(tuple, local))
                      for s in t["shapes"]),
                  f"rank {r['rank']}: launches at {t['shapes']}, not the "
                  f"local-head shape {local}")
        log(f"  rank 0's step: the planner's HBM estimate "
            f"{tp['estimate'] / 2**30:.2f} GiB, measured peak over the "
            f"net and the one-rank step "
            f"{tp['peak'] / 2**30:.2f} GiB (max_memory_allocated)")

    pp = ranks[0]["pp"]
    log(f"== model parallel (c): pp = 2, M = {MP_PP_M}, 2 layers, "
        f"{MP_STEPS} SGD steps, {MP_PP_BATCH} x {seq}")
    for r in ranks:
        for sched in ("gpipe", "1f1b"):
            t = r["pp"][sched]
            log(f"  rank {r['rank']} {sched}: losses {t['losses']}; "
                f"{t['seconds']:.2f} s; flash_attn_fwd {t['launches']} "
                f"launches; collectives {t['issued']}")
    log(f"  [{where}] |diff| / |update| against the one-rank step: "
        f"GPipe {pp['gpipe']['ratio']:.3e}, 1F1B {pp['1f1b']['ratio']:.3e} "
        f"(bound {MP_PP_BOUND:g}); planted (1F1B, microbatches reversed in "
        f"the backward) {pp['fault']:.3e}")
    for sched in ("gpipe", "1f1b"):
        check(pp[sched]["ratio"] <= MP_PP_BOUND,
              f"pp = 2 {sched} off the one-rank step: "
              f"{pp[sched]['ratio']:.3e}")
        check(pp[sched]["issued"].get("send", 0) > 0,
              f"{sched}: no activation sent between the stages")
    check(pp["fault"] > MP_PP_BOUND,
          f"the pp check misses the reversed backward: {pp['fault']:.3e}")
    if not tiny:
        for r in ranks:
            for sched, per in (("gpipe", 1), ("1f1b", 2)):
                n = r["pp"][sched]["launches"]
                check(n == per * MP_PP_M * MP_STEPS,
                      f"rank {r['rank']} {sched}: flash_attn_fwd launched "
                      f"{n} times, expected {per * MP_PP_M * MP_STEPS}")

    sp = ranks[0]["sp"]
    shape = MP_TINY_SP if tiny else MP_SP_SHAPE
    log(f"== model parallel (d): sp = 2, (B, H, L, D) = {shape}, causal, "
        f"fp32 [{where}]")
    for r in ranks:
        s = r["sp"]
        log(f"  rank {r['rank']}: ring max|err| {s['ring']['err']:.3e} "
            f"({s['ring']['seconds']:.2f} s, {s['ring']['issued']}), "
            f"Ulysses {s['ulysses']['err']:.3e} "
            f"({s['ulysses']['seconds']:.2f} s, {s['ulysses']['issued']}); "
            f"planted source shard {s['fault']:.3e}")
        for which in ("ring", "ulysses"):
            check(s[which]["err"] <= MP_SP_BOUND,
                  f"rank {r['rank']}: {which} attention off the plain one: "
                  f"{s[which]['err']:.3e} > {MP_SP_BOUND:g}")
        check(s["fault"] > MP_SP_BOUND,
              f"the ring check misses the source-shard fault: "
              f"{s['fault']:.3e}")
    log(f"  the pair's phases (rank 0): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in
                    ranks[0]["phase_s"].items()))
    return {"mp_tp_llama": tp["launches"],
            "mp_pp_gpipe": pp["gpipe"]["launches"],
            "mp_pp_1f1b": pp["1f1b"]["launches"]}


def mp_two_rank_phase(seed, tiny=False, during=None):
    """Phase 16 (b)-(d): the pair started, ``during()`` run while it works,
    its readings checked.  Returns (flash_attn_fwd's launches by path,
    rank 0's readings)."""
    work = tempfile.mkdtemp(prefix="mxnet_mp_")
    try:
        t0 = time.time()
        procs = mp_start_ranks(seed, work, tiny)
        if during is not None:
            during()
        ranks = mp_finish_ranks(procs, work, t0)
        log(f"  the pair ran in {time.time() - t0:.1f} s (start-up "
            f"included)")
        cfg = _mp_cfg(tiny, 1)
        return mp_check_ranks(ranks, cfg, tiny), ranks[0]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def mp_nccl_checks(seed):
    """(a) world size 1 over a NCCL communicator: TrainStep(plan=) under
    each named rule set equal to the plain step bit for bit (the plain
    step run twice to show it repeats itself)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import TrainStep, planner

    cfg = _mp_cfg(False, 1)
    net = init_llama(cfg, seed, mx.gpu(0))
    ids, labels = llama_batch(seed, 1, MP_SEQ, cfg.vocab_size)
    x, y = torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda()
    sig = planner.signature_of(net)

    def run(plan=None):
        step = TrainStep(net, llama_loss, "sgd", MP_SGD, device="cuda",
                         plan=plan)
        losses = [step(x, y).item() for _ in range(MP_STEPS)]
        return losses, {k: v.detach().clone() for k, v in
                        step.params.items()}, step

    log(f"== model parallel (a): world size 1 over NCCL, TrainStep(plan=) "
        f"under {', '.join(MP_RULES)}, Llama-3-8B widths, 1 layer "
        f"[{gpu_line()}]")
    base = [run()[:2] for _ in range(2)]
    same = all(torch.equal(base[0][1][k], base[1][1][k]) for k in base[0][1])
    log(f"  the plain step repeats itself bit for bit: {same}")
    check(same and base[0][0] == base[1][0], "the plain step does not repeat")
    for rules in MP_RULES:
        plan = planner.plan_sharding(planner.PlannerConfig(
            mesh="auto", rules=rules), sig, 1)
        losses, params, step = run(plan)
        equal = losses == base[0][0] and all(
            torch.equal(params[k], base[0][1][k]) for k in params)
        log(f"  {rules}: mesh {dict(plan.axes)}, execution "
            f"{sorted(set(step.execution.values()))}, losses {losses}; "
            f"equal to the plain step bit for bit: {equal}")
        check(equal, f"TrainStep(plan={rules}) at world size 1 is not the "
                     f"plain step")
        del step, params
    del net, base
    torch.cuda.empty_cache()


def llama_signature(cfg):
    """The (name, shape, dtype) signature of LlamaForCausalLM(cfg), from
    the blocks' declared shapes (nothing allocated), in
    ``planner.signature_of``'s order."""
    from mxnet_tpu_torch.gluon.model_zoo.language import llama

    net = llama.LlamaForCausalLM(cfg)
    return tuple((name, tuple(p.shape), "float32")
                 for name, p in sorted(net.collect_params().items()))


def mp_planner_reading():
    """(e) the mesh the planner chooses for Llama-3-8B at full depth on
    MP_PLAN_DEVICES cards of this card's memory (Adam, ZeRO off,
    MP_PLAN_ROWS tokens a step), with its estimate."""
    from mxnet_tpu_torch.gluon.model_zoo.language import llama
    from mxnet_tpu_torch.parallel import planner

    sig = llama_signature(llama.LlamaConfig())
    cfg = planner.PlannerConfig(mesh="auto", rules="megatron+fsdp",
                                optimizer="adam", zero=False,
                                batch_rows=MP_PLAN_ROWS)
    plan = planner.plan_sharding(cfg, sig, MP_PLAN_DEVICES)
    log(f"== model parallel (e): the planner for Llama-3-8B (32 layers, "
        f"{sum(math.prod(s) for _, s, _ in sig) / 1e9:.3f} G parameters), "
        f"Adam, {MP_PLAN_ROWS} tokens a step, on {MP_PLAN_DEVICES} cards of "
        f"{cfg.hbm_gb:.1f} GiB [{gpu_line()}]: mesh {dict(plan.axes)} "
        f"({plan.chosen_by}); estimate {plan.hbm['total'] / 2**30:.2f} GiB "
        f"a card (params {plan.hbm['params'] / 2**30:.2f}, grads "
        f"{plan.hbm['grads'] / 2**30:.2f}, optimizer "
        f"{plan.hbm['optimizer'] / 2**30:.2f}, activations "
        f"{plan.hbm['activations'] / 2**30:.2f}); candidates "
        + ", ".join(f"{c['axes']}: {c['total'] / 2**30:.1f} GiB"
                    for c in plan.candidates[:4]))
    check(plan.hbm["feasible"], "the planner's mesh does not fit the card")
    return plan


def model_parallel_phase(seed):
    """Phase 16; returns flash_attn_fwd's launches by path."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    launches, _ = mp_two_rank_phase(seed, during=mp_planner_reading)
    t1 = time.perf_counter()
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    try:
        mp_nccl_checks(seed)
    finally:
        dist.destroy_process_group()
    log(f"  phase 16: the pair {t1 - t0:.1f} s, (a) "
        f"{time.perf_counter() - t1:.1f} s")
    return launches


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights, prompts and inputs")
    parser.add_argument("--fleet-replica", action="store_true",
                        help="serve the Llama-3-8B-width net from --seed "
                             "until SIGTERM: a child of phase 4c's process "
                             "fleet")
    parser.add_argument("--fleet-replica-log", metavar="PATH",
                        help="with --fleet-replica: where its stderr goes")
    parser.add_argument("--op-table", action="store_true",
                        help="run only the build and phase 8, the mx.nd "
                             "op table")
    parser.add_argument("--gluon-train", action="store_true",
                        help="run only the build and phase 9, the Gluon "
                             "training surface")
    parser.add_argument("--bert-step-seeds", type=int, nargs="+",
                        metavar="SEED",
                        help="run only the build and the BERT-base step "
                             "check (bert 2) once for each seed, and print "
                             "the bf16 step's readings (its spread over "
                             "seeds)")
    parser.add_argument("--gluon-bert-seeds", type=int, nargs="+",
                        metavar="SEED",
                        help="run only the build and the Gluon BERT step "
                             "check (gluon train 2) once for each seed, and "
                             "print its fp32, TF32 and bf16 readings (their "
                             "spread over seeds)")
    parser.add_argument("--persistence", action="store_true",
                        help="run only the build and phase 10, persistence "
                             "and preemption")
    parser.add_argument("--frontend", action="store_true",
                        help="run only the build and phase 11, the Gluon "
                             "frontend (hybridize() as CUDA graphs)")
    parser.add_argument("--data", action="store_true",
                        help="run only the build and phase 12, the data "
                             "path")
    parser.add_argument("--planes", action="store_true",
                        help="run only the build and phase 13, the runtime "
                             "planes (with the serving FLOP check at 2 "
                             "layers)")
    parser.add_argument("--symbolic", action="store_true",
                        help="run only the build and phase 14, the "
                             "symbolic half (export, SymbolBlock, Module, "
                             "test_utils)")
    parser.add_argument("--distributed", action="store_true",
                        help="run only the build and phase 15, data "
                             "parallelism across processes")
    parser.add_argument("--model-parallel", action="store_true",
                        help="run only the build and phase 16, the sharded "
                             "training step (tensor, pipeline, context and "
                             "expert parallelism, the planner)")
    parser.add_argument("--mp-rank", type=int, default=None,
                        help="a rank of phase 16's pair (0 or 1)")
    parser.add_argument("--mp-dir", metavar="PATH",
                        help="with --mp-rank: the shared work directory")
    parser.add_argument("--mp-tiny", action="store_true",
                        help="with --mp-rank: a tiny Llama on the CPU (the "
                             "CPU test of phase 16)")
    parser.add_argument("--dp-worker", action="store_true",
                        help="a rank of phase 15 (b): started by "
                             "tools/launch.py")
    parser.add_argument("--dp-dir", metavar="PATH",
                        help="with --dp-worker: the shared work directory")
    parser.add_argument("--dp-tiny", action="store_true",
                        help="with --dp-worker: a 2-layer BERT on the CPU "
                             "(the CPU test of phase 15)")
    parser.add_argument("--watchdog-worker", action="store_true",
                        help="run the BERT recipe with the stall watchdog "
                             "and arm its seam: a child of phase 13 (d)")
    parser.add_argument("--watchdog-dir", metavar="PATH")
    parser.add_argument("--nvcc-seconds", nargs="+", metavar="CU",
                        help="compile each .cu with the kernels' nvcc "
                             "flags, in turn, twice, and print the seconds "
                             "(a source's build time against another's)")
    parser.add_argument("--tune-replay", action="store_true",
                        help="launch the kernel at phase 13 (e)'s shapes "
                             "with the stored tuning winners and print the "
                             "tiles: a child of phase 13 (e)")
    parser.add_argument("--resume-worker", action="store_true",
                        help="run the fp16 BERT recipe under "
                             "run_with_recovery, a step a line to "
                             "--resume-log, checkpoints in --resume-dir: a "
                             "child of phase 10 (c)")
    parser.add_argument("--resume-dir", metavar="PATH")
    parser.add_argument("--resume-log", metavar="PATH")
    parser.add_argument("--resume-device", default="cuda")
    parser.add_argument("--resume-tiny", action="store_true",
                        help="with --resume-worker: the CPU tests' BERT")
    return parser.parse_args(argv)


def main():
    args = parse_args()
    if args.dp_worker and args.dp_tiny:
        return dp_worker_main(args)
    if args.mp_rank is not None and args.mp_tiny:
        return mp_worker_main(args)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.fleet_replica:
        return fleet_replica_main(args)
    if args.resume_worker:
        return resume_worker_main(args)
    if args.watchdog_worker:
        return watchdog_worker_main(args)
    if args.tune_replay:
        return tune_replay_main(args)
    if args.dp_worker:
        return dp_worker_main(args)
    if args.mp_rank is not None:
        return mp_worker_main(args)
    from mxnet_tpu_torch import _kernels

    if args.nvcc_seconds:
        with tempfile.TemporaryDirectory() as tmp:
            for rnd in (1, 2):
                for src in args.nvcc_seconds:
                    t0 = time.perf_counter()
                    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                                    "-o", os.path.join(tmp, "k.so"), src],
                                   check=True, capture_output=True)
                    log(f"  nvcc {src} (round {rnd}): "
                        f"{time.perf_counter() - t0:.2f} s")
        return 0

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

    if args.gluon_bert_seeds:
        from mxnet_tpu_torch.gluon.model_zoo.language import bert

        outs = {}
        for seed in args.gluon_bert_seeds:
            log(f"== gluon train 2 at seed {seed}")
            outs[seed] = bert_recipe_check(bert.BertConfig(dropout=0.0), seed,
                                           check_bounds=False, controls=True)
            torch.cuda.empty_cache()
        log(f"  [{gpu_line()}] the Gluon BERT step by seed, as ratios to "
            f"the CPU's deviation of the same precision (fp32: worst and "
            f"median tensor; TF32 planted: worst; bf16 and its planted "
            f"faults, fp16 in place of bf16, the updated weights kept in "
            f"bf16, AMP's fp32 list empty and the attention's scale off "
            f"by {BF16_SCALE_FAULT - 1:g}: worst / loss / median "
            f"tensor): " + ", ".join(
                f"{seed}: fp32 {o['fp32']:.3f} / {o['fp32 median']:.3f}, "
                f"tf32 {o['tf32']:.3f}, " + ", ".join(
                    f"{key} {r['worst']:.3f} / {r['loss']:.3f} / "
                    f"{r['median']:.3f}"
                    for key, r in o["bf16 readings"].items())
                for seed, o in outs.items()))
        spread = {key: [o["bf16 readings"][key]["worst"]
                        for o in outs.values()]
                  for key in ("bf16", "fp16", "master")}
        for key, vals in spread.items():
            log(f"  {key} worst: {min(vals):.3f}-{max(vals):.3f}")
        in_bf16 = {key: [o["bf16 readings"][key]["loss in bf16"]
                         for o in outs.values()]
                   for key in ("bf16", "fp32 list")}
        log(f"  losses that are bf16 numbers: bf16 {in_bf16['bf16']}, "
            f"fp32 list dropped {in_bf16['fp32 list']}; bound: worst "
            f"{GLUON_BF16_NOISE_FACTOR:g}")
        return 0 if max(spread["bf16"]) <= GLUON_BF16_NOISE_FACTOR \
            < min(spread["fp16"] + spread["master"]) \
            and not any(in_bf16["bf16"]) and all(in_bf16["fp32 list"]) \
            else 1

    if args.gluon_train:
        log("== the Gluon training surface (phase 9 alone)")
        n = gluon_train_phase(args.seed)
        check(n > 0, "flash_attn_fwd never ran on the gluon_bert_lamb path")
        log(f"== done in {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.persistence:
        log("== persistence and preemption (phase 10 alone)")
        n = persistence_phase(args.seed)
        check(n > 0, "flash_attn_fwd never ran on the gluon_bert_resume "
                     "path")
        log(f"== done in {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.data:
        log("== the data path (phase 12 alone)")
        n = data_phase(args.seed)
        check(n > 0, "flash_attn_fwd never ran on the "
                     "gluon_bert_dataloader path")
        log(f"== done in {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.planes:
        log("== the runtime planes (phase 13 alone)")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        check_tiles(gen, PLANES_TILE_CASES)
        log("== planes (b): serving FLOPs at Llama-3-8B widths, 2 layers")
        planes_serving(args.seed)
        torch.cuda.empty_cache()
        n, _ = planes_phase(args.seed, gen, tile_checks=False)
        check(n > 0, "flash_attn_fwd never ran on the gluon_bert_planes "
                     "path")
        log(f"== done in {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.symbolic:
        log("== the symbolic half (phase 14 alone)")
        n = symbolic_phase(args.seed)
        check(n > 0, "flash_attn_fwd never ran on the symbol_block_bert "
                     "path")
        log(f"== done in {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.distributed:
        log("== data parallelism across processes (phase 15 alone)")
        launches = distributed_phase(args.seed, float("nan"))
        for path, n in launches.items():
            check(n > 0, f"flash_attn_fwd never ran on the {path} path")
        log(f"== done in {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.model_parallel:
        log("== the sharded training step (phase 16 alone)")
        launches = model_parallel_phase(args.seed)
        for path, n in launches.items():
            check(n > 0, f"flash_attn_fwd never ran on the {path} path")
        log(f"== done in {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.frontend:
        log("== the Gluon frontend (phase 11 alone)")
        n = frontend_phase(args.seed)
        check(n > 0, "flash_attn_fwd never ran on the "
                     "gluon_bert_lamb_hybrid path")
        log(f"== done in {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.op_table:
        log("== the mx.nd op table (phase 8 alone)")
        n = op_table_phase(args.seed)
        check(n == 0, f"flash_attn_fwd launched {n} times on the op table")
        log(f"== done in {time.perf_counter() - t_all:.1f} s")
        return 0

    log("== kernels vs plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    row = kernel_phase(gen)
    log(f"  kernel phase took {time.perf_counter() - t0:.1f} s")
    report_children("the kernel phase")

    # the kernel's launches on each path, each counted from zero over the
    # path's run; this slice's main path is the serving fleet (4c)
    t0 = time.perf_counter()
    log("== serving: Llama-3-8B widths and depth (32 layers)")
    launches = serving_phase(args.seed)
    log("== serving 4c (3): a process fleet of two children at Llama-3-8B "
        "widths and depth")
    fleet_process_run(args.seed)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    log(f"  serving phase took {t1 - t0:.1f} s")
    report_children("the serving phase")

    log("== training: ResNet-50 v1 widths")
    resnet_img_s = training_phase(args.seed)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    log(f"  resnet phase took {t2 - t1:.1f} s")
    report_children("the resnet phase")

    log("== transformer training: BERT-base widths")
    launches["bert_train"], bert_samples_s = bert_phase(args.seed)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    log(f"  bert phase took {t3 - t2:.1f} s")
    report_children("the bert phase")

    log("== Llama training: Llama-3-8B widths")
    launches.update(llama_phase(args.seed))
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    log(f"  llama phase took {t4 - t3:.1f} s")
    report_children("the llama phase")

    log("== the mx.nd op table: every definition, the LSTM LM, the "
        "samplers, the detection chains")
    n_op_table = op_table_phase(args.seed)
    check(n_op_table == 0, f"flash_attn_fwd launched {n_op_table} times on "
                           f"the op table")
    t5 = time.perf_counter()
    log(f"  op table phase took {t5 - t4:.1f} s")
    report_children("the op table phase")

    log("== the Gluon training surface: every optimizer, GluonNLP's BERT "
        "and GluonCV's ResNet-50 recipes through gluon.Trainer")
    launches["gluon_bert_lamb"] = gluon_train_phase(args.seed,
                                                    bert_samples_s)
    torch.cuda.empty_cache()
    t6 = time.perf_counter()
    log(f"  gluon train phase took {t6 - t5:.1f} s")
    report_children("the gluon train phase")

    log("== persistence and preemption: nd.save/load on the card, the fp16 "
        "BERT-base recipe checkpointed, preempted and resumed, "
        "TrainStep.run, Estimator.fit")
    launches["gluon_bert_resume"] = persistence_phase(args.seed)
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    log(f"  persistence phase took {t7 - t6:.1f} s")
    report_children("the persistence phase")

    log("== the Gluon frontend: autograd.grad / Function / control flow, "
        "the vision zoo, gluon.rnn and the BERT recipe hybridized as CUDA "
        "graphs")
    launches["gluon_bert_lamb_hybrid"] = frontend_phase(args.seed)
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    log(f"  frontend phase took {t8 - t7:.1f} s")
    report_children("the frontend phase")

    log("== the data path: LibSVM -> CSR -> a factorization machine, "
        "RecordIO -> ImageRecordIter -> ResNet-50, DataLoader process "
        "workers -> the BERT-LAMB recipe")
    launches["gluon_bert_dataloader"] = data_phase(args.seed, resnet_img_s)
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    log(f"  data phase took {t9 - t8:.1f} s")
    report_children("the data phase")

    log("== the runtime planes: mx.profiler over torch.profiler, FLOPs and "
        "the MFU gauge, the guard, the watchdog, the tiles as tuning knobs, "
        "telemetry aggregation")
    launches["gluon_bert_planes"], tiles = planes_phase(args.seed, gen,
                                                        tile_checks=False)
    row.update(tiles)
    report_children("the planes phase")
    torch.cuda.empty_cache()
    t10 = time.perf_counter()

    log("== the symbolic half: BERT-base exported and imported through the "
        "kernel, ResNet-50 through mx.mod.Module, check_consistency")
    launches["symbol_block_bert"] = symbolic_phase(args.seed, resnet_img_s)
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    log(f"  symbolic phase took {t11 - t10:.1f} s")
    report_children("the symbolic phase")

    log("== data parallelism across processes: TrainStep(mesh=) and the "
        "KVStore over a one-rank NCCL group, two processes through "
        "tools/launch.py and dist_sync, the agreements")
    launches.update(distributed_phase(args.seed, bert_samples_s))
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    log(f"  distributed phase took {t12 - t11:.1f} s")
    report_children("the distributed phase")

    log("== the sharded training step: tensor, pipeline and context "
        "parallelism over a pair of ranks on the card, TrainStep(plan=) over "
        "a one-rank NCCL group, the planner")
    launches.update(model_parallel_phase(args.seed))
    torch.cuda.empty_cache()
    log(f"  model parallel phase took {time.perf_counter() - t12:.1f} s")
    report_children("the model parallel phase")
    for path, n in launches.items():
        check(n > 0, f"flash_attn_fwd never ran on the {path} path")
        row["by_path"][path]["launches"] = n
    # the op table path runs plain PyTorch and library calls only
    row["by_path"]["op_table"] = {
        "shape": "medium PTB LSTM LM: vocab 10000, 2 x 650, T 35, batch 20",
        "launches": n_op_table}
    row["launches"] = launches["serve_fleet"]

    left = stop_children()
    check(not left, f"processes that outlived SIGKILL: {left}")
    log(f"== done in {time.perf_counter() - t_all:.1f} s")
    print(gpu_line())
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    become_subreaper()
    try:
        rc = main()
    finally:
        stop_children(say=lambda m: print(m, file=sys.stderr, flush=True))
    sys.exit(rc)
