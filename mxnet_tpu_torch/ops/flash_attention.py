"""Flash attention: the hand-written Hopper kernel, its plain version and
the blockwise backward (counterpart of ``mxnet_tpu/ops/flash_attention.py``).

Layout: (batch, heads, seq, head_dim); q heads may be a multiple of the
k/v heads (GQA).  Dispatch is by the tensors' device: a CPU tensor takes the
plain PyTorch version ``_mha_with_lse``; a CUDA tensor launches the kernel
(``csrc/flash_attn_fwd.cu``) or raises.  Every prefill length and every
supported head dim goes through the kernel on the card: the reference's
``_use_pallas`` gate is a TPU tiling rule and has no counterpart here.

Gradients: under autograd the forward goes through ``_FlashAttention``,
which saves q, k, v, o and lse, and whose backward is the port of the
reference's ``_fa_backward_blockwise`` (PyTorch products per key block,
recomputing the probabilities from lse; no forward runs again).  The
reference repeats k/v for GQA outside its ``custom_vjp``; the kernel reads
the kv heads natively, so the backward folds the per-q-head dk/dv back onto
the kv heads itself.  With grad off (serving) the output has no graph,
so nothing stays saved.

Tiles: the 16-bit kernel is built at several (query, key) tiles for D = 64
and 128 (``KERNEL_TILES``); each call resolves its tile through the tuning
funnel (``flash_block_q`` / ``flash_block_kv``), as the reference resolves
its Pallas block sizes.  FLOPs: the op runs outside a FLOP count
(``introspection.counting``) and reports its forward's and backward's
FLOPs to it itself.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from .. import _kernels
from .. import introspection
from ..base import MXNetError
from .registry import register

__all__ = ["NEG_INF", "flash_attention"]

# masked scores; exp(NEG_INF - m) is exactly 0.0, so padded keys add exact
# zeros to the softmax sum (the paged KV cache relies on this)
NEG_INF = -1e30

KERNEL_HEAD_DIMS = (32, 64, 128, 256)
# the 16-bit kernel's tile instances (query rows, keys) by head dim, the
# default first (csrc/flash_attn_fwd.cu's Tile); the fp32 kernel has one
KERNEL_TILES = {32: ((128, 128),),
                64: ((128, 128), (128, 64), (64, 128), (64, 64)),
                128: ((128, 128), (128, 64), (64, 128), (64, 64)),
                256: ((64, 64),)}
# the kernel's element types, by the code its C entry point takes
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_shapes(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention takes (B, H, L, D) tensors")
    b, hq, lq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise MXNetError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    hkv, lk = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise MXNetError(f"kv heads ({hkv}) must divide q heads ({hq})")
    if lq == 0 or lk == 0:
        raise MXNetError("flash_attention needs non-empty sequences")
    if causal and lq > lk:
        raise MXNetError(f"causal attention needs Lq <= Lk (got Lq={lq}, "
                         f"Lk={lk}): rows before the first key are fully "
                         "masked")


def _mha_with_lse(q, k, v, causal, sm_scale):
    """Plain version: (o in v's dtype, lse (B, H, Lq)).  fp32 scores,
    NEG_INF mask with the offset-aware causal diagonal, max-shift softmax,
    value product in the value dtype — as the reference computes it.  fp64
    inputs keep fp64 scores and lse (the reference has no fp64)."""
    lq = q.shape[2]
    hq, hkv = q.shape[1], k.shape[1]
    if hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    if causal:
        lk = k.shape[2]
        mask = torch.ones(lq, lk, dtype=torch.bool,
                          device=q.device).tril(diagonal=lk - lq)
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    lse = (m + torch.log(denom))[..., 0]
    return o, lse


def _kernel_strides(name, t):
    """Element strides (batch, head, seq) of a (B, H, L, D) tensor as the
    kernel takes them: its tensor maps (TMA) need a dense head dim, a
    16-byte aligned base and the other strides positive multiples of 16
    bytes.  Raises :class:`MXNetError` otherwise; the caller copies
    nothing.  A size-1 dim's stride is never used to address, so one that
    TMA would refuse is replaced by the tensor's span."""
    shape, strides = t.shape, t.stride()
    align = 16 // t.element_size()          # elements in 16 bytes
    if t.data_ptr() % 16:
        raise MXNetError(f"the flash-attention kernel takes 16-byte aligned "
                         f"tensors ({name} is at {t.data_ptr():#x})")
    if shape[3] > 1 and strides[3] != 1:
        raise MXNetError(f"the flash-attention kernel takes a dense head "
                         f"dim ({name} has stride {strides[3]})")
    out = list(strides[:3])
    for i in range(3):
        if out[i] > 0 and out[i] % align == 0:
            continue
        if shape[i] > 1:
            raise MXNetError(f"the flash-attention kernel takes strides "
                             f"that are positive multiples of 16 bytes "
                             f"({name} has strides {tuple(strides)})")
        span = max(n * st for n, st in zip(shape, strides))
        out[i] = -(-span // align) * align
    return out


def tile_signature(q, k, causal):
    """The tuning signature of a call: its shapes, dtype and mask (a
    winner stored under it steers this shape alone; ``tuning``'s global
    fallback steers the rest)."""
    return ("flash_attn_fwd", tuple(q.shape), tuple(k.shape), str(q.dtype),
            bool(causal))


def _fa_block_sizes(q, k, causal):
    """The 16-bit kernel's (query, key) tile for this call, resolved through
    the tuning funnel as the reference's ``_fa_block_sizes`` does
    (``flash_block_q`` / ``flash_block_kv``: a search trial > the
    ``MXNET_FLASH_BLOCK_Q`` / ``_KV`` pins > ``MXNET_TUNE=1`` winners
    stored for this call's signature > the default).  A knob left at its
    default gives the head dim's own tile; a pinned pair the head dim is
    not built at raises, naming the tiles it has; a stored winner it is
    not built at (another shape's global winner) is ignored."""
    from .. import tuning as _tuning

    d = q.shape[3]
    tiles = KERNEL_TILES[d]
    sig = tile_signature(q, k, causal)
    bq, src_q = _tuning.resolve_info("flash_block_q", signature=sig)
    bk, src_k = _tuning.resolve_info("flash_block_kv", signature=sig)
    dq, dk = tiles[0]
    pair = (int(bq) if src_q != "default" else dq,
            int(bk) if src_k != "default" else dk)
    if pair in tiles:
        return pair
    if "tuned" in (src_q, src_k) and src_q in ("tuned", "default") and \
            src_k in ("tuned", "default"):
        return tiles[0]
    raise MXNetError(
        f"flash_attn_fwd: tile {pair[0]} x {pair[1]} (flash_block_q from "
        f"{src_q}, flash_block_kv from {src_k}) is not built at head_dim "
        f"{d}; its tiles (query rows x keys): "
        + ", ".join(f"{a} x {b}" for a, b in tiles))


def _flash_fwd_cuda(q, k, v, causal, sm_scale, tile=None):
    """Launch ``csrc/flash_attn_fwd.cu`` on CUDA tensors: returns
    ``(o (B, Hq, Lq, D) in q.dtype, lse (B, Hq, Lq) fp32)``.  q/k/v may be
    any views the tensor maps take (see :func:`_kernel_strides`); ``o`` is
    the (B, Hq, Lq, D) view of a (B, Lq, Hq, D) tensor, so merging its
    heads back into the hidden dim is free.  ``tile`` (query rows, keys) is
    one of ``KERNEL_TILES[D]`` (default: :func:`_fa_block_sizes`; the fp32
    kernel has one tile and ignores it).  Raises on anything the kernel
    does not take; never falls back."""
    _check_shapes(q, k, v, causal)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise MXNetError("the flash-attention kernel takes CUDA tensors on "
                         "one device")
    if q.dtype not in KERNEL_DTYPES or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"the flash-attention kernel takes float32, "
                         f"bfloat16 or float16 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, lq, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise MXNetError(f"the flash-attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    strides = [*_kernel_strides("q", q), *_kernel_strides("k", k),
               *_kernel_strides("v", v)]
    lib = _kernels.load("flash_attn_fwd")
    o = torch.empty((b, lq, hq, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides += _kernel_strides("o", o)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:
        tile = (0, 0)
    else:
        tile = _fa_block_sizes(q, k, causal) if tile is None else tuple(tile)
        if tile not in KERNEL_TILES[d]:
            raise MXNetError(
                f"flash_attn_fwd: tile {tile} is not built at head_dim {d} "
                f"(tiles: {KERNEL_TILES[d]})")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxt_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, hq, k.shape[1], lq, k.shape[2], d,
            int(bool(causal)), float(sm_scale),
            KERNEL_DTYPES[q.dtype],
            (ctypes.c_longlong * 12)(*strides), tile[0], tile[1], stream)
    if err:
        raise MXNetError(f"flash_attn_fwd launch failed: CUDA error {err} "
                         f"({lib.mxt_cuda_error_string(err).decode()})")
    with _COUNT_LOCK:
        _flash_fwd_cuda.launches += 1
        _flash_fwd_cuda.launches_by_len[lq] = \
            _flash_fwd_cuda.launches_by_len.get(lq, 0) + 1
        _flash_fwd_cuda.launches_by_tile[tile] = \
            _flash_fwd_cuda.launches_by_tile.get(tile, 0) + 1
    return o, lse


# launches in all, by query length (the prefill bucket on the serving
# path) and by tile ((0, 0): the fp32 kernel); a run sets them to zero
# before the part it counts.  Engine loops of several replicas launch from
# their own threads: the lock keeps the read-modify-write of the counts
# whole
_COUNT_LOCK = threading.Lock()
_flash_fwd_cuda.launches = 0
_flash_fwd_cuda.launches_by_len = {}
_flash_fwd_cuda.launches_by_tile = {}
_kernels.count_launches("flash_attn_fwd", _flash_fwd_cuda)


def _causal_mask(lq, lk, k0, bk, device):
    """(Lq, bk) bool: query i sees key k0 + j iff i + (Lk - Lq) >= k0 + j,
    the forward's offset-aware diagonal (decode-style Lq < Lk)."""
    q_pos = torch.arange(lq, device=device)[:, None]
    k_pos = k0 + torch.arange(bk, device=device)[None, :]
    return q_pos + (lk - lq) >= k_pos


def _fold_gqa(d, hkv):
    """Per-q-head gradients (B, Hq, L, D) summed onto their kv heads: q
    head h reads kv head h // (Hq / Hkv), so the fold is a reshape to
    (B, Hkv, Hq / Hkv, L, D) and a sum over the group."""
    b, hq, length, dim = d.shape
    if hq == hkv:
        return d
    return d.reshape(b, hkv, hq // hkv, length, dim).sum(dim=2)


def _fa_backward_blockwise(q, k, v, o, lse, g, causal, sm_scale,
                           block_k=512):
    """(dq, dk, dv) in the input dtypes: the port of the reference's
    ``_fa_backward_blockwise``.  ``delta = sum(o * g)``; per key block of
    up to ``block_k`` (the whole length when the block does not divide
    Lk), the probabilities are recomputed as ``exp(s - lse)`` under the
    causal mask, then dv, dp, ``ds = p * (dp - delta) * sm_scale``, dk,
    and dq accumulates.  Arithmetic in ``promote_types(q.dtype, fp32)``;
    only one block's (B, Hq, Lq, block_k) scores are live at a time.
    k/v arrive with Hkv heads and dk/dv leave with them (_fold_gqa)."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    rep = hq // hkv
    block_k = min(block_k, lk)
    if lk % block_k:
        block_k = lk
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, gf = q.to(acc), g.to(acc)
    delta = (o.to(acc) * gf).sum(dim=-1, keepdim=True)       # (b,h,lq,1)
    lse = lse.to(acc)[..., None]
    dq = torch.zeros(qf.shape, dtype=acc, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, lk, block_k):
        kb = k[:, :, k0:k0 + block_k].to(acc)
        vb = v[:, :, k0:k0 + block_k].to(acc)
        if rep > 1:
            kb = kb.repeat_interleave(rep, dim=1)
            vb = vb.repeat_interleave(rep, dim=1)
        s = torch.matmul(qf, kb.transpose(-1, -2)) * sm_scale
        if causal:
            s = s.masked_fill(~_causal_mask(lq, lk, k0, block_k, q.device),
                              NEG_INF)
        p = torch.exp(s - lse)                                # (b,h,q,bk)
        dvs.append(_fold_gqa(torch.matmul(p.transpose(-1, -2), gf), hkv))
        dp = torch.matmul(gf, vb.transpose(-1, -2))
        ds = p * (dp - delta) * sm_scale
        dks.append(_fold_gqa(torch.matmul(ds.transpose(-1, -2), qf), hkv))
        dq += torch.matmul(ds, kb)
    dk = dks[0] if len(dks) == 1 else torch.cat(dks, dim=2)
    dv = dvs[0] if len(dvs) == 1 else torch.cat(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_flops(q, k, backward=False):
    """The FLOPs this op reports to a running count
    (``introspection.counting``): 4·D per (query, key) pair and q head
    forward (QK^T and PV), 10·D backward (the score recompute, dV, dP, dK
    and dQ of ``_fa_backward_blockwise``), over all Lq × Lk pairs, causal
    or not (the library's SDPA formula)."""
    b, hq, lq, d = q.shape
    return (10.0 if backward else 4.0) * b * hq * lq * k.shape[2] * d


def _report(q, k, backward):
    """Hand the attention's FLOPs to a running count (the counter cannot
    see the kernel, a ctypes launch, and is kept off the plain version's
    and the backward's products, which this report covers)."""
    introspection.report_flops(attention_flops(q, k, backward),
                               key="attention")


class _FlashAttention(torch.autograd.Function):
    """Attention with the blockwise backward (the reference's
    ``custom_vjp``).  The forward by device: the kernel on CUDA tensors,
    the plain version on CPU tensors; anything else raises.  ``o`` is saved
    as the forward returned it (on the card a transposed view), with no
    copy.  Both directions run outside a FLOP count and report their
    FLOPs to it (:func:`attention_flops`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        with introspection.uncounted():
            if q.is_cuda:
                # the projections' (B, L, H, D) outputs go in as views
                o, lse = _flash_fwd_cuda(q, k, v, causal, sm_scale)
            elif q.device.type == "cpu":
                o, lse = _mha_with_lse(q, k, v, causal, sm_scale)
            else:
                raise MXNetError(f"flash_attention runs on CUDA (kernel) or "
                                 f"CPU (plain version), not {q.device}")
        if introspection.counting_active():
            _report(q, k, backward=False)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        with introspection.uncounted():
            dq, dk, dv = _fa_backward_blockwise(q, k, v, o, lse, g,
                                                ctx.causal, ctx.sm_scale)
        if introspection.counting_active():
            _report(q, k, backward=True)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Scaled dot-product attention, q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D)
    with Hq % Hkv == 0 (GQA).  Returns o (B, Hq, Lq, D), differentiable
    through ``_FlashAttention``.  Under ``torch.no_grad()``, or when no
    input requires grad, the output has no graph and what the forward
    saved is dropped at once."""
    _check_shapes(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))


@register("_contrib_flash_attention", aliases=("flash_attention",))
def flash_attention_op(q, k, v, causal=False, sm_scale=None):
    """The op-table entry Gluon blocks reach as ``F.flash_attention`` (in
    the AMP target list, so a bf16 step casts q/k/v to bf16)."""
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
