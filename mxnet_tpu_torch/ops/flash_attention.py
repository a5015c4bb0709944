"""Flash attention: the hand-written Hopper kernel and its plain version
(counterpart of ``mxnet_tpu/ops/flash_attention.py``).

Layout: (batch, heads, seq, head_dim); q heads may be a multiple of the
k/v heads (GQA).  Dispatch is by the tensors' device: a CPU tensor takes the
plain PyTorch version ``_mha_with_lse``; a CUDA tensor launches the kernel
(``csrc/flash_attn_fwd.cu``) or raises.  Every prefill length and every
supported head dim goes through the kernel on the card: the reference's
``_use_pallas`` gate is a TPU tiling rule and has no counterpart here.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _kernels
from ..base import MXNetError

__all__ = ["NEG_INF", "flash_attention"]

# masked scores; exp(NEG_INF - m) is exactly 0.0, so padded keys add exact
# zeros to the softmax sum (the paged KV cache relies on this)
NEG_INF = -1e30

KERNEL_HEAD_DIMS = (32, 64, 128, 256)


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
    """Plain version: (o in v's dtype, lse fp32 (B, H, Lq)).  fp32 scores,
    NEG_INF mask with the offset-aware causal diagonal, max-shift softmax,
    value product in the value dtype — as the reference computes it."""
    lq = q.shape[2]
    hq, hkv = q.shape[1], k.shape[1]
    if hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
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


def _flash_fwd_cuda(q, k, v, causal, sm_scale):
    """Launch ``csrc/flash_attn_fwd.cu`` on CUDA tensors: returns
    ``(o (B, Hq, Lq, D) in q.dtype, lse (B, Hq, Lq) fp32)``.  q/k/v may be
    any views the tensor maps take (see :func:`_kernel_strides`); ``o`` is
    the (B, Hq, Lq, D) view of a (B, Lq, Hq, D) tensor, so merging its
    heads back into the hidden dim is free.  Raises on anything the kernel
    does not take; never falls back."""
    _check_shapes(q, k, v, causal)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise MXNetError("the flash-attention kernel takes CUDA tensors on "
                         "one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"the flash-attention kernel takes float32 or "
                         f"bfloat16 q/k/v of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxt_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, hq, k.shape[1], lq, k.shape[2], d,
            int(bool(causal)), float(sm_scale),
            int(q.dtype == torch.bfloat16),
            (ctypes.c_longlong * 12)(*strides), stream)
    if err:
        raise MXNetError(f"flash_attn_fwd launch failed: CUDA error {err} "
                         f"({lib.mxt_cuda_error_string(err).decode()})")
    _flash_fwd_cuda.launches += 1
    _flash_fwd_cuda.launches_by_len[lq] = \
        _flash_fwd_cuda.launches_by_len.get(lq, 0) + 1
    return o, lse


# launches in all, and by query length (the prefill bucket on the serving
# path); a run sets both to zero before the part it counts
_flash_fwd_cuda.launches = 0
_flash_fwd_cuda.launches_by_len = {}


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Scaled dot-product attention, q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D)
    with Hq % Hkv == 0 (GQA).  Returns o (B, Hq, Lq, D)."""
    _check_shapes(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        # the projections' (B, L, H, D) outputs go in as transposed views
        return _flash_fwd_cuda(q, k, v, causal, sm_scale)[0]
    if q.device.type != "cpu":
        raise MXNetError(f"flash_attention runs on CUDA (kernel) or CPU "
                         f"(plain version), not {q.device}")
    return _mha_with_lse(q, k, v, causal, sm_scale)[0]
