"""Transformer ops (counterpart of ``mxnet_tpu/ops/attention_ops.py``): the
interleaved-matmul attention ops of GluonNLP's BERT (``(L, B, 3 * H * D)``
projections, the reference's layout, through batched ``torch.matmul``) and
the LLM building blocks ``rms_norm`` / ``rope`` / ``swiglu`` /
``moe_swiglu``, registered in the op table so Gluon blocks reach them as
``F.rms_norm`` ... and ``nd.rms_norm`` ... exist.  Plain PyTorch; the
LLM blocks keep the reference's cast points (fp32 inside, the input dtype
outside).  None is on the AMP lists, so under a bf16 ``TrainStep`` each
runs in the dtype it receives."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["rms_norm", "rope", "swiglu", "moe_swiglu",
           "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
           "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt"]


# --------------------------------------------------------------------------
# interleaved-matmul attention: qkv (L, B, 3 * H * D) holds, for each head,
# its q, k and v rows side by side (kv: k and v)
# --------------------------------------------------------------------------
def _split_interleaved(qkv, heads, n):
    """The ``n`` parts of each head as (B * H, L, D) tensors."""
    L, B, E = qkv.shape
    d = E // (n * heads)
    x = qkv.reshape(L, B, heads, n, d)
    return [x[:, :, :, i, :].permute(1, 2, 0, 3).reshape(B * heads, L, d)
            for i in range(n)]


def _merge_heads(out, heads):
    """(B * H, L, D) -> (L, B, H * D)."""
    bh, L, d = out.shape
    return out.reshape(bh // heads, heads, L, d).permute(2, 0, 1, 3) \
        .reshape(L, bh // heads, heads * d)


@register("_contrib_interleaved_matmul_selfatt_qk",
          aliases=("interleaved_matmul_selfatt_qk",))
def interleaved_matmul_selfatt_qk(qkv, heads=1):
    """(L, B, 3HD) -> the scores (B * H, L, L), scaled by 1/sqrt(D)."""
    q, k, _ = _split_interleaved(qkv, heads, 3)
    return torch.matmul(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])


@register("_contrib_interleaved_matmul_selfatt_valatt",
          aliases=("interleaved_matmul_selfatt_valatt",))
def interleaved_matmul_selfatt_valatt(qkv, att, heads=1):
    """att (B * H, L, L) times the v of qkv -> (L, B, H * D)."""
    v = _split_interleaved(qkv, heads, 3)[2]
    return _merge_heads(torch.matmul(att, v), heads)


@register("_contrib_interleaved_matmul_encdec_qk",
          aliases=("interleaved_matmul_encdec_qk",))
def interleaved_matmul_encdec_qk(q, kv, heads=1):
    """q (Lq, B, HD) against the k of kv (Lk, B, 2HD) -> (B * H, Lq, Lk),
    scaled by 1/sqrt(D)."""
    Lq, B, E = q.shape
    d = E // heads
    qt = q.reshape(Lq, B, heads, d).permute(1, 2, 0, 3).reshape(
        B * heads, Lq, d)
    k = _split_interleaved(kv, heads, 2)[0]
    return torch.matmul(qt, k.transpose(1, 2)) / math.sqrt(d)


@register("_contrib_interleaved_matmul_encdec_valatt",
          aliases=("interleaved_matmul_encdec_valatt",))
def interleaved_matmul_encdec_valatt(kv, att, heads=1):
    """att (B * H, Lq, Lk) times the v of kv (Lk, B, 2HD) -> (Lq, B, HD)."""
    v = _split_interleaved(kv, heads, 2)[1]
    return _merge_heads(torch.matmul(att, v), heads)


@register("rms_norm")
def rms_norm(x, gamma, eps=1e-6):
    """RMSNorm with fp32 accumulation; returns ``x.dtype``."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * gamma.float()).to(x.dtype)


@register("rope")
def rope(x, positions=None, base=10000.0, scale=1.0):
    """Rotary position embedding over the last dim, half-split (Llama).

    ``x`` (B, H, L, D) with D even; ``positions`` None (arange), (L,) or
    (B, L).  cos/sin are computed in fp32 and cast to ``x.dtype``."""
    b, h, l, d = x.shape
    if positions is None:
        positions = torch.arange(l, device=x.device)
    positions = torch.as_tensor(positions, device=x.device).float() * scale
    half = d // 2
    # the frequencies rounded from fp64: fp32 pow differs by ulps between
    # the card and the CPU, and an angle of position 2047 multiplies that
    # into ~1e-4
    freqs = (base ** (-torch.arange(0, half, dtype=torch.float64,
                                    device=x.device) / half)).float()
    angles = positions[..., None] * freqs                  # (..., L, d/2)
    if angles.dim() == 2:        # (L, d/2): shared across batch and heads
        angles = angles[None, None]
    elif angles.dim() == 3:      # (B, L, d/2): per-batch, broadcast over heads
        angles = angles[:, None]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@register("swiglu")
def swiglu(gate, up):
    """SwiGLU gate: silu(gate) * up."""
    return F.silu(gate) * up


@register("_contrib_moe_swiglu", aliases=("moe_swiglu",))
def moe_swiglu(x, router_weight, gate_proj, up_proj, down_proj,
               capacity_factor=1.25, aux_loss_weight=0.0):
    """Switch-MoE SwiGLU FFN over stacked expert weights.

    x (B, L, H); router (H, E); gate/up (E, H, I); down (E, I, H).  With
    ``aux_loss_weight`` > 0 the load-balance loss times the weight rides
    the backward pass (``inject_aux_loss``)."""
    from ..parallel.expert_parallel import inject_aux_loss, moe_apply

    def expert_fn(p, toks):
        return (F.silu(toks @ p["g"]) * (toks @ p["u"])) @ p["d"]

    b, l, h = x.shape
    out, aux = moe_apply(
        expert_fn, {"g": gate_proj, "u": up_proj, "d": down_proj},
        router_weight, x.reshape(-1, h),
        capacity_factor=float(capacity_factor))
    out = out.reshape(b, l, h)
    aux_loss_weight = float(aux_loss_weight)
    if aux_loss_weight:
        out = inject_aux_loss(
            out, aux_loss_weight
            * aux["load_balance_loss"].to(out.dtype))
    return out
