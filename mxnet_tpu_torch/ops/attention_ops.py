"""LLM building-block ops (counterpart of ``mxnet_tpu/ops/attention_ops.py``
``rms_norm`` / ``rope`` / ``swiglu`` / ``moe_swiglu``), registered in the op
table so Gluon blocks reach them as ``F.rms_norm`` ... and ``nd.rms_norm``
... exist.  Plain PyTorch, with the reference's cast points: fp32 inside,
the input dtype outside.  None is on the AMP lists, so under a bf16
``TrainStep`` each runs in the dtype it receives."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["rms_norm", "rope", "swiglu", "moe_swiglu"]


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
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
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
