"""LLM building-block ops (counterpart of ``mxnet_tpu/ops/attention_ops.py``
``rms_norm``/``rope``/``swiglu``): plain PyTorch, same numerics contract
(fp32 inside, the input dtype outside)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "swiglu"]


def rms_norm(x, gamma, eps=1e-6):
    """RMSNorm with fp32 accumulation; returns ``x.dtype``."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * gamma.float()).to(x.dtype)


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


def swiglu(gate, up):
    """SwiGLU gate: silu(gate) * up."""
    return F.silu(gate) * up
