"""Arithmetic that must round the same on the card and the CPU."""
from __future__ import annotations

import torch

__all__ = ["div_scalar"]


def div_scalar(x, s):
    """``x / s`` for a Python number ``s``, correctly rounded on every
    device.  PyTorch's CUDA kernels divide by a Python scalar as a product
    with its reciprocal, an ulp off the CPU's quotient, and a floor or a
    round of the quotient (a pooling bin's edge, a nearest-neighbour
    index, a quantization step) then differs: 3 * (1 / 3) floors to 0."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)
