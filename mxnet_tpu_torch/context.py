"""Device resolution: the one place the port's default-device rule lives.

Every entry point (``LlamaForCausalLM``, the model factories, the serving
engine) takes ``device=None`` and resolves it here.  ``None`` means the
first CUDA card; on a machine without one that is an error, never a quiet
move to the CPU.  A caller that wants the CPU asks for it by name
(``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``None`` -> ``cuda:0`` (raises without a CUDA device); anything else
    -> ``torch.device(device)``, with a bare ``"cuda"`` pinned to index 0."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError("no CUDA device; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev
