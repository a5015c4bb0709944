"""Random state (counterpart of ``mxnet_tpu/random.py``): ``seed()`` and one
explicit ``torch.Generator`` per device.  The port's random draws (the
initializers) take their generator from :func:`generator`; nothing on the
path uses torch's global generator."""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]


class _RngState(threading.local):
    def __init__(self):
        self.seed = 0
        self.generators = {}     # torch.device -> torch.Generator


_S = _RngState()


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


def seed(seed_state, ctx="all"):
    """Seed the generator of ``ctx`` (a Context), or of every device with
    ``ctx="all"`` (reference: mx.random.seed)."""
    if ctx == "all":
        _S.seed = int(seed_state)
        _S.generators.clear()
        return
    generator(ctx.device).manual_seed(int(seed_state))


def generator(device):
    """The generator of ``device``, created from the current seed at first
    use."""
    key = _key(device)
    gen = _S.generators.get(key)
    if gen is None:
        gen = torch.Generator(device=key)
        gen.manual_seed(_S.seed)
        _S.generators[key] = gen
    return gen
