"""Device contexts (counterpart of ``mxnet_tpu/context.py``): ``mx.cpu()``,
``mx.gpu(i)`` and ``current_context()`` over ``torch.device``, and the one
place the port's default-device rule lives.

Every entry point takes ``device=None`` / ``ctx=None`` and resolves it
here.  ``None`` means the first CUDA card (the default context is
``gpu(0)``); on a machine without one that is an error, never a quiet
move to the CPU.  A caller that wants the CPU asks for it by name
(``device="cpu"``, ``ctx=mx.cpu()``), as the tests do.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "resolve_device"]


class Context:
    """Device context: hashable, comparable; ``with ctx:`` makes it the
    default.  ``gpu`` contexts resolve to CUDA cards."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {v: k for k, v in devtype2str.items()}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in self.devstr2type:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_typeid = self.devstr2type[device_type]
        self.device_id = device_id
        self._old_ctx = None

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    @property
    def device(self):
        """The ``torch.device`` of this context (raises for a gpu context
        on a machine without a CUDA card)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.device_id))

    @classmethod
    def from_device(cls, device):
        device = torch.device(device)
        if device.type == "cpu":
            return cls("cpu", 0)
        return cls("gpu", device.index or 0)

    @classmethod
    def _current(cls):
        if not hasattr(cls._default_ctx, "value"):
            cls._default_ctx.value = Context("gpu", 0)
        return cls._default_ctx.value

    def __enter__(self):
        self._old_ctx = Context._current()
        Context._default_ctx.value = self
        return self

    def __exit__(self, *exc):
        Context._default_ctx.value = self._old_ctx
        return False

    def __eq__(self, other):
        return isinstance(other, Context) and \
            self.device_typeid == other.device_typeid and \
            self.device_id == other.device_id

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def current_context():
    """The default context: ``gpu(0)`` unless a ``with ctx:`` scope says
    otherwise."""
    return Context._current()


def resolve_device(device=None):
    """``None`` -> ``cuda:0`` (raises without a CUDA device); a Context ->
    its device; anything else -> ``torch.device(device)``, with a bare
    ``"cuda"`` pinned to index 0."""
    if isinstance(device, Context):
        return device.device
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError("no CUDA device; pass device='cpu' "
                             "(ctx=mx.cpu())")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev
