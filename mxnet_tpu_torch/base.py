"""Base types of the PyTorch/CUDA port (counterpart of
``mxnet_tpu/base.py``): the error type, the name registry behind the
initializer and optimizer factories, and the dtype names the frontend
accepts."""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["MXNetError", "Registry", "numeric_types", "torch_dtype",
           "dtype_name"]

numeric_types = (float, int, _np.generic)


class MXNetError(Exception):
    """Error raised by the port's operators, models and serving engine."""


class Registry:
    """Case-insensitive name -> factory registry with aliases."""

    def __init__(self, name):
        self.name = name
        self._fmap = {}

    def register(self, obj=None, name=None, aliases=()):
        def _do(o):
            self._fmap[(name or o.__name__).lower()] = o
            for a in aliases:
                self._fmap[a.lower()] = o
            return o

        return _do if obj is None else _do(obj)

    def create(self, key, *args, **kwargs):
        k = key.lower()
        if k not in self._fmap:
            raise MXNetError(f"{self.name} registry: unknown entry {key!r}. "
                             f"Known: {sorted(self._fmap)}")
        return self._fmap[k](*args, **kwargs)


def torch_dtype(dtype):
    """The torch dtype of an MXNet dtype spelling: a numpy dtype or type,
    its name, "bfloat16", or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(_np.zeros(0, _np.dtype(dtype))).dtype


def dtype_name(dtype):
    """The MXNet spelling of a torch dtype: the numpy dtype, or the string
    "bfloat16", which numpy has no type for."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return torch.empty(0, dtype=dtype).numpy().dtype
