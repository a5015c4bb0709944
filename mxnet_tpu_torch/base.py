"""Base error type of the PyTorch/CUDA port (counterpart of
``mxnet_tpu/base.py``'s ``MXNetError``)."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(Exception):
    """Error raised by the port's operators, models and serving engine."""
