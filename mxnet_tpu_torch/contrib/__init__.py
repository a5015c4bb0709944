"""Contrib packages of the port (counterpart of
``mxnet_tpu/contrib/__init__.py``): ``amp``."""
from . import amp  # noqa: F401

__all__ = ["amp"]
