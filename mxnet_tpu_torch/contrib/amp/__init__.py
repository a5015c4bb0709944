"""AMP -- automatic mixed precision (counterpart of
``mxnet_tpu/contrib/amp``)."""
from .amp import init, disable, _cast_scope
from . import lists  # noqa: F401

__all__ = ["init", "disable"]
