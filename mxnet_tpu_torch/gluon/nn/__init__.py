"""Gluon layers of the port (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .activations import __all__ as _a
from .basic_layers import __all__ as _b
from .conv_layers import __all__ as _c

__all__ = list(_b) + list(_c) + list(_a)
