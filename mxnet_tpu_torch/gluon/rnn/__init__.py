"""Gluon recurrent layers and cells of the port (counterpart of
``mxnet_tpu/gluon/rnn``)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
from .rnn_cell import __all__ as _c
from .rnn_layer import __all__ as _l

__all__ = list(_c) + list(_l)
