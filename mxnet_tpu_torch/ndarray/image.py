"""``mx.nd.image``: every ``image_*`` op of the table under its short name
(counterpart of ``mxnet_tpu/ndarray/image.py``)."""
from __future__ import annotations

import sys as _sys

from ..ops.registry import OP_TABLE
from . import _make_op_func

_mod = _sys.modules[__name__]
for _name in list(OP_TABLE):
    if _name.startswith("image_"):
        setattr(_mod, _name[len("image_"):],
                _make_op_func(_name, OP_TABLE[_name]))
