"""``mx.nd.contrib``: every ``_contrib_*`` op of the table under its short
name (counterpart of ``mxnet_tpu/ndarray/contrib.py``).

The control-flow operators ``foreach``, ``while_loop`` and ``cond`` record
a whole loop as one autograd node through ``autograd.apply_fn``, which is
not ported yet: until then they raise.
"""
from __future__ import annotations

import sys as _sys

from ..base import MXNetError
from ..ops.registry import OP_TABLE
from . import _make_op_func

__all__ = ["foreach", "while_loop", "cond"]


def _waits(name):
    def fn(*args, **kwargs):
        raise MXNetError(f"nd.contrib.{name} is not ported yet: it waits "
                         f"for autograd.apply_fn (ROADMAP.md A4)")

    fn.__name__ = fn.__qualname__ = name
    return fn


foreach = _waits("foreach")
while_loop = _waits("while_loop")
cond = _waits("cond")

_mod = _sys.modules[__name__]
for _name, _od in OP_TABLE.items():
    if _name.startswith("_contrib_"):
        _short = _name[len("_contrib_"):]
        if not hasattr(_mod, _short):
            setattr(_mod, _short, _make_op_func(_name, _od))
