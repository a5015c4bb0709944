"""mx.sym.contrib: the contrib operators on the symbolic frontend
(counterpart of ``mxnet_tpu/symbol/contrib.py``).  Every registered
``_contrib_*`` op is exposed under its short name."""
from __future__ import annotations

import sys as _sys

from ..ops.registry import OP_TABLE
from .symbol import _make_symbol_function


def _bind_contrib_ops():
    mod = _sys.modules[__name__]
    for name, od in OP_TABLE.items():
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            if not hasattr(mod, short):
                setattr(mod, short, _make_symbol_function(od))


_bind_contrib_ops()
