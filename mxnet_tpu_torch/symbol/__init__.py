"""mx.sym: the symbolic frontend (counterpart of ``mxnet_tpu/symbol/``).

The op surface is generated from the same table that drives ``mx.nd.*``
(one op table, both frontends)."""
from __future__ import annotations

from .. import ops as _ops  # noqa: F401  (populates the table)
from .symbol import (Symbol, var, Variable, Group, load, load_json, constant,
                     evaluate, populate_namespace)

populate_namespace(globals())

from . import contrib  # noqa: E402,F401

zeros = globals().get("zeros")
ones = globals().get("ones")
