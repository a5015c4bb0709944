"""Single operator table driving the ``mx.nd.*`` surface (counterpart of
``mxnet_tpu/ops/registry.py``).

Each op is one pure function on torch tensors: positional tensor inputs,
static attributes as keywords.  Shape and dtype inference is the function
itself and FGradient is torch autograd, so the table has no gradient
entries; ``differentiable=False`` ops run with autograd off.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["OpDef", "register", "get_op", "list_ops", "OP_TABLE"]

OP_TABLE = {}


class OpDef:
    """One operator.

    fn : callable(*tensors, **attrs) -> tensor | tuple(tensors)
    nout : number of outputs (tuple length)
    creation : no tensor inputs (zeros, ones); the frontend passes the
        target ``device=`` and accepts ``ctx=``/``dtype=``
    differentiable : False -> never recorded for autograd
    """

    __slots__ = ("name", "fn", "nout", "creation", "differentiable",
                 "aliases")

    def __init__(self, name, fn, nout=1, creation=False, differentiable=True,
                 aliases=()):
        self.name = name
        self.fn = fn
        self.nout = nout
        self.creation = creation
        self.differentiable = differentiable
        self.aliases = aliases


def register(name=None, nout=1, creation=False, differentiable=True,
             aliases=()):
    """Decorator: register a pure function as an operator."""

    def _do(fn):
        opname = name or fn.__name__
        od = OpDef(opname, fn, nout=nout, creation=creation,
                   differentiable=differentiable, aliases=aliases)
        if opname in OP_TABLE:
            raise MXNetError(f"duplicate op registration: {opname}")
        OP_TABLE[opname] = od
        for a in aliases:
            OP_TABLE[a] = od
        return fn

    return _do


def get_op(name):
    od = OP_TABLE.get(name)
    if od is None:
        raise MXNetError(f"unknown operator {name!r}")
    return od


def list_ops():
    return sorted(OP_TABLE)
