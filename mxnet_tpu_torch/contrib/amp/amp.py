"""Automatic mixed precision (counterpart of
``mxnet_tpu/contrib/amp/amp.py``).

Every op call funnels through ``ndarray.invoke``, so one hook there applies
the cast policy of :mod:`.lists` at op level, by op name: a listed op's
float inputs are cast inside the call, so torch autograd casts the
gradients back to the fp32 master weights.  This is the reference's policy
op for op; ``torch.autocast`` is not used, because its op lists are not
these.  The loss scaler is not ported yet.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ...base import MXNetError, torch_dtype
from ...ndarray.ndarray import _AMP
from . import lists

__all__ = ["init", "disable"]

_DEFAULT_TARGET = "bfloat16"


def _make_wrap(target_dtype, target_ops, fp32_ops):
    tgt = torch_dtype(target_dtype)

    def wrap(od, fn):
        if od.name in target_ops:
            to = tgt
        elif od.name in fp32_ops:
            to = torch.float32
        else:
            return fn

        def cast_fn(*tensors):
            return fn(*(t.to(to) if t.is_floating_point() and t.dtype != to
                        else t for t in tensors))

        return cast_fn

    return wrap


def init(target_dtype=_DEFAULT_TARGET):
    """Enable AMP globally (reference: amp.init); target 'bfloat16' or
    'float16'."""
    if target_dtype not in ("bfloat16", "float16"):
        raise MXNetError(f"unsupported AMP target_dtype {target_dtype!r}")
    wrap = _make_wrap(target_dtype, frozenset(lists.TARGET_DTYPE_OPS),
                      frozenset(lists.FP32_OPS))
    _AMP.update(on=True, target=target_dtype, wrap=wrap)


def disable():
    """Turn AMP off."""
    _AMP.update(on=False, target=None, wrap=None)


@contextmanager
def _cast_scope(target_dtype=_DEFAULT_TARGET):
    """Scoped AMP: ``TrainStep(dtype=...)`` runs the model's forward under
    the policy without flipping global state for the caller."""
    prev = dict(_AMP)
    try:
        init(target_dtype)
        yield
    finally:
        _AMP.update(prev)
