"""Nested lists and tuples of tensors as flat lists (a recurrent net's
states, a block's several inputs or outputs): used by
``parallel.functional.functionalize`` and the hybridize cache."""
from __future__ import annotations

import torch

from .ndarray.ndarray import NDArray

__all__ = ["flatten", "unflatten"]


def _walk(x, leaves):
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return "T"
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_walk(v, leaves) for v in x))
    return ("C", x)


def _build(spec, it, wrap):
    if spec == "T":
        return wrap(next(it))
    if spec[0] == "C":
        return spec[1]
    return spec[0](_build(s, it, wrap) for s in spec[1])


# module-level walkers, not recursive closures: a closure that calls itself
# is a reference cycle, which would keep the leaves (a recorded call's
# outputs, and with them its tape node) alive until the next collection


def flatten(tree):
    """(the tensors of ``tree`` in order, its structure) over nested lists
    and tuples; NDArrays count as their tensors."""
    leaves = []
    return leaves, _walk(tree, leaves)


def unflatten(spec, leaves, wrap=lambda t: t):
    """Rebuild a :func:`flatten` structure from ``leaves`` (each passed
    through ``wrap``)."""
    return _build(spec, iter(leaves), wrap)
