"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``;
``download`` raises, as the reference's does."""
from __future__ import annotations

import hashlib
import math

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split a batch into ``num_slice`` slices along ``batch_axis``; the
    last takes the remainder unless ``even_split`` demands none."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data size {size} not divisible by {num_slice} slices")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data[begin:end] if batch_axis == 0 else
                      data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch and load each slice to one context (with one context,
    the whole batch on it)."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns that norm before the rescale, a float.  The norm
    is one multi-tensor reduction of the fp32 values, as the reference
    casts, and one read to the host; on the CPU it accumulates in fp64, as
    torch's fp32 sum there drifts by ~1e-3 over BERT's 23M-entry word
    embedding.  ``check_isfinite`` raises MXNetError on a non-finite norm
    (before any array changes)."""
    tensors = [a._data for a in arrays]
    acc = torch.float64 if tensors[0].device.type == "cpu" else None
    norms = torch._foreach_norm([t if t.dtype == torch.float32 else t.float()
                                 for t in tensors], 2, dtype=acc)
    total_norm = float(torch.linalg.vector_norm(torch.stack(norms)))
    if check_isfinite and not math.isfinite(total_norm):
        raise MXNetError(f"global norm is not finite ({total_norm})")
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            torch._foreach_mul_(tensors, scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 hex digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise MXNetError("download() requires network access, which this "
                     "environment does not have; place files locally instead")
