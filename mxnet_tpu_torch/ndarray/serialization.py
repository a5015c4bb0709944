"""NDArray save/load in the legacy ``.params`` TLV container (counterpart
of ``mxnet_tpu/ndarray/serialization.py``), byte for byte as the reference
writes it:

    uint64  kMXAPINDArrayListMagic = 0x112
    uint64  reserved = 0
    uint64  ndarray count N
    N x NDArray records:
        uint32  NDARRAY_V2_MAGIC = 0xF993FAC9
        uint32  reserved (stype = -1 dense)
        uint32  ndim
        uint32  shape[ndim]
        uint32  context.dev_type = 1, int32 context.dev_id = 0 (always the
                CPU, wherever the array lived)
        int32   type_flag (mshadow enum)
        raw     data bytes (C order)
    uint64  name count (N or 0)
    N x (uint64 len, bytes) names

bfloat16 travels as its raw 16-bit words (numpy has no bfloat16 of its
own): written from the tensor's int16 view and read back into one, so no
numpy bfloat16 type is ever needed.  A 0-d array keeps its shape ().
"""
from __future__ import annotations

import struct

import numpy as _np
import torch

from ..base import MXNetError
from ..context import current_context
from .ndarray import NDArray

__all__ = ["save", "load", "host_copies"]

_LIST_MAGIC = 0x112
_ND_MAGIC = 0xF993FAC9

# mshadow type flags (reference: mshadow/base.h TypeFlag)
_TYPE_FLAG = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
              torch.uint8: 3, torch.int32: 4, torch.int8: 5, torch.int64: 6,
              torch.bool: 7, torch.bfloat16: 12}
_FLAG_TYPE = {v: k for k, v in _TYPE_FLAG.items()}


def host_copies(tensors, clone_host=True):
    """CPU copies of ``tensors`` made in one pass: each CUDA tensor is
    copied into pinned host memory without blocking, and the card is
    synchronised once for them all (a read-back tensor by tensor would
    wait for each).  CPU tensors are cloned, or passed through with
    ``clone_host=False``."""
    out, cuda = [], False
    for t in tensors:
        t = t.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            cuda = True
        else:
            host = t.clone() if clone_host else t
        out.append(host)
    if cuda:
        torch.cuda.synchronize()
    return out


def _tensor(arr):
    if isinstance(arr, NDArray):
        return arr._data
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(_np.array(arr, order="C"))


def _record(t):
    """One NDArray record of the host tensor ``t``."""
    if t.dtype not in _TYPE_FLAG:
        raise MXNetError(f"unsupported dtype {t.dtype}")
    t = t.contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return b"".join((
        struct.pack("<II", _ND_MAGIC, 0xFFFFFFFF),
        struct.pack("<I", t.dim()),
        struct.pack(f"<{t.dim()}I", *t.shape),
        struct.pack("<Ii", 1, 0),                 # cpu context
        struct.pack("<i", _TYPE_FLAG[t.dtype]),
        raw.numpy().tobytes()))


def save(fname, data):
    """Save NDArrays (also torch tensors or numpy arrays): a dict
    {name: array}, a list, or one array, to a path or a binary file
    object.  Arrays on the card are copied to the host in one pass first
    (:func:`host_copies`)."""
    if isinstance(data, (NDArray, torch.Tensor, _np.ndarray)):
        names, arrays = [], [data]
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    elif isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    else:
        raise MXNetError(f"cannot save {type(data)}")
    tensors = host_copies([_tensor(a) for a in arrays], clone_host=False)
    if hasattr(fname, "write"):
        _write_list(fname, tensors, names)
        return
    with open(fname, "wb") as f:
        _write_list(f, tensors, names)


def _write_list(f, tensors, names):
    f.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(tensors)))
    for t in tensors:
        f.write(_record(t))
    f.write(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)


def _read(f, n):
    buf = f.read(n)
    if len(buf) != n:
        raise MXNetError(f"truncated .params file ({len(buf)} of {n} bytes)")
    return buf


def load(fname, ctx=None):
    """Load NDArrays saved by :func:`save` (or by the reference) onto
    ``ctx`` (default: the current context, the first CUDA card).  Returns
    a dict when the file names its arrays, else a list."""
    device = (ctx or current_context()).device
    with open(fname, "rb") as f:
        magic, _res, count = struct.unpack("<QQQ", _read(f, 24))
        if magic != _LIST_MAGIC:
            raise MXNetError(f"invalid .params file {fname} "
                             f"(magic {magic:#x})")
        arrays = []
        for _ in range(count):
            nd_magic, _stype = struct.unpack("<II", _read(f, 8))
            if nd_magic != _ND_MAGIC:
                raise MXNetError("corrupt NDArray record")
            (ndim,) = struct.unpack("<I", _read(f, 4))
            shape = struct.unpack(f"<{ndim}I", _read(f, 4 * ndim)) \
                if ndim else ()
            _read(f, 8)                                   # context
            (tflag,) = struct.unpack("<i", _read(f, 4))
            if tflag not in _FLAG_TYPE:
                raise MXNetError(f"unsupported type flag {tflag}")
            dtype = _FLAG_TYPE[tflag]
            raw = torch.int16 if dtype == torch.bfloat16 else dtype
            itemsize = torch.empty(0, dtype=raw).element_size()
            n = 1
            for s in shape:
                n *= s
            words = _np.frombuffer(
                _read(f, n * itemsize),
                dtype=torch.empty(0, dtype=raw).numpy().dtype)
            t = torch.from_numpy(words.copy()).reshape(shape)
            if dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            arrays.append(NDArray._wrap(t.to(device)))
        (n_names,) = struct.unpack("<Q", _read(f, 8))
        names = []
        for _ in range(n_names):
            (ln,) = struct.unpack("<Q", _read(f, 8))
            names.append(_read(f, ln).decode("utf-8"))
    if names:
        return dict(zip(names, arrays))
    return arrays
