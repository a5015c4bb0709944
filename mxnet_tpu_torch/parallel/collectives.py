"""Collectives over ``torch.distributed`` (counterpart of
``mxnet_tpu/parallel/collectives.py``).

The reference issues XLA collectives inside ``shard_map`` over a device
mesh.  The port runs one process per device, so each wrapper here is a
``torch.distributed`` call over the process group of a mesh axis
(:meth:`..mesh.Mesh.group`): NCCL for CUDA tensors, gloo for CPU
tensors.  A CUDA tensor on a group without NCCL raises, unless the caller
passes ``host=True`` (``reduce_scatter``, ``all_gather`` and the
``allreduce_hosts`` family): then a host copy is reduced over gloo and
the result comes back to the tensor's device.  The host-reduced stores
(``dist_sync``, two processes sharing a card) pass their
``_host_reduce``; this is the only place that makes that copy.

One issue site.  Every collective goes through :func:`_issue`, the
counterpart of the reference's ``_combine_with_seam``: it stamps the
flight recorder's ledger (so ``telemetry_agg``'s ledger skew and the
black-box blame see every collective), passes the
``collectives.allreduce`` fault seam (retried only in a single process:
a unilateral re-issue would desync the peers' collective order), and
counts the call per op (:func:`issued`, and the telemetry counter
``mxnet_collectives_issued_total``).  The equal-call-count contract of
the reference holds unchanged: every process issues the same collectives
in the same order, and no collective sits under a rank-conditional
branch.

Without a process group every wrapper is the identity of one process
(``all_gather`` stacks one row), as the reference's are on one device.
``shard_map``, ``place_global`` and ``fetch_global`` have no counterpart:
in a process-per-device design there is no global array to place or
fetch; a rank's view of a value spread over the ranks is
:func:`all_gather`.  ``psum``'s gradient is ``psum`` of the gradient, as
under the reference's ``shard_map``, so a sum inside a recorded forward
(``TrainStep(mesh=)``'s BatchNorm moments) back-propagates to every rank.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

from .. import fault
from .. import flight_recorder as _flight
from .. import telemetry as _telemetry
from ..base import MXNetError

__all__ = ["psum", "pmean", "all_gather", "reduce_scatter", "ppermute",
           "all_to_all", "allreduce_hosts", "allreduce_hosts_quantized",
           "allreduce_hosts_quantized_multi", "allreduce_any", "barrier",
           "issued", "reset_issued", "world_size", "rank"]

_ISSUED_TOTAL = _telemetry.counter(
    "mxnet_collectives_issued_total",
    "collectives issued through the one issue site, by op",
    labelnames=("op",))
_ISSUED = {}
_LOCK = threading.Lock()


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_size():
    """Processes in the default group (1 without a process group)."""
    d = _dist()
    return d.get_world_size() if d is not None else 1


def rank():
    """This process's rank in the default group (0 without one)."""
    d = _dist()
    return d.get_rank() if d is not None else 0


def issued():
    """``{op: count}`` of the collectives issued since the last
    :func:`reset_issued`."""
    with _LOCK:
        return dict(_ISSUED)


def reset_issued():
    with _LOCK:
        _ISSUED.clear()


def _issue(op, lead, fn, axis=None, generation=None):
    """THE issue site: ledger stamp, fault seam, count, then ``fn()``."""
    with _flight.collective(op, shape=getattr(lead, "shape", None),
                            dtype=getattr(lead, "dtype", None),
                            axis=axis, generation=generation):
        if world_size() == 1:
            out = fault.call_with_retries("collectives.allreduce", fn)
        else:
            fault.check("collectives.allreduce")
            out = fn()
    with _LOCK:
        _ISSUED[op] = _ISSUED.get(op, 0) + 1
    _ISSUED_TOTAL.labels(op=op).inc()
    return out


def _resolve(axis_name, mesh):
    """(group, size, axis label) of a mesh axis; ``None``/``"world"`` is
    the default group."""
    if axis_name in (None, "world"):
        return None, world_size(), "world"
    from .mesh import get_default_mesh

    mesh = mesh if mesh is not None else get_default_mesh()
    return mesh.group(axis_name), mesh.axis_size(axis_name), \
        str(axis_name)


def _check(t, group, host):
    """Raise unless the group's backend takes ``t`` (its host copy under
    ``host``): NCCL for a CUDA tensor, gloo for a CPU one."""
    backend = str(_dist().get_backend(group))
    if t.is_cuda and not host:
        if "nccl" not in backend:
            raise MXNetError(
                "a CUDA tensor on a group without NCCL: init the process "
                "group with backend 'cpu:gloo,cuda:nccl', or reduce through "
                "a host-reduced store (kvstore 'dist_sync')")
    elif "gloo" not in backend:
        raise MXNetError("a CPU tensor on a group without gloo: init the "
                         "process group with backend 'cpu:gloo,cuda:nccl'")


def _staged(t, group, host=False):
    """A copy of ``t`` that the group's backend takes: on the host under
    ``host``, else on ``t``'s device."""
    _check(t, group, host)
    return t.detach().cpu() if host and t.is_cuda else t.detach().clone()


def _allreduce_raw(t, group, op="sum", inplace=False, host=False):
    """The all-reduce of ``t`` (a new tensor; ``inplace``: into ``t``
    itself where the backend takes it as it is)."""
    if inplace and t.is_contiguous() and not (host and t.is_cuda):
        _check(t, group, host)
        buf = t
    else:
        buf = _staged(t, group, host)
    red = {"sum": _dist().ReduceOp.SUM, "max": _dist().ReduceOp.MAX}[op]
    _dist().all_reduce(buf, op=red, group=group)
    if buf is t:
        return t
    if inplace:
        with torch.no_grad():
            return t.copy_(buf)
    return buf.to(t.device)


def _gather_raw(t, group, n, host=False):
    buf = _staged(t, group, host).contiguous()
    parts = [torch.empty_like(buf) for _ in range(n)]
    _dist().all_gather(parts, buf, group=group)
    return [p.to(t.device) for p in parts]


class _PSum(torch.autograd.Function):
    """psum whose gradient is psum of the gradient."""

    @staticmethod
    def forward(ctx, x, group, label):
        ctx.group, ctx.label = group, label
        return _issue("psum", x, lambda: _allreduce_raw(x, group),
                      axis=label)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return _issue("psum_grad", g,
                      lambda: _allreduce_raw(g, ctx.group),
                      axis=ctx.label), None, None


def psum(x, axis_name="dp", mesh=None):
    """Sum of ``x`` over the ranks of ``axis_name``."""
    if _dist() is None:
        return x
    group, _, label = _resolve(axis_name, mesh)
    if x.requires_grad and torch.is_grad_enabled():
        return _PSum.apply(x, group, label)
    return _issue("psum", x, lambda: _allreduce_raw(x, group), axis=label)


def psum_(x, axis_name="dp", mesh=None):
    """:func:`psum` into ``x`` itself (no gradient): the data-parallel
    step's flat gradient buckets, which it owns."""
    if _dist() is None:
        return x
    group, _, label = _resolve(axis_name, mesh)
    return _issue("psum", x, lambda: _allreduce_raw(x, group, inplace=True),
                  axis=label)


def pmean(x, axis_name="dp", mesh=None):
    if _dist() is None:
        return x
    _, n, _ = _resolve(axis_name, mesh)
    return psum(x, axis_name, mesh) / n


def all_gather(x, axis_name="dp", axis=0, tiled=True, mesh=None,
               host=False):
    """Every rank's ``x`` along ``axis``: concatenated (``tiled``) or
    stacked on a new axis.  ``host``: gathered through a host copy."""
    if _dist() is None:
        return x if tiled else x.unsqueeze(axis)
    group, n, label = _resolve(axis_name, mesh)
    parts = _issue("all_gather", x, lambda: _gather_raw(x, group, n, host),
                   axis=label)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)


def reduce_scatter(x, axis_name="dp", scatter_dimension=0, mesh=None,
                   host=False):
    """The sum over the ranks of ``axis_name``, split into equal tiles
    along ``scatter_dimension``: this rank keeps its tile.  ``host``:
    reduced through a host copy, the tile returned on ``x``'s device."""
    if _dist() is None:
        return x
    group, n, label = _resolve(axis_name, mesh)
    if x.shape[scatter_dimension] % n:
        raise MXNetError(f"reduce_scatter: dim {scatter_dimension} of "
                         f"{tuple(x.shape)} not divisible by {n}")
    from .mesh import get_default_mesh

    idx = (mesh or get_default_mesh()).axis_index(label) \
        if label != "world" else rank()

    def run():
        xm = x.movedim(scatter_dimension, 0).contiguous()
        if xm.is_cuda and not host:
            _check(xm, group, host)
            out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                              dtype=xm.dtype, device=xm.device)
            _dist().reduce_scatter_tensor(out, xm, group=group)
        else:
            buf = _staged(xm, group, host)
            _dist().all_reduce(buf, group=group)
            out = buf.chunk(n, 0)[idx].to(x.device, copy=True)
        return out.movedim(0, scatter_dimension)

    return _issue("reduce_scatter", x, run, axis=label)


def ppermute(x, perm, axis_name="sp", mesh=None):
    """Send ``x`` along the ``(source, destination)`` pairs of ``perm``
    (indices along ``axis_name``); a rank no pair sends to gets zeros, as
    in the reference."""
    if _dist() is None:
        src = {d: s for s, d in perm}
        return x.clone() if src.get(0) == 0 else torch.zeros_like(x)
    group, _, label = _resolve(axis_name, mesh)
    from .mesh import get_default_mesh

    m = mesh or get_default_mesh()
    ranks = m.axis_ranks(label) if label != "world" else \
        list(range(world_size()))
    me = ranks.index(rank())

    def run():
        dist = _dist()
        buf = _staged(x, group).contiguous()
        out = torch.zeros_like(buf)
        ops = []
        for s, d in perm:
            if s == me:
                ops.append(dist.P2POp(dist.isend, buf, ranks[d], group))
            if d == me:
                ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out.to(x.device)

    return _issue("ppermute", x, run, axis=label)


def all_to_all(x, axis_name="sp", split_axis=0, concat_axis=0, tiled=True,
               mesh=None):
    """Split ``x`` into one tile per rank along ``split_axis``, send tile
    j to rank j, and concatenate the received tiles along
    ``concat_axis`` (stacked on a new axis when not ``tiled``)."""
    if _dist() is None:
        return x if tiled else x.unsqueeze(concat_axis)
    group, n, label = _resolve(axis_name, mesh)

    def run():
        chunks = [c.contiguous() for c in x.chunk(n, split_axis)]
        stacked = _staged(torch.stack(chunks), group).contiguous()
        out = torch.empty_like(stacked)
        _dist().all_to_all_single(out, stacked, group=group)
        out = out.to(x.device)
        parts = list(out.unbind(0))
        return torch.cat(parts, concat_axis) if tiled else \
            torch.stack(parts, concat_axis)

    return _issue("all_to_all", x, run, axis=label)


# --------------------------------------------------------------------------
# host-value collectives over every process (the KVStore's and the
# agreements')
# --------------------------------------------------------------------------
def _as_tensor(value):
    if isinstance(value, torch.Tensor):
        return value, True
    return torch.as_tensor(_np.asarray(value)), False


def _back(t, was_tensor):
    return t if was_tensor else t.numpy()


def allreduce_hosts(value, _testing_force=False, op="allreduce",
                    host=False):
    """Sum ``value`` (a tensor or a numpy array) over every process; the
    result has its type, device and dtype.  The KVStore's reduction and
    the agreements' primitive.  ``host``: a CUDA tensor is summed through
    a host copy.  One process without ``_testing_force``: the value
    itself (seam-guarded)."""
    if _dist() is None:
        if not _testing_force:
            fault.guard("collectives.allreduce")
            return value
        t, was = _as_tensor(value)
        return _back(_issue(op, t, lambda: t.clone()), was)
    t, was = _as_tensor(value)
    return _back(_issue(op, t, lambda: _allreduce_raw(t, None, host=host),
                        axis="world"), was)


def allreduce_any(flag, _testing_force=False):
    """Logical OR of a host bool over every process in ONE collective:
    the agreement of ``lifecycle.check_stop`` and of the loss scaler."""
    if _dist() is None and not _testing_force:
        fault.guard("collectives.allreduce")
        return bool(flag)
    out = allreduce_hosts(torch.tensor([1.0 if flag else 0.0]),
                          _testing_force=_testing_force, op="allreduce_any")
    return bool(out.item() > 0)


def barrier():
    """Every process waits here for the others (a one-element all-reduce
    through the issue site; nothing without a process group)."""
    if _dist() is None:
        return
    t = torch.zeros(1)
    if not ("gloo" in str(_dist().get_backend(None))):
        t = t.cuda()
    _issue("barrier", t, lambda: _allreduce_raw(t, None), axis="world")


def _int8_quantize(v):
    """Per-tensor symmetric int8 quantization: (payload, fp32 scale)."""
    vf = v.float()
    scale = torch.clamp(vf.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(vf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _gather_rows(t, op, host):
    """(world, ...) stack of every process's ``t`` through the issue
    site."""
    if _dist() is None:
        return _issue(op, t, lambda: t.unsqueeze(0).clone())
    n = world_size()
    return torch.stack(_issue(op, t, lambda: _gather_raw(t, None, n, host),
                              axis="world"))


def allreduce_hosts_quantized(value, _testing_force=False, host=False):
    """Sum over processes of an int8 payload and its fp32 scale per
    process (~4x less traffic than fp32), dequantized and summed on
    receipt; the result keeps the input's dtype.  Error per contribution
    at most max|v| / 254."""
    if _dist() is None and not _testing_force:
        fault.guard("collectives.allreduce")
        return value
    q, scale = _int8_quantize(value)
    payload = torch.cat([q.reshape(-1).view(torch.uint8),
                         scale.reshape(1).view(torch.uint8)])
    rows = _gather_rows(payload, "allreduce_q8", host)
    n = q.numel()
    qs = rows[:, :n].view(torch.int8).float()
    ss = rows[:, n:].contiguous().view(torch.float32)
    out = (qs * ss).sum(0)
    return out.reshape(value.shape).to(value.dtype)


def allreduce_hosts_quantized_multi(values, _testing_force=False,
                                    host=False):
    """Several tensors in ONE int8 collective, each with its own scale,
    so a small gradient beside a large one keeps its resolution."""
    if _dist() is None and not _testing_force:
        fault.guard("collectives.allreduce")
        return list(values)
    qs, scales = zip(*[_int8_quantize(v.reshape(-1)) for v in values])
    sizes = [int(v.numel()) for v in values]
    payload = torch.cat([torch.cat(qs).view(torch.uint8),
                         torch.stack(scales).view(torch.uint8)])
    rows = _gather_rows(payload, "allreduce_q8_multi", host)
    total = sum(sizes)
    q_all = rows[:, :total].view(torch.int8).float()
    s_all = rows[:, total:].contiguous().view(torch.float32)
    reps = torch.repeat_interleave(
        s_all, torch.tensor(sizes, device=s_all.device), dim=1)
    summed = (q_all * reps).sum(0)
    out, off = [], 0
    for v, n in zip(values, sizes):
        out.append(summed[off:off + n].reshape(v.shape).to(v.dtype))
        off += n
    return out
