"""Context (sequence) parallelism over the ``sp`` mesh axis (counterpart of
``mxnet_tpu/parallel/context_parallel.py``): ring attention and
DeepSpeed-Ulysses.

Each ``sp`` rank holds one contiguous shard of the sequence: rank i the
positions ``[i * L_local, (i + 1) * L_local)``.

- :func:`ring_attention`: the K/V shards rotate around the ``sp`` ring
  (``collectives.ppermute``, one hop a step, n steps) while each rank
  accumulates the online softmax of its own queries in fp32; the causal
  mask compares global positions.  The reference's jnp body, step for
  step.
- :func:`ulysses_attention`: an ``all_to_all`` regroups (heads-full,
  sequence-local) into (heads-local, sequence-full), the plain dense
  attention runs on the rank's heads (the reference calls its dense
  reference here, not its kernel), and a second ``all_to_all`` restores
  the layout.

``context_parallel_attention`` / ``ulysses_context_parallel_attention``
take the whole (B, H, L, D) tensors, as the reference's wrappers do, cut
this rank's shard, run the schedule and gather the whole output back.
Both are differentiable: the gradient of a ``ppermute`` is the reverse
``ppermute`` and that of an ``all_to_all`` the reverse ``all_to_all``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["ring_attention", "context_parallel_attention",
           "ulysses_attention", "ulysses_context_parallel_attention"]


def _mesh(mesh):
    from .mesh import get_default_mesh

    return mesh if mesh is not None else get_default_mesh()


class _PPermute(torch.autograd.Function):
    """``collectives.ppermute`` whose gradient is the reverse ppermute."""

    @staticmethod
    def forward(ctx, x, perm, axis, mesh, host):
        from . import collectives

        ctx.meta = (perm, axis, mesh, host)
        return collectives.ppermute(x, perm, axis, mesh, host)

    @staticmethod
    def backward(ctx, g):
        from . import collectives

        perm, axis, mesh, host = ctx.meta
        back = [(d, s) for s, d in perm]
        return (collectives.ppermute(g.contiguous(), back, axis, mesh, host),
                None, None, None, None)


class _AllToAll(torch.autograd.Function):
    """``collectives.all_to_all`` (tiled) whose gradient is the reverse
    all_to_all."""

    @staticmethod
    def forward(ctx, x, axis, split, concat, mesh, host):
        from . import collectives

        ctx.meta = (axis, split, concat, mesh, host)
        return collectives.all_to_all(x, axis, split, concat, True, mesh,
                                      host)

    @staticmethod
    def backward(ctx, g):
        from . import collectives

        axis, split, concat, mesh, host = ctx.meta
        return (collectives.all_to_all(g.contiguous(), axis, concat, split,
                                       True, mesh, host),
                None, None, None, None, None)


def _source(my, i, n):
    """The sequence shard whose K/V a rank holds at ring step ``i``."""
    return (my - i) % n


def ring_attention(q, k, v, axis_name="sp", causal=False, sm_scale=None,
                   mesh=None):
    """Blockwise attention with K/V ring rotation over ``axis_name``.

    q, k, v: (B, H, L_local, D), this rank's shard of the sequence (GQA:
    repeat the kv heads first).  Returns (B, H, L_local, D) in q's
    dtype."""
    from . import collectives

    mesh = _mesh(mesh)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n = mesh.axis_size(axis_name)
    my = mesh.axis_index(axis_name)
    b, h, lloc, d = q.shape
    host = collectives.needs_host(q)
    qf = q.float() * sm_scale
    q_pos = my * lloc + torch.arange(lloc, device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    m = torch.full((b, h, lloc), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lloc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, lloc, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        s = torch.matmul(qf, k_cur.float().transpose(-1, -2))
        if causal:
            k_pos = _source(my, i, n) * lloc + torch.arange(lloc,
                                                            device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v_cur.float())
        m = m_new
        if i < n - 1:
            # the last step's rotation would bring back the rank's own
            # shard, which nothing reads: the reference's scan issues it,
            # this loop does not
            k_cur = _PPermute.apply(k_cur, perm, axis_name, mesh, host)
            v_cur = _PPermute.apply(v_cur, perm, axis_name, mesh, host)
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).to(q.dtype)


def _shard_seq(t, mesh, axis_name):
    n = mesh.axis_size(axis_name)
    return t.chunk(n, 2)[mesh.axis_index(axis_name)].contiguous()


class _ShardSeq(torch.autograd.Function):
    """This rank's sequence shard of a whole tensor every rank holds; the
    gradient comes back whole on every rank (each rank's shard summed over
    the axis), as to the reference's replicated input."""

    @staticmethod
    def forward(ctx, t, axis, mesh, host):
        ctx.meta = (axis, mesh, host)
        return _shard_seq(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        from . import collectives

        axis, mesh, host = ctx.meta
        full = collectives.all_gather(g.contiguous(), axis, axis=2,
                                      mesh=mesh, host=host)
        return full, None, None, None


class _GatherSeq(torch.autograd.Function):
    """The whole sequence from every rank's shard; backward, this rank's
    shard of the gradient (each rank computes the same whole-sequence
    loss downstream)."""

    @staticmethod
    def forward(ctx, x, axis, mesh, host):
        from . import collectives

        ctx.meta = (axis, mesh)
        return collectives.all_gather(x, axis, axis=2, mesh=mesh, host=host)

    @staticmethod
    def backward(ctx, g):
        axis, mesh = ctx.meta
        return _shard_seq(g, mesh, axis), None, None, None


def context_parallel_attention(q, k, v, mesh, axis_name="sp", causal=False,
                               sm_scale=None):
    """Attention over the whole sequence with the sequence split over
    ``axis_name``: q/k/v are whole (B, H, L, D) tensors, each rank rings
    its shard and the whole output is gathered back on every rank."""
    from . import collectives

    host = collectives.needs_host(q)
    o = ring_attention(*(_ShardSeq.apply(t, axis_name, mesh, host)
                         for t in (q, k, v)),
                       axis_name=axis_name, causal=causal, sm_scale=sm_scale,
                       mesh=mesh)
    return _GatherSeq.apply(o, axis_name, mesh, host)


def ulysses_attention(q, k, v, axis_name="sp", causal=False, sm_scale=None,
                      mesh=None):
    """DeepSpeed-Ulysses sequence parallelism: all_to_all to (heads-local,
    sequence-full), the plain attention on the rank's heads, all_to_all
    back.  q, k, v: (B, H, L_local, D), this rank's shard; the head count
    must divide by the axis size (GQA: repeat the kv heads first).
    Returns (B, H, L_local, D)."""
    from ..ops.flash_attention import _mha_with_lse
    from . import collectives

    mesh = _mesh(mesh)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n = mesh.axis_size(axis_name)
    h = q.shape[1]
    if h % n:
        raise ValueError(f"ulysses_attention needs heads ({h}) divisible "
                         f"by the {axis_name!r} axis size ({n})")
    host = collectives.needs_host(q)

    def to_seq(x):     # (B, H, L/n, D) -> (B, H/n, L, D)
        return _AllToAll.apply(x.contiguous(), axis_name, 1, 2, mesh, host)

    def to_heads(x):   # (B, H/n, L, D) -> (B, H, L/n, D)
        return _AllToAll.apply(x.contiguous(), axis_name, 2, 1, mesh, host)

    o = _mha_with_lse(to_seq(q), to_seq(k), to_seq(v), causal, sm_scale)[0]
    return to_heads(o)


def ulysses_context_parallel_attention(q, k, v, mesh, axis_name="sp",
                                       causal=False, sm_scale=None):
    """The Ulysses analog of :func:`context_parallel_attention`."""
    from . import collectives

    host = collectives.needs_host(q)
    o = ulysses_attention(*(_ShardSeq.apply(t, axis_name, mesh, host)
                            for t in (q, k, v)),
                          axis_name=axis_name, causal=causal,
                          sm_scale=sm_scale, mesh=mesh)
    return _GatherSeq.apply(o, axis_name, mesh, host)
