"""Switch-style mixture of experts on one device (counterpart of
``mxnet_tpu/parallel/expert_parallel.py``).

Top-1 (switch) routing with capacity dropping, written as the reference
writes it: dense one-hot dispatch and combine tensors and plain products
(``torch.einsum`` / ``matmul``), so the shapes are static.  Tokens beyond
an expert's capacity get combine weight 0 (they pass through the
residual).

Expert parallelism (``mesh=``): every rank of the ``ep`` axis routes the
same tokens, computes only its own ``E / ep`` experts on their dispatched
slots, and the experts' outputs come back to every rank by an all-gather
over ``ep`` (what the reference's two sharding constraints make GSPMD
do).  The expert weights stay the whole stacked tree, as the reference
takes them; each rank reads its rows, and their gradient comes back whole
on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["moe_apply", "stack_expert_params", "inject_aux_loss"]


def _tree_map(fn, *trees):
    """``fn`` over the leaves of dict / list / tuple trees of one
    structure."""
    head = trees[0]
    if isinstance(head, dict):
        return type(head)((k, _tree_map(fn, *(t[k] for t in trees)))
                          for k in head)
    if isinstance(head, (list, tuple)):
        return type(head)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def stack_expert_params(per_expert):
    """[expert0_tree, ...] -> one tree whose leaves have a leading expert
    axis (what ``moe_apply`` takes)."""
    return _tree_map(lambda *xs: torch.stack(xs), *per_expert)


class _ExpertRows(torch.autograd.Function):
    """Rows ``[lo, hi)`` of a stacked expert leaf; the gradient comes back
    to the whole leaf on every ``ep`` rank (each rank's rows summed over
    ``ep``)."""

    @staticmethod
    def forward(ctx, leaf, lo, hi, mesh, axis, host):
        ctx.meta = (leaf.shape, lo, hi, mesh, axis, host)
        return leaf[lo:hi]

    @staticmethod
    def backward(ctx, g):
        from . import collectives

        shape, lo, hi, mesh, axis, host = ctx.meta
        full = torch.zeros(shape, dtype=g.dtype, device=g.device)
        full[lo:hi] = g
        return (collectives.psum(full, axis, mesh, host), None, None, None,
                None, None)


def moe_apply(expert_fn, expert_params, router_weight, x, mesh=None,
              axis="ep", capacity_factor=1.25):
    """Top-1 MoE layer.

    ``expert_fn(params_one_expert, tokens (C, d)) -> (C, d)``;
    ``expert_params``: a tree whose leaves are (E, ...); ``router_weight``
    (d, E); ``x`` (T, d).  Returns ``(out (T, d), aux)``: ``aux`` holds the
    load-balancing loss ``E * sum_e f_e * p_e`` (Switch Transformer eq. 4)
    in fp32, each expert's load and the number of dropped tokens, both
    int32.  Each expert's capacity is ``C = max(1, int(capacity_factor * T
    / E))``.  ``mesh``: the experts split over its ``axis`` (every rank
    passes the same tokens)."""
    T = x.shape[0]
    E = router_weight.shape[1]
    n = 1 if mesh is None else mesh.axis_size(axis)
    if E % n:
        raise MXNetError(f"num experts {E} not divisible by ep axis {n}")
    C = max(1, int(capacity_factor * T / E))

    gates = torch.softmax(x @ router_weight, dim=-1)          # (T, E)
    expert_idx = gates.argmax(dim=-1)                         # first max
    gate = gates.gather(1, expert_idx[:, None])[:, 0]
    # each token's position in its expert's queue, counted in int32: in
    # bf16, counts above 256 are not representable and positions collide
    sel_i = F.one_hot(expert_idx, E).to(torch.int32)          # (T, E)
    pos = torch.cumsum(sel_i, dim=0, dtype=torch.int32) * sel_i - 1
    keep = (pos >= 0) & (pos < C)
    slot = F.one_hot(pos.clamp(0, C - 1).long(), C).to(x.dtype)
    dispatch = sel_i.to(x.dtype)[:, :, None] * slot           # (T, E, C)
    dispatch = dispatch * keep.to(x.dtype)[:, :, None]
    combine = dispatch * gate[:, None, None]

    expert_in = torch.einsum("tec,td->ecd", dispatch, x)      # (E, C, d)
    lo, hi = 0, E
    if n > 1:
        from . import collectives

        host = collectives.needs_host(x)
        per = E // n
        lo = mesh.axis_index(axis) * per
        hi = lo + per
        expert_params = _tree_map(
            lambda leaf: _ExpertRows.apply(leaf, lo, hi, mesh, axis, host),
            expert_params)
    # one expert at a time: torch.func.vmap refuses the saved-tensor hooks
    # of a rematerialized (checkpointed) caller
    expert_out = torch.stack([
        expert_fn(_tree_map(lambda leaf, e=e: leaf[e], expert_params),
                  expert_in[lo + e]) for e in range(hi - lo)])
    if n > 1:
        from .tensor_parallel import _GatherFromTP

        # every rank's experts, back on every rank
        expert_out = _GatherFromTP.apply(expert_out, (mesh, axis, host), 0)
    out = torch.einsum("tec,ecd->td", combine, expert_out)

    # statistics in int32 / fp32: a bf16 one-hot summed over >256 tokens
    # saturates
    f = sel_i.float().mean(dim=0)                             # routed share
    p = gates.float().mean(dim=0)                             # mean gate
    aux = {"load_balance_loss": E * torch.sum(f * p),
           "expert_load": sel_i.sum(dim=0, dtype=torch.int32),
           "dropped": T - keep.sum(dtype=torch.int32)}
    return out, aux


class _InjectAuxLoss(torch.autograd.Function):
    """Identity on ``x``; the backward hands ``x`` its cotangent unchanged
    and the aux scalar a cotangent of 1, whatever the reduction downstream
    (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, aux_scalar):
        ctx.aux = (aux_scalar.shape, aux_scalar.dtype, aux_scalar.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.aux
        return g, torch.ones(shape, dtype=dtype, device=device)


def inject_aux_loss(x, aux_scalar):
    """Forward identity on ``x``; in the backward, ``aux_scalar`` gets its
    gradient as if it were added to the final scalar loss with weight 1.
    Lets a block deep in a network (an MoE router's load-balance term) add
    a loss term without threading it to the training loop.  Under
    ``TrainStep``, which minimises the mean of the loss, the term acts as
    if added to that mean."""
    return _InjectAuxLoss.apply(x, aux_scalar)
