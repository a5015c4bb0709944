"""Switch-style mixture of experts on one device (counterpart of
``mxnet_tpu/parallel/expert_parallel.py``).

Top-1 (switch) routing with capacity dropping, written as the reference
writes it: dense one-hot dispatch and combine tensors and plain products
(``torch.einsum`` / ``matmul``), so the shapes are static.  Tokens beyond
an expert's capacity get combine weight 0 (they pass through the
residual).  Sharding the expert axis over a mesh (``mesh=``) waits for the
multi-GPU slice and raises here.
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


def moe_apply(expert_fn, expert_params, router_weight, x, mesh=None,
              capacity_factor=1.25):
    """Top-1 MoE layer.

    ``expert_fn(params_one_expert, tokens (C, d)) -> (C, d)``;
    ``expert_params``: a tree whose leaves are (E, ...); ``router_weight``
    (d, E); ``x`` (T, d).  Returns ``(out (T, d), aux)``: ``aux`` holds the
    load-balancing loss ``E * sum_e f_e * p_e`` (Switch Transformer eq. 4)
    in fp32, each expert's load and the number of dropped tokens, both
    int32.  Each expert's capacity is ``C = max(1, int(capacity_factor * T
    / E))``."""
    if mesh is not None:
        raise MXNetError("moe_apply over a mesh (expert parallelism) is not "
                         "ported yet; call it with mesh=None on one device")
    T = x.shape[0]
    E = router_weight.shape[1]
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
    # one expert at a time: torch.func.vmap refuses the saved-tensor hooks
    # of a rematerialized (checkpointed) caller
    expert_out = torch.stack([
        expert_fn(_tree_map(lambda leaf, e=e: leaf[e], expert_params),
                  expert_in[e]) for e in range(E)])
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
