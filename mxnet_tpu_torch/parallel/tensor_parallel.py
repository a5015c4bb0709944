"""Megatron-style tensor parallelism (counterpart of
``mxnet_tpu/parallel/tensor_parallel.py``).

The spec builders are the reference's: parameters get
:class:`..mesh.PartitionSpec` annotations over the ``tp`` axis,

- **column-parallel** (q/k/v, gate/up projections, lm_head): weight
  ``(out, in)`` split on the out dim;
- **row-parallel** (o_proj, down_proj): weight split on the in dim;
- embeddings split the hidden dim; norms replicate.

The reference leaves the collectives to GSPMD.  The port runs them
itself: under :func:`tp_scope` (``TrainStep`` opens it when a plan's
Megatron specs run as tensor parallelism) a model that supports it
(``LlamaForCausalLM.tensor_parallel_specs``) calls Megatron's pair of
functions around its column- and row-parallel products, each rank holding
its own tile of every split weight:

- :func:`copy_to_tp` (identity forward, all-reduce of the gradient over
  ``tp``) where a replicated activation enters column-parallel products;
- :func:`reduce_from_tp` (all-reduce forward, identity backward) on the
  partial sums a row-parallel product leaves;
- :func:`gather_from_tp` (all-gather forward, this rank's slice of the
  gradient backward) on a hidden-split embedding's rows and on the
  vocabulary-split logits, which then meet the loss whole.

Outside the scope each of the three is the identity, so the same model
code runs on one device.  Every collective goes through
``collectives``.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from contextlib import contextmanager

import torch

from ..base import MXNetError

__all__ = ["specs_from_rules", "megatron_specs", "moe_expert_specs",
           "MEGATRON_RULES", "validate_specs", "tp_scope", "tp_size",
           "copy_to_tp", "reduce_from_tp", "gather_from_tp"]


def _P(*entries):
    from .mesh import PartitionSpec

    return PartitionSpec(*entries)


def _sizes(mesh):
    """Axis name -> size of a :class:`..mesh.Mesh` or a plain mapping."""
    shape = getattr(mesh, "shape", mesh)
    return dict(shape)


# (regex searched against the param name, spec template) — templates use the
# literal string "tp" where the tp axis goes (substituted with the actual
# axis name at build time); a template without "tp" pins the spec verbatim
# (e.g. (None,) force-replicates a matching param); position i applies to
# weight dim i
MEGATRON_RULES = (
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj|lm_head)_weight$",
     ("tp", None)),
    (r"(o_proj|down_proj)_weight$", (None, "tp")),
    (r"embed_tokens_weight$", (None, "tp")),
    # biases of column-parallel layers live on the sharded out dim
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj|lm_head)_bias$", ("tp",)),
)


def specs_from_rules(params, rules, mesh, axis="tp", default=None):
    """Build {name: PartitionSpec} from (regex, template) rules.

    ``params`` maps name -> anything with ``.shape``.  A rule only
    applies when the sharded dim is divisible by the axis size; otherwise
    the param falls back to ``default`` (replicated), the reference's
    warning-free degrade."""
    n = _sizes(mesh)[axis]
    compiled = [(re.compile(pat), tpl) for pat, tpl in rules]
    specs = OrderedDict()
    for name, v in params.items():
        spec = default if default is not None else _P()
        for pat, tpl in compiled:
            if pat.search(name):
                tpl_axes = tuple(axis if t == "tp" else t for t in tpl)
                if "tp" not in tpl:
                    # rule pins an explicit spec (e.g. force-replicate)
                    spec = _P(*tpl_axes)
                else:
                    sdim = tpl.index("tp")
                    # exact-rank match: a 3-D stacked-expert weight must
                    # not be captured by the 2-D dense rule
                    if len(v.shape) == len(tpl) and v.shape[sdim] % n == 0:
                        spec = _P(*tpl_axes)
                break
        specs[name] = spec
    return specs


def megatron_specs(params, mesh, axis="tp"):
    """Column/row-parallel specs for transformer params named with the
    q/k/v/o_proj, gate/up/down_proj, embed_tokens, lm_head convention
    (the model zoo's language models produce these names)."""
    if axis not in _sizes(mesh):
        raise MXNetError(f"mesh has no {axis!r} axis: {_sizes(mesh)}")
    return specs_from_rules(params, MEGATRON_RULES, mesh, axis=axis)


def moe_expert_specs(params, mesh, axis="ep"):
    """Expert-parallel specs for stacked-expert MoE weights (leading
    expert axis, e.g. LlamaMoEMLP's (E, H, I) tensors): shard the expert
    dim over ``axis``, replicate routers.  Merge on top of
    megatron_specs for combined tp+ep meshes."""
    if axis not in _sizes(mesh):
        raise MXNetError(f"mesh has no {axis!r} axis: {_sizes(mesh)}")
    n = _sizes(mesh)[axis]
    specs = OrderedDict()
    for name, v in params.items():
        if re.search(r"(gate_proj|up_proj|down_proj)_weight$", name) \
                and len(v.shape) == 3 and v.shape[0] % n == 0:
            specs[name] = _P(axis, None, None)
        elif re.search(r"router_weight$", name):
            specs[name] = _P()
    return specs


def validate_specs(params, specs, mesh):
    """Check every spec divides its param evenly; raise with the offending
    names."""
    sizes = _sizes(mesh)
    bad = []
    for name, spec in specs.items():
        v = params.get(name)
        if v is None:
            continue
        for d, ax in enumerate(tuple(spec)):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n = 1
            for a in axes:
                n *= sizes[a]
            if d >= len(v.shape) or v.shape[d] % n != 0:
                bad.append((name, tuple(v.shape), tuple(spec)))
    if bad:
        raise MXNetError(f"indivisible tensor-parallel specs: {bad}")
    return True


# --------------------------------------------------------------------------
# Megatron's functions, run by the model under tp_scope
# --------------------------------------------------------------------------
_SCOPE = threading.local()


@contextmanager
def tp_scope(mesh, axis="tp", host=False):
    """Run the model's tensor-parallel hooks over ``axis`` of ``mesh``
    (``host``: the collectives reduce through host copies)."""
    prev = getattr(_SCOPE, "cfg", None)
    _SCOPE.cfg = (mesh, axis, host)
    try:
        yield
    finally:
        _SCOPE.cfg = prev


def _cfg():
    return getattr(_SCOPE, "cfg", None)


def tp_size():
    """Ranks on the open scope's tensor-parallel axis (1 outside it)."""
    cfg = _cfg()
    return 1 if cfg is None else cfg[0].axis_size(cfg[1])


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg):
        ctx.cfg = cfg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from . import collectives

        mesh, axis, host = ctx.cfg
        return collectives.psum(g.contiguous(), axis, mesh, host), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg):
        from . import collectives

        mesh, axis, host = cfg
        return collectives.psum(x.contiguous(), axis, mesh, host)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, dim):
        from . import collectives

        mesh, axis, host = cfg
        ctx.cfg, ctx.dim = cfg, dim
        return collectives.all_gather(x.contiguous(), axis, axis=dim,
                                      mesh=mesh, host=host)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, _ = ctx.cfg
        n = mesh.axis_size(axis)
        return g.chunk(n, ctx.dim)[mesh.axis_index(axis)].contiguous(), \
            None, None


def copy_to_tp(x):
    """Identity forward; the gradient all-reduced over ``tp`` (a
    replicated activation entering column-parallel products)."""
    cfg = _cfg()
    return x if cfg is None else _CopyToTP.apply(x, cfg)


def reduce_from_tp(x):
    """The sum over ``tp`` of a row-parallel product's partial sums;
    identity backward."""
    cfg = _cfg()
    return x if cfg is None else _ReduceFromTP.apply(x, cfg)


def gather_from_tp(x, dim=-1):
    """Every ``tp`` rank's tile of ``x`` along ``dim``, concatenated;
    backward, this rank's slice of the gradient."""
    cfg = _cfg()
    if cfg is None:
        return x
    return _GatherFromTP.apply(x, cfg, dim % x.dim())
