"""Logical-axis rule engine: parameter names/shapes → PartitionSpecs
(counterpart of ``mxnet_tpu/parallel/planner/rules.py``).

The T5X shape (SNIPPETS.md [2]/[3]): sharding intent is declared twice,
once per *parameter family* (a name-regex rule assigns each weight dim a
**logical axis** — ``model``, ``embed``, ``vocab``, ``expert`` …) and
once per *deployment* (a **binding** maps logical axes to mesh axes —
``model → tp``, ``expert → ep`` …).  The same model rules therefore
serve every mesh: flip the binding and a column-parallel weight moves
from tp to replicated without touching model code.

Resolution order for one parameter (first hit wins):

1. **override** — exact-name entry in ``RuleSet.overrides`` (the escape
   hatch for the one weird tensor);
2. **name rule** — first ``(regex, template)`` whose pattern ``search``es
   the name.  A template whose logical axes all bind to ``None`` *pins*
   the spec verbatim (force-replicate), matching any rank; a template
   with bound axes applies only at the exact rank and when every bound
   dim divides evenly (GSPMD's requirement) — otherwise the parameter
   falls through replicated, the same warning-free degrade
   :func:`tensor_parallel.specs_from_rules` ships;
3. **shape heuristic** — when the spec is still fully replicated and the
   rule set names a ``heuristic_axis`` (the FSDP case, where intent is
   "shard *something*", not a specific dim): the first dim divisible by
   (and at least as large as) the axis size is sharded.  This reproduces
   :func:`data_parallel.fsdp_specs` bit-for-bit — the planner replacing
   the hand-wired layouts must not move a single byte.

Everything here is pure: specs come out as plain tuples of
axis-name-or-None (hashable, picklable, JSON-able) and are converted to
the port's :class:`..mesh.PartitionSpec` only at the plan boundary.
"""
from __future__ import annotations

import re
from collections import OrderedDict

from ...base import MXNetError

__all__ = ["RuleSet", "LLAMA_LOGICAL_RULES", "MEGATRON_BINDING",
           "named_rule_set", "resolve_specs", "spec_tuple"]

# Logical-axis rules for the model-zoo transformer naming convention
# (llama/bert produce `q_proj_weight`-style global names; serving params
# use `q_proj.weight` block paths — the separator class covers both).
# Dim order follows the weights: Dense stores (out, in).
LLAMA_LOGICAL_RULES = (
    # column-parallel: out dim carries heads/intermediate ("model")
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj|lm_head)[._]weight$",
     ("model", "embed")),
    # row-parallel: in dim carries the model-parallel partial sums
    (r"(o_proj|down_proj)[._]weight$", ("embed", "model")),
    # token embedding (vocab, hidden): shard the hidden dim
    (r"embed_tokens[._]weight$", ("vocab", "model")),
    # biases of column-parallel layers live on the sharded out dim
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj|lm_head)[._]bias$",
     ("model",)),
    # stacked-expert MoE weights (E, ...): shard the expert dim
    (r"(gate_proj|up_proj|down_proj)[._]weight$",
     ("expert", None, None)),
    (r"router[._]weight$", (None, None)),      # pinned: routers replicate
    # norms/scales replicate (pinned, any rank)
    (r"(norm|layernorm|ln)[0-9_.]*[._](weight|gamma|beta|bias)$",
     (None,)),
)

# the Megatron deployment of those rules: the model dim goes to tp,
# everything else replicates — exactly tensor_parallel.MEGATRON_RULES
MEGATRON_BINDING = {"model": "tp", "embed": None, "vocab": None,
                    "expert": "ep"}


class RuleSet:
    """One deployment's sharding policy: name rules + logical→mesh
    binding + optional shape heuristic + per-param overrides.

    ``rules``: ordered ``(regex, template)`` pairs; template entries are
    logical-axis names (strings) or ``None``.  ``binding``: logical name
    → mesh axis name (or None = replicate that logical axis).  A logical
    name absent from the binding binds to None.  ``heuristic_axis``:
    mesh axis for the first-divisible-dim fallback (FSDP), or None.
    ``overrides``: exact param name → template (same binding applies).
    """

    def __init__(self, rules=(), binding=None, heuristic_axis=None,
                 overrides=None, name="custom"):
        self.rules = tuple((pat, tuple(tpl)) for pat, tpl in rules)
        self.binding = dict(binding or {})
        self.heuristic_axis = heuristic_axis
        self.overrides = dict(overrides or {})
        self.name = name
        self._compiled = [(re.compile(pat), tpl)
                          for pat, tpl in self.rules]

    def key(self):
        """Hashable identity — part of the plan's determinism contract."""
        return (self.name, self.rules,
                tuple(sorted(self.binding.items(),
                             key=lambda kv: kv[0])),
                self.heuristic_axis,
                tuple(sorted((k, tuple(v))
                             for k, v in self.overrides.items())))

    def with_overrides(self, overrides):
        merged = dict(self.overrides)
        merged.update(overrides or {})
        return RuleSet(self.rules, self.binding, self.heuristic_axis,
                       merged, name=self.name)

    # -- resolution ---------------------------------------------------------
    def _apply_template(self, tpl, shape, axis_sizes):
        """Bound spec for one template at one shape, or None when the
        template does not apply here (rank mismatch / indivisible /
        every bound axis degenerated to size 1)."""
        bound = tuple(None if t is None else self.binding.get(t)
                      for t in tpl)
        if all(a is None for a in bound):
            # pinned replicate: applies at any rank (the force-replicate
            # semantics of tensor_parallel's no-"tp" templates) and is
            # FINAL — the heuristic never reshards a pinned parameter.
            # () is the canonical replicated form (== PartitionSpec()),
            # matching what the hand-wired builders emit
            return ()
        if len(tpl) != len(shape):
            return None       # exact-rank match only (3-D MoE vs 2-D)
        out = []
        for d, a in enumerate(bound):
            n = axis_sizes.get(a, 1) if a is not None else 1
            if n <= 1:
                # a bound axis of size 1 shards nothing: drop it so the
                # heuristic below can still claim the parameter (a
                # megatron+fsdp plan at tp=1 degrades to pure fsdp)
                out.append(None)
                continue
            if shape[d] % n != 0 or shape[d] < n:
                return None   # indivisible: warning-free replicated fall
            out.append(a)
        if all(a is None for a in out):
            return None       # vacuous at this mesh: fall through
        return tuple(out)

    def spec_for(self, name, shape, axis_sizes):
        """The spec tuple for one parameter under ``axis_sizes``
        (mesh axis name → size).  Pure; deterministic; first template
        that *applies* wins (overrides before rules)."""
        shape = tuple(int(s) for s in shape)
        tpl = self.overrides.get(name)
        if tpl is not None:
            out = self._apply_template(tuple(tpl), shape, axis_sizes)
            if out is not None:
                return out
        for pat, rtpl in self._compiled:
            if pat.search(name):
                out = self._apply_template(rtpl, shape, axis_sizes)
                if out is not None:
                    return out
        ax = self.heuristic_axis
        n = axis_sizes.get(ax, 1) if ax else 1
        if ax and n > 1:
            # fsdp_specs bit-compat: FIRST dim divisible by and >= n,
            # emitted in fsdp_specs' own trimmed form (no trailing Nones)
            for d, size in enumerate(shape):
                if size % n == 0 and size >= n:
                    return tuple([None] * d + [ax])
        return ()


# the named deployments `PlannerConfig(rules=...)` accepts
_NAMED = {
    "replicated": lambda: RuleSet(name="replicated"),
    "fsdp": lambda: RuleSet(heuristic_axis="fsdp", name="fsdp"),
    "megatron": lambda: RuleSet(LLAMA_LOGICAL_RULES, MEGATRON_BINDING,
                                name="megatron"),
    "megatron+fsdp": lambda: RuleSet(LLAMA_LOGICAL_RULES,
                                     MEGATRON_BINDING,
                                     heuristic_axis="fsdp",
                                     name="megatron+fsdp"),
}


def named_rule_set(name):
    """Look up a predefined rule set (``replicated`` / ``fsdp`` /
    ``megatron`` / ``megatron+fsdp``)."""
    try:
        return _NAMED[name]()
    except KeyError:
        raise MXNetError(
            f"unknown planner rule set {name!r} "
            f"(known: {sorted(_NAMED)})") from None


def resolve_specs(ruleset, signature, axis_sizes):
    """Spec tuples for an ordered ``(name, shape, dtype)`` signature."""
    return OrderedDict(
        (name, ruleset.spec_for(name, shape, axis_sizes))
        for name, shape, _dtype in signature)


def stage_spec(ndim, axis="pp"):
    """The structural spec of a stacked pipeline-stage leaf: leading
    stage dim over the pp axis, everything else replicated.  Stage
    params are positional (stacked trees), so this is the one spec the
    name-rule engine cannot express.  The port's ``pipeline_apply`` runs
    row ``axis_index(pp)`` of each leaf on its rank, which is this
    layout."""
    return tuple([axis] + [None] * (int(ndim) - 1))


def spec_tuple(spec):
    """Normalize a PartitionSpec-or-tuple to the planner's plain-tuple
    form (sub-tuples kept for multi-axis dims)."""
    out = []
    for a in tuple(spec):
        out.append(tuple(a) if isinstance(a, (list, tuple)) else a)
    return tuple(out)
