"""Sharding planner (counterpart of ``mxnet_tpu/parallel/planner``):
declarative mesh config + logical-axis rules → per-parameter
PartitionSpecs, with HBM-model mesh auto-selection.  Pure Python: the
same config, signature and device count give the reference's specs, mesh,
estimate and plan JSON.

The one audited place sharding decisions are made (ROADMAP "a real
partitioner"; SNIPPETS.md [2]/[3] T5X ``Partitioner`` shape).  Before
this subsystem, layout intent was hand-wired across TrainStep,
``pipeline_apply``, per-model code and the ZeRO engine; now each of those
*consumes* a :class:`ShardingPlan`:

    cfg  = planner.PlannerConfig(mesh="auto", rules="megatron+fsdp",
                                 optimizer="adam", batch_rows=512,
                                 hbm_gb=16)
    plan = planner.plan_for(net, cfg)          # pure + deterministic
    print(plan.visualize_sharding())           # per-param table + HBM
    step = TrainStep(net, loss_fn, plan=plan)  # specs + mesh + batch

Plans are pure functions of (config, parameter signature, device
count): every SPMD peer and every restart computes the same plan
(``plan.digest()`` is equal across processes), and with rules
equivalent to a hand-wired layout the resulting specs are identical —
trajectories do not move by a bit.

Knobs: ``MXNET_PLANNER_MESH``, ``MXNET_PLANNER_HBM_GB``,
``MXNET_PLANNER_PIPELINE_IN_JIT``, ``MXNET_PLANNER_REPORT`` (env.py).
"""
from . import hbm
from . import rules
from .hbm import choose_mesh, enumerate_meshes, estimate
from .plan import (PlannerConfig, ShardingPlan, get_default_plan,
                   plan_for, plan_sharding, report_from_snapshot,
                   set_default_plan, signature_of)
from .rules import LLAMA_LOGICAL_RULES, MEGATRON_BINDING, RuleSet, \
    named_rule_set

__all__ = ["PlannerConfig", "ShardingPlan", "plan_sharding", "plan_for",
           "signature_of", "set_default_plan", "get_default_plan",
           "report_from_snapshot", "RuleSet", "named_rule_set",
           "LLAMA_LOGICAL_RULES", "MEGATRON_BINDING", "estimate",
           "enumerate_meshes", "choose_mesh", "rules", "hbm"]
