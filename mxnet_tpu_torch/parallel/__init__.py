"""Parallel training of the port (counterpart of ``mxnet_tpu/parallel``),
one process a device over ``torch.distributed``:

- mesh:              the named process mesh (dp/fsdp/tp/sp/ep/pp axes),
                     ``PartitionSpec`` and ``Placement``
- collectives:       psum/all_gather/reduce_scatter/ppermute/all_to_all/
                     send/recv, through one issue site
- data_parallel:     the fused ``TrainStep``, data-parallel over a mesh and
                     sharded by a plan (fsdp, Megatron tensor parallelism,
                     pipelining)
- tensor_parallel:   Megatron column/row specs and the tp functions
- pipeline_parallel: GPipe and 1F1B over pp by send/recv
- context_parallel:  ring attention and Ulysses over sp
- expert_parallel:   the switch-MoE layer, its experts split over ep
- planner:           logical-axis rules + the HBM model's mesh choice ->
                     one ShardingPlan
- distributed, bucketing, zero: the process bootstrap, gradient buckets
                     and ZeRO-1
"""
from . import (bucketing, collectives, distributed, expert_parallel, mesh,
               pipeline_parallel, planner, tensor_parallel, zero)
from .context_parallel import (context_parallel_attention, ring_attention,
                               ulysses_attention,
                               ulysses_context_parallel_attention)
from .data_parallel import TrainStep, make_adam_update, make_sgd_update
from .expert_parallel import moe_apply, stack_expert_params
from .functional import functionalize
from .mesh import get_default_mesh, make_mesh, set_default_mesh
from .pipeline_parallel import pipeline_apply, stack_stage_params

__all__ = ["mesh", "collectives", "distributed", "tensor_parallel",
           "make_mesh", "get_default_mesh", "set_default_mesh",
           "ring_attention", "context_parallel_attention",
           "ulysses_attention", "ulysses_context_parallel_attention",
           "pipeline_parallel", "expert_parallel", "pipeline_apply",
           "stack_stage_params", "moe_apply", "stack_expert_params",
           "planner", "functionalize", "TrainStep", "make_sgd_update",
           "make_adam_update", "bucketing", "zero"]
