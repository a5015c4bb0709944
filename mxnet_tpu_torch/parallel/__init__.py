"""Training steps and data parallelism of the port (counterpart of
``mxnet_tpu/parallel``): the functionalized Gluon forward, the fused
``TrainStep`` (data-parallel over a ``mesh``), the process ``mesh``,
``collectives`` over ``torch.distributed``, the process bootstrap
(``distributed.init``), gradient ``bucketing``, ZeRO-1 (``zero``) and the
switch-MoE layer on one device (``expert_parallel``).
Tensor, pipeline, context and expert parallelism and the planner come with
the second multi-GPU slice (ROADMAP A6)."""
from . import bucketing, collectives, distributed, expert_parallel, mesh, zero
from .data_parallel import TrainStep, make_adam_update, make_sgd_update
from .expert_parallel import moe_apply, stack_expert_params
from .functional import functionalize
from .mesh import get_default_mesh, make_mesh, set_default_mesh

__all__ = ["functionalize", "TrainStep", "make_sgd_update",
           "make_adam_update", "mesh", "collectives", "distributed",
           "bucketing", "zero", "make_mesh", "get_default_mesh",
           "set_default_mesh", "expert_parallel", "moe_apply",
           "stack_expert_params"]
