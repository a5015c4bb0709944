"""Training steps of the port (counterpart of ``mxnet_tpu/parallel``): the
functionalized Gluon forward and the fused single-device ``TrainStep``."""
from .data_parallel import TrainStep, make_adam_update, make_sgd_update
from .functional import functionalize

__all__ = ["functionalize", "TrainStep", "make_sgd_update",
           "make_adam_update"]
