"""mx.model (counterpart of ``mxnet_tpu/model.py``): what scripts still
use of the legacy FeedForward module, ``save_checkpoint``,
``load_checkpoint`` and ``BatchEndParam``, over the Module
implementations."""
from .module.base_module import _BatchEndParam as BatchEndParam
from .module.module import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]
