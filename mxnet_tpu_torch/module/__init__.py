"""mx.mod: the symbolic training API (counterpart of
``mxnet_tpu/module/``)."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module, load_checkpoint, save_checkpoint

__all__ = ["BaseModule", "Module", "BucketingModule", "save_checkpoint",
           "load_checkpoint"]
