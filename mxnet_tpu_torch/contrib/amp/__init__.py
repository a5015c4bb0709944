"""AMP -- automatic mixed precision (counterpart of
``mxnet_tpu/contrib/amp``)."""
from .amp import (init, disable, init_trainer, scale_loss, unscale,
                  convert_model, convert_hybrid_block, list_fp16_ops,
                  list_fp32_ops, _cast_scope)
from .loss_scaler import LossScaler
from . import lists  # noqa: F401

__all__ = ["init", "disable", "init_trainer", "scale_loss", "unscale",
           "convert_model", "convert_hybrid_block", "list_fp16_ops",
           "list_fp32_ops", "LossScaler"]
