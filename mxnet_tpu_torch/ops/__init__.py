"""Operators of the port: the op table behind ``mx.nd`` (the tensor, nn,
LLM, optimizer, random, image, detection, quantization and legacy
families and the subgraph backend's fused ops, plain PyTorch and library
calls), and the kernel-backed flash attention
(``_contrib_flash_attention``)."""
from . import tensor  # noqa: F401  (populates the table)
from . import nn  # noqa: F401
from . import attention_ops  # noqa: F401
from . import flash_attention  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import random_ops  # noqa: F401
from . import image_ops  # noqa: F401
from . import detection_ops  # noqa: F401
from . import quantization_ops  # noqa: F401
from . import legacy_ops  # noqa: F401
from .. import subgraph  # noqa: F401
from .registry import OP_TABLE, get_op, list_ops, register  # noqa: F401
