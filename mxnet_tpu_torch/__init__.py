"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``, for NVIDIA
Hopper (H100).

The first slice is the serving path: the model-zoo Llama
(``gluon.model_zoo.language.llama``) served by the continuous-batching,
paged-KV ``serving.ServingEngine``, with prefill attention in a hand-written
CUDA flash-attention kernel (``csrc/flash_attn_fwd.cu``).  Entry points run
on the first CUDA card unless the caller passes ``device="cpu"``.  The
package imports ``torch`` and numpy, never ``jax`` and nothing of
``mxnet_tpu``.
"""
from __future__ import annotations

from .base import MXNetError
from .context import resolve_device

__all__ = ["MXNetError", "resolve_device"]
