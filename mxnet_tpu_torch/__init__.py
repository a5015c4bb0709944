"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``, for NVIDIA
Hopper (H100).

Serving: the model-zoo Llama (``gluon.model_zoo.language.llama``) served
by the continuous-batching, paged-KV ``serving.ServingEngine``, with
prefill attention in a hand-written CUDA flash-attention kernel
(``csrc/flash_attn_fwd.cu``).  Training: ``mx.nd`` over an op table,
``autograd``, Gluon blocks and parameters, ``gluon.Trainer`` and the fused
``parallel.TrainStep``, which train the model-zoo ResNets
(``gluon.model_zoo.vision``), BERT and the same Llama the engine serves
(``gluon.model_zoo.language``).  Entry points run
on the first CUDA card unless the caller passes ``device="cpu"`` /
``ctx=mx.cpu()``.  The package imports ``torch`` and numpy, never ``jax``
and nothing of ``mxnet_tpu``.
"""
from __future__ import annotations

from . import autograd, initializer, ndarray, random
from . import initializer as init
from . import ndarray as nd
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, resolve_device
from . import contrib, gluon, optimizer, parallel  # noqa: E402

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "resolve_device", "nd", "ndarray", "autograd", "init",
           "initializer", "random", "gluon", "optimizer", "parallel",
           "contrib"]
