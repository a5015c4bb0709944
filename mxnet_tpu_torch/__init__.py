"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``, for NVIDIA
Hopper (H100).

Serving: the model-zoo Llama (``gluon.model_zoo.language.llama``) served
by the continuous-batching, paged-KV ``serving.ServingEngine``, with
prefill attention in a hand-written CUDA flash-attention kernel
(``csrc/flash_attn_fwd.cu``).  Training: ``mx.nd`` over an op table,
``autograd``, Gluon blocks and parameters, ``gluon.Trainer`` (every
optimizer, ``lr_scheduler``, ``metric``, AMP loss scaling) and the fused
``parallel.TrainStep``, which train the model-zoo ResNets
(``gluon.model_zoo.vision``), BERT and the same Llama the engine serves
(``gluon.model_zoo.language``).  Entry points run
on the first CUDA card unless the caller passes ``device="cpu"`` /
``ctx=mx.cpu()``.  ``serving.serve()`` answers HTTP completions beside the
runtime planes ``telemetry`` (metrics, ``/metrics``), ``fault`` (fault
seams and retries), ``flight_recorder`` (the event ring and black-box
dumps) and ``lifecycle`` (graceful stop and exit codes).  Persistence:
``nd.save``/``nd.load``, ``save_parameters``, ``Trainer.save_states`` and
``checkpoint.CheckpointManager`` / ``run_with_recovery`` read and write
the reference's files, and a training loop that polls
``lifecycle.check_stop()`` resumes exactly after a preemption.  The package
imports ``torch`` and numpy, never ``jax`` and nothing of ``mxnet_tpu``.
"""
from __future__ import annotations

from . import autograd, initializer, ndarray, random
from . import initializer as init
from . import ndarray as nd
from .base import MXNetError
from . import context
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_gpus, num_tpus, resolve_device, tpu)
from . import contrib, gluon, lr_scheduler, metric, optimizer  # noqa: E402
from . import parallel  # noqa: E402
from . import env, fault, flight_recorder, lifecycle, telemetry  # noqa: E402
from . import callback, checkpoint  # noqa: E402

env.apply_env()

__all__ = ["MXNetError", "Context", "cpu", "gpu", "tpu", "cpu_pinned",
           "current_context", "num_gpus", "num_tpus", "context",
           "resolve_device", "nd", "ndarray", "autograd", "init",
           "initializer", "random", "gluon", "optimizer", "lr_scheduler",
           "metric", "parallel",
           "contrib", "env", "fault", "telemetry", "flight_recorder",
           "lifecycle", "checkpoint", "callback"]
