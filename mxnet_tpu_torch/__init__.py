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
``lifecycle.check_stop()`` resumes exactly after a preemption.  Data:
``gluon.data`` (datasets, samplers, the DataLoader with thread or process
workers, ``vision``), ``io`` (ImageRecordIter over a native C++ RecordIO
reader, CSVIter, LibSVMIter, MNISTIter), ``recordio``, ``image`` and
``nd.sparse`` (row_sparse and csr storage, the CSR product).  Runtime
planes: ``profiler`` (per-op spans and the card's kernels in a Chrome
trace, over ``torch.profiler``), ``introspection`` (FLOPs counted once per
signature, the live MFU gauge), ``guard`` (the numerical-integrity guard:
skip and rewind), ``lifecycle.Watchdog`` (the stall watchdog),
``telemetry_agg`` (cross-rank snapshot merge and black-box blame) and
``tuning`` (knobs, successive halving, the winner DB; the
flash-attention kernel's tiles are knobs).  The symbolic half:
``mx.sym`` (Symbols over the same op table, ``infer_shape``, the
reference's JSON), the ``Executor``, ``HybridBlock.export`` and
``gluon.SymbolBlock.imports`` (deploy files that cross between the two
packages), ``mx.mod`` (``Module``, ``BucketingModule``), ``mx.model``,
``mx.mon``, ``mx.viz`` and ``mx.test_utils``.  Data parallelism across
processes: ``mx.kv`` (every KVStore type), ``parallel.distributed.init``
over ``torch.distributed``, ``parallel.collectives``, ``Trainer`` over a
KVStore with bucketed all-reduce and ZeRO-1, and ``TrainStep(mesh=)``.
The package imports ``torch``
and numpy, never ``jax`` and nothing of ``mxnet_tpu``.
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
from . import kvstore  # noqa: E402
from . import kvstore as kv  # noqa: E402
from .ndarray import NDArray  # noqa: E402
from . import env, fault, flight_recorder, lifecycle, telemetry  # noqa: E402
from . import callback, checkpoint  # noqa: E402
from . import image, io, native, recordio  # noqa: E402
from . import (guard, introspection, profiler, telemetry_agg,  # noqa: E402
               tuning)
from . import executor, model, module, monitor, symbol, util  # noqa: E402
from . import module as mod  # noqa: E402
from . import monitor as mon  # noqa: E402
from . import symbol as sym  # noqa: E402
from . import visualization  # noqa: E402
from . import visualization as viz  # noqa: E402
from .executor import Executor  # noqa: E402
from .util import test_utils  # noqa: E402

env.apply_env()

__all__ = ["MXNetError", "Context", "cpu", "gpu", "tpu", "cpu_pinned",
           "current_context", "num_gpus", "num_tpus", "context",
           "resolve_device", "nd", "ndarray", "autograd", "init",
           "initializer", "random", "gluon", "optimizer", "lr_scheduler",
           "metric", "parallel", "kv", "kvstore", "NDArray",
           "contrib", "env", "fault", "telemetry", "flight_recorder",
           "lifecycle", "checkpoint", "callback", "io", "recordio",
           "image", "native", "profiler", "introspection", "guard",
           "tuning", "telemetry_agg", "sym", "symbol", "mod", "module",
           "model", "executor", "Executor", "viz", "visualization", "mon",
           "monitor", "util", "test_utils"]
