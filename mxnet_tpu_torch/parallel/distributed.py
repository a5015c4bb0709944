"""Process bootstrap and the sharded optimizer update (counterpart of
``mxnet_tpu/parallel/distributed.py``).

- ``init()`` reads the reference's launcher contract
  (``MXNET_COORDINATOR_ADDRESS`` or ``DMLC_PS_ROOT_URI`` +
  ``DMLC_PS_ROOT_PORT``, ``MXNET_NUM_WORKERS`` or ``DMLC_NUM_WORKER``,
  ``MXNET_WORKER_ID`` or ``DMLC_WORKER_ID``), so ``tools/launch.py -n N
  --launcher local`` starts port scripts as it starts reference ones, and
  calls ``torch.distributed.init_process_group``: gloo for CPU tensors,
  and NCCL beside it for CUDA tensors unless ``device="cpu"``.  Each
  process's card is ``cuda:{worker_id % device_count}``; a process with no
  card raises.  One process is a no-op that returns False, as in the
  reference.  A multi-process job turns on the stop agreement of
  ``lifecycle.check_stop`` and, unless ``MXNET_LIFECYCLE_SIGNALS=0``, the
  graceful-stop signal handlers.
- ``ShardedOptimizerUpdater`` is the server-side optimizer of a
  distributed store: per key, the gradient is reduce-scattered over the
  processes, each process updates its ``1/n`` shard of the flat padded
  weight (its optimizer state lives only for that shard), and the updated
  weight is all-gathered.  SGD (with or without momentum) and Adam, with
  the replicated kernels' math on each shard.
"""
from __future__ import annotations

import math
import os

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["init", "is_initialized", "ShardedOptimizerUpdater",
           "supports_sharded_update"]

_STATE = {"initialized": False}


def init(coordinator_address=None, num_processes=None, process_id=None,
         local_device_ids=None, device=None):
    """Join the process group from the arguments or the launcher's
    environment; returns True once joined, False for one process.
    ``device="cpu"`` runs the process on the CPU over gloo;
    ``local_device_ids`` picks the card of this process from a list."""
    import torch.distributed as dist

    if _STATE["initialized"]:
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("MXNET_COORDINATOR_ADDRESS")
        if coordinator_address is None:
            uri = os.environ.get("DMLC_PS_ROOT_URI")
            port = os.environ.get("DMLC_PS_ROOT_PORT")
            if uri and port:
                coordinator_address = f"{uri}:{port}"
    if num_processes is None:
        num_processes = int(os.environ.get(
            "MXNET_NUM_WORKERS", os.environ.get("DMLC_NUM_WORKER", "1")))
    if process_id is None:
        process_id = int(os.environ.get(
            "MXNET_WORKER_ID", os.environ.get("DMLC_WORKER_ID", "0")))
    if num_processes <= 1 or coordinator_address is None:
        return False
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise MXNetError("distributed.init: no CUDA device; pass "
                             "device='cpu' to run this process on the CPU")
        ids = local_device_ids or list(range(torch.cuda.device_count()))
        dev = torch.device("cuda", ids[process_id % len(ids)])
        torch.cuda.set_device(dev)
        backend = "cpu:gloo,cuda:nccl"
    from .. import fault

    fault.call_with_retries(
        "distributed.init", dist.init_process_group, backend=backend,
        init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id)
    _STATE["initialized"] = True
    # every peer must leave at the same step, or the others wait forever
    # in their next collective: turn the stop agreement on, and catch the
    # scheduler's SIGTERM so a preemption publishes a final checkpoint
    from .. import env as _env
    from .. import lifecycle

    lifecycle.coordinate_stops(True)
    if _env.get_bool("MXNET_LIFECYCLE_SIGNALS", True):
        lifecycle.install_signal_handlers()
    return True


def is_initialized():
    return _STATE["initialized"]


# --------------------------------------------------------------------------
# sharded optimizer update (update_on_kvstore in a distributed store)
# --------------------------------------------------------------------------
_SUPPORTED = {"SGD": "sgd", "Adam": "adam"}


def supports_sharded_update(optimizer):
    return type(optimizer).__name__ in _SUPPORTED


def _shard_update(kind, opt, w, g, state, lr, wd, clip):
    """The replicated kernels' math on one shard: the update ops of
    ``ops/optimizer_ops.py`` with per-element (tensor) or scalar lr/wd.
    Returns (new weight shard, new state tuple)."""
    from ..ops import optimizer_ops as _ops

    kw = dict(lr=lr, wd=wd, rescale_grad=opt.rescale_grad,
              clip_gradient=clip)
    if kind == "adam":
        m, v = state
        new_w, m2, v2 = _ops.adam_update(w, g, m, v, beta1=opt.beta1,
                                         beta2=opt.beta2,
                                         epsilon=opt.epsilon, **kw)
        return new_w, (m2, v2)
    if state:
        new_w, mom2 = _ops.sgd_mom_update(w, g, state[0],
                                          momentum=opt.momentum, **kw)
        return new_w, (mom2,)
    return _ops.sgd_update(w, g, **kw), ()


def _clip_of(opt):
    return opt.clip_gradient if (opt.clip_gradient or 0) > 0 else -1.0


def _adam_lr(opt, lr, index):
    t = opt._index_update_count[index]
    return lr * math.sqrt(1.0 - opt.beta2 ** t) / (1.0 - opt.beta1 ** t)


class ShardedOptimizerUpdater:
    """Per-key reduce-scatter, sharded optimizer state, all-gather.

    The weight stays replicated on every process; the optimizer state of
    each key is the flat padded shard this process owns (the reference's
    key-range-sharded servers).  Called as the store's updater,
    ``(index, grad, weight)``, with this process's gradient: the sum over
    processes happens inside the reduce-scatter.  ``host=True`` (the
    host-reduced stores) runs both collectives on host copies."""

    def __init__(self, optimizer, host=False):
        kind = _SUPPORTED.get(type(optimizer).__name__)
        if kind is None:
            raise MXNetError(
                f"sharded update unsupported for {type(optimizer).__name__}")
        self.optimizer = optimizer
        self._kind = kind
        self.host = host
        self._state = {}      # key -> tuple of flat shard tensors
        # key -> full flat states read from a file or adopted, sliced into
        # this process's shard at the key's next update (the true size is
        # the weight's, whatever the writer padded to)
        self._pending = {}

    def _n_state(self):
        if self._kind == "adam":
            return 2
        return 1 if getattr(self.optimizer, "momentum", 0.0) else 0

    def __call__(self, index, grad_nd, weight_nd):
        from . import collectives as coll
        from .bucketing import shard_layout

        opt = self.optimizer
        w = weight_nd._data
        n, me = coll.world_size(), coll.rank()
        padded, shard, _ = shard_layout(w.numel(), n)
        if index in self._pending:
            self._state[index] = tuple(
                torch.nn.functional.pad(
                    f[:w.numel()].to(w.device, w.dtype),
                    (0, padded - w.numel()))[me * shard:(me + 1) * shard]
                for f in self._pending.pop(index))
        if index not in self._state:
            self._state[index] = tuple(
                torch.zeros(shard, dtype=w.dtype, device=w.device)
                for _ in range(self._n_state()))
        elif self._state[index] and \
                self._state[index][0].device != w.device:
            self._state[index] = tuple(s.to(w.device)
                                       for s in self._state[index])
        opt._update_count(index)
        lr, wd = opt._get_lr(index), opt._get_wd(index)
        if self._kind == "adam":
            lr = _adam_lr(opt, lr, index)
        g = torch.nn.functional.pad(
            grad_nd._data.to(w.device, w.dtype).reshape(-1),
            (0, padded - w.numel()))
        g_shard = coll.reduce_scatter(g, axis_name="world", host=self.host)
        wf = torch.nn.functional.pad(w.reshape(-1), (0, padded - w.numel()))
        w_shard = wf[me * shard:(me + 1) * shard]
        new_shard, new_state = _shard_update(
            self._kind, opt, w_shard, g_shard, self._state[index], lr, wd,
            _clip_of(opt))
        self._state[index] = new_state
        full = coll.all_gather(new_shard, axis_name="world", host=self.host)
        weight_nd._set(full[:w.numel()].reshape(w.shape))

    # -- state io ------------------------------------------------------------
    def _full_states(self):
        """{key: tuple of full flat numpy states} (an all-gather a leaf:
        every process reaches a save at the same point)."""
        from . import collectives as coll

        out = {k: tuple(f.numpy() for f in v)
               for k, v in self._pending.items()}
        for k in sorted(self._state, key=str):
            out[k] = tuple(coll.all_gather(s.detach().cpu(),
                                           axis_name="world").numpy()
                           for s in self._state[k])
        return out

    def get_states(self, dump_optimizer=False):
        payload = {"state": self._full_states(), "kind": self._kind,
                   "version": 2}
        if dump_optimizer:
            payload["optimizer"] = self.optimizer
        from ..optimizer.optimizer import _ref_dumps

        return _ref_dumps(payload)

    def set_states(self, blob):
        import io

        from ..optimizer.optimizer import _StatesUnpickler

        payload = _StatesUnpickler(io.BytesIO(blob)).load()
        if payload.get("version", 1) < 2 and \
                payload.get("kind", self._kind) == "sgd":
            raise MXNetError(
                "optimizer state blob predates the lr-folded sgd momentum "
                "layout and cannot be migrated; re-save states")
        self._state, self._pending = {}, {}
        for k, states in payload["state"].items():
            if payload.get("kind", self._kind) == "adam" and \
                    len(states) == 3:
                m, v, t = states
                states = (m, v)
                self.optimizer._index_update_count[k] = int(_np.asarray(t))
            self._adopt_flat(k, states)
        if "optimizer" in payload:
            self.optimizer = payload["optimizer"]

    def _adopt_flat(self, k, leaves):
        flats = tuple(torch.as_tensor(_np.asarray(
            s._data.detach().cpu() if hasattr(s, "_data") else s)).reshape(-1)
            for s in leaves if s is not None)
        if len(flats) == self._n_state():
            self._state.pop(k, None)
            self._pending[k] = flats

    def adopt_dense_states(self, states):
        """Fold replicated per-key states (``Updater.states`` layout, or a
        ZeRO payload's member pieces) into this updater's shards."""
        for k, st in states.items():
            leaves = st if isinstance(st, (tuple, list)) else (st,)
            self._adopt_flat(k, leaves)
