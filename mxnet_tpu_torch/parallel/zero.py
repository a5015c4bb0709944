"""ZeRO-1 optimizer-state sharding on the bucketed gradient path
(counterpart of ``mxnet_tpu/parallel/zero.py``).

Instead of every process all-reducing each flat gradient bucket and then
applying the same update to a full replica of the optimizer state, the
bucket is reduce-scattered, each process updates only its ``1/dp`` shard
(momentum and Adam's moments live permanently sharded), and the updated
weights are all-gathered back.  Optimizer memory drops to about ``1/dp``
a process.

- The bucket plan (``bucketing.Bucketer``) is deterministic on every
  process; the shard layout is ``bucketing.shard_layout`` (flat size
  padded to a multiple of dp, contiguous shards).  ``dp`` is the number
  of processes.
- State is keyed by **(plan generation, bucket index)**: a replan never
  aliases state across bucket compositions.  A retired generation's
  shards are harvested to per-parameter pieces (``_carry``) and
  re-flattened into the next plan, the same machinery that restores a
  checkpoint onto another dp.
- ``state_payload()``/``load_state_payload()`` are dp- and plan-agnostic
  (per-parameter pieces), so a payload written at world size 2 loads at
  4, and the two packages read each other's ``MXTRZRO1`` files.
- The shard update is the replicated kernels' math (``ops/optimizer_ops``
  ``sgd_update``, ``sgd_mom_update``, ``adam_update``) on the shard, so
  one process reproduces the replicated update bit for bit.
- ``reshard(plan=)`` (live plan-to-plan resharding) waits for the
  planner of the second multi-GPU slice (ROADMAP A6) and raises.

Gating: ``MXNET_ZERO`` (default off); SGD and Adam (``supports``).
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import env as _env
from .. import fault as _fault
from .. import telemetry as _telemetry
from ..base import MXNetError, dtype_name
from . import bucketing as _bucketing

__all__ = ["zero_enabled", "supports", "kind_of", "ZeroBucketEngine",
           "updater_adopter", "payload_to_states", "fold_into_updater"]

_RS_BYTES = _telemetry.counter(
    "mxnet_zero_reduce_scatter_bytes_total",
    "flat-bucket bytes through the ZeRO reduce-scatter (padded, counted "
    "once per bucket)")
_AG_BYTES = _telemetry.counter(
    "mxnet_zero_all_gather_bytes_total",
    "updated-param bytes through the ZeRO all-gather (padded, counted "
    "once per bucket)")
_COLLECTIVES = _telemetry.counter(
    "mxnet_zero_collectives_total",
    "ZeRO collectives issued (2 per bucket per step)")
_STATE_BYTES = _telemetry.gauge(
    "mxnet_zero_optimizer_bytes_per_rank",
    "per-rank bytes of sharded optimizer state currently resident")

_SUPPORTED = {"SGD": "sgd", "Adam": "adam"}


def zero_enabled():
    """Whether ZeRO-1 sharding is on (``MXNET_ZERO``, default off)."""
    return _env.zero_enabled()


def supports(optimizer):
    """True when ``optimizer`` has a flat sharded update (SGD/Adam)."""
    return type(optimizer).__name__ in _SUPPORTED


def kind_of(optimizer):
    return _SUPPORTED.get(type(optimizer).__name__)


def _torch_dtype(name):
    return getattr(torch, str(name).replace("torch.", ""))


class ZeroBucketEngine:
    """Sharded weight update for flat gradient buckets: one engine owns
    the sharded optimizer state of one optimizer (a Trainer's or a
    store's).  ``host=True`` (a host-reduced store's) runs the
    reduce-scatter and the all-gather on host copies."""

    def __init__(self, optimizer, plan=None, host=False):
        kind = kind_of(optimizer)
        if kind is None:
            raise MXNetError(
                f"ZeRO sharded update unsupported for "
                f"{type(optimizer).__name__} (supported: "
                f"{sorted(_SUPPORTED)})")
        if plan is not None:
            raise MXNetError("ZeroBucketEngine(plan=): sharding plans come "
                             "with the planner of the second multi-GPU "
                             "slice (ROADMAP A6)")
        self.optimizer = optimizer
        self._kind = kind
        self.host = host
        self._state = {}
        self._carry = {}
        self.adopt = None

    @property
    def dp(self):
        """Shard count: the number of processes."""
        from .collectives import world_size

        return world_size()

    def _n_state(self):
        if self._kind == "adam":
            return 2
        return 1 if getattr(self.optimizer, "momentum", 0.0) else 0

    # -- state assembly / harvest -------------------------------------------
    def _assemble(self, state_key, bucket, opt_keys, padded, shard, dtype,
                  device):
        """This process's state shards for one bucket, re-flattened from
        carried per-parameter pieces (a restore at any dp, a replan, an
        adopted replicated updater), zeros elsewhere."""
        from .collectives import rank

        flats = [torch.zeros(padded, dtype=dtype)
                 for _ in range(self._n_state())]
        for key, off, size in zip(opt_keys, bucket.offsets, bucket.sizes):
            pieces = self._carry.pop(key, None)
            if pieces is None and self.adopt is not None:
                pieces = self.adopt(key)
            if pieces is None:
                continue
            if any(p is not None and _np.asarray(p).size != size
                   for p in pieces):
                # the parameter changed shape since the state was saved:
                # its old momentum means nothing, start from zeros
                continue
            for flat, piece in zip(flats, pieces):
                if piece is not None:
                    flat[off:off + size] = torch.from_numpy(
                        _np.ascontiguousarray(piece, dtype=_np.float64)
                        .reshape(-1)).to(dtype)
        me = rank()
        leaves = tuple(f[me * shard:(me + 1) * shard].clone().to(device)
                       for f in flats)
        self._state[state_key] = {
            "leaves": leaves,
            "members": tuple((k, off, size, tuple(shape)) for k, off, size,
                             shape in zip(opt_keys, bucket.offsets,
                                          bucket.sizes, bucket.shapes)),
            "size": bucket.size, "dtype": dtype_name(dtype)}
        self._record_bytes()
        return self._state[state_key]

    def state_bytes(self):
        """Bytes of optimizer state this process holds."""
        return sum(lv.numel() * lv.element_size()
                   for e in self._state.values() for lv in e["leaves"])

    def _record_bytes(self):
        _STATE_BYTES.set(self.state_bytes())

    def _full_leaves(self, entry):
        """Every process's shards gathered into the full flat states (a
        collective: reached at the same point on every process)."""
        from .collectives import all_gather

        return [all_gather(lv.detach().cpu(), axis_name="world")
                [:entry["size"]] for lv in entry["leaves"]]

    def _harvest_entry(self, entry):
        fulls = self._full_leaves(entry)
        for key, off, size, shape in entry["members"]:
            self._carry[key] = tuple(
                _float_np(full[off:off + size]).reshape(shape)
                for full in fulls)

    def retire(self, generation):
        """Harvest ``generation``'s shards to per-parameter pieces so the
        state survives into the next plan's layout."""
        for sk in [sk for sk in self._state if sk[0] == generation]:
            self._harvest_entry(self._state.pop(sk))
        self._record_bytes()

    def reshard(self, plan, budget_bytes=None):
        raise MXNetError("ZeroBucketEngine.reshard(plan=): live resharding "
                         "comes with the planner of the second multi-GPU "
                         "slice (ROADMAP A6); restore a checkpoint onto "
                         "the new world size instead")

    # -- the per-bucket step -----------------------------------------------
    def step_bucket(self, generation, bucket, grad_flats, weight_flat,
                    opt_keys=None):
        """Reduce-scatter the flat gradient (the sum of ``grad_flats``,
        this process's contributions), update this process's shard, and
        all-gather the updated flat weight; returns it (``bucket.size``
        elements, on the weight's device)."""
        import math

        from . import collectives as coll
        from .distributed import _shard_update

        # an injected fault raises before any state or count changes
        _fault.check("collectives.allreduce")
        opt = self.optimizer
        keys = list(bucket.keys) if opt_keys is None else list(opt_keys)
        dtype = _torch_dtype(bucket.dtype)
        dev = weight_flat.device
        dp = self.dp
        padded, shard, _ = _bucketing.shard_layout(bucket.size, dp)
        state_key = (generation, bucket.index)
        entry = self._state.get(state_key)
        if entry is None:
            entry = self._assemble(state_key, bucket, keys, padded, shard,
                                   dtype, dev)
        for k in keys:
            opt._update_count(k)
        lrs = [opt._get_lr(k) for k in keys]
        wds = [opt._get_wd(k) for k in keys]
        if self._kind == "adam":
            lrs = [lr * math.sqrt(1.0 - opt.beta2 **
                                  opt._index_update_count[k])
                   / (1.0 - opt.beta1 ** opt._index_update_count[k])
                   for lr, k in zip(lrs, keys)]
        me = coll.rank()
        lr = self._hyper(lrs, bucket, padded, shard, me, dev)
        wd = self._hyper(wds, bucket, padded, shard, me, dev)
        clip = opt.clip_gradient if (opt.clip_gradient or 0) > 0 else -1.0
        g = grad_flats[0].to(dev, dtype)
        for extra in grad_flats[1:]:
            g = g + extra.to(dev, dtype)
        g = torch.nn.functional.pad(g, (0, padded - g.numel()))
        g_shard = coll.reduce_scatter(g, axis_name="world", host=self.host)
        w = torch.nn.functional.pad(weight_flat.to(dtype),
                                    (0, padded - weight_flat.numel()))
        w_shard = w[me * shard:(me + 1) * shard]
        new_shard, new_state = _shard_update(
            self._kind, opt, w_shard, g_shard, entry["leaves"], lr, wd, clip)
        entry["leaves"] = new_state
        w_new = coll.all_gather(new_shard, axis_name="world", host=self.host)
        nbytes = padded * torch.empty((), dtype=dtype).element_size()
        _RS_BYTES.inc(nbytes)
        _AG_BYTES.inc(nbytes)
        _COLLECTIVES.inc(2)
        return w_new[:bucket.size]

    @staticmethod
    def _hyper(values, bucket, padded, shard, me, device):
        """A scalar when every member shares the value, else this shard's
        slice of the per-element vector."""
        if len(set(values)) <= 1:
            return values[0] if values else 0.0
        flat = torch.zeros(padded, dtype=torch.float32)
        for val, off, size in zip(values, bucket.offsets, bucket.sizes):
            flat[off:off + size] = val
        return flat[me * shard:(me + 1) * shard].to(device)

    # -- checkpoint payload -------------------------------------------------
    @property
    def has_state(self):
        return bool(self._state) or bool(self._carry)

    def state_payload(self):
        """Per-parameter numpy pieces of every resident shard: the
        checkpoint form, valid for any dp or bucket plan (a collective:
        every process reaches a save at the same point)."""
        members = {k: tuple(None if p is None else _np.asarray(p)
                            for p in v) for k, v in self._carry.items()}
        for entry in self._state.values():
            fulls = self._full_leaves(entry)
            for key, off, size, shape in entry["members"]:
                members[key] = tuple(
                    _float_np(full[off:off + size]).reshape(shape).copy()
                    for full in fulls)
        return {"version": 1, "kind": self._kind, "members": members}

    def load_state_payload(self, payload):
        if payload.get("kind") != self._kind:
            raise MXNetError(
                f"ZeRO state payload is for a {payload.get('kind')!r} "
                f"optimizer, engine runs {self._kind!r}")
        self._state.clear()
        self._carry = {k: tuple(v) for k, v in payload["members"].items()}
        self._record_bytes()


def _float_np(t):
    """numpy of a state tensor (bfloat16 widened to float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flatten_state(state):
    if state is None:
        return [None], "none"
    if isinstance(state, (tuple, list)):
        return list(state), ("seq", isinstance(state, tuple), len(state))
    return [state], "single"


def updater_adopter(updater):
    """An ``adopt`` hook that moves a replicated Updater's per-parameter
    state into the bucket shards (a replicated checkpoint restored into
    ZeRO mode keeps its momentum)."""
    def _adopt(key):
        st = updater.states.pop(key, None)
        if st is None:
            return None
        updater.states_synced.pop(key, None)
        leaves, _ = _flatten_state(st)
        return tuple(None if lv is None else _float_np(lv._data)
                     for lv in leaves)
    return _adopt


def fold_into_updater(updater, payload):
    """Fold an engine payload into a replicated Updater (a ZeRO checkpoint
    restored with ``MXNET_ZERO`` off keeps its momentum); the states move
    to their weights' device at the next update."""
    states = payload_to_states(payload)
    updater.states.update(states)
    for k in states:
        updater.states_synced[k] = False


def payload_to_states(payload):
    """An engine payload as replicated per-key states (``Updater.states``
    layout, CPU NDArrays)."""
    from ..ndarray.ndarray import NDArray

    kind = payload.get("kind")
    out = {}
    for key, pieces in payload["members"].items():
        nds = [None if p is None else
               NDArray._wrap(torch.from_numpy(_np.array(p)))
               for p in pieces]
        if kind == "adam":
            out[key] = tuple(nds)
        elif len(nds) == 1:
            out[key] = nds[0]
        else:
            out[key] = None
    return out
