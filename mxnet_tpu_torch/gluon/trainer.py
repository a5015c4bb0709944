"""Gluon Trainer: parameters, KVStore and optimizer (counterpart of
``mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` reduces the gradients through the KVStore, then
applies the optimizer with the gradients rescaled by 1 / batch_size.  The
optimizer gets the parameters as ``param_dict`` ({index: Parameter}), so
each Parameter's ``lr_mult`` and ``wd_mult`` reach its update.

The KVStore follows the reference's decision table (``_init_kvstore``):
``kvstore=None`` reduces nothing; a type string or a store is created and
given every initialized parameter; ``update_on_kvstore`` defaults to True
for the distributed stores, and then the store's own optimizer updates
the weights (the gradients are pushed and the weights pulled back).
Otherwise the gradients ride flat buckets capped by
``MXNET_ALLREDUCE_BUCKET_MB`` (``parallel.bucketing``) through the store
and the Trainer's optimizer updates them; with ``MXNET_ZERO=1`` and SGD
or Adam, the bucketed update is ZeRO-1 (``parallel.zero``: reduce-scatter,
a ``1/dp`` shard of the optimizer state per process, all-gather).  One
process holds one context: a local store with nothing to compress has one
value per key, which it would return unchanged, so that round trip is
skipped.

``save_states``/``load_states`` write and read the reference's formats
(either package reads the other's file): the updater's blob, the store's
when it updates the weights, or ``MXTRZRO1`` + the ZeRO payload, which
loads at any world size, or with ``MXNET_ZERO`` off.  With
``MXNET_GUARD_CHECKSUM=1`` each step stamps the digest of its reduced
gradients into the flight recorder (``guard``'s quarantine evidence).
"""
from __future__ import annotations

import pickle

import torch

from .. import guard as _guard
from .. import kvstore as kvs_mod
from .. import optimizer as opt_mod
from .. import telemetry as _telemetry
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_STEPS_TOTAL = _telemetry.counter(
    "mxnet_trainer_steps_total", "Trainer.step calls (telemetry=True)")


class Trainer:
    """``telemetry=True`` attributes each ``step()`` to the telemetry step
    timeline, as the reference's Trainer does: gradient sync as the
    ``collectives`` phase, the parameter update as ``optimizer`` (see
    :mod:`mxnet_tpu_torch.telemetry`).  Off by default."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, telemetry=False):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict/dict/list")
        self._params = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p}")
            self._params.append(p)
        self._compression_params = compression_params
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **(optimizer_params or {}))
        self._updater = opt_mod.get_updater(self._optimizer)
        self._scale = self._optimizer.rescale_grad
        self._telemetry = bool(telemetry)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._bucketer = None    # fused-allreduce plan cache
        self._bucket_gen_seen = None
        self._zero = None        # ZeRO-1 engine
        self._zero_warned = False
        self._zero_done = set()  # parameters ZeRO updated this step
        self._zero_pending = []  # (generation, bucket) awaiting _update

    @property
    def _updaters(self):
        return [self._updater]

    def _init_kvstore(self):
        """The update_on_kvstore decision (reference decision table: a
        distributed store updates the weights unless told otherwise)."""
        kvstore = self._kvstore_params["kvstore"]
        update_on_kvstore = self._kvstore_params["update_on_kvstore"]
        if kvstore is None:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            kv = kvstore if isinstance(kvstore, kvs_mod.KVStore) else \
                kvs_mod.create(kvstore)
            self._kvstore = kv
            if update_on_kvstore is None:
                update_on_kvstore = "dist" in kv.type
            self._update_on_kvstore = bool(update_on_kvstore)
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if not self._nothing_to_reduce():
                for i, p in enumerate(self._params):
                    if p._nd is not None:
                        kv.init(i, p.data())
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

    @property
    def step_count(self):
        """Optimizer updates applied so far (``optimizer.num_update``; the
        store's optimizer under ``update_on_kvstore``)."""
        kv_opt = self._kv_optimizer()
        return (kv_opt or self._optimizer).num_update

    def _kv_optimizer(self):
        if self._update_on_kvstore and self._kvstore is not None:
            return self._kvstore._optimizer
        return None

    @property
    def learning_rate(self):
        """The learning rate of the next update: the scheduler's at the
        update count, if the optimizer has one."""
        opt = self._optimizer
        return opt.lr if opt.lr_scheduler is None else \
            opt.lr_scheduler(opt.num_update)

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        """Raises MXNetError if the optimizer has a scheduler."""
        self._optimizer.set_learning_rate(lr)
        if self._kv_optimizer() is not None:
            self._kv_optimizer().set_learning_rate(lr)

    def _set_rescale(self, batch_size):
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._kvstore is not None and self._kvstore._optimizer is not None:
            self._kvstore._optimizer.rescale_grad = self._scale / batch_size

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients, then update every parameter from its
        gradient scaled by 1 / batch_size (reference: Trainer.step)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._set_rescale(batch_size)
        if self._telemetry:
            _STEPS_TOTAL.inc()
        with _telemetry.maybe_phase(self._telemetry, "collectives"):
            self._allreduce_grads()
        if _guard.checksum_enabled():
            self._stamp_checksum()
        with _telemetry.maybe_phase(self._telemetry, "optimizer"):
            self._update(ignore_stale_grad)

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._set_rescale(batch_size)
        self._update(ignore_stale_grad)

    # -- gradient reduction ------------------------------------------------
    def _active(self):
        return [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._nd is not None]

    def _zero_engine(self):
        """The ZeRO-1 engine when the mode applies (``MXNET_ZERO=1``,
        buckets on, the Trainer's own optimizer, SGD or Adam)."""
        from ..parallel import bucketing as _bucketing
        from ..parallel import zero as _zero

        if not _zero.zero_enabled() or self._update_on_kvstore or \
                self._kvstore is None or _bucketing.bucket_cap_bytes() <= 0:
            return None
        if not _zero.supports(self._optimizer):
            if not self._zero_warned:
                import warnings

                warnings.warn(
                    f"MXNET_ZERO=1 but {type(self._optimizer).__name__} has "
                    f"no flat sharded update; optimizer state stays "
                    f"replicated", stacklevel=2)
                self._zero_warned = True
            return None
        if self._zero is None or self._zero.optimizer is not self._optimizer:
            self._zero = _zero.ZeroBucketEngine(
                self._optimizer,
                host=getattr(self._kvstore, "_host_reduce", False))
            self._zero.adopt = _zero.updater_adopter(self._updater)
        return self._zero

    def _nothing_to_reduce(self):
        """A local store with one context a process, no compression and no
        optimizer returns every value as pushed."""
        return not isinstance(self._kvstore, kvs_mod.DistTPUSyncKVStore) \
            and self._kvstore._compression is None \
            and not self._update_on_kvstore

    def _allreduce_grads(self):
        from ..parallel import bucketing as _bucketing

        self._zero_done = set()
        self._zero_pending = []
        if self._kvstore is None or self._nothing_to_reduce():
            return
        if not self._update_on_kvstore and _bucketing.bucket_cap_bytes() > 0:
            self._allreduce_grads_bucketed()
            return
        for i, param in self._active():
            self._kvstore.push(i, param.list_grad())
            self._kvstore.pull(i, param.list_data() if
                               self._update_on_kvstore else param.list_grad())

    def _allreduce_grads_bucketed(self):
        """Dense gradients coalesced into size-capped flat buckets, one
        push/pull (one collective in a distributed store) a bucket, in a
        plan that is deterministic in parameter order; row-sparse and host
        keys keep the per-key path."""
        from ..ndarray.ndarray import NDArray
        from ..parallel import bucketing as _bucketing

        active = [(i, p.grad()) for i, p in self._active()]
        if not active:
            return
        grads = dict(active)
        entries, bypass = [], []
        for i, g in active:
            if g.stype == "row_sparse" or self._kvstore._is_host_key(i):
                bypass.append(i)
            else:
                entries.append((i, tuple(g.shape), g.dtype))
        if self._bucketer is None:
            self._bucketer = _bucketing.Bucketer()
        plan = self._bucketer.plan_for(entries)
        gen = self._bucketer.generation
        zero = self._zero_engine()
        prev = self._bucket_gen_seen
        if prev != gen:
            # a replan retired the previous generation's buckets: drop
            # their compression residuals and harvest their ZeRO shards
            self._bucket_gen_seen = gen
            comp = self._kvstore._compression
            if comp is not None and hasattr(comp, "drop_residuals"):
                comp.drop_residuals(
                    lambda k: isinstance(k, str)
                    and k.startswith("__grad_bucket")
                    and not k.endswith(f"g{gen}"))
            if zero is not None and prev is not None:
                zero.retire(("gen", prev))
        for b in plan.buckets:
            if zero is not None and _bucketing.float_kind(b.dtype):
                # ZeRO-1: the step runs in _update, so allreduce_grads ->
                # edit grads -> update keeps its meaning
                self._zero_pending.append((gen, b))
                continue
            if not b.fused:
                (i,) = b.keys
                self._kvstore.push(i, [grads[i]])
                self._kvstore.pull(i, [grads[i]])
                continue
            key = f"__grad_bucket{b.index}g{gen}"
            flat = NDArray._wrap(
                _bucketing.pack([grads[i]._data for i in b.keys]))
            self._kvstore.push(key, [flat])
            self._kvstore.pull(key, [flat])
            self._kvstore._discard_transient(key)
            _bucketing.record_fused(b.nbytes)
            if _guard.checksum_enabled():
                _guard.stamp_bucket_checksum(key, flat._data,
                                             step=self.step_count)
            for i, part in zip(b.keys, _bucketing.unpack(b, flat._data)):
                grads[i]._set(part)
        for i in bypass:
            _bucketing.record_bypass()
            self._kvstore.push(i, [grads[i]])
            self._kvstore.pull(i, [grads[i]])

    def _zero_step_bucket(self, gen, b):
        """One ZeRO bucket: flat gradient and weight to the engine, the
        updated flat weight back into the parameters."""
        from ..parallel import bucketing as _bucketing

        flat = _bucketing.pack([self._params[i].grad()._data
                                for i in b.keys])
        w_flat = _bucketing.pack([self._params[i].data()._data
                                  for i in b.keys])
        new_flat = self._zero.step_bucket(("gen", gen), b, [flat], w_flat)
        if _guard.checksum_enabled():
            _guard.stamp_bucket_checksum(f"__zero_bucket{b.index}g{gen}",
                                         new_flat, step=self.step_count)
        for i, part in zip(b.keys, _bucketing.unpack(b, new_flat)):
            self._params[i].data()._set(part)
            self._zero_done.add(i)

    def _update(self, ignore_stale_grad=False):
        if self._update_on_kvstore and self._kvstore is not None:
            return      # the store updated the weights in _allreduce_grads
        if self._zero_pending:
            pending, self._zero_pending = self._zero_pending, []
            for gen, b in pending:
                self._zero_step_bucket(gen, b)
        for i, param in self._active():
            if i in self._zero_done:
                continue
            self._updater(i, param.grad(), param.data())

    def _stamp_checksum(self):
        """Quarantine evidence (``MXNET_GUARD_CHECKSUM=1``) with no bucket
        path: the digest of the gradients as one flat bucket."""
        if self._kvstore is not None and not self._nothing_to_reduce():
            return      # the bucketed path stamped each reduced bucket
        grads = [p.grad()._data.reshape(-1) for _, p in self._active()]
        if grads:
            _guard.stamp_bucket_checksum("__grad_bucket0",
                                         torch.cat(grads),
                                         step=self.step_count)

    # -- states ------------------------------------------------------------
    # the header of a states file holding ZeRO-1 sharded optimizer state:
    # MXTRZRO1 + pickled {"updater": <blob>, "zero": <payload>}
    _ZERO_MAGIC = b"MXTRZRO1"

    def _states_blob(self):
        """The bytes ``save_states`` writes (an async checkpoint takes them
        on the step loop's thread and writes them on another)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore and self._kvstore is not None:
            return self._kvstore._optimizer_states_blob(dump_optimizer=True)
        blob = self._updater.get_states(dump_optimizer=True)
        if self._zero is not None and self._zero.has_state:
            return self._ZERO_MAGIC + pickle.dumps(
                {"updater": blob, "zero": self._zero.state_payload()})
        return blob

    def save_states(self, fname):
        """Write the optimizer and its states to ``fname``."""
        blob = self._states_blob()
        with open(fname, "wb") as f:
            f.write(blob)

    def load_states(self, fname):
        """Read a ``save_states`` file of either package: the optimizer
        (its update counts and scheduler included) replaces this
        Trainer's, with ``param_dict`` rebuilt over its parameters."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                data = f.read()
            zero_payload = None
            if data.startswith(self._ZERO_MAGIC):
                obj = pickle.loads(data[len(self._ZERO_MAGIC):])
                if not isinstance(obj, dict) or \
                        not {"updater", "zero"} <= set(obj):
                    raise MXNetError(f"{fname}: a ZeRO-1 states file "
                                     f"(MXTRZRO1) without its updater "
                                     f"blob and sharded payload")
                data, zero_payload = obj["updater"], obj["zero"]
            self._updater.set_states(data)
            self._optimizer = self._updater.optimizer
            self._zero = None
            if zero_payload is not None:
                engine = self._zero_engine()
                if engine is not None:
                    engine.load_state_payload(zero_payload)
                else:
                    from ..parallel import zero as _zero

                    _zero.fold_into_updater(self._updater, zero_payload)
        self._optimizer.param_dict = dict(enumerate(self._params))

