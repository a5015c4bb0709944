"""KVStore: the parameter-synchronization abstraction (counterpart of
``mxnet_tpu/kvstore.py``; exported as ``mx.kv`` and ``mx.kvstore``).

String-keyed ``init``/``push``/``pull``/``pushpull``/``row_sparse_pull``
with an optional server-side optimizer (``set_optimizer``), gradient
compression (2-bit with error-feedback residuals, int8) and the
optimizer-state files of the reference (the plain updater blob, the
``MXKVOPT1`` bundle with host row-sparse and ZeRO state, and the legacy
bundled dict).  ``create`` knows the reference's eleven type strings:

- ``local``, ``device``, ``nccl``, ``local_allreduce_cpu`` and
  ``local_allreduce_device`` are the single-process :class:`KVStore`:
  the values pushed for a key are summed, and an attached optimizer runs
  once on the sum.
- ``dist_sync``, ``dist_device_sync``, ``dist_async``, ``dist_tpu_sync``,
  ``dist_sync_device`` and ``dist`` are :class:`DistTPUSyncKVStore`: once
  a ``torch.distributed`` process group exists, a push is summed over
  every process, in dtype-segregated flat buckets
  (``parallel.bucketing``), through ``parallel.collectives``.
  ``dist_device_sync``, ``dist_sync_device`` and ``dist_tpu_sync`` reduce
  CUDA tensors on the card (NCCL); ``dist_sync``, ``dist_async`` and
  ``dist`` reduce a host copy over gloo, as MXNet 1.x's parameter servers
  reduce on the CPU (so processes that share one card can train
  together).  ``dist_async`` is synchronous, as the reference's is: it is
  the same store.  With ``set_optimizer`` the update is the per-key
  reduce-scatter / sharded update / all-gather
  (``parallel.distributed.ShardedOptimizerUpdater``), or under
  ``MXNET_ZERO=1`` the bucketed ZeRO-1 engine (``parallel.zero``).
  Without a process group the store is the local one, as the reference's
  is in one process.

Row-sparse keys live in host memory (``_HostRowSparseTable``):
``row_sparse_pull`` moves only the requested rows and a sparse push runs
the optimizer's own update on the touched rows (lazy updates).
"""
from __future__ import annotations

import io
import pickle

import numpy as _np
import torch

from . import fault
from . import telemetry
from .base import MXNetError, dtype_name
from .ndarray.ndarray import NDArray, invoke, waitall

__all__ = ["KVStore", "DistTPUSyncKVStore", "create", "TwoBitCompression",
           "Int8Compression"]

_PUSH_BYTES = telemetry.counter(
    "mxnet_kvstore_push_bytes_total", "bytes pushed (post-reduce, per key)")
_PULL_BYTES = telemetry.counter(
    "mxnet_kvstore_pull_bytes_total", "bytes pulled (per output)")
_PUSH_OPS = telemetry.counter("mxnet_kvstore_push_ops_total", "push calls")
_PULL_OPS = telemetry.counter("mxnet_kvstore_pull_ops_total", "pull calls")


def _nd_nbytes(v):
    from .ndarray.sparse import RowSparseNDArray

    t = v._rs_values if isinstance(v, RowSparseNDArray) else v._data
    return int(t.numel()) * t.element_size()


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _np_of(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _nd(arr, like=None):
    """An NDArray over a host numpy array, on ``like``'s device."""
    t = torch.from_numpy(_np.array(arr))
    if like is not None:
        t = t.to(like._data.device)
    return NDArray._wrap(t)


class _HostRowSparseTable:
    """Server-side weight of a row-sparse key, in host memory: pulls
    gather rows on the host and move only those rows; sparse pushes
    update only the gradient's rows.  ``bytes_h2d``/``bytes_d2h`` count
    the row traffic."""

    def __init__(self, dense_np):
        self.table = _np.array(dense_np)
        self.state = None
        self.sparse_pushes = 0
        self.bytes_h2d = 0
        self.bytes_d2h = 0


class KVStore:
    """Single-process KVStore (local/device/nccl semantics)."""

    def __init__(self, kind="local"):
        self._kind = kind
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._pending_host_state = {}
        # per-key traffic history: a key that saw a sparse push re-enters
        # the mixed path after a demote; a key with dense traffic is not
        # promoted by a row_sparse_pull
        self._sparse_push_counts = {}
        self._dense_pushed = set()

    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # -- core API ----------------------------------------------------------
    def init(self, key, value):
        from .ndarray.sparse import RowSparseNDArray

        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if isinstance(v, RowSparseNDArray):
                self._store[k] = _HostRowSparseTable(_np_of(v._dense()))
            else:
                self._store[k] = v.copy()

    def push(self, key, value, priority=0):
        """Sum the values pushed for each key into the store (and run the
        attached optimizer on the sum).  The entry seam ``kvstore.push``
        retries a transient fault before any state changes."""
        from .ndarray.sparse import RowSparseNDArray

        fault.guard("kvstore.push")
        _PUSH_OPS.inc()
        keys, grouped = _group_key_value(key, value)
        for k, vals in zip(keys, grouped):
            reduced = _reduce(vals)
            _PUSH_BYTES.inc(_nd_nbytes(reduced))
            sparse = isinstance(reduced, RowSparseNDArray)
            if not sparse:
                self._dense_pushed.add(k)
            if (sparse and self._updater is not None
                    and self._optimizer is not None
                    and self._compression is None
                    and getattr(self._optimizer, "lazy_update", False)
                    and not getattr(self, "_sharded_update", False)):
                host = self._ensure_host_table(k)
                self._sparse_lazy_update(k, host, reduced)
                continue
            if isinstance(self._store.get(k), _HostRowSparseTable):
                host = self._store[k]
                if (self._updater is not None
                        and self._optimizer is not None
                        and self._compression is None and not sparse
                        and host.sparse_pushes > 0
                        and not getattr(self, "_sharded_update", False)):
                    # a dense gradient on a key with sparse traffic:
                    # update every row in place, keeping the host state
                    self._host_dense_update(k, host, reduced)
                    continue
                self._store[k] = self._demote(k)
            if self._compression is not None:
                reduced = self._compression.round_trip(reduced, key=k)
            if self._updater is not None:
                self._updater(_key_int(k), reduced, self._store[k])
            else:
                self._store[k] = reduced

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy the stored value into every output."""
        fault.guard("kvstore.pull")
        _PULL_OPS.inc()
        keys, grouped = _group_key_value(key, out)
        for k, outs in zip(keys, grouped):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized in kvstore")
            src = self._store[k]
            if isinstance(src, _HostRowSparseTable):
                src = self._materialize(k)
            for o in outs:
                o._set(src._data.to(o._data.device, o._data.dtype))
                _PULL_BYTES.inc(_nd_nbytes(o))

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def _is_host_key(self, key):
        """True when ``key`` is a host row-sparse table (Trainer routes
        such keys around the buckets)."""
        return isinstance(self._store.get(str(key)), _HostRowSparseTable)

    def _discard_transient(self, key):
        """Drop a gradient bucket's stored value after its pull."""
        k = str(key)
        self._store.pop(k, None)
        self._dense_pushed.discard(k)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the requested rows: a host key gathers them on the
        host and moves only those."""
        if row_ids is None:
            return self.pull(key, out, priority)
        outs, rids, keys = _as_list(out), _as_list(row_ids), _as_list(key)
        if len(keys) == 1 and len(outs) > 1:
            keys = keys * len(outs)
        for k, o, r in zip(keys, outs, rids):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized in kvstore")
            src = self._store[k]
            if not isinstance(src, _HostRowSparseTable) and \
                    not getattr(self, "_sharded_update", False) and \
                    (self._sparse_push_counts.get(k, 0) > 0
                     or k not in self._dense_pushed):
                # promote only keys whose traffic is row-sparse: a dense
                # key alternating with row pulls stays on the device path
                src = self._ensure_host_table(k)
            if isinstance(src, _HostRowSparseTable):
                rid = _np.asarray(r._data.cpu() if isinstance(r, NDArray)
                                  else r).astype(_np.int64)
                rid = _np.clip(rid, 0, src.table.shape[0] - 1)
                rows = src.table[rid]
                src.bytes_h2d += rows.nbytes
                o._set(torch.from_numpy(rows).to(o._data.device,
                                                 o._data.dtype))
                continue
            src_local = src.as_in_context(o.context)
            rows = invoke("take", [src_local, r], {"axis": 0, "mode": "clip"})
            o._set(rows._data.to(o._data.dtype))

    # -- host row-sparse machinery -----------------------------------------
    def _ensure_host_table(self, k):
        cur = self._store[k]
        if isinstance(cur, _HostRowSparseTable):
            return cur
        host = _HostRowSparseTable(_np_of(cur._data))
        host.sparse_pushes = self._sparse_push_counts.get(k, 0)
        if k in self._pending_host_state:
            host.state = self._pending_host_state.pop(k)
        self._store[k] = host
        return host

    def _ensure_host_state(self, k, host, probe_nd):
        """Host mirrors of every optimizer-state leaf of key ``k``
        (adopting dense state the Updater already holds)."""
        if host.state is not None:
            return
        idx = _key_int(k)
        if self._updater is not None and idx in getattr(
                self._updater, "states", {}):
            adopted = self._updater.states.pop(idx)
            self._updater.states_synced.pop(idx, None)
            leaves, treedef = _flatten_state(adopted)
            host.state = ([None if lv is None else _np_of(lv._data)
                           for lv in leaves], treedef)
            return
        probe = self._optimizer.create_state_multi_precision(idx, probe_nd)
        leaves, treedef = _flatten_state(probe)
        host.state = ([None if lv is None else
                       _np.zeros((host.table.shape[0],)
                                 + tuple(lv.shape[1:]), _np_of(lv._data).dtype)
                       for lv in leaves], treedef)

    def _demote(self, k):
        """A host key back to an NDArray; its host state goes to the
        Updater."""
        host = self._store[k]
        if host.state is not None and self._updater is not None:
            leaves, treedef = host.state
            idx = _key_int(k)
            self._updater.states[idx] = _unflatten_state(
                [None if lv is None else _nd(lv) for lv in leaves], treedef)
            self._updater.states_synced[idx] = False
        return _nd(host.table)

    def _host_dense_update(self, k, host, grad):
        idx = _key_int(k)
        w_nd = _nd(host.table, grad)
        host.bytes_h2d += host.table.nbytes
        self._ensure_host_state(k, host, w_nd)
        leaves, treedef = host.state
        state = _unflatten_state([None if lv is None else _nd(lv, grad)
                                  for lv in leaves], treedef)
        self._optimizer.update_multi_precision(idx, w_nd, grad, state)
        host.table[...] = _np_of(w_nd._data)
        host.bytes_d2h += host.table.nbytes
        new_leaves, _ = _flatten_state(state)
        for lv, new in zip(leaves, new_leaves):
            if lv is not None and new is not None:
                lv[...] = _np_of(new._data)

    def _materialize(self, k, count=True):
        host = self._store[k]
        if count:
            host.bytes_h2d += host.table.nbytes
        return _nd(host.table)

    def _sparse_lazy_update(self, k, host, grad):
        """The optimizer's own update on the touched rows only (the
        reference's server-side lazy update)."""
        rows = _np_of(grad._rs_indices).astype(_np.int64)
        vals = _np_of(grad._rs_values)
        host.bytes_d2h += vals.nbytes
        if rows.size == 0:
            return
        uniq, inv = _np.unique(rows, return_inverse=True)
        if uniq.size != rows.size:
            merged = _np.zeros((uniq.size,) + vals.shape[1:], vals.dtype)
            _np.add.at(merged, inv, vals)
            rows, vals = uniq, merged
        idx = _key_int(k)
        host.sparse_pushes += 1
        self._sparse_push_counts[k] = self._sparse_push_counts.get(k, 0) + 1
        w_rows = host.table[rows]
        dev = grad._rs_values.device
        w_nd = NDArray._wrap(torch.from_numpy(w_rows).to(dev))
        g_nd = NDArray._wrap(torch.from_numpy(vals).to(dev))
        host.bytes_h2d += w_rows.nbytes + vals.nbytes
        self._ensure_host_state(k, host, w_nd)
        leaves, treedef = host.state
        slice_leaves = [None if lv is None else
                        NDArray._wrap(torch.from_numpy(lv[rows]).to(dev))
                        for lv in leaves]
        for lv in slice_leaves:
            if lv is not None:
                host.bytes_h2d += lv.size * lv._data.element_size()
        state = _unflatten_state(slice_leaves, treedef)
        self._optimizer.update_multi_precision(idx, w_nd, g_nd, state)
        new_w = _np_of(w_nd._data)
        host.table[rows] = new_w
        host.bytes_d2h += new_w.nbytes
        new_leaves, _ = _flatten_state(state)
        for lv, new in zip(leaves, new_leaves):
            if lv is not None and new is not None:
                arr = _np_of(new._data)
                lv[rows] = arr
                host.bytes_d2h += arr.nbytes

    # -- optimizer attach ---------------------------------------------------
    def set_optimizer(self, optimizer):
        """The store's own copy of the optimizer (a pickle round trip, as
        the reference ships it to its servers) and its Updater."""
        from . import optimizer as opt_mod

        optimizer = pickle.loads(pickle.dumps(optimizer))
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    def set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        ctype = compression_params.get("type", "2bit")
        if ctype == "2bit":
            self._compression = TwoBitCompression(
                float(compression_params.get("threshold", 0.5)))
        elif ctype == "int8":
            self._compression = Int8Compression()
        else:
            raise MXNetError(f"unknown gradient compression type {ctype}")

    # -- optimizer state io ---------------------------------------------------
    # Two variants, told apart by an explicit header: the updater's own
    # states blob (what Trainer.save_states writes), or the 8-byte magic
    # MXKVOPT1 and a pickled {"updater": blob, "host_states": {key:
    # state}, "zero": payload} when host row-sparse keys or ZeRO shards
    # hold state.  The ZeRO payload is dp- and plan-agnostic.
    _STATE_MAGIC = b"MXKVOPT1"

    def _optimizer_states_blob(self, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no updater attached")
        blob = self._updater.get_states(dump_optimizer)
        host = {k: v.state for k, v in self._store.items()
                if isinstance(v, _HostRowSparseTable) and v.state is not None}
        zero = getattr(self, "_zero", None)
        zero_payload = zero.state_payload() \
            if zero is not None and zero.has_state else None
        if host or zero_payload is not None:
            bundle = {"updater": blob, "host_states": host}
            if zero_payload is not None:
                bundle["zero"] = zero_payload
            return self._STATE_MAGIC + pickle.dumps(bundle)
        return blob

    def save_optimizer_states(self, fname, dump_optimizer=False):
        blob = self._optimizer_states_blob(dump_optimizer)
        with open(fname, "wb") as f:
            f.write(blob)

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no updater attached")
        with open(fname, "rb") as f:
            data = f.read()
        if data.startswith(self._STATE_MAGIC):
            obj = pickle.loads(data[len(self._STATE_MAGIC):])
            self._adopt_bundled_states(obj["updater"], obj["host_states"],
                                       obj.get("zero"))
            return
        # the one generation of bundled state before MXKVOPT1: a bare
        # pickled dict with a marker key (read without importing the
        # reference: the states unpickler maps its classes to the port's)
        from .optimizer.optimizer import _StatesUnpickler

        try:
            legacy = _StatesUnpickler(io.BytesIO(data)).load()
        except Exception:
            legacy = None
        if isinstance(legacy, dict) and "__kv_host_states__" in legacy:
            self._adopt_bundled_states(legacy["updater"],
                                       legacy["__kv_host_states__"])
        else:
            self._updater.set_states(data)

    def _adopt_host_states(self, host_states):
        self._pending_host_state.update(host_states)
        for k in list(self._pending_host_state):
            cur = self._store.get(k)
            if isinstance(cur, _HostRowSparseTable):
                cur.state = self._pending_host_state.pop(k)

    def _adopt_bundled_states(self, updater_blob, host_states,
                              zero_payload=None):
        from .parallel.distributed import ShardedOptimizerUpdater

        if zero_payload is not None and \
                isinstance(self._updater, ShardedOptimizerUpdater):
            # written by a ZeRO store, read by the per-key sharded
            # updater: both parts fold into its per-key shards
            from .optimizer.optimizer import _StatesUnpickler

            obj = _StatesUnpickler(io.BytesIO(updater_blob)).load()
            if isinstance(obj, tuple) and len(obj) == 2:
                states, self._updater.optimizer = obj
                self._optimizer = self._updater.optimizer
            else:
                states = obj
            self._updater.adopt_dense_states(states)
            self._updater.adopt_dense_states(zero_payload["members"])
            self._adopt_host_states(host_states)
            return
        self._updater.set_states(updater_blob)
        self._adopt_host_states(host_states)
        if zero_payload is None:
            return
        zero = getattr(self, "_zero", None)
        if zero is not None:
            zero.load_state_payload(zero_payload)
        else:
            from .parallel import zero as _zero

            _zero.fold_into_updater(self._updater, zero_payload)

    def barrier(self):
        waitall()

    def _send_command_to_servers(self, head, body):
        pass


class TwoBitCompression:
    """2-bit gradient quantization with an error-feedback residual per key
    (reference: ``src/kvstore/gradient_compression``): values at or beyond
    the threshold send +-threshold, the rest 0, and what was not sent
    carries into the key's next push."""

    def __init__(self, threshold=0.5):
        self.threshold = threshold
        self._residuals = {}

    def drop_residuals(self, match):
        for k in [k for k in self._residuals if match(k)]:
            del self._residuals[k]

    def round_trip(self, grad_nd, key=None):
        g = grad_nd._data
        r = self._residuals.get(key)
        if r is not None:
            g = g + r
        t = self.threshold
        q = torch.where(g >= t, torch.full_like(g, t),
                        torch.where(g <= -t, torch.full_like(g, -t),
                                    torch.zeros_like(g)))
        self._residuals[key] = g - q
        return NDArray._wrap(q)


class Int8Compression:
    """int8 symmetric quantization: inside the collective in a distributed
    store (``collectives.allreduce_hosts_quantized``), a round trip that
    models the same error in a local one."""

    def round_trip(self, grad_nd, key=None):
        from .parallel.collectives import _int8_quantize

        g = grad_nd._data
        q, scale = _int8_quantize(g)
        return NDArray._wrap((q.float() * scale).to(g.dtype))


class DistTPUSyncKVStore(KVStore):
    """The distributed store: a push is summed over every process (see the
    module docstring); ``rank``/``num_workers`` are the process group's."""

    _HOST_REDUCED = ("dist_sync", "dist_async", "dist")

    def __init__(self, kind="dist_tpu_sync"):
        super().__init__(kind)
        self._host_reduce = kind in self._HOST_REDUCED
        self._fuse_bucketer = None
        self._zero = None
        self._zero_bucketer = None
        self._zero_key_plans = {}
        self._zero_gen_seen = None
        self._sharded_update = False

    @staticmethod
    def _distributed():
        """True once a process group exists (of any size: one process in
        a group of one still goes through its collectives)."""
        import torch.distributed as dist

        return dist.is_available() and dist.is_initialized()

    @property
    def rank(self):
        from .parallel.collectives import rank

        return rank()

    @property
    def num_workers(self):
        from .parallel.collectives import world_size

        return world_size()

    def barrier(self):
        from .parallel.collectives import barrier

        waitall()
        barrier()

    def set_optimizer(self, optimizer):
        """The server-side optimizer as a reduce-scatter, a sharded update
        and an all-gather: per key (``ShardedOptimizerUpdater``), or per
        flat bucket under ``MXNET_ZERO=1`` (``ZeroBucketEngine``).  Other
        optimizers keep the replicated updater on the summed gradient."""
        from .parallel import distributed as _dist
        from .parallel import zero as _zero

        super().set_optimizer(optimizer)
        self._zero = None
        self._sharded_update = False
        if _zero.zero_enabled() and _zero.supports(self._optimizer):
            self._zero = _zero.ZeroBucketEngine(self._optimizer,
                                                host=self._host_reduce)
            self._zero.adopt = _zero.updater_adopter(self._updater)
        elif _dist.supports_sharded_update(self._optimizer):
            self._updater = _dist.ShardedOptimizerUpdater(
                self._optimizer, host=self._host_reduce)
            self._sharded_update = True

    def push(self, key, value, priority=0):
        from .ndarray.sparse import RowSparseNDArray
        from .parallel import bucketing as _bucketing

        fault.guard("kvstore.push")
        _PUSH_OPS.inc()
        keys, grouped = _group_key_value(key, value)
        reduced_list = [_reduce(vals) for vals in grouped]
        for reduced in reduced_list:
            _PUSH_BYTES.inc(_nd_nbytes(reduced))
        for k, reduced in zip(keys, reduced_list):
            if not isinstance(reduced, RowSparseNDArray):
                self._dense_pushed.add(k)
            if isinstance(self._store.get(k), _HostRowSparseTable):
                self._store[k] = self._demote(k)
        zero_set = set()
        if self._zero is not None and self._updater is not None:
            zero_set = {k for k, red in zip(keys, reduced_list)
                        if not isinstance(red, RowSparseNDArray)
                        and _bucketing.float_kind(red.dtype)}
        sharded = self._sharded_update and self._updater is not None
        dist = self._distributed()
        if dist and not sharded:
            # ZeRO keys are summed inside their reduce-scatter; the call
            # stays unconditional, so every process issues the same
            # collectives whatever the partition
            idxs = [j for j, k in enumerate(keys) if k not in zero_set]
            sub = self._allreduce_bucketed(
                [reduced_list[j] for j in idxs], [keys[j] for j in idxs])
            for j, v in zip(idxs, sub):
                reduced_list[j] = v
        # int8 compression happened inside the collective: quantizing the
        # sum again would add its error twice
        already = dist and not sharded and \
            isinstance(self._compression, Int8Compression)
        zero_batch = []
        for k, reduced in zip(keys, reduced_list):
            if k in zero_set:
                if self._compression is not None:
                    reduced = self._compression.round_trip(reduced, key=k)
                zero_batch.append((k, reduced))
                continue
            if sharded:
                if self._compression is not None:
                    reduced = self._compression.round_trip(reduced, key=k)
                self._updater(_key_int(k), reduced, self._store[k])
                continue
            if self._compression is not None and not already:
                reduced = self._compression.round_trip(reduced, key=k)
            if self._updater is not None:
                self._updater(_key_int(k), reduced, self._store[k])
            else:
                self._store[k] = reduced
        if zero_batch:
            self._zero_push(zero_batch)

    def _zero_push(self, batch):
        """ZeRO-1 server-side update of dense float ``(key, reduced)``
        pairs: a multi-key push rides one shared Bucketer (its generation
        tags the shards; a replan retires the old generation), a one-key
        push a stable one-key plan."""
        from .parallel import bucketing as _bucketing

        if len(batch) > 1:
            for k, _ in batch:
                old = self._zero_key_plans.pop(k, None)
                if old is not None:
                    self._zero.retire(("key", k, old[2]))
            entries = [(k, tuple(v.shape), v.dtype) for k, v in batch]
            if self._zero_bucketer is None:
                self._zero_bucketer = _bucketing.Bucketer()
            plan = self._zero_bucketer.plan_for(entries)
            gen = self._zero_bucketer.generation
            prev = self._zero_gen_seen
            if prev != gen:
                self._zero_gen_seen = gen
                if prev is not None:
                    self._zero.retire(("gen", prev))
            vals = dict(batch)
            for b in plan.buckets:
                self._zero_step_bucket(("gen", gen), b, vals)
            return
        k, reduced = batch[0]
        if self._zero_gen_seen is not None:
            self._zero.retire(("gen", self._zero_gen_seen))
            self._zero_gen_seen = None
        sig = (tuple(reduced.shape), reduced.dtype)
        entry = self._zero_key_plans.get(k)
        if entry is None or entry[0] != sig:
            version = 0
            if entry is not None:
                version = entry[2] + 1
                self._zero.retire(("key", k, entry[2]))
            (bucket,) = _bucketing.assign_buckets(
                [(k, sig[0], sig[1])],
                cap_bytes=_bucketing.bucket_cap_bytes()).buckets
            entry = (sig, bucket, version)
            self._zero_key_plans[k] = entry
        self._zero_step_bucket(("key", k, entry[2]), entry[1],
                               {k: reduced})

    def _zero_step_bucket(self, tag, bucket, vals):
        from .parallel import bucketing as _bucketing

        flat = _bucketing.pack([vals[k]._data for k in bucket.keys])
        w_flat = _bucketing.pack([self._store[k]._data
                                  for k in bucket.keys])
        new_flat = self._zero.step_bucket(
            tag, bucket, [flat], w_flat,
            opt_keys=[_key_int(k) for k in bucket.keys])
        for k, part in zip(bucket.keys, _bucketing.unpack(bucket, new_flat)):
            old = self._store[k]
            self._store[k] = NDArray._wrap(part.to(old._data.dtype).clone())

    def load_optimizer_states(self, fname):
        super().load_optimizer_states(fname)
        if self._zero is not None:
            from .parallel import zero as _zero

            new_opt = self._updater.optimizer
            if _zero.kind_of(new_opt) != self._zero._kind:
                # the file swapped the optimizer class: rebuild the engine
                engine = None
                if _zero.supports(new_opt):
                    engine = _zero.ZeroBucketEngine(new_opt,
                                                    host=self._host_reduce)
                    engine.adopt = _zero.updater_adopter(self._updater)
                self._zero = engine
                self._zero_bucketer = None
                self._zero_key_plans = {}
                self._zero_gen_seen = None
            else:
                self._zero.optimizer = new_opt
            self._optimizer = new_opt

    def _allreduce_bucketed(self, nds, keys=None):
        """Sum the values over every process.  Values of at most
        ``MXNET_KVSTORE_BIGARRAY_BOUND`` elements ride dtype-segregated
        flat buckets capped at ``MXNET_ALLREDUCE_BUCKET_MB`` (a plan
        computed in push order and cached, identical on every process);
        larger values, and everything at a cap of 0, get their own
        collective.  Fused bytes are counted once per bucket."""
        from . import env
        from .parallel import bucketing as _bucketing
        from .parallel import collectives as _coll

        bound = env.kvstore_bigarray_bound()
        cap = _bucketing.bucket_cap_bytes()
        int8 = isinstance(self._compression, Int8Compression)
        host = self._host_reduce
        reduce_fn = _coll.allreduce_hosts_quantized if int8 else \
            _coll.allreduce_hosts
        vals = [nd._data for nd in nds]
        out = list(vals)
        done = set()
        small = [i for i, v in enumerate(vals) if v.numel() <= bound] \
            if cap > 0 else []
        if len(small) > 1:
            entries = [(keys[i] if keys is not None else i,
                        tuple(vals[i].shape), dtype_name(vals[i].dtype))
                       for i in small]
            if self._fuse_bucketer is None:
                self._fuse_bucketer = _bucketing.Bucketer()
            plan = self._fuse_bucketer.plan_for(entries)
            pos = {e[0]: i for e, i in zip(entries, small)}
            for b in plan.buckets:
                if not b.fused:
                    continue
                members = [pos[k] for k in b.keys]
                if int8:
                    fused = _coll.allreduce_hosts_quantized_multi(
                        [vals[i] for i in members], host=host)
                    for i, v in zip(members, fused):
                        out[i] = v
                else:
                    summed = reduce_fn(
                        _bucketing.pack([vals[i] for i in members]),
                        host=host)
                    for i, part in zip(members,
                                       _bucketing.unpack(b, summed)):
                        out[i] = part
                _bucketing.record_fused(b.nbytes)
                done.update(members)
        for i in range(len(vals)):
            if i not in done:
                out[i] = reduce_fn(vals[i], host=host)
        return [NDArray._wrap(v) for v in out]


_KVSTORE_REG = {}
for _name in ("local", "device", "nccl", "local_allreduce_cpu",
              "local_allreduce_device"):
    _KVSTORE_REG[_name] = KVStore
for _name in ("dist_sync", "dist_device_sync", "dist_async", "dist_tpu_sync",
              "dist_sync_device", "dist"):
    _KVSTORE_REG[_name] = DistTPUSyncKVStore


def create(name="local"):
    """A KVStore by type string (reference: KVStore::Create)."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    if name not in _KVSTORE_REG:
        raise MXNetError(f"unknown kvstore type {name!r}; known: "
                         f"{', '.join(_KVSTORE_REG)}")
    return _KVSTORE_REG[name](name)


# --------------------------------------------------------------------------
def _key_value(key, value):
    keys = _as_list(key)
    values = _as_list(value)
    if len(keys) == 1 and len(values) > 1:
        raise MXNetError("single key with multiple values: use push for "
                         "multi-device values")
    return [str(k) for k in keys], values


def _group_key_value(key, value):
    """Values grouped per key (reference: KVStoreLocal::GroupKVPairs)."""
    keys = [str(k) for k in _as_list(key)]
    values = _as_list(value)
    if len(keys) == 1:
        return keys, [values]
    if len(values) == len(keys):
        return keys, [[v] if not isinstance(v, (list, tuple)) else list(v)
                      for v in values]
    if len(values) % len(keys) == 0:
        per = len(values) // len(keys)
        return keys, [values[i * per:(i + 1) * per] for i in range(len(keys))]
    raise MXNetError("cannot group keys with values")


def _reduce(vals):
    from .ndarray.sparse import RowSparseNDArray, add_rowsparse

    if all(isinstance(v, RowSparseNDArray) for v in vals):
        if len(vals) == 1:
            return vals[0].copy()
        acc = vals[0]
        for v in vals[1:]:
            acc = add_rowsparse(acc, v)
        return acc
    if len(vals) == 1:
        return vals[0].copy()
    acc = vals[0]._data.detach().clone()
    for v in vals[1:]:
        acc = acc + v._data.to(acc.device)
    return NDArray._wrap(acc)


def _key_int(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _flatten_state(state):
    """(leaves, treedef) of an optimizer state (None / NDArray / tuple /
    list)."""
    if state is None:
        return [None], "none"
    if isinstance(state, (tuple, list)):
        return list(state), ("seq", isinstance(state, tuple), len(state))
    return [state], "single"


def _unflatten_state(leaves, treedef):
    if treedef == "none":
        return None
    if treedef == "single":
        return leaves[0]
    _, is_tuple, n = treedef
    seq = list(leaves[:n])
    return tuple(seq) if is_tuple else seq
