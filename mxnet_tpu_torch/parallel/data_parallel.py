"""Fused training step on one device (counterpart of
``mxnet_tpu/parallel/data_parallel.py``): forward through the
functionalized net, backward with torch autograd, and the optimizer update
over all trainable tensors at once, in one call per step.

The master weights and optimizer state are fp32 tensors the step owns; with
``dtype="bfloat16"`` the model's forward runs under the AMP cast policy
(``contrib.amp``), its outputs are cast back to fp32 and the loss is fp32,
as in the reference.  ``remat=True`` recomputes the whole forward in the
backward instead of storing its activations.  ``run()`` drives the step
over an iterator of batches through the device prefetcher, polling
``lifecycle.check_stop()`` at every step boundary and, with a guard, the
loss sentinel.  The first call of each batch signature counts the step's
FLOPs (``introspection``); every call accounts them.

``mesh=`` (``parallel.make_mesh()``) makes the step data-parallel over
the processes of the mesh's batch axes (``dp``, ``fsdp``), one process a
device: each process passes its own shard of the global batch, as the
reference's multi-process workers do.  The parameters start from process
0's values; after the backward the gradients are summed in flat buckets
(``parallel.bucketing``, capped by ``MXNET_ALLREDUCE_BUCKET_MB``) and
divided by the process count, and the loss is averaged, so loss and
gradients are those of the global batch.  Training-mode BatchNorm
normalises by the moments of the global batch in forward and backward
(``ops.nn.BATCH_STATS``), as GSPMD makes the reference's sharded jit do.

Sharded parameters (``plan=``, a ``planner.ShardingPlan``, or the legacy
``param_sharding="fsdp"`` / a dict of specs, which become a plan through
``ShardingPlan.from_specs`` as in the reference; ``extra_param_specs``
applies last).  The reference gets its layouts from GSPMD; here each rank
runs its layout itself and holds only its tile of each split parameter
and of that parameter's optimizer state.  ``self.execution`` names how
each parameter runs:

- ``local``: replicated; its gradient summed over the batch axes;
- ``tp``: the plan holds the net's whole Megatron layout
  (``net.tensor_parallel_specs``) and the net runs it as tensor
  parallelism under ``tensor_parallel.tp_scope`` (column-parallel
  q/k/v/gate/up/lm_head, the attention on the rank's own heads,
  row-parallel o/down summed over ``tp``, the embedding and the logits
  gathered);
- ``gathered``: any other split (``fsdp``, a user's dict): the whole
  tensor all-gathered before use, its gradient reduce-scattered over the
  batch axes it is split on; this computes what GSPMD computes.

``pipeline={'num_microbatches': M, 'axis': 'pp', 'schedule': 'gpipe' |
'1f1b', 'remat_stage': bool}`` streams the net's uniform trunk over the
``pp`` axis (``net.pipeline_decompose``; ``pipeline_parallel``): each pp
rank holds its own stage's layers, the embedding and head run on every pp
rank, and the batch axes compose with it.  The compile cache has no
counterpart (there is nothing to compile ahead).
"""
from __future__ import annotations

import time
import warnings
from collections import OrderedDict
from contextlib import nullcontext
from functools import partial

import numpy as _np
import torch

from .. import autograd as _ag
from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import Block
from ..ndarray.ndarray import NDArray
from . import collectives as _collectives
from .functional import functionalize, rematerialize
from .mesh import AXES, PartitionSpec, Placement

__all__ = ["TrainStep", "make_sgd_update", "make_adam_update",
           "replicated_specs", "fsdp_specs"]


def make_sgd_update(lr=0.01, momentum=0.9, wd=0.0):
    """(init, update) of TrainStep's SGD: g += wd * p; m = momentum * m + g;
    p -= lr * m.  ``update(params, grads, state)`` works in place on the
    lists of parameters and state (grads are only read)."""

    def init(params):
        return {"mom": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(params, grads, state):
        if wd:
            # out of place: autograd may hand two parameters one tensor
            grads = torch._foreach_add(grads, params, alpha=wd)
        torch._foreach_mul_(state["mom"], momentum)
        torch._foreach_add_(state["mom"], grads)
        torch._foreach_add_(params, state["mom"], alpha=-lr)

    return init, update


def make_adam_update(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, wd=0.0):
    """(init, update) of TrainStep's Adam, the reference's formula:
    g += wd * p; m = beta1 * m + (1 - beta1) * g; v = beta2 * v +
    (1 - beta2) * g * g; p -= lr * (m / c1) / (sqrt(v / c2) + eps) with
    c1, c2 the bias corrections.  In place as make_sgd_update, one
    ``_foreach`` call per operation over all tensors (not ~8 ops per
    tensor)."""

    def init(params):
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params], "t": 0}

    @torch.no_grad()
    def update(params, grads, state):
        state["t"] += 1
        c1 = 1.0 - beta1 ** state["t"]
        c2 = 1.0 - beta2 ** state["t"]
        m, v = state["m"], state["v"]
        if wd:
            grads = torch._foreach_add(grads, params, alpha=wd)
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, grads, alpha=1 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - beta2)
        denom = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(m, c1)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-lr)

    return init, update


def _float_outputs(out):
    """Every floating tensor of ``out`` (a tensor or a tuple) in fp32; the
    rest unchanged."""
    if isinstance(out, (tuple, list)):
        return type(out)(_float_outputs(o) for o in out)
    return out.float() if out.is_floating_point() else out


def replicated_specs(params):
    """Every parameter replicated."""
    return OrderedDict((k, PartitionSpec()) for k in params)


def fsdp_specs(params, mesh, axis="fsdp"):
    """Each parameter's first dim that divides by the ``fsdp`` axis split
    over it (the ZeRO-3 layout); small or indivisible parameters
    replicated.  The planner's ``fsdp`` rule set, as in the reference."""
    from .planner.rules import RuleSet

    rs = RuleSet(heuristic_axis=axis, name="fsdp")
    sizes = dict(mesh.shape)
    return OrderedDict((k, PartitionSpec(*rs.spec_for(k, v.shape, sizes)))
                       for k, v in params.items())


def _trim(spec):
    """A spec without its trailing ``None`` entries."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


_DIGEST_CHUNK = 1 << 24


def _digest(t):
    """Two int64 sums over ``t``'s bits (plain and position-weighted): equal
    on two ranks iff their tensors agree, but for a collision."""
    w = t.detach().reshape(-1)
    view = {8: torch.int64, 4: torch.int32, 2: torch.int16,
            1: torch.uint8}[w.element_size()]
    w = w.view(view)
    s1 = s2 = 0
    for i in range(0, w.numel(), _DIGEST_CHUNK):
        c = w[i:i + _DIGEST_CHUNK].long()
        pos = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
        s1 += int(c.sum())
        s2 += int((c * pos).sum())
    return (s1 + (1 << 63)) % (1 << 64) - (1 << 63), \
        (s2 + (1 << 63)) % (1 << 64) - (1 << 63)


class _GatherParam(torch.autograd.Function):
    """A split parameter gathered whole before use; its gradient summed
    over the batch axes it is split on by a reduce-scatter, and cut to
    this rank's tile along the others (where every rank computed the same
    whole gradient)."""

    @staticmethod
    def forward(ctx, local, placement, batch_axes, host):
        ctx.meta = (placement, batch_axes, host)
        return placement.gather(local, host=host)

    @staticmethod
    def backward(ctx, g):
        placement, batch_axes, host = ctx.meta
        mesh = placement.mesh
        for d, axes in placement.split_dims():
            bax = tuple(a for a in axes if a in batch_axes)
            if bax == axes:
                g = _collectives.reduce_scatter(g, axes, d, mesh, host)
                continue
            if bax:
                g = _collectives.psum(g, bax, mesh, host)
            g = g.chunk(mesh.axis_size(axes), d)[mesh.axis_index(axes)]
        return g.contiguous(), None, None, None


class TrainStep:
    """One fused training step for a Gluon net on one device.

    Usage::

        step = TrainStep(net, loss_fn, optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1,
                                           "momentum": 0.9},
                         dtype="bfloat16")
        loss = step(x, y)      # numpy, tensor or NDArray batch
        step.write_back()      # sync trained values into the Gluon net

    ``loss_fn(outputs, labels)`` is a function on tensors or a Gluon loss;
    the step minimizes the mean of what it returns.  ``outputs`` is what
    the net returns (a tuple for a net with several heads); under
    ``dtype`` every floating output is cast back to fp32 first.  Batches
    are staged onto the device unchanged (integer ids stay integers).  The
    step copies the net's parameters onto ``device`` (default the first
    CUDA card; raises without one) and trains those copies; BatchNorm
    moving stats are threaded through as state when ``train_mode``.
    Dropout draws its masks from the device's generator
    (``mxnet_tpu_torch.random``): the same seed gives the same step, with
    ``remat`` or without.

    Gradients: a trainable parameter the forward never read (a block that
    was not called, such as BERT's token-type embedding without token
    types) gets a zero gradient, as under the reference's ``jax.grad``.
    A parameter the forward read but the loss has no gradient for (its
    path was detached, or its output was left unused) raises
    :class:`MXNetError` naming it, instead of training on zeros.
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 train_mode=True, dtype=None, device=None, pipeline=None,
                 remat=False, mesh=None, param_sharding="replicated",
                 extra_param_specs=None, batch_axes=("dp", "fsdp"),
                 plan=None):
        if remat and pipeline is not None:
            raise MXNetError(
                "TrainStep(remat=True) does not compose with pipeline=; "
                "use pipeline={'remat_stage': True} for per-stage "
                "rematerialization inside the pipe")
        # plan first: the plan supplies the mesh and the batch axes
        self._plan = plan
        if plan is not None:
            if mesh is None:
                mesh = plan.build_mesh()
            else:
                for ax, size in plan.axes.items():
                    if size != mesh.shape.get(ax, 1):
                        raise MXNetError(
                            f"plan axis {ax}={size} does not match the "
                            f"mesh ({dict(mesh.shape)}) — build the mesh "
                            "with plan.build_mesh() or re-plan")
            batch_axes = tuple(plan.batch_axes)
        self._device = resolve_device(device)
        self._mesh = mesh
        self._bucketer = {}
        self._net = net
        self._loss_fn = loss_fn
        self._apply_fn, params = functionalize(net, train_mode=train_mode,
                                               with_state=train_mode)
        if remat:
            # whole-model rematerialization; a model with finer-grained
            # remat (Llama's per-layer checkpoint) has its own option
            base_apply = self._apply_fn

            def remat_apply(p, *inputs, read=None):
                return rematerialize(
                    lambda *a: base_apply(p, *a, read=read), *inputs)

            self._apply_fn = remat_apply
        self._with_state = train_mode
        self._pipeline = None
        if pipeline is not None:
            if mesh is None:
                raise MXNetError("pipeline parallelism needs a mesh")
            pp_axis = pipeline.get("axis", "pp")
            if pp_axis not in mesh.shape:
                raise MXNetError(f"mesh has no {pp_axis!r} axis")
            self._pipeline = {
                "M": int(pipeline["num_microbatches"]),
                "axis": pp_axis,
                "schedule": pipeline.get("schedule", "gpipe"),
                "remat_stage": bool(pipeline.get("remat_stage", False)),
                "decomp": net.pipeline_decompose(mesh.shape[pp_axis],
                                                 train_mode=train_mode),
            }
            if self._pipeline["schedule"] not in ("gpipe", "1f1b"):
                raise MXNetError(f"unknown pipeline schedule "
                                 f"{self._pipeline['schedule']!r}")
            batch_axes = tuple(a for a in batch_axes if a != pp_axis)
        self._batch_axes = tuple(a for a in batch_axes
                                 if mesh is not None and a in mesh.shape)
        grad_req = {name: p.grad_req
                    for name, p in net.collect_params().items()}
        # the net's own order, for naming parameters in messages (the
        # names' counters do not sort as the blocks were made)
        self._net_order = {name: i for i, name in enumerate(grad_req)}
        opt = dict(optimizer_params or {})
        if optimizer == "sgd":
            init, self._update = make_sgd_update(
                lr=opt.get("learning_rate", 0.01),
                momentum=opt.get("momentum", 0.0), wd=opt.get("wd", 0.0))
        elif optimizer == "adam":
            init, self._update = make_adam_update(
                lr=opt.get("learning_rate", 1e-3),
                beta1=opt.get("beta1", 0.9), beta2=opt.get("beta2", 0.999),
                eps=opt.get("epsilon", 1e-8), wd=opt.get("wd", 0.0))
        else:
            raise MXNetError(f"TrainStep optimizer {optimizer!r} not "
                             f"supported (use 'sgd' or 'adam', or the "
                             f"imperative Trainer)")
        # the net's own tensors: each is copied (or its tile cut and
        # copied) onto the device once, at the end
        full = OrderedDict((k, v.detach()) for k, v in params.items())
        self.execution = OrderedDict((k, "local") for k in full)
        self._place = {}
        self._tp = False
        self._host = False
        if mesh is not None:
            self._host = self._device.type == "cuda" and \
                _collectives.needs_host(torch.empty(0, device=self._device))
            if plan is None:
                plan = self._legacy_plan(params, mesh, param_sharding,
                                         batch_axes, optimizer, opt)
            missing = [k for k in params if k not in plan.specs]
            if missing and plan.specs:
                # a plan keyed on another net instance's names would
                # replicate everything without a word
                warnings.warn(
                    f"sharding plan covers none of/only part of this "
                    f"net's params ({len(missing)}/{len(params)} "
                    f"missing, e.g. {missing[0]!r}); missing params "
                    "replicate. Re-plan from THIS net's signature "
                    "(planner.signature_of) — gluon auto-name prefixes "
                    "differ between instances.", stacklevel=2)
            self._plan = plan
            specs = plan.partition_specs(params.keys())
            if extra_param_specs:
                specs.update((k, PartitionSpec(*v))
                             for k, v in extra_param_specs.items())
            self._layout(net, specs, grad_req)
            self._open_groups(specs)
            full = self._replicate_from_rank0(full)
            self._shapes = {k: (tuple(v.shape), v.dtype)
                            for k, v in full.items()}
            full = self._owned(full)
            for k in list(full):
                if k in self._place:
                    full[k] = self._place[k].shard(full[k])
        full = OrderedDict((k, v.to(self._device, copy=True).contiguous())
                           for k, v in full.items())
        self.train_params = OrderedDict(
            (k, v.requires_grad_()) for k, v in full.items()
            if grad_req[k] != "null")
        self.rest_params = OrderedDict(
            (k, v) for k, v in full.items() if grad_req[k] == "null")
        self.opt_state = init(list(self.train_params.values()))
        self._dtype = dtype
        if dtype is None:
            self._amp_scope = nullcontext
        else:
            from ..contrib.amp import _cast_scope

            self._amp_scope = partial(_cast_scope, dtype)
        self.step_count = 0
        self._flops = {}          # signature -> FLOPs of one step

    @property
    def params(self):
        merged = OrderedDict(self.rest_params)
        merged.update(self.train_params)
        return merged

    def _stage(self, v):
        if isinstance(v, NDArray):
            v = v._data
        elif not isinstance(v, torch.Tensor):
            v = torch.from_numpy(_np.asarray(v))
        return v.to(self._device, non_blocking=True)

    def _loss(self, out, y):
        if isinstance(self._loss_fn, Block):
            with _ag._scope(recording=True):
                return self._loss_fn(NDArray._wrap(out),
                                     NDArray._wrap(y))._data
        return self._loss_fn(out, y)

    def __call__(self, x, y):
        """One step on the batch (x, y); returns the loss, a 0-d fp32
        tensor on the device.  The first call of a signature (the batch's
        shapes and dtypes) counts the step's FLOPs
        (``introspection.counting``); every call accounts them
        (``mxnet_executable_flops_total{kind="train_step"}``, the MFU
        gauge)."""
        from .. import introspection as _introspection
        from .. import telemetry as _telemetry

        x, y = self._stage(x), self._stage(y)
        sig = (tuple(x.shape), str(x.dtype), tuple(y.shape), str(y.dtype))
        flops = self._flops.get(sig)
        if sig in self._flops or len(self._flops) >= 4096:
            loss = self._step(x, y)
        else:
            t0 = time.perf_counter()
            with _introspection.counting() as rec:
                loss = self._step(x, y)
            flops = self._flops[sig] = rec["flops"]
            _telemetry.compile_event(
                "train_step", type(self._net).__name__,
                time.perf_counter() - t0,
                "new_step" if len(self._flops) == 1 else "new_shape")
        _introspection.account_flops(flops, kind="train_step")
        return loss

    # -- layouts over the mesh -----------------------------------------
    def _legacy_plan(self, params, mesh, param_sharding, batch_axes,
                     optimizer, opt):
        """The legacy modes (``param_sharding``) resolved as the
        reference resolves them, then wrapped as a plan, so every sharded
        step reads one layout object."""
        from . import planner as _planner

        if param_sharding == "fsdp":
            specs = fsdp_specs(params, mesh)
        elif param_sharding == "replicated":
            specs = replicated_specs(params)
        elif isinstance(param_sharding, dict):
            specs = OrderedDict((k, param_sharding.get(k, PartitionSpec()))
                                for k in params)
        else:
            raise MXNetError(f"bad param_sharding {param_sharding!r}")
        return _planner.ShardingPlan.from_specs(
            dict(mesh.shape), specs, batch_axes,
            _planner.signature_of(params),
            optimizer=("adam" if optimizer == "adam" else
                       ("sgd_momentum" if opt.get("momentum") else "sgd")))

    def _layout(self, net, specs, grad_req):
        """How each parameter runs (``self.execution``): ``local``
        (replicated), ``tp`` (Megatron tensor parallelism: the whole net's
        Megatron layout is in the plan and the net runs it,
        ``tensor_parallel_specs``) or ``gathered`` (every other split: the
        whole tensor all-gathered before use, its gradient
        reduce-scattered back).  The running state (grad_req null) stays
        whole."""
        mesh = self._mesh
        tp_n = mesh.shape.get("tp", 1)
        want = None
        if tp_n > 1 and self._pipeline is None and \
                hasattr(net, "tensor_parallel_specs"):
            want = net.tensor_parallel_specs(tp_n)
            self._tp = bool(want) and all(
                _trim(specs.get(k, ())) == _trim(v) for k, v in want.items())
        for k, spec in specs.items():
            pl = Placement(mesh, spec)
            if grad_req.get(k, "null") == "null" or not pl.split_dims():
                continue
            self._place[k] = pl
            self.execution[k] = "tp" if self._tp and k in want \
                else "gathered"
        # the batch axes each gradient is still to be summed over (a
        # reduce-scatter over a batch axis has summed it already)
        live = tuple(a for a in self._batch_axes if mesh.shape[a] > 1)
        self._grad_axes = {}
        for k in self.execution:
            done = set()
            if self.execution[k] == "gathered":
                for _, axes in self._place[k].split_dims():
                    done.update(a for a in axes if a in live)
            self._grad_axes[k] = tuple(a for a in live if a not in done)

    def _open_groups(self, specs):
        """Make every process group this step uses, in one order on every
        rank (a group is made by all processes at once)."""
        mesh = self._mesh
        need = {AXES, tuple(self._batch_axes)}
        need.update((a,) for a in AXES)
        for spec in specs.values():
            for _, axes in Placement(mesh, spec).split_dims():
                need.add(axes)
                need.add(tuple(a for a in axes if a in self._batch_axes))
        need.update(self._grad_axes.values())
        for axes in sorted(need, key=repr):
            if axes and mesh.axis_size(axes) > 1:
                mesh.group(axes)

    def _owned(self, full):
        """The parameters this rank holds: under a pipeline, the pre and
        post parameters and its own stage's layers'."""
        if self._pipeline is None:
            return full
        d = self._pipeline["decomp"]
        axis = self._pipeline["axis"]
        S = self._mesh.axis_size(axis)
        s = self._mesh.axis_index(axis)
        per = len(d["layer_names"]) // S
        self._stage_layers = list(range(s * per, (s + 1) * per))
        self._layer_owner = {name: li // per
                             for li, names in enumerate(d["layer_names"])
                             for name in names.values()}
        return OrderedDict((k, v) for k, v in full.items()
                           if self._layer_owner.get(k, s) == s)

    # -- data parallelism over the mesh --------------------------------
    def _dp_size(self):
        return self._mesh.axis_size(self._batch_axes) \
            if self._batch_axes else 1

    def _sum_dp(self, t):
        return _collectives.psum(t, self._batch_axes, self._mesh,
                                 self._host)

    def _replicate_from_rank0(self, full):
        """Every process starts from process 0's parameter values (one
        sum a dtype bucket over the mesh, the other processes contributing
        zeros), unless a digest of every tensor shows the processes
        already agree bit for bit (ranks that built the net from one
        seed).  Returns the tensors to start from."""
        if _collectives._dist() is None or not full:
            return full
        dig = torch.tensor([v for t in full.values() for v in _digest(t)],
                           dtype=torch.int64, device=self._device)
        rows = _collectives.all_gather(dig, AXES, axis=0, tiled=False,
                                       mesh=self._mesh, host=self._host)
        if bool((rows == rows[0]).all()):
            return full
        first = int(self._mesh.devices.flat[0])
        mine = _collectives.rank() == first
        tensors = [t.to(self._device, copy=True) for t in full.values()]
        with torch.no_grad():
            summed = self._sum_buckets(
                [t if mine else torch.zeros_like(t) for t in tensors],
                None, AXES)
            for t, v in zip(tensors, summed):
                t.copy_(v)
        return OrderedDict(zip(full, tensors))

    def _sum_buckets(self, grads, scale, axes):
        """The sums over ``axes`` of ``grads`` (times ``scale``), in
        dtype-segregated flat buckets, each reduced in place (a lone
        member's bucket is a view of the tensor itself)."""
        from . import bucketing

        entries = [(i, tuple(g.shape), str(g.dtype).replace("torch.", ""))
                   for i, g in enumerate(grads)]
        key = tuple(axes)
        if key not in self._bucketer:
            self._bucketer[key] = bucketing.Bucketer()
        plan = self._bucketer[key].plan_for(entries)
        out = list(grads)
        for b in plan.buckets:
            flat = _collectives.psum_(
                bucketing.pack([grads[i] for i in b.keys]), axes,
                self._mesh, self._host)
            if scale is not None and scale != 1.0:
                flat.mul_(scale)
            if b.fused:
                bucketing.record_fused(b.nbytes)
            for i, part in zip(b.keys, bucketing.unpack(b, flat)):
                out[i] = part
        return out

    def _reduce_grads(self, grads):
        """The global batch's mean gradients: each summed over the batch
        axes it is not yet summed over, all divided by the batch ranks."""
        n = self._dp_size()
        groups = OrderedDict()
        for i, k in enumerate(self.train_params):
            groups.setdefault(self._grad_axes[k], []).append(i)
        out = list(grads)
        for axes, idx in groups.items():
            if axes:
                summed = self._sum_buckets([grads[i] for i in idx], 1.0 / n,
                                           axes)
            else:
                summed = [grads[i] / n if n != 1 else grads[i]
                          for i in idx]
            for i, g in zip(idx, summed):
                out[i] = g
        return out

    def _step(self, x, y):
        if self._batch_axes:
            from ..ops import nn as _nn

            _nn.BATCH_STATS.reduce = self._sum_dp
            _nn.BATCH_STATS.world = self._dp_size()
            try:
                return self._step_local(x, y, True)
            finally:
                _nn.BATCH_STATS.reduce = None
        return self._step_local(x, y, False)

    def _inputs(self):
        """The tensors the forward reads: local and tensor-parallel
        parameters as this rank holds them, the others gathered whole."""
        p = dict(self.rest_params)
        for k, t in self.train_params.items():
            pl = self._place.get(k)
            p[k] = t if pl is None or self.execution[k] == "tp" else \
                _GatherParam.apply(t, pl, self._batch_axes, self._host)
        return p

    def _pipelined(self, p, x):
        """Embedding, this rank's pipeline stage, head (``pipeline=``)."""
        from .pipeline_parallel import run_stage

        cfg = self._pipeline
        d = cfg["decomp"]
        h = d["pre_fn"]({k: p[k] for k in d["pre_names"]}, x)
        stage = [{k0: p[d["layer_names"][li][k0]]
                  for k0 in d["layer0_names"]} for li in self._stage_layers]

        def stage_fn(layers, hh):
            for lp in layers:
                hh = d["layer_fn"](lp, hh)
            return hh

        h = run_stage(stage_fn, stage, h, self._mesh, cfg["M"],
                      axis=cfg["axis"], remat_stage=cfg["remat_stage"],
                      schedule=cfg["schedule"], host=self._host)
        return d["post_fn"]({k: p[k] for k in d["post_names"]}, h)

    def _step_local(self, x, y, data_parallel):
        from .tensor_parallel import tp_scope

        train = list(self.train_params.values())
        read = set()
        scope = partial(tp_scope, self._mesh, "tp", self._host) \
            if self._tp else nullcontext
        with torch.enable_grad(), scope():
            p = self._inputs()
            with self._amp_scope():
                if self._pipeline is not None:
                    out, state = self._pipelined(p, x), {}
                else:
                    res = self._apply_fn(p, x, read=read)
                    out, state = res if self._with_state else (res, {})
            if self._dtype is not None:
                out = _float_outputs(out)
            loss = self._loss(out, y).mean()
            grads = torch.autograd.grad(loss, train, allow_unused=True)
        cut = sorted((name for name, g in zip(self.train_params, grads)
                      if g is None and name in read),
                     key=self._net_order.__getitem__)
        if cut:
            raise MXNetError(
                f"TrainStep: the forward read {len(cut)} trainable "
                f"parameter(s) the loss has no gradient for (a detached "
                f"path, or an unused output): {', '.join(cut[:8])}")
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(train, grads)]
        if data_parallel:
            # the global batch's mean loss and gradients: sums over the
            # processes, divided by their count
            with torch.no_grad():
                grads = self._reduce_grads(grads)
                loss = self._sum_dp(loss.detach()) / self._dp_size()
        self._update(train, grads, self.opt_state)
        for k, v in state.items():
            self.rest_params[k] = v
        self.step_count += 1
        return loss.detach()

    def run(self, batches, steps=None, prefetch=0, guard=None):
        """Drive the step over an iterator of ``(x, y)`` batches, the next
        ``prefetch`` batches staged to the card in the background
        (:class:`..gluon.data.PrefetchIterator`; ``None`` resolves the
        ``prefetch_buffer`` tuning knob).  The default, 0, stages each
        batch in turn on the caller's stream: on BERT's 32 KB token batches
        the pipeline's thread and side stream cost more than the copies
        they hide, and on ResNet-50's 154 MB image batches from
        ``io.ImageRecordIter`` (whose decode pool already reads ahead)
        depth 2 was no faster.  Returns the per-step losses (device
        scalars; the card is synchronised once, at the end, so a failed
        step raises here).

        With ``steps=N`` the loop stops after N batches; up to
        ``prefetch`` more may already be staged, and ``close()`` drops
        them: callers splitting one iterator over several ``run`` calls
        pass ``prefetch=0``.

        ``guard`` (a :class:`..guard.Guard`; default a fresh one when
        ``MXNET_GUARD=1``) polls the loss sentinel after every step
        (``Guard.poll_loss``: one host read of the loss a step).  The
        fused step commits its update before a verdict can land, so an
        anomaly cannot be skipped here: a persistent one escalates to
        :class:`..guard.GuardRewind`, which ``run_with_recovery`` absorbs
        as a rewind from the latest valid checkpoint.

        Preemption: every step boundary polls ``lifecycle.check_stop()``;
        on a stop the loop returns the losses so far, and the caller
        (``lifecycle.stop_requested()`` is then true) publishes its final
        checkpoint and raises ``lifecycle.GracefulExit``.  A failure dumps
        the flight recorder's black box before it propagates."""
        from .. import flight_recorder as _flight
        from .. import guard as _guard_mod
        from .. import lifecycle as _lifecycle
        from ..gluon.data.prefetcher import PrefetchIterator

        if guard is None and _guard_mod.enabled():
            guard = _guard_mod.Guard()
        losses = []
        try:
            it = PrefetchIterator(iter(batches), depth=prefetch,
                                  device=self._device)
            try:
                while steps is None or len(losses) < steps:
                    if _lifecycle.check_stop():
                        break
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    losses.append(self(batch[0], batch[1]))
                    if guard is not None:
                        guard.poll_loss(losses[-1], step=len(losses))
            finally:
                it.close()
            if losses:
                losses[-1].item()   # the one sync, so a step error is ours
        except _lifecycle.GracefulExit:
            raise
        except Exception:
            _flight.dump_blackbox("train_step_failure")
            raise
        return losses

    def gathered_params(self):
        """Every parameter whole, in the net's order (a collective: every
        rank calls it at the same point): split ones gathered, a
        pipeline's other stages' layers brought from their ranks."""
        merged = self.params
        out = OrderedDict()
        with torch.no_grad():
            for k in sorted(merged, key=self._net_order.get):
                t = merged[k]
                pl = self._place.get(k)
                out[k] = t if pl is None else pl.gather(t, host=self._host)
            if self._pipeline is not None:
                axis = self._pipeline["axis"]
                s = self._mesh.axis_index(axis)
                for k in sorted(self._layer_owner, key=self._net_order.get):
                    shape, dtype = self._shapes[k]
                    t = out[k] if self._layer_owner[k] == s else \
                        torch.zeros(shape, dtype=dtype, device=self._device)
                    out[k] = _collectives.psum(t, axis, self._mesh,
                                               self._host)
        return OrderedDict((k, out[k]) for k in
                           sorted(out, key=self._net_order.get))

    def write_back(self):
        """Copy the trained values back into the Gluon net's Parameters
        (whole: under a mesh a collective, as :meth:`gathered_params`)."""
        merged = self.gathered_params() if self._mesh is not None \
            else self.params
        for name, p in self._net.collect_params().items():
            if name in merged:
                p.data()._set(merged[name])
