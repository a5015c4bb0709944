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
Parameters stay replicated (``param_sharding="replicated"``); ``fsdp``
sharding, ``plan=``, ``pipeline=`` and the compile cache come with the
second multi-GPU slice (ROADMAP A6).
"""
from __future__ import annotations

import time
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
from .functional import functionalize, rematerialize

__all__ = ["TrainStep", "make_sgd_update", "make_adam_update"]


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
        if pipeline is not None:
            if remat:
                raise MXNetError(
                    "TrainStep(remat=True) does not compose with pipeline=; "
                    "use pipeline={'remat_stage': True} for per-stage "
                    "rematerialization inside the pipe")
            raise MXNetError("TrainStep(pipeline=...): pipelining comes with "
                             "the second multi-GPU slice (ROADMAP A6)")
        if plan is not None or extra_param_specs or \
                param_sharding != "replicated":
            raise MXNetError(
                "TrainStep(plan= / extra_param_specs= / param_sharding="
                f"{param_sharding!r}): sharded parameters come with the "
                "planner of the second multi-GPU slice (ROADMAP A6); this "
                "slice replicates them")
        self._device = resolve_device(device)
        self._mesh = mesh
        self._batch_axes = tuple(a for a in batch_axes
                                 if mesh is not None and a in mesh.shape)
        self._bucketer = None
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
        grad_req = {name: p.grad_req
                    for name, p in net.collect_params().items()}
        # the net's own order, for naming parameters in messages (the
        # names' counters do not sort as the blocks were made)
        self._net_order = {name: i for i, name in enumerate(grad_req)}
        self.train_params = OrderedDict(
            (k, v.detach().to(self._device, copy=True).requires_grad_())
            for k, v in params.items() if grad_req[k] != "null")
        self.rest_params = OrderedDict(
            (k, v.detach().to(self._device, copy=True))
            for k, v in params.items() if grad_req[k] == "null")
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
        if mesh is not None:
            self._replicate_from_rank0()
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

    # -- data parallelism over the mesh --------------------------------
    def _dp_size(self):
        return self._mesh.axis_size(self._batch_axes) \
            if self._batch_axes else 1

    def _sum_dp(self, t):
        from . import collectives

        return collectives.psum(t, self._batch_axes, self._mesh)

    def _replicate_from_rank0(self):
        """Every process starts from process 0's parameter values (one
        sum a dtype bucket, the other processes contributing zeros)."""
        from . import collectives

        if collectives._dist() is None:
            return
        first = self._mesh.axis_ranks(self._batch_axes)[0] \
            if self._batch_axes else collectives.rank()
        mine = collectives.rank() == first
        tensors = list(self.params.values())
        with torch.no_grad():
            summed = self._sum_buckets(
                [t if mine else torch.zeros_like(t) for t in tensors],
                scale=None)
            for t, v in zip(tensors, summed):
                t.copy_(v)

    def _sum_buckets(self, grads, scale):
        """The sums over the batch axes of ``grads`` (times ``scale``),
        in dtype-segregated flat buckets, each reduced in place (a lone
        member's bucket is a view of the tensor itself)."""
        from . import bucketing

        entries = [(i, tuple(g.shape), str(g.dtype).replace("torch.", ""))
                   for i, g in enumerate(grads)]
        if self._bucketer is None:
            self._bucketer = bucketing.Bucketer()
        from . import collectives

        plan = self._bucketer.plan_for(entries)
        out = list(grads)
        for b in plan.buckets:
            flat = collectives.psum_(
                bucketing.pack([grads[i] for i in b.keys]),
                self._batch_axes, self._mesh)
            if scale is not None and scale != 1.0:
                flat.mul_(scale)
            if b.fused:
                bucketing.record_fused(b.nbytes)
            for i, part in zip(b.keys, bucketing.unpack(b, flat)):
                out[i] = part
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

    def _step_local(self, x, y, data_parallel):
        train = list(self.train_params.values())
        read = set()
        with torch.enable_grad():
            p = dict(self.rest_params)
            p.update(self.train_params)
            with self._amp_scope():
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
            n = self._dp_size()
            with torch.no_grad():
                grads = self._sum_buckets(grads, scale=1.0 / n)
                loss = self._sum_dp(loss.detach()) / n
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

    def write_back(self):
        """Copy the trained values back into the Gluon net's Parameters."""
        merged = self.params
        for name, p in self._net.collect_params().items():
            if name in merged:
                p.data()._set(merged[name])
