"""The cache entries of a hybridized HybridBlock (counterpart of the
reference's jit-compiled cached op, ``mxnet_tpu/gluon/block.py``
``_call_cached_op`` / ``_build_cache``).

An entry runs the block's functionalized forward
(``parallel.functional.functionalize``): the parameters are read from a
name -> tensor dict, running-state updates (BatchNorm's statistics) come
back as values and are written into their Parameters after the call.

- :class:`FunctionalForward` (CPU tensors) runs it as it is, recorded by
  torch autograd while ``autograd.record()`` is on.
- :class:`GraphForward` (CUDA tensors) captures it in a CUDA graph.  The
  graph reads the parameters by address and the inputs from static copies;
  every call copies the inputs in, replays, and returns fresh tensors.
  Under ``record()`` the forward and the backward are captured together
  (the ``torch.cuda.make_graphed_callables`` pattern) and a call is one
  node of the tape, whose backward replays the backward graph and hands
  each parameter and input its gradient.  The backward reads the
  activations the graph keeps, so a recorded call made while an earlier
  call's backward is still to run replays another capture of the same
  forward (a discriminator run on real and on fake data, a siamese net).
  The port's generator of the card is registered with the graphs, so a
  replay draws its dropout masks from it, the same masks an eager run
  draws from the same state.

A graph's backward has no double backward: under ``create_graph=True``
the node recomputes the forward from its saved inputs (and the
generator's state at the call) and differentiates that, so second-order
gradients are exact.  A forward that cannot be captured (a host read, a
shape that depends on values) raises MXNetError naming the block and the
cause; it never runs eagerly instead.
"""
from __future__ import annotations

import gc
import weakref

import torch

from .. import _kernels
from .._tree import flatten, unflatten
from .. import random as _random
from ..base import MXNetError
from ..ndarray import ndarray as _ndm

__all__ = ["FunctionalForward", "GraphForward"]

WARMUP = 2          # eager runs on a side stream before a capture


def _renew_generators(device):
    """After a capture that ended in an error: the generators it
    registered (the port's and torch's default of ``device``) may be left
    in capture mode, where any draw fails; give each a fresh state at the
    same seed and offset."""
    _random._renew(device)
    default = torch.cuda.default_generators[device.index or 0]
    fresh = torch.Generator(device=device)
    fresh.set_state(default.get_state())
    default.graphsafe_set_state(fresh.graphsafe_get_state())


def _write_state(plist, state):
    by_name = dict(plist)
    with torch.no_grad():
        for name, value in state.items():
            by_name[name]._nd._data.copy_(value)


class FunctionalForward:
    """The functionalized forward, run as it is (CPU tensors)."""

    def __init__(self, apply_fn, plist, in_spec):
        self._apply_fn = apply_fn
        self._plist = plist
        self._in_spec = in_spec

    def __call__(self, leaves, recording):
        params = {name: p._nd._data for name, p in self._plist}
        with torch.set_grad_enabled(recording):
            out, state = self._apply_fn(
                params, *unflatten(self._in_spec, leaves))
        _write_state(self._plist, state)
        return flatten(out)


class _GraphNode(torch.autograd.Function):
    """One call of a recorded GraphForward on the tape: ``tensors`` are the
    differentiable parameters, then every input."""

    @staticmethod
    def forward(ctx, entry, rng, *tensors):
        outs = entry.replay(tensors[entry.n_diff:])
        ctx.entry, ctx.rng = entry, rng
        entry.pending = weakref.ref(ctx)
        ctx.save_for_backward(*tensors[entry.n_diff:])
        ctx.mark_non_differentiable(*(o for o, req in zip(outs, entry.out_req)
                                      if not req))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        entry = ctx.entry
        inputs = ctx.saved_tensors
        if torch.is_grad_enabled():       # create_graph: a double backward
            return (None, None) + entry.recompute_grads(inputs, ctx.rng,
                                                        grads)
        return (None, None) + entry.replay_backward(grads)


class GraphForward:
    """The functionalized forward captured in a CUDA graph, with its
    backward when built under ``record()`` (CUDA tensors)."""

    def __init__(self, name, apply_fn, plist, leaves, in_spec, recording):
        self.name = name
        self._apply_fn = apply_fn
        self._plist = plist
        self._in_spec = in_spec
        self._recording = recording
        device = leaves[0].device if leaves else \
            plist[0][1]._nd._data.device
        self._params = {n: p._nd._data for n, p in plist}
        self._diff = [t for t in self._params.values()
                      if recording and t.requires_grad]
        self.n_diff = len(self._diff)
        # the capture reads the parameters through aliases of their memory
        # that are leaves of its own: a live tape's gradient accumulators of
        # the parameters belong to the default stream, not the capture's
        self._static_params = {n: t.detach().requires_grad_(
            recording and t.requires_grad) for n, t in self._params.items()}
        self._gen = _random.generator(device)
        self.pending = None       # the tape node of the last recorded call
        self._spare = None        # the next capture of the same forward
        self._static_in = [t.detach().clone().requires_grad_(
            recording and t.requires_grad) for t in leaves]
        self._capture(device)

    # -- capture -----------------------------------------------------------
    def _run(self):
        with torch.set_grad_enabled(self._recording):
            out, state = self._apply_fn(
                self._static_params,
                *unflatten(self._in_spec, self._static_in))
        leaves, out_spec = flatten(out)
        return leaves, out_spec, state

    def _grad_targets(self):
        return [t for t in self._static_params.values() if t.requires_grad] \
            + [s for s in self._static_in if s.requires_grad]

    def _capture(self, device):
        rng = self._gen.get_state()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                leaves, _, _ = self._run()
                req = [o for o in leaves if o.requires_grad]
                if req and self._grad_targets():
                    torch.autograd.grad(req, self._grad_targets(),
                                        [torch.ones_like(o) for o in req],
                                        allow_unused=True)
                del leaves, req
        torch.cuda.current_stream(device).wait_stream(side)
        self._gen.set_state(rng)
        pool = torch.cuda.graph_pool_handle()
        self._fwd = torch.cuda.CUDAGraph()
        self._fwd.register_generator_state(self._gen)
        before = _kernels.launch_counts()
        _ndm._CAPTURE.block = self.name
        # no garbage collection inside a capture: freeing another graph's
        # memory there can end the capture in an error
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self._fwd, pool=pool):
                leaves, self._out_spec, state = self._run()
            self.out_req = [o.requires_grad for o in leaves]
            self._bwd = None
            req = [o for o in leaves if o.requires_grad]
            if self._recording and req and self._grad_targets():
                self._static_gout = [torch.empty_like(o) for o in req]
                self._bwd = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self._bwd, pool=pool):
                    self._static_grads = torch.autograd.grad(
                        req, self._grad_targets(), self._static_gout,
                        allow_unused=True)
            # the capture's autograd graph is spent: keep no node of it
            # (its parameters' accumulators belong to the capture's stream)
            self._static_out = [o.detach() for o in leaves]
            self._static_state = {k: v.detach() for k, v in state.items()}
        except Exception as e:
            _renew_generators(device)
            if isinstance(e, MXNetError):
                raise
            root = e
            while root.__context__ is not None:
                root = root.__context__
            raise MXNetError(
                f"hybridized block {self.name!r} cannot be captured in a "
                f"CUDA graph: {root!r}") from e
        finally:
            _ndm._CAPTURE.block = None
            if gc_was_on:
                gc.enable()
        after = _kernels.launch_counts()
        # the capture recorded these launches without running them; each
        # replay runs them
        self.launches = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        _kernels.add_launches({k: -n for k, n in self.launches.items()})
        self.replays = 0

    # -- calls -------------------------------------------------------------
    def replay(self, inputs):
        """Copy ``inputs`` in, replay the forward, write the running state
        back; fresh copies of the outputs."""
        with torch.no_grad():
            for s, x in zip(self._static_in, inputs):
                s.copy_(x)
        self._fwd.replay()
        self.replays += 1
        _kernels.add_launches(self.launches)
        _write_state(self._plist, self._static_state)
        return [o.detach().clone() for o in self._static_out]

    def replay_backward(self, grads):
        if self._bwd is None:
            return (None,) * (self.n_diff + len(self._static_in))
        with torch.no_grad():
            for s, g in zip(self._static_gout,
                            (g for g, req in zip(grads, self.out_req)
                             if req)):
                s.copy_(g)
        self._bwd.replay()
        res = iter(g.detach().clone() if g is not None else None
                   for g in self._static_grads)
        out = [next(res) for _ in range(self.n_diff)]
        out += [next(res) if s.requires_grad else None
                for s in self._static_in]
        return tuple(out)

    def recompute_grads(self, inputs, rng, grads):
        """The gradients of a call, recomputed eagerly from its saved
        ``inputs`` and the generator's state ``rng`` at the call, with
        their own graph (for ``create_graph=True``)."""
        now = self._gen.get_state()
        self._gen.set_state(rng)
        try:
            out, _ = self._apply_fn(self._params,
                                    *unflatten(self._in_spec, inputs))
        finally:
            self._gen.set_state(now)
        leaves = flatten(out)[0]
        pairs = [(o, g) for o, g in zip(leaves, grads) if o.requires_grad]
        targets = self._diff + [x for x in inputs if x.requires_grad]
        res = iter(torch.autograd.grad(
            [o for o, _ in pairs], targets, [g for _, g in pairs],
            create_graph=True, allow_unused=True))
        out = [next(res) for _ in range(self.n_diff)]
        out += [next(res) if x.requires_grad else None for x in inputs]
        return tuple(out)

    def _busy(self):
        """Whether the last recorded call's backward is still to run: its
        tape node is alive and has not freed what it saved."""
        node = self.pending() if self.pending is not None else None
        if node is None:
            return False
        try:
            node.saved_tensors
        except RuntimeError:      # freed by a backward without retain_graph
            return False
        return True

    def __call__(self, leaves, recording):
        if not recording:
            return self.replay(leaves), self._out_spec
        if self._busy():
            if self._spare is None:
                self._spare = GraphForward(self.name, self._apply_fn,
                                           self._plist, leaves,
                                           self._in_spec, True)
            return self._spare(leaves, recording)
        rng = self._gen.get_state()
        outs = _GraphNode.apply(self, rng, *self._diff, *leaves)
        return list(outs), self._out_spec
