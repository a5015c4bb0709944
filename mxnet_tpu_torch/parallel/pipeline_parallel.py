"""Pipeline parallelism over the ``pp`` mesh axis, GPipe and 1F1B
(counterpart of ``mxnet_tpu/parallel/pipeline_parallel.py``).

Each ``pp`` rank runs one stage: it holds that stage's parameters
(weight-stationary) and streams the M microbatches through them.
Activations move to the next stage's rank by ``collectives.send`` /
``recv``; the backward runs over the reverse ring, each stage taking the
cotangent of its output from the next stage and sending the cotangent of
its input to the previous one.  A stage starts a microbatch as soon as its
input has arrived, so the stages overlap as the reference's tick loop
makes them (bubble share (S-1)/(M+S-1)), and no stage ever runs on a
bubble's placeholder (the reference's NaN-safe double ``where`` has
nothing to guard here).

Two schedules, the reference's:

- ``schedule='gpipe'`` (default): the forward keeps each microbatch's
  autograd graph (or, under ``remat_stage=True``, recomputes the stage's
  activations inside it) and the backward walks the graphs;
- ``schedule='1f1b'``: the forward stashes only each microbatch's stage
  input; the backward recomputes the stage one microbatch at a time and
  back-propagates it at once, so at most one microbatch's activations are
  alive (the memory property 1F1B exists for).

The last stage's output is handed to every ``pp`` rank (a sum over
``pp`` in which the other stages contribute zeros), so the heterogeneous
ends of a model (embedding, head, loss) run replicated on each stage's
rank, as the reference runs them outside its ``shard_map``; the
cotangent of the first stage's input is handed back the same way.

Composes with data parallelism: ranks along the batch axes run their own
pipelines on their own microbatches.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["pipeline_apply", "stack_stage_params"]


def _tree_map(fn, *trees):
    head = trees[0]
    if isinstance(head, dict):
        return type(head)((k, _tree_map(fn, *(t[k] for t in trees)))
                          for k in head)
    if isinstance(head, (list, tuple)):
        return type(head)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _rebuild(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def stack_stage_params(per_stage_params):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    axis (what :func:`pipeline_apply` takes)."""
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def _cotangent(d_out, m):
    """The output cotangent the last stage seeds microbatch ``m``'s
    backward with."""
    return d_out[m]


class _Run:
    """One pipelined call: the stage function, this rank's stage and the
    axis it streams over."""

    def __init__(self, stage_fn, tree, mesh, axis, M, schedule, remat,
                 host):
        self.stage_fn, self.tree = stage_fn, tree
        self.mesh, self.axis, self.M = mesh, axis, M
        self.schedule, self.remat, self.host = schedule, remat, host
        self.S = mesh.axis_size(axis)
        self.s = mesh.axis_index(axis)

    def stage(self, params, h):
        p = _rebuild(self.tree, params)
        if self.remat:
            from .functional import rematerialize

            return rematerialize(lambda t: self.stage_fn(p, t), h)
        return self.stage_fn(p, h)

    def _send(self, t, to):
        from . import collectives

        collectives.send(t.detach(), to, self.axis, self.mesh, self.host)

    def _recv(self, like, frm):
        from . import collectives

        return collectives.recv(like, frm, self.axis, self.mesh, self.host)

    def forward(self, xs, params):
        from . import collectives

        S, s, M = self.S, self.s, self.M
        keep = self.schedule == "gpipe"
        stash, outs = [], []
        req = [p.detach().requires_grad_(p.requires_grad) for p in params]
        for m in range(M):
            inp = xs[m] if s == 0 else self._recv(xs[m], s - 1)
            if keep:
                inp = inp.detach().requires_grad_()
                with torch.enable_grad():
                    out = self.stage(req, inp)
                stash.append((inp, out))
            else:
                with torch.no_grad():
                    out = self.stage(params, inp)
                stash.append(inp)
            if s < S - 1:
                self._send(out, s + 1)
            else:
                outs.append(out.detach())
        ys = torch.stack(outs) if s == S - 1 else torch.zeros_like(xs)
        # the last stage's output, on every stage's rank
        ys = collectives.psum(ys, self.axis, self.mesh, self.host)
        return ys, stash, req

    def backward(self, stash, req, d_out, params, xs):
        from . import collectives

        S, s, M = self.S, self.s, self.M
        dxs = torch.zeros_like(xs)
        dps = [None] * len(params)
        for m in reversed(range(M)):
            g = _cotangent(d_out, m) if s == S - 1 else \
                self._recv(xs[m], s + 1)
            if self.schedule == "gpipe":
                inp, out = stash[m]
                leaves = req
            else:
                inp = stash[m].detach().requires_grad_()
                leaves = [p.detach().requires_grad_(p.requires_grad)
                          for p in params]
                with torch.enable_grad():
                    out = self.stage(leaves, inp)
            wrt = [inp] + [p for p in leaves if p.requires_grad]
            grads = list(torch.autograd.grad(out, wrt, g,
                                             allow_unused=True))
            dx = grads.pop(0)
            dx = torch.zeros_like(inp) if dx is None else dx
            it = iter(grads)
            for i, p in enumerate(leaves):
                if not p.requires_grad:
                    continue
                gp = next(it)
                if gp is not None:
                    dps[i] = gp if dps[i] is None else dps[i] + gp
            stash[m] = None             # this microbatch's graph is done
            if s > 0:
                self._send(dx, s - 1)
            else:
                dxs[m] = dx
        # the first stage's input cotangent, on every stage's rank
        dxs = collectives.psum(dxs, self.axis, self.mesh, self.host)
        return dxs, dps


class _Pipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, xs, *params):
        ys, stash, req = run.forward(xs, params)
        ctx.run, ctx.stash, ctx.req = run, stash, req
        ctx.save_for_backward(xs, *params)
        return ys

    @staticmethod
    def backward(ctx, d_out):
        xs, *params = ctx.saved_tensors
        dxs, dps = ctx.run.backward(ctx.stash, ctx.req, d_out.contiguous(),
                                    params, xs)
        ctx.stash = ctx.req = None
        return (None, dxs, *dps)


def run_stage(stage_fn, stage_tree, x, mesh, num_microbatches, axis="pp",
              remat_stage=False, schedule="gpipe", host=None):
    """The pipeline of :func:`pipeline_apply` with this rank's own stage
    parameters ``stage_tree`` (a tree of tensors, no stage axis): the
    weight-stationary form ``TrainStep(pipeline=)`` runs.  Returns the
    last stage's output for ``x``, on every ``pp`` rank."""
    from . import collectives

    if schedule not in ("gpipe", "1f1b"):
        raise MXNetError(f"unknown pipeline schedule {schedule!r}")
    M = int(num_microbatches)
    if x.shape[0] % M:
        raise MXNetError(f"batch {x.shape[0]} not divisible by "
                         f"num_microbatches {M}")
    if host is None:
        host = collectives.needs_host(x)
    params = _leaves(stage_tree)
    run = _Run(stage_fn, stage_tree, mesh, axis, M, schedule, remat_stage,
               host)
    xs = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
    ys = _Pipe.apply(run, xs, *params)
    return ys.reshape(x.shape)


class _SelectStage(torch.autograd.Function):
    """Row ``s`` of a stacked stage leaf; the gradient comes back to the
    whole stacked leaf on every ``pp`` rank (each rank's row summed over
    ``pp``), as the reference's replicated stage tree gets it."""

    @staticmethod
    def forward(ctx, leaf, s, mesh, axis, host):
        ctx.meta = (leaf.shape, s, mesh, axis, host)
        return leaf[s]

    @staticmethod
    def backward(ctx, g):
        from . import collectives

        shape, s, mesh, axis, host = ctx.meta
        full = torch.zeros(shape, dtype=g.dtype, device=g.device)
        full[s] = g
        return collectives.psum(full, axis, mesh, host), None, None, None, \
            None


def pipeline_apply(stage_fn, stage_params, x, mesh, num_microbatches,
                   axis="pp", remat_stage=False, schedule="gpipe",
                   batch_axes=(), in_jit_sharding=None):
    """Run ``stage_fn`` as an S-stage pipeline over the mesh's ``pp``
    axis.

    ``stage_fn(params_one_stage, x_mb) -> y_mb``, ``y_mb`` of ``x_mb``'s
    shape (homogeneous stages; the heterogeneous ends of a model run
    outside, see ``TrainStep(pipeline=)``).  ``stage_params``: a tree whose
    leaves are (S, ...); each rank runs row ``mesh.axis_index(axis)``.
    ``x``: this rank's batch, its leading dim divisible by
    ``num_microbatches``; the ranks along ``batch_axes`` each pass their
    own shard (the reference shards one global batch over them).  Returns
    ``stage_{S-1}(...stage_0(x))`` on every ``pp`` rank.
    ``in_jit_sharding`` is the reference's layout flag: accepted, and
    both values run this pipeline."""
    from . import collectives

    S = mesh.axis_size(axis)
    n_stages = {leaf.shape[0] for leaf in _leaves(stage_params)}
    if n_stages != {S}:
        raise MXNetError(
            f"stage_params leading dim {sorted(n_stages)} must equal the "
            f"pp axis size {S} (one stage per device)")
    host = collectives.needs_host(x)
    s = mesh.axis_index(axis) if S > 1 else 0
    mine = _tree_map(lambda leaf: _SelectStage.apply(leaf, s, mesh, axis,
                                                     host), stage_params)
    return run_stage(stage_fn, mine, x, mesh, num_microbatches, axis=axis,
                     remat_stage=remat_stage, schedule=schedule, host=host)
