"""A pool of spawned CPU processes joined in one gloo process group, for
the port's data-parallel tests (``tests/test_torch_{collectives,kvstore,
zero,dist_train}.py``), and the tasks they run there.

Each worker sets ``torch.set_num_threads(1)``, joins the group through a
``FileStore`` under the test's temporary directory (no TCP port to
collide with under xdist) and runs tasks until it is told to stop, then
destroys the group.  A task is a function of this module (or, named
``module.function``, of another test-side module such as
``torch_sharded_tasks``) called as ``fn(rank, world, *args)``; its result
(numpy, numbers, dicts) goes back to the parent, one per rank.  This
module imports ``torch`` and the port, never ``jax`` or the reference, so
the workers never do either.
"""
from __future__ import annotations

import os
import queue
import traceback

import numpy as np

TIMEOUT_S = 120


def _task(name):
    """A task of this module by name, or ``module.function`` of another
    test-side module (``torch_sharded_tasks``)."""
    if "." in name:
        import importlib

        mod, _, fn = name.rpartition(".")
        return getattr(importlib.import_module(mod), fn)
    return globals()[name]


def _worker(rank, world, store_path, tasks, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ["MXNET_WORKER_ID"] = str(rank)
    os.environ["MXNET_NUM_WORKERS"] = str(world)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            name, args = item
            try:
                out = ("ok", _task(name)(rank, world, *args))
            except BaseException:   # the parent re-raises it
                out = ("err", traceback.format_exc())
            results.put((rank, out))
    finally:
        dist.destroy_process_group()


class DistPool:
    """``world`` spawned CPU processes in one gloo group."""

    def __init__(self, world, tmp_dir):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world)]
        store = os.path.join(str(tmp_dir), f"store_w{world}")
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, world, store, self._tasks[r],
                                         self._results))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, name, *args, per_rank=None):
        """Run task ``name`` on every rank; ``per_rank[r]`` (a tuple) is
        appended to rank r's arguments.  Returns the results by rank;
        raises with every failing rank's traceback."""
        dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
        if dead:
            raise RuntimeError(f"task {name}: ranks {dead} of the pool are "
                               f"gone (an earlier task failed or hung)")
        for r, q in enumerate(self._tasks):
            extra = tuple(per_rank[r]) if per_rank is not None else ()
            q.put((name, tuple(args) + extra))
        out, errs = [None] * self.world, []
        for _ in range(self.world):
            r, status, value = self._next_result(name)
            if status == "err":
                errs.append(f"rank {r}:\n{value}")
            out[r] = value
        if errs:
            raise RuntimeError("\n".join(errs))
        return out

    def _next_result(self, name):
        """The next rank's answer; kills the pool and raises when none
        comes in ``TIMEOUT_S`` or a rank dies meanwhile."""
        waited = 0.0
        while True:
            try:
                r, (status, value) = self._results.get(timeout=1.0)
                return r, status, value
            except queue.Empty:
                waited += 1.0
            dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
            if dead or waited >= TIMEOUT_S:
                self.close(kill=True)
                raise TimeoutError(
                    f"task {name}: ranks {dead} died" if dead else
                    f"task {name}: no answer in {TIMEOUT_S} s")

    def close(self, kill=False):
        for p, q in zip(self._procs, self._tasks):
            if p.is_alive() and not kill:
                q.put(None)
        for p in self._procs:
            p.join(timeout=0 if kill else 30)
            if p.is_alive():
                p.kill()
                p.join()


# --------------------------------------------------------------------------
# helpers of the tasks
# --------------------------------------------------------------------------
def _np(t):
    import torch

    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _with_env(env, fn):
    prev = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        return fn()
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _mlp(weights, width, hidden, out):
    """The port's two-layer MLP with the reference's weights (in
    ``collect_params`` order)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon import load_reference_params

    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(hidden, activation="relu", in_units=width),
            gluon.nn.Dense(out, in_units=hidden))
    net.initialize(ctx=mx.cpu())
    net(nd.zeros((1, width), ctx=mx.cpu()))
    load_reference_params(net, weights)
    return net


def _shard(a, rank, world):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def _params(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


# --------------------------------------------------------------------------
# tasks
# --------------------------------------------------------------------------
def t_collectives(rank, world, inputs):
    """Every collective of the port on this rank's slice of ``inputs``
    (arrays of leading dim ``world``): returns {name: numpy}."""
    import torch

    from mxnet_tpu_torch.parallel import collectives as c

    c.reset_issued()
    x = torch.from_numpy(inputs["x"][rank])
    m = torch.from_numpy(inputs["m"][rank])
    ring = [(i, (i + 1) % world) for i in range(world)]
    out = {
        "psum": c.psum(x),
        "pmean": c.pmean(x),
        "all_gather": c.all_gather(x, axis=0, tiled=True),
        "all_gather_stack1": c.all_gather(x, axis=1, tiled=False),
        "reduce_scatter": c.reduce_scatter(m),
        "ppermute": c.ppermute(x, ring, axis_name="dp"),
        "ppermute_half": c.ppermute(x, [(0, world - 1)], axis_name="dp"),
        "all_to_all": c.all_to_all(m, axis_name="dp", split_axis=0,
                                   concat_axis=1),
        "hosts": c.allreduce_hosts(inputs["x"][rank]),
        "any": np.asarray(c.allreduce_any(rank == world - 1)),
        "none": np.asarray(c.allreduce_any(False)),
        "q8": c.allreduce_hosts_quantized(x),
        "q8_multi": torch.cat([v.reshape(-1) for v in
                               c.allreduce_hosts_quantized_multi(
                                   [x, m * 1e-3])]),
    }
    # a dp x fsdp = (world / 2) x 2 mesh: the sum over dp in a subgroup
    from mxnet_tpu_torch.parallel import make_mesh

    out["psum_dp_of_fsdp2"] = c.psum(x, "dp", mesh=make_mesh(fsdp=2))
    c.barrier()
    # the gradient of a sum is the sum of the gradients
    xg = x.clone().requires_grad_()
    (c.psum(xg) * (rank + 1)).sum().backward()
    out["psum_grad"] = xg.grad
    res = {k: _np(v) for k, v in out.items()}
    res["issued"] = c.issued()
    return res


def t_kv_dist(rank, world, kind, compression, values, big_bound):
    """A distributed store: init, a multi-key push of this rank's values
    (one key past the big-array bound) and a pull; returns the pulled
    values and the issued collectives."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.parallel import collectives as c

    def run():
        c.reset_issued()
        kv = mx.kv.create(kind)
        keys = sorted(values)
        kv.init(keys, [nd.zeros(values[k][rank].shape, ctx=mx.cpu())
                       for k in keys])
        if compression:
            kv.set_gradient_compression(compression)
        kv.push(keys, [nd.array(values[k][rank], ctx=mx.cpu())
                       for k in keys])
        outs = [nd.zeros(values[k][rank].shape, ctx=mx.cpu()) for k in keys]
        kv.pull(keys, out=outs)
        kv.barrier()
        return {"out": {k: o.asnumpy() for k, o in zip(keys, outs)},
                "rank": kv.rank, "num_workers": kv.num_workers,
                "issued": c.issued()}

    return _with_env({"MXNET_KVSTORE_BIGARRAY_BOUND": big_bound}, run)


def t_mlp_trainer(rank, world, weights, data, kvstore, optimizer, opt_args,
                  update_on_kvstore, steps, zero, states_in=None,
                  states_out=None, shape=(8, 16, 4)):
    """Train the MLP on this rank's shard of the global batches through a
    Trainer over ``kvstore``; returns the parameters after ``steps``.
    ``states_in`` loads a states file first, ``states_out`` saves one
    after (rank 0 writes)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    def run():
        net = _mlp(weights, *shape)
        tr = gluon.Trainer(net.collect_params(), optimizer, dict(opt_args),
                           kvstore=kvstore,
                           update_on_kvstore=update_on_kvstore)
        if states_in is not None:
            tr.load_states(states_in)
        for x, y in data[:steps]:
            xs = nd.array(_shard(x, rank, world), ctx=mx.cpu())
            ys = nd.array(_shard(y, rank, world), ctx=mx.cpu())
            with autograd.record():
                loss = ((net(xs) - ys) ** 2).sum(axis=1)
            loss.backward()
            tr.step(x.shape[0])
        out = {"params": _params(net), "zero_bytes": 0}
        if tr._zero is not None:
            out["zero_bytes"] = tr._zero.state_bytes()
        if states_out is not None:
            blob = tr._states_blob()
            if rank == 0:
                with open(states_out, "wb") as f:
                    f.write(blob)
        return out

    return _with_env({"MXNET_ZERO": "1" if zero else "0"}, run)


def _loss_bert(outs, labels):
    import torch

    mlm, nsp = outs
    labels = labels.long()
    mlm_l = -torch.log_softmax(mlm, -1).gather(-1, labels[:, :-1, None])
    nsp_l = -torch.log_softmax(nsp, -1).gather(-1, labels[:, -1:])
    return mlm_l.mean() + nsp_l.mean()


def _loss_ce(logits, labels):
    import torch

    return -torch.log_softmax(logits, -1).gather(
        -1, labels.long()[:, None]).mean()


def build_net(kind, cfg):
    """The port's BERT (``BertForPretraining``) or tiny ResNet on the
    CPU, uninitialised weights settled by one forward."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    if kind == "bert":
        from mxnet_tpu_torch.gluon.model_zoo.language import bert

        net = bert.BertForPretraining(bert.BertConfig(**cfg))
        net.initialize(ctx=mx.cpu())
        net(nd.zeros((1, cfg["max_position"] // 2), ctx=mx.cpu(),
                     dtype="int32"))
        return net, _loss_bert
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    net = resnet.ResNetV1(resnet.BasicBlockV1, cfg["layers"],
                          cfg["channels"], classes=cfg["classes"],
                          thumbnail=True)
    net.initialize(ctx=mx.cpu())
    net(nd.zeros((1, 3, cfg["size"], cfg["size"]), ctx=mx.cpu()))
    return net, _loss_ce


def t_trainstep_mesh(rank, world, kind, cfg, weights, batches, optimizer,
                     opt_args, planted=False):
    """``TrainStep(mesh=make_mesh())`` on this rank's shard of each global
    batch; returns the losses and the parameters (running stats
    included) after the batches.  ``planted`` runs the step with
    BatchNorm's per-process moments (the global-moment hook off)."""
    from mxnet_tpu_torch.gluon import load_reference_params
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    net, loss = build_net(kind, cfg)
    load_reference_params(net, weights)
    step = TrainStep(net, loss, optimizer=optimizer,
                     optimizer_params=dict(opt_args), device="cpu",
                     mesh=make_mesh())
    if planted:
        step._step = lambda x, y: step._step_local(x, y, True)
    losses = [float(step(_shard(x, rank, world),
                         _shard(y, rank, world)).item())
              for x, y in batches]
    step.write_back()
    return {"losses": losses, "params": _params(net)}


def t_check_stop(rank, world, stop_rank, stop_at, steps, every):
    """A loop polling ``lifecycle.check_stop`` with agreement on; a stop
    requested on ``stop_rank`` alone at step ``stop_at``.  Returns the
    step each rank left at and the collectives issued."""
    from mxnet_tpu_torch import lifecycle
    from mxnet_tpu_torch.parallel import collectives as c

    def run():
        lifecycle.reset()
        c.reset_issued()
        lifecycle.coordinate_stops(True)
        left = None
        try:
            for step in range(steps):
                if rank == stop_rank and step == stop_at:
                    lifecycle.request_stop("test")
                if lifecycle.check_stop():
                    left = step
                    break
                c.psum(__import__("torch").ones(1))   # the step's work
        finally:
            lifecycle.reset()
        return {"left": left, "issued": c.issued()}

    return _with_env({"MXNET_STOP_SYNC_EVERY": every}, run)


def t_loss_scaler(rank, world, weights, x, y, overflow_rank):
    """An AMP-scaled float16-policy Trainer step over a distributed store,
    an inf planted in one rank's gradient: every rank must skip the
    update and halve the scale."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.contrib import amp

    net = _mlp(weights, 8, 16, 4)
    before = _params(net)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore="dist_sync", update_on_kvstore=False)
    amp.init("float16", target_dtype_ops=[], fp32_ops=[])
    try:
        amp.init_trainer(tr)
        scale0 = tr._amp_loss_scaler.loss_scale
        xs = nd.array(_shard(x, rank, world), ctx=mx.cpu())
        ys = nd.array(_shard(y, rank, world), ctx=mx.cpu())
        with autograd.record():
            loss = ((net(xs) - ys) ** 2).sum()
        loss.backward()
        if rank == overflow_rank:
            g = next(iter(net.collect_params().values())).grad()
            g._data[0, 0] = torch.inf
        tr.step(x.shape[0])
        skipped = all(np.array_equal(a, b)
                      for a, b in zip(before, _params(net)))
        return {"skipped": skipped,
                "scale": tr._amp_loss_scaler.loss_scale / scale0}
    finally:
        amp.disable()


def t_guard(rank, world, weights, x, y, bad_rank):
    """The guard's agreed verdict (a NaN planted in one rank's gradient is
    every rank's ``nonfinite``) and the canary vote (one rank's digest
    differs: every rank raises, naming it)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, guard, nd

    net = _mlp(weights, 8, 16, 4)
    xs = nd.array(_shard(x, rank, world), ctx=mx.cpu())
    ys = nd.array(_shard(y, rank, world), ctx=mx.cpu())
    with autograd.record():
        loss = ((net(xs) - ys) ** 2).sum()
    loss.backward()
    params = list(net.collect_params().values())
    g = guard.Guard()
    clean = g.check(params)
    if rank == bad_rank:
        params[0].grad()._data[0, 0] = torch.nan
    verdict = g.check(params)
    digest = g.canary(lambda: torch.ones(4))
    try:
        g.canary(lambda: torch.ones(4) * (2.0 if rank == bad_rank else 1.0))
        blamed = None
    except guard.NumericalDivergence as e:
        blamed = list(e.ranks)
    return {"clean": clean, "verdict": verdict, "digest": digest,
            "blamed": blamed}


def t_sync_bn(rank, world, x, gamma, beta):
    """Eager ``SyncBatchNorm`` in training mode on this rank's shard: the
    output rows and the running stats."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm

    bn = SyncBatchNorm(in_channels=x.shape[1])
    bn.initialize(ctx=mx.cpu())
    bn.gamma.set_data(nd.array(gamma, ctx=mx.cpu()))
    bn.beta.set_data(nd.array(beta, ctx=mx.cpu()))
    xs = nd.array(_shard(x, rank, world), ctx=mx.cpu())
    xs.attach_grad()
    with autograd.record():
        out = bn(xs)
    out.backward()
    return {"out": out.asnumpy(), "mean": bn.running_mean.data().asnumpy(),
            "var": bn.running_var.data().asnumpy(),
            "grad_finite": bool(np.isfinite(xs.grad.asnumpy()).all())}


def t_checkpoint(rank, world, weights, directory):
    """Every rank saves the same step (sync, then async) with a ZeRO
    Adam trainer: one writer publishes; every rank restores the same
    weights."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    def run():
        net = _mlp(weights, 8, 16, 4)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01}, kvstore="dist_sync",
                           update_on_kvstore=False)
        rs = np.random.RandomState(rank)
        xs = nd.array(rs.randn(2, 8).astype("f"), ctx=mx.cpu())
        with autograd.record():
            loss = (net(xs) ** 2).sum()
        loss.backward()
        tr.step(4)
        mgr = CheckpointManager(directory, max_to_keep=2)
        mgr.save(1, net, tr)
        listing = sorted(os.listdir(directory))
        mgr.save(2, net, tr, async_=True)
        mgr.close()
        from mxnet_tpu_torch.parallel.collectives import barrier

        barrier()
        net2 = _mlp(weights, 8, 16, 4)
        tr2 = gluon.Trainer(net2.collect_params(), "adam",
                            {"learning_rate": 0.01}, kvstore="dist_sync",
                            update_on_kvstore=False)
        step = mgr.restore(net2, tr2)
        same = all(np.array_equal(a, b)
                   for a, b in zip(_params(net), _params(net2)))
        return {"listing": listing, "restored": step, "same": same,
                "steps": mgr.all_steps(),
                "timing": sorted(getattr(mgr, "last_save_timing", {}))}

    return _with_env({"MXNET_ZERO": "1"}, run)


def t_ledger_skew(rank, world, directory, planted):
    """Uniform collectives, then each rank publishes its snapshot and rank
    0 merges: the ledger positions' skew is 0, or 1 with an extra stamp
    planted on rank 0 (a collective its peers never reached)."""
    import torch

    from mxnet_tpu_torch import flight_recorder, telemetry_agg
    from mxnet_tpu_torch.parallel import collectives as c

    flight_recorder.reset()
    for _ in range(3):
        c.psum(torch.ones(2))
    if planted and rank == 0:
        with flight_recorder.collective("planted"):
            pass
    telemetry_agg.publish(directory, rank)
    c.barrier()
    if rank != 0:
        return None
    doc = telemetry_agg.merge_dir(directory)
    return {"positions": telemetry_agg._ledger_positions(doc)}


def t_module(rank, world, sym_json, arg_params, x, y, kvstore):
    """``mx.mod.Module`` over a distributed store (one context a
    process): the weights after two updates."""
    import mxnet_tpu_torch as mx

    sym = mx.sym.load_json(sym_json)
    mod = mx.mod.Module(sym, context=mx.cpu())
    xs, ys = _shard(x, rank, world), _shard(y, rank, world)
    mod.bind(data_shapes=[("data", xs.shape)],
             label_shapes=[("softmax_label", ys.shape)])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in arg_params.items()})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.1),
                                         ("rescale_grad", 1.0 / x.shape[0])))
    batch = mx.io.DataBatch([mx.nd.array(xs, ctx=mx.cpu())],
                            [mx.nd.array(ys, ctx=mx.cpu())])
    for _ in range(2):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


def t_trainstep_mesh_modes(rank, world, kind, cfg, weights, batches,
                           optimizer, opt_args):
    """``TrainStep(mesh=)`` called step by step, with ``remat=True``,
    through ``run()``, and under ``dtype="bfloat16"``: the parameters
    after the batches, by mode."""
    from mxnet_tpu_torch.gluon import load_reference_params
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    shards = [(_shard(x, rank, world), _shard(y, rank, world))
              for x, y in batches]
    out = {}
    for mode in ("call", "remat", "run", "bfloat16"):
        net, loss = build_net(kind, cfg)
        load_reference_params(net, weights)
        step = TrainStep(net, loss, optimizer=optimizer,
                         optimizer_params=dict(opt_args), device="cpu",
                         mesh=make_mesh(), remat=mode == "remat",
                         dtype="bfloat16" if mode == "bfloat16" else None)
        if mode == "run":
            losses = step.run(iter(shards))
        else:
            losses = [step(x, y) for x, y in shards]
        step.write_back()
        out[mode] = {"losses": [float(v.item()) for v in losses],
                     "params": _params(net)}
    return out
