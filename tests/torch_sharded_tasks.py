"""Tasks of the sharded-training tests (``tests/test_torch_{planner,
tensor_parallel,pipeline,context_parallel}.py``), run on the ranks of a
``torch_dist_pool.DistPool`` as ``"torch_sharded_tasks.<name>"``.

Each rank builds the port's net from the reference's weights, runs the
sharded step on its own shard of each global batch (the rows of its index
along the step's batch axes) and returns what the parent holds against
the reference: losses, every parameter whole (``TrainStep.
gathered_params``), how each ran (``TrainStep.execution``) and the
collectives it issued.  Imports ``torch`` and the port, never ``jax`` or
the reference.
"""
from __future__ import annotations

from torch_dist_pool import _loss_ce, _np, build_net

LLAMA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=48, max_seq_len=32)


def loss_lm(logits, labels):
    import torch

    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None])


def _net(model, cfg, weights):
    """The port's net with the reference's weights (by position)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import load_reference_params

    if model == "bert":
        net, loss = build_net("bert", cfg)
    elif model == "mlp_bn":
        # the reference's tests/test_parallel.py _tiny_net
        from mxnet_tpu_torch import gluon

        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(16, activation="relu", in_units=8),
                gluon.nn.BatchNorm(in_channels=16),
                gluon.nn.Dense(cfg["classes"], in_units=16))
        net.initialize(ctx=mx.cpu())
        net(nd.zeros((2, 8), ctx=mx.cpu()))
        loss = _loss_ce
    else:
        from mxnet_tpu_torch.gluon.model_zoo.language import llama

        net = llama.LlamaForCausalLM(llama.LlamaConfig(**cfg))
        net.initialize(ctx=mx.cpu())
        net(nd.zeros((1, 8), ctx=mx.cpu(), dtype="int32"))
        loss = loss_lm
    load_reference_params(net, weights)
    return net, loss


def _rows(a, mesh, axes):
    """This rank's rows of a global batch along ``axes``."""
    axes = tuple(a_ for a_ in axes if mesh.shape.get(a_, 1) > 1)
    if not axes:
        return a
    n = mesh.axis_size(axes)
    i = mesh.axis_index(axes)
    per = a.shape[0] // n
    return a[i * per:(i + 1) * per]


def _structural(net):
    """global parameter name -> the net's own position."""
    return {p.name: i for i, p in enumerate(net.collect_params().values())}


def _faults(step, net, fault):
    """Planted faults of the sharded step (each must miss the bound)."""
    if fault == "kv_split":
        # each rank holds the next rank's kv heads: its query heads meet
        # another group's keys and values
        import torch

        for name, pl in step._place.items():
            if "k_proj" in name or "v_proj" in name:
                t = step.train_params[name]
                n = pl.mesh.axis_size("tp")
                i = pl.mesh.axis_index("tp")
                tiles = pl.gather(t.detach()).chunk(n, 0)
                with torch.no_grad():
                    t.copy_(tiles[(i + 1) % n])


def t_train(rank, world, model, cfg, weights, batches, mesh_kw, sharding,
            optimizer, opt_args, pipeline=None, fault=None):
    """The sharded ``TrainStep`` over ``make_mesh(**mesh_kw)``.
    ``sharding``: ``{"rules": name}`` (a plan from the planner, on the
    mesh's axes), ``{"param_sharding": "fsdp" | "replicated"}`` or
    ``{"specs": {position: spec}}`` (a dict of specs by parameter
    position).  Returns losses, params (by position), execution (by
    position) and the collectives issued."""
    from mxnet_tpu_torch.parallel import TrainStep, collectives, make_mesh
    from mxnet_tpu_torch.parallel import pipeline_parallel as pp_mod
    from mxnet_tpu_torch.parallel import planner
    from mxnet_tpu_torch.parallel import tensor_parallel as tp_mod

    net, loss = _net(model, cfg, weights)
    mesh = make_mesh(**mesh_kw)
    names = list(net.collect_params())
    kw = {}
    if "rules" in sharding:
        axes = {a: n for a, n in mesh.shape.items() if a != "sp"}
        cfg_p = planner.PlannerConfig(mesh=axes, rules=sharding["rules"],
                                      hbm_gb=16.0)
        kw["plan"] = planner.plan_for(net, cfg_p)
    elif "param_sharding" in sharding:
        kw["param_sharding"] = sharding["param_sharding"]
        kw["mesh"] = mesh
    else:
        kw["param_sharding"] = {names[int(i)]: tuple(s) for i, s in
                                sharding["specs"].items()}
        kw["mesh"] = mesh
    collectives.reset_issued()
    saved = tp_mod.reduce_from_tp, pp_mod._cotangent
    if fault == "no_row_reduce":
        tp_mod.reduce_from_tp = lambda x: x
    if fault == "reversed_backward":
        # the last stage seeds microbatch m with the cotangent of M-1-m
        pp_mod._cotangent = lambda d, m: d[d.shape[0] - 1 - m]
    try:
        step = TrainStep(net, loss, optimizer=optimizer,
                         optimizer_params=dict(opt_args), device="cpu",
                         pipeline=pipeline, **kw)
        _faults(step, net, fault)
        bax = step._batch_axes
        losses = [float(step(_rows(x, step._mesh, bax),
                             _rows(y, step._mesh, bax)).item())
                  for x, y in batches]
    finally:
        tp_mod.reduce_from_tp, pp_mod._cotangent = saved
    full = step.gathered_params()
    pos = _structural(net)
    return {"losses": losses,
            "params": [_np(full[n]) for n in sorted(full, key=pos.get)],
            "execution": {pos[k]: v for k, v in step.execution.items()},
            "issued": collectives.issued(),
            "local_shapes": {pos[k]: tuple(v.shape) for k, v in
                             step.train_params.items()},
            "plan_text": step._plan.visualize_sharding(step.execution)}


def t_pipeline_apply(rank, world, per_stage, x, M, schedule, remat=False,
                     stage="tanh", in_jit=None):
    """``pipeline_apply`` over ``pp`` = world of ``stage_fn`` on the
    stacked ``per_stage`` params: the output, the gradients of
    ``(y * y).sum()`` to the stacked params and to x, and the collectives
    issued."""
    import torch

    from mxnet_tpu_torch.parallel import collectives, make_mesh
    from mxnet_tpu_torch.parallel import pipeline_parallel as pp

    def stage_fn(p, h):
        if stage == "norm":     # NaN on an all-zero input
            return (h / torch.linalg.norm(h, dim=-1, keepdim=True)) @ p["w"]
        return torch.tanh(h @ p["w"] + p["b"])

    mesh = make_mesh(pp=len(per_stage))
    stacked = pp.stack_stage_params(
        [{k: torch.from_numpy(v).requires_grad_() for k, v in s.items()}
         for s in per_stage])
    stacked = {k: v.detach().requires_grad_() for k, v in stacked.items()}
    xt = torch.from_numpy(x).requires_grad_()
    collectives.reset_issued()
    y = pp.pipeline_apply(stage_fn, stacked, xt, mesh, M, schedule=schedule,
                          remat_stage=remat, in_jit_sharding=in_jit)
    (y * y).sum().backward()
    return {"y": _np(y), "grads": {k: _np(v.grad) for k, v in
                                   stacked.items()},
            "gx": _np(xt.grad), "issued": collectives.issued()}


def t_pipeline_rejects(rank, world):
    """The reference's rejections of bad pipeline configurations: each
    raises MXNetError; returns the messages."""
    import torch

    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel import pipeline_parallel as pp

    mesh = make_mesh(pp=world)
    fn = lambda p, h: h @ p["w"]   # noqa: E731
    out = []
    cases = [({"w": torch.zeros(world + 1, 4, 4)}, 2, "gpipe"),
             ({"w": torch.zeros(world, 4, 4)}, 3, "gpipe"),
             ({"w": torch.zeros(world, 4, 4)}, 2, "2f2b")]
    for params, M, sched in cases:
        try:
            pp.pipeline_apply(fn, params, torch.zeros(4, 4), mesh, M,
                              schedule=sched)
            out.append(None)
        except MXNetError as e:
            out.append(str(e))
    return out


def t_attention(rank, world, q, k, v, causal, which, fault=None,
                with_grad=False):
    """Ring (``which="ring"``) or Ulysses context parallelism over ``sp``
    = world on the whole (B, H, L, D) tensors: the output, the gradient of
    ``(o ** 2).sum()`` to q, and the collectives issued."""
    import torch

    from mxnet_tpu_torch.parallel import collectives, make_mesh
    from mxnet_tpu_torch.parallel import context_parallel as cp

    mesh = make_mesh(sp=world)
    qt = torch.from_numpy(q).requires_grad_(with_grad)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    collectives.reset_issued()
    saved = cp._source
    if fault == "ring_source":
        cp._source = lambda my, i, n: (my - i + 1) % n
    try:
        fn = cp.context_parallel_attention if which == "ring" else \
            cp.ulysses_context_parallel_attention
        o = fn(qt, kt, vt, mesh, causal=causal)
        out = {"o": _np(o), "issued": collectives.issued()}
        if with_grad:
            (o ** 2).sum().backward()
            out["gq"] = _np(qt.grad)
    finally:
        cp._source = saved
    return out


def t_ulysses_indivisible(rank, world):
    import torch

    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel import context_parallel as cp

    q = torch.zeros(1, world + 1, 8, 4)
    try:
        cp.ulysses_context_parallel_attention(q, q, q, make_mesh(sp=world))
    except ValueError as e:
        return str(e)
    return None


def t_moe(rank, world, x, wr, per_expert, capacity_factor):
    """``moe_apply`` over ``ep`` = world: the output, the gradients of
    ``out.sum()`` to the stacked expert weights and the router, and the
    collectives issued."""
    import torch

    from mxnet_tpu_torch.parallel import collectives, make_mesh
    from mxnet_tpu_torch.parallel import expert_parallel as ep

    params = ep.stack_expert_params(
        [{"w": torch.from_numpy(p["w"])} for p in per_expert])
    params = {"w": params["w"].requires_grad_()}
    wr_t = torch.from_numpy(wr).requires_grad_()
    collectives.reset_issued()
    out, aux = ep.moe_apply(lambda p, t: torch.tanh(t @ p["w"]), params,
                            wr_t, torch.from_numpy(x),
                            mesh=make_mesh(ep=world),
                            capacity_factor=capacity_factor)
    out.sum().backward()
    return {"out": _np(out), "gw": _np(params["w"].grad),
            "gr": _np(wr_t.grad), "dropped": int(aux["dropped"]),
            "issued": collectives.issued()}


def t_zero_plan(rank, world, weights, data, plan_axes, steps):
    """A Trainer under ``MXNET_ZERO=1`` over ``dist_sync`` with a plan of
    ``plan_axes`` installed as the session default: its engine's plan and
    shard count, and the parameters after ``steps``."""
    from torch_dist_pool import t_mlp_trainer

    from mxnet_tpu_torch.parallel import planner, zero

    sig = (("w", (16, 8), "float32"),)
    plan = planner.plan_sharding(
        planner.PlannerConfig(mesh=dict(plan_axes), rules="replicated",
                              optimizer="sgd_momentum", zero=True,
                              hbm_gb=16.0), sig, world)
    planner.set_default_plan(plan)
    try:
        import mxnet_tpu_torch as mx

        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
        eng = zero.ZeroBucketEngine(opt)
        out = {"dp": eng.dp, "governed": eng._plan is plan,
               "axis": repr(eng._shard_axis()[0])}
        res = t_mlp_trainer(rank, world, weights, data, "dist_sync", "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9}, False,
                            steps, True)
        out["params"] = res["params"] if isinstance(res, dict) else res
    finally:
        planner.set_default_plan(None)
    try:
        bad = planner.plan_sharding(
            planner.PlannerConfig(mesh={"dp": 1}, rules="replicated",
                                  hbm_gb=16.0), sig, 1)
        zero.ZeroBucketEngine(opt, plan=bad)
        out["sub_mesh"] = None
    except Exception as e:      # noqa: BLE001 - the message is the check
        out["sub_mesh"] = str(e)
    return out


