"""The sharding plan: one audited object every sharding consumer reads
(counterpart of ``mxnet_tpu/parallel/planner/plan.py``; the same JSON,
digest, report and telemetry round trip).

``plan_sharding(config, signature, device_count)`` is a **pure
function** — no wall clock, no device queries, no dict-order hazards —
so every SPMD peer and every restart computes the identical plan from
the identical inputs (the same contract :mod:`..bucketing` establishes
for grad buckets).  The plan is JSON-serializable; its ``digest()`` is
the cross-process determinism fingerprint.

Consumers:

- :class:`..data_parallel.TrainStep` — param specs, batch axes, mesh,
  the pipeline flag (``pipeline_in_jit_sharding``, carried; the port's
  pipeline holds each stage on its own rank whatever its value);
- :class:`..zero.ZeroBucketEngine` — the shard count and flat-bucket
  layout of the sharded optimizer state.

Specs stay plain tuples inside the plan; :meth:`ShardingPlan.spec` hands
out the port's :class:`..mesh.PartitionSpec` and
:meth:`ShardingPlan.sharding` its :class:`..mesh.Placement`.
"""
from __future__ import annotations

import json
from collections import OrderedDict

from ... import env as _env
from ... import telemetry as _telemetry
from ...base import MXNetError
from .. import bucketing as _bucketing
from . import hbm as _hbm
from . import rules as _rules

__all__ = ["PlannerConfig", "ShardingPlan", "plan_sharding",
           "signature_of", "plan_for", "set_default_plan",
           "get_default_plan", "report_from_snapshot"]

# the planner's mesh axes: the four auto-selection explores plus ep
# (expert parallelism — explicit-config only; MoE capacity factors are
# outside the HBM model, so auto never picks it)
_MESH_AXES = ("dp", "fsdp", "tp", "pp", "ep")

# telemetry families: the visualize_sharding report round-trips through
# snapshot() (report_from_snapshot(snapshot()) == plan.report())
_G_AXIS = _telemetry.gauge(
    "mxnet_planner_mesh_axis", "chosen mesh axis sizes of the published "
    "sharding plan", labelnames=("axis",))
_G_BYTES = _telemetry.gauge(
    "mxnet_planner_bytes_per_device", "HBM-model per-device byte "
    "estimate of the published plan", labelnames=("component",))
_G_PARAM = _telemetry.gauge(
    "mxnet_planner_param_bytes", "per-device bytes of one parameter "
    "under the published plan", labelnames=("param", "spec"))
_G_FEASIBLE = _telemetry.gauge(
    "mxnet_planner_feasible", "1 when the published plan fits the HBM "
    "budget (0 = over budget)")
_G_BUDGET = _telemetry.gauge(
    "mxnet_planner_budget_bytes", "per-device HBM budget the published "
    "plan was selected against")

_DEFAULT = None
# (param, spec) label tuples of the most recent publish() — removed
# before the next publish so the snapshot never carries stale rows
_PUBLISHED_PARAM_LABELS: set = set()


def set_default_plan(plan):
    """Install (or clear, with None) the session default plan — the one
    plan-unaware layers consult: the Trainer's ZeRO engine derives its
    shard count from it."""
    global _DEFAULT
    _DEFAULT = plan


def get_default_plan():
    return _DEFAULT


def _parse_mesh_str(s):
    """``"dp=4,tp=2"`` → axes dict; ``"auto"`` passes through."""
    s = (s or "").strip()
    if not s or s == "auto":
        return "auto"
    axes = {}
    for part in s.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in _MESH_AXES:
            raise MXNetError(f"bad mesh axis {k!r} in {s!r} "
                             f"(axes: {_MESH_AXES})")
        try:
            axes[k] = int(v)
        except ValueError:
            raise MXNetError(f"bad mesh size {v!r} in {s!r}") from None
    _check_axis_sizes(axes)
    return axes


def _check_axis_sizes(axes):
    for k, v in axes.items():
        if v < 1:
            raise MXNetError(
                f"bad mesh size {k}={v}: axis sizes must be >= 1")


class PlannerConfig:
    """Declarative planner input.  ``mesh``: ``'auto'``, an axes dict
    (missing axes default to 1; ``dp`` absorbs the remainder when
    absent), or None = the ``MXNET_PLANNER_MESH`` knob (default
    ``auto``).  ``rules``: a named rule set (``replicated`` / ``fsdp`` /
    ``megatron`` / ``megatron+fsdp``) or a :class:`rules.RuleSet`.
    ``overrides``: exact param name → logical template.  ``optimizer``:
    ``sgd`` / ``sgd_momentum`` / ``adam`` (HBM-model slots).  ``zero``:
    ZeRO-1 state sharding assumed (default: the ``MXNET_ZERO`` knob).
    ``hbm_gb``: per-device budget (default: ``MXNET_PLANNER_HBM_GB``, else
    the first CUDA card's memory).
    ``pipeline``: the model streams its trunk over pp — lets auto
    selection consider pp>1 and sizes the activation term by
    ``microbatches``.  ``pipeline_in_jit_sharding``: the reference's stage
    layout flag, carried in the plan (default:
    ``MXNET_PLANNER_PIPELINE_IN_JIT``); both values run the same
    pipeline in the port."""

    def __init__(self, mesh=None, rules="replicated", overrides=None,
                 batch_axes=("dp", "fsdp"), optimizer="sgd", zero=None,
                 batch_rows=0, microbatches=1, hbm_gb=None,
                 pipeline=False, max_tp=None, max_fsdp=None,
                 pipeline_in_jit_sharding=None):
        if mesh is None:
            mesh = _parse_mesh_str(_env.planner_mesh())
        elif isinstance(mesh, str):
            mesh = _parse_mesh_str(mesh)
        else:
            mesh = {k: int(v) for k, v in mesh.items()}
            for k in mesh:
                if k not in _MESH_AXES:
                    raise MXNetError(f"bad mesh axis {k!r} "
                                     f"(axes: {_MESH_AXES})")
            _check_axis_sizes(mesh)
        self.mesh = mesh
        self.ruleset = rules if isinstance(rules, _rules.RuleSet) \
            else _rules.named_rule_set(rules)
        if overrides:
            self.ruleset = self.ruleset.with_overrides(overrides)
        self.batch_axes = tuple(batch_axes)
        self.optimizer = optimizer
        self.zero = _env.zero_enabled() if zero is None else bool(zero)
        self.batch_rows = int(batch_rows)
        self.microbatches = max(1, int(microbatches))
        self.hbm_gb = float(hbm_gb) if hbm_gb is not None \
            else _env.planner_hbm_gb()
        self.pipeline = bool(pipeline)
        self.max_tp = max_tp
        self.max_fsdp = max_fsdp
        self.pipeline_in_jit_sharding = (
            _env.planner_pipeline_in_jit()
            if pipeline_in_jit_sharding is None
            else bool(pipeline_in_jit_sharding))

    def key(self):
        mesh = self.mesh if isinstance(self.mesh, str) \
            else tuple(sorted(self.mesh.items()))
        return (mesh, self.ruleset.key(), self.batch_axes,
                self.optimizer, self.zero, self.batch_rows,
                self.microbatches, round(self.hbm_gb, 6), self.pipeline,
                self.max_tp, self.max_fsdp,
                self.pipeline_in_jit_sharding)


class ShardingPlan:
    """Immutable result of :func:`plan_sharding`."""

    def __init__(self, axes, specs, batch_axes, hbm_est, signature,
                 chosen_by, budget_bytes, candidates,
                 pipeline_in_jit_sharding):
        self.axes = OrderedDict((a, int(axes.get(a, 1)))
                                for a in _MESH_AXES)
        self.specs = OrderedDict(specs)
        # stored verbatim: batch_spec() must equal P(batch_axes) exactly
        # (bit-compat with the hand-wired TrainStep spec) — do NOT
        # filter size-1 axes here
        self.batch_axes = tuple(batch_axes)
        self.hbm = dict(hbm_est)
        self.signature = tuple(signature)
        self.chosen_by = chosen_by          # "auto" | "explicit"
        self.budget_bytes = int(budget_bytes)
        self.candidates = list(candidates)  # auto-selection audit trail
        self.pipeline_in_jit_sharding = bool(pipeline_in_jit_sharding)

    @classmethod
    def from_specs(cls, axes, specs, batch_axes, signature=(),
                   optimizer="sgd", zero=False,
                   pipeline_in_jit_sharding=None):
        """Wrap pre-resolved specs (legacy TrainStep string modes, an
        explicit param_sharding dict) as a plan, so every sharding
        consumer reads one object regardless of how the layout was
        decided.  Specs pass through untouched — bit-compat by
        construction."""
        signature = tuple(signature)
        norm = OrderedDict(
            (k, _rules.spec_tuple(v)) for k, v in specs.items())
        est = _hbm.estimate(signature, norm, axes, optimizer=optimizer,
                            zero=zero) if signature else \
            {"params": 0, "grads": 0, "optimizer": 0, "activations": 0,
             "total": 0, "zero_shards": 1, "data_parallel": 1}
        budget = int(_env.planner_hbm_gb() * (1 << 30))
        est["feasible"] = est["total"] <= budget
        return cls(axes, norm, batch_axes, est, signature, "explicit",
                   budget, [{"axes": dict(axes), "total": est["total"],
                             "feasible": est["feasible"]}],
                   _env.planner_pipeline_in_jit()
                   if pipeline_in_jit_sharding is None
                   else pipeline_in_jit_sharding)

    # -- consumption --------------------------------------------------------
    def device_count(self):
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    def spec(self, name):
        """The :class:`..mesh.PartitionSpec` for one parameter
        (replicated when the plan has never seen the name — a late-added
        buffer must not crash the step)."""
        from ..mesh import PartitionSpec

        return PartitionSpec(*self.specs.get(name, ()))

    def partition_specs(self, names=None):
        """OrderedDict name → PartitionSpec (optionally restricted to
        ``names``, in that order)."""
        keys = self.specs.keys() if names is None else names
        return OrderedDict((k, self.spec(k)) for k in keys)

    def sharding(self, name, mesh):
        """The :class:`..mesh.Placement` of one parameter on ``mesh``."""
        from ..mesh import Placement

        return Placement(mesh, self.spec(name))

    def replicated(self, mesh):
        """The replicated :class:`..mesh.Placement` on ``mesh``."""
        from ..mesh import Placement

        return Placement(mesh, ())

    def batch_spec(self):
        """Batch-dim spec — dim 0 over the data axes, the reference's
        ``P(batch_axes)``."""
        from ..mesh import PartitionSpec

        return PartitionSpec(tuple(self.batch_axes))

    def build_mesh(self, devices=None):
        """The process mesh this plan was sized for (all six repo axes,
        the planned ones carrying their chosen sizes) over ``devices``
        (ranks; default the leading ``device_count()`` ranks of the
        process group)."""
        from ..mesh import make_mesh

        if devices is None:
            devices = list(range(self.device_count()))
        return make_mesh(dp=self.axes["dp"], fsdp=self.axes["fsdp"],
                         tp=self.axes["tp"], pp=self.axes["pp"],
                         ep=self.axes["ep"], devices=devices)

    @property
    def zero_shards(self):
        """Ranks the flat-bucket optimizer state shards over under
        ZeRO-1: the data-parallel replica count (dp×fsdp)."""
        return self.axes["dp"] * self.axes["fsdp"]

    def shard_layout(self, size):
        """ZeRO flat-bucket layout under this plan (pure, like
        :func:`bucketing.shard_layout`)."""
        return _bucketing.shard_layout(size, self.zero_shards)

    def transfer_plan_to(self, tgt_plan, signature=None,
                         zero_buckets=()):
        """The slice-move schedule to ``tgt_plan``'s layout: resharding
        (``parallel/resharding.py``) comes with the next multi-GPU slice
        (ROADMAP A6) and raises here."""
        raise MXNetError("ShardingPlan.transfer_plan_to: resharding comes "
                         "with the next multi-GPU slice (ROADMAP A6, "
                         "resharding.py with the elastic restore)")

    # -- identity / serialization ------------------------------------------
    def to_json(self):
        return json.dumps({
            "axes": dict(self.axes),
            "batch_axes": list(self.batch_axes),
            "specs": {k: [list(e) if isinstance(e, tuple) else e
                          for e in v] for k, v in self.specs.items()},
            "hbm": self.hbm,
            "chosen_by": self.chosen_by,
            "budget_bytes": self.budget_bytes,
            "pipeline_in_jit_sharding": self.pipeline_in_jit_sharding,
            "signature": [[n, list(s), str(d)]
                          for n, s, d in self.signature],
        }, sort_keys=True)

    def digest(self):
        """Stable fingerprint — equal across processes iff the plans are
        byte-identical (the CI determinism check)."""
        import hashlib

        return hashlib.sha256(self.to_json().encode()).hexdigest()

    # -- report -------------------------------------------------------------
    def report(self, execution=None):
        """Structured ``visualize_sharding`` payload (what the telemetry
        gauges publish and :func:`report_from_snapshot` reconstructs).
        ``execution`` (``TrainStep.execution``: name → ``local`` / ``tp``
        / ``gathered``) adds each row's execution."""
        rows = []
        for name, shape, dtype in self.signature:
            size = 1
            for s in shape:
                size *= int(s)
            nbytes = size * _hbm.dtype_bytes(dtype)
            spec = self.specs.get(name, ())
            f = _hbm._shard_factor(spec, self.axes)
            rows.append({"param": name, "spec": self._spec_str(spec),
                         "bytes_per_device": int(nbytes / f)})
            if execution is not None:
                rows[-1]["execution"] = execution.get(name, "local")
        return {
            "axes": dict(self.axes),
            "chosen_by": self.chosen_by,
            "budget_bytes": int(self.budget_bytes),
            "feasible": bool(self.hbm["total"] <= self.budget_bytes),
            "components": {k: int(self.hbm[k]) for k in
                           ("params", "grads", "optimizer",
                            "activations", "total")},
            "params": rows,
        }

    @staticmethod
    def _spec_str(spec):
        if not spec:
            return "replicated"
        return "P(" + ", ".join(
            "None" if e is None else
            ("+".join(e) if isinstance(e, tuple) else str(e))
            for e in spec) + ")"

    def visualize_sharding(self, execution=None):
        """Human-readable plan dump (T5X ``visualize_sharding`` style);
        with ``execution`` (``TrainStep.execution``) a last column names
        how the step runs each parameter."""
        rep = self.report(execution)
        mesh = " ".join(f"{a}={n}" for a, n in self.axes.items()
                        if a in _MESH_AXES)
        lines = [f"sharding plan — mesh [{mesh}] "
                 f"({self.device_count()} devices, {self.chosen_by})"]
        w = max([len(r["param"]) for r in rep["params"]] + [5])
        ws = max([len(r["spec"]) for r in rep["params"]] + [4])
        run = "" if execution is None else "  execution"
        lines.append(f"{'param':<{w}}  {'spec':<{ws}}  bytes/device{run}")
        for r in rep["params"]:
            b = _fmt_bytes(r["bytes_per_device"])
            lines.append(f"{r['param']:<{w}}  {r['spec']:<{ws}}  " + (
                b if execution is None else f"{b:<12}  {r['execution']}"))
        c = rep["components"]
        lines.append(
            "per-device: params %s · grads %s · optimizer %s · "
            "activations/µbatch %s · total %s (budget %s) %s" % (
                _fmt_bytes(c["params"]), _fmt_bytes(c["grads"]),
                _fmt_bytes(c["optimizer"]), _fmt_bytes(c["activations"]),
                _fmt_bytes(c["total"]), _fmt_bytes(rep["budget_bytes"]),
                "FEASIBLE" if rep["feasible"] else "OVER BUDGET"))
        return "\n".join(lines)

    def publish(self):
        """Write the report into the telemetry registry (labeled gauges)
        so it rides ``telemetry.snapshot()`` / the Prometheus endpoint;
        the snapshot round-trips via :func:`report_from_snapshot`.
        Re-publishing (a new plan, a different net) first removes the
        previous publish's per-param rows — stale series would break the
        round trip and serve dead numbers (the zero.py labeled-gauge
        retire discipline)."""
        global _PUBLISHED_PARAM_LABELS
        rep = self.report()
        new_labels = {(r["param"], r["spec"]) for r in rep["params"]}
        for param, spec in _PUBLISHED_PARAM_LABELS - new_labels:
            _G_PARAM.remove(param=param, spec=spec)
        _PUBLISHED_PARAM_LABELS = new_labels
        for a, n in rep["axes"].items():
            _G_AXIS.labels(axis=a).set(n)
        for comp, v in rep["components"].items():
            _G_BYTES.labels(component=comp).set(v)
        for r in rep["params"]:
            _G_PARAM.labels(param=r["param"], spec=r["spec"]).set(
                r["bytes_per_device"])
        _G_FEASIBLE.set(1 if rep["feasible"] else 0)
        _G_BUDGET.set(rep["budget_bytes"])
        return rep


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0


def report_from_snapshot(snap):
    """Reconstruct the published plan report from a
    ``telemetry.snapshot()`` payload (None when no plan was published).
    The round trip ``report_from_snapshot(snapshot()) ==
    plan.report()`` holds."""
    metrics = snap.get("metrics", {})
    axis_fam = metrics.get("mxnet_planner_mesh_axis")
    if not axis_fam or not axis_fam.get("samples"):
        return None
    axes = {s["labels"]["axis"]: int(s["value"])
            for s in axis_fam["samples"]}
    comps = {s["labels"]["component"]: int(s["value"])
             for s in metrics.get("mxnet_planner_bytes_per_device",
                                  {}).get("samples", [])}
    rows = [{"param": s["labels"]["param"], "spec": s["labels"]["spec"],
             "bytes_per_device": int(s["value"])}
            for s in metrics.get("mxnet_planner_param_bytes",
                                 {}).get("samples", [])]
    feas = metrics.get("mxnet_planner_feasible", {}).get("samples", [])
    budget = metrics.get("mxnet_planner_budget_bytes",
                         {}).get("samples", [])
    return {
        "axes": axes,
        "components": comps,
        "params": rows,
        "feasible": bool(feas and feas[0]["value"]),
        "budget_bytes": int(budget[0]["value"]) if budget else 0,
    }


# --------------------------------------------------------------------------
# planning
# --------------------------------------------------------------------------
def signature_of(params):
    """Ordered ``(name, shape, dtype)`` signature from a params mapping
    (values: anything with ``.shape``/``.dtype``), a Gluon net
    (``collect_params`` order), or an existing signature."""
    if hasattr(params, "collect_params"):
        from ..functional import functionalize

        _, tree = functionalize(params)
        params = tree
    if isinstance(params, (list, tuple)):
        return tuple((str(n), tuple(int(x) for x in s), str(d))
                     for n, s, d in params)
    return tuple((str(k), tuple(int(x) for x in v.shape),
                  str(getattr(v, "dtype", "float32")).replace("torch.", ""))
                 for k, v in params.items())


def plan_sharding(config, signature, device_count):
    """config × parameter signature × device count → ShardingPlan.

    Pure and deterministic: identical inputs produce plans with
    identical :meth:`ShardingPlan.digest` on every process."""
    signature = tuple(signature)
    n = int(device_count)
    if n < 1:
        raise MXNetError(f"device_count must be >= 1, got {n}")
    budget = int(config.hbm_gb * (1 << 30))
    rs = config.ruleset
    if config.mesh == "auto":
        axes, est, trail = _hbm.choose_mesh(
            signature, rs, n, budget_bytes=budget,
            optimizer=config.optimizer, zero=config.zero,
            batch_rows=config.batch_rows,
            microbatches=config.microbatches,
            allow_pp=config.pipeline, max_tp=config.max_tp,
            max_fsdp=config.max_fsdp)
        chosen_by = "auto"
    else:
        axes = dict(config.mesh)
        fixed = 1
        for a in _MESH_AXES:
            if a != "dp":
                fixed *= axes.get(a, 1)
        if "dp" not in axes:
            if n % fixed:
                raise MXNetError(f"{n} devices not divisible by "
                                 f"fsdp*tp*pp={fixed}")
            axes["dp"] = n // fixed
        total = axes["dp"] * fixed
        if total > n:
            raise MXNetError(f"mesh {axes} covers {total} devices, "
                             f"only {n} available")
        # total < n is the elastic sub-mesh convention: the plan takes
        # the leading devices (build_mesh slices; the ZeRO elastic
        # restore tests drive exactly this)
        est = _hbm.estimate(signature, rs, axes,
                            optimizer=config.optimizer, zero=config.zero,
                            batch_rows=config.batch_rows,
                            microbatches=config.microbatches)
        est["feasible"] = est["total"] <= budget
        trail = [{"axes": dict(axes), "total": est["total"],
                  "feasible": est["feasible"]}]
        chosen_by = "explicit"
    specs = _rules.resolve_specs(rs, signature, axes)
    plan = ShardingPlan(axes, specs, config.batch_axes, est, signature,
                        chosen_by, budget, trail,
                        config.pipeline_in_jit_sharding)
    if _env.planner_report():
        print(plan.visualize_sharding())
    return plan


def plan_for(net_or_params, config=None, devices=None):
    """Convenience wrapper: plan for a Gluon net / params mapping on the
    process group's size (or an explicit ``devices`` int/list)."""
    from ..collectives import world_size

    if config is None:
        config = PlannerConfig()
    if devices is None:
        n = world_size()
    elif isinstance(devices, int):
        n = devices
    else:
        n = len(devices)
    return plan_sharding(config, signature_of(net_or_params), n)
