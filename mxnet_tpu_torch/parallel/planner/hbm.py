"""HBM cost model + automatic mesh selection (counterpart of
``mxnet_tpu/parallel/planner/hbm.py``; the budget is an argument, the
planner's default the card's memory, ``env.planner_hbm_gb``).

Grounded in the weight-update-sharding accounting of arXiv:2004.13336
(PAPERS.md): per-device HBM at a training step is

    params/dev + grads/dev + optimizer-state/dev + activations/microbatch

where params and grads shard over the *model* axes a parameter's spec
names (``fsdp``/``tp``/``pp``…), optimizer state additionally shards
1/dp under ZeRO-1 (the flat-bucket layout,
:func:`bucketing.shard_layout`), and activations scale with the
per-device microbatch.  The activation term is deliberately a coarse,
*documented* model — one output tensor of ``(microbatch_rows,
out_features)`` per ≥2-D weight, out dim sharded as the weight's dim 0
is — because the planner must stay a pure function of the parameter
signature (no tracing); ``chip_smoke.py`` phase 16 prints the estimate
beside the card's measured peak so the error stays visible.

Mesh auto-selection (``mesh='auto'``) enumerates every divisor
factorization ``dp×fsdp×tp×pp == device_count`` in strict preference
order — maximize dp first (data parallelism needs no model cooperation),
then fsdp (shards memory without changing math), then tp (needs logical
rules), then pp (needs ``pipeline_decompose`` support, so it only enters
the search when the config asks for a pipeline) — and picks the FIRST
candidate whose estimate fits the per-device budget.  Enumeration
order is a pure function of the device count, so every SPMD peer and
every restart selects the same mesh.
"""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["OPTIMIZER_SLOTS", "estimate", "enumerate_meshes",
           "choose_mesh"]

# optimizer-state slots per parameter element (fp32 each), mirroring
# parallel/zero.py's supported set
OPTIMIZER_SLOTS = {"sgd": 0, "sgd_momentum": 1, "adam": 2}

_GiB = float(1 << 30)


def dtype_bytes(dtype):
    """Bytes of one element of ``dtype`` (a numpy or torch dtype name;
    bfloat16, which numpy lacks, is 2)."""
    import numpy as _np

    name = str(dtype).replace("torch.", "")
    return 2 if name == "bfloat16" else _np.dtype(name).itemsize


def _shard_factor(spec, axis_sizes):
    n = 1
    for entry in spec:
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a is not None:
                n *= int(axis_sizes.get(a, 1))
    return n


def estimate(signature, ruleset, axis_sizes, *, optimizer="sgd",
             zero=False, batch_rows=0, microbatches=1, training=True,
             itemsize=4):
    """Per-device HBM estimate (bytes) for one candidate mesh.

    ``signature``: ordered ``(name, shape, dtype)``; ``axis_sizes``:
    mesh axis name → size; ``batch_rows``: GLOBAL batch rows (divided by
    the data axes and ``microbatches`` for the activation term).
    Returns a dict with the per-component and total byte counts plus the
    resolved dp/zero factors — everything the report prints.
    """
    slots = OPTIMIZER_SLOTS.get(optimizer)
    if slots is None:
        raise MXNetError(f"unknown optimizer kind {optimizer!r} for the "
                         f"HBM model (known: {sorted(OPTIMIZER_SLOTS)})")
    if hasattr(ruleset, "spec_for"):
        spec_of = ruleset.spec_for
    else:
        # pre-resolved specs (a hand-built plan): name -> spec tuple
        resolved = dict(ruleset)
        spec_of = lambda name, shape, sizes: \
            tuple(resolved.get(name, ()))  # noqa: E731
    data_par = int(axis_sizes.get("dp", 1)) * int(axis_sizes.get("fsdp", 1))
    zero_shards = max(1, data_par) if zero else 1
    p_bytes = g_bytes = o_bytes = a_bytes = 0
    mb_rows = 0
    if batch_rows:
        denom = max(1, data_par) * max(1, int(microbatches))
        mb_rows = max(1, -(-int(batch_rows) // denom))
    for name, shape, dtype in signature:
        shape = tuple(int(s) for s in shape)
        size = 1
        for s in shape:
            size *= s
        isz = dtype_bytes(dtype)
        spec = spec_of(name, shape, axis_sizes)
        f = _shard_factor(spec, axis_sizes)
        per_dev = (size * isz) / f
        p_bytes += per_dev
        if training:
            g_bytes += per_dev
            # fp32 optimizer slots.  State is sharded EITHER like the
            # param (GSPMD/fsdp specs) OR 1/(dp*fsdp) by ZeRO's flat
            # buckets — the two mechanisms do not compose, so take the
            # larger factor, never the product (dividing by both would
            # claim more shards than data ranks exist and steer auto
            # selection toward an OOM mesh)
            o_bytes += slots * (size * 4) / max(f, zero_shards)
        if mb_rows and len(shape) >= 2:
            out_f = shape[0]
            out_shard = spec[0] if spec else None
            a_bytes += (mb_rows * out_f * itemsize) \
                / _shard_factor((out_shard,), axis_sizes)
    total = p_bytes + g_bytes + o_bytes + a_bytes
    return {"params": int(p_bytes), "grads": int(g_bytes),
            "optimizer": int(o_bytes), "activations": int(a_bytes),
            "total": int(total), "zero_shards": zero_shards,
            "data_parallel": data_par}


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_meshes(device_count, *, allow_pp=False, max_tp=None,
                     max_fsdp=None):
    """Every ``dp×fsdp×tp×pp == device_count`` factorization, in the
    deterministic preference order the auto-selector walks: dp
    descending, then fsdp, tp, pp descending within a dp."""
    n = int(device_count)
    out = []
    for dp in _divisors(n):
        rest = n // dp
        for fsdp in _divisors(rest):
            if max_fsdp and fsdp > max_fsdp:
                continue
            rest2 = rest // fsdp
            for tp in _divisors(rest2):
                if max_tp and tp > max_tp:
                    continue
                pp = rest2 // tp
                if pp > 1 and not allow_pp:
                    continue
                out.append({"dp": dp, "fsdp": fsdp, "tp": tp, "pp": pp})
    out.sort(key=lambda m: (-m["dp"], -m["fsdp"], -m["tp"], -m["pp"]))
    return out


def choose_mesh(signature, ruleset, device_count, *, budget_bytes,
                optimizer="sgd", zero=False, batch_rows=0,
                microbatches=1, allow_pp=False, max_tp=None,
                max_fsdp=None, strict=True):
    """First feasible factorization under ``budget_bytes`` per device.

    Returns ``(axes_dict, estimate_dict, candidates)`` where
    ``candidates`` is the examined prefix (each with its total) — the
    report's audit trail.  With ``strict=True`` an infeasible budget
    raises; otherwise the minimum-footprint candidate is returned with
    ``feasible=False`` in its estimate.
    """
    cands = enumerate_meshes(device_count, allow_pp=allow_pp,
                             max_tp=max_tp, max_fsdp=max_fsdp)
    trail, best = [], None
    for axes in cands:
        est = estimate(signature, ruleset, axes, optimizer=optimizer,
                       zero=zero, batch_rows=batch_rows,
                       microbatches=microbatches)
        est["feasible"] = est["total"] <= budget_bytes
        trail.append({"axes": dict(axes), "total": est["total"],
                      "feasible": est["feasible"]})
        if best is None or est["total"] < best[1]["total"]:
            best = (axes, est)
        if est["feasible"]:
            return axes, est, trail
    if strict:
        axes, est = best
        raise MXNetError(
            f"no dp*fsdp*tp*pp mesh over {device_count} devices fits "
            f"the {budget_bytes / _GiB:.2f} GiB HBM budget — smallest "
            f"candidate {axes} still needs {est['total'] / _GiB:.2f} "
            f"GiB/device (raise MXNET_PLANNER_HBM_GB, shrink the model/"
            f"batch, or enable ZeRO/fsdp rules)")
    return best[0], best[1], trail
