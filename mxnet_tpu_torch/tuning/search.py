"""Knob-space search driver: grid + successive halving, scored by
measurements, with a deterministic candidate order (counterpart of
``mxnet_tpu/tuning/search.py``).

Enumerate the declared grid, measure every candidate at a small budget,
keep the better half, double the budget, repeat: the cheap rungs prune
the bad region and only the contenders pay a full-budget measurement
(TVM's measurement loop, arXiv:1802.04799).

Determinism: the candidate SCHEDULE (which values run, in which order, at
which budget) is a pure function of the knob's declared grid and the rung
parameters.  Two processes tuning one knob walk identical schedules (ties
in a rung break by grid position, never by dict or hash order); only the
scores, and so the winner, reflect the machine.

Scores are "lower is better" throughout (seconds, or ms, per call for
training arms).  Serving arms fold tokens/s and p99 TTFT into one
ascending score, so one driver serves both families.
"""
from __future__ import annotations

from .. import telemetry as _telemetry
from . import knobs as _knobs

__all__ = ["schedule", "successive_halving", "tune_knob"]

_TRIALS = _telemetry.counter(
    "mxnet_tuning_trials_total",
    "search-trial measurements executed by the tuning driver "
    "(a warm replay of a stored winner performs zero)",
    labelnames=("knob",))


def schedule(knob, rungs=2, budget0=2, eta=2):
    """The deterministic rung schedule for ``knob``: a list of
    ``(budget, n_candidates)`` pairs, BEFORE any measurement.  Rung 0
    holds the default + the full grid (deduplicated, grid order);
    each later rung keeps the better half (ceil) at ``eta``× the
    budget.  Pure — this is the cross-process identical part."""
    if isinstance(knob, str):
        knob = _knobs.get_knob(knob)
    seen = []
    for v in (knob.default,) + knob.grid:
        if v not in seen:
            seen.append(v)
    out = []
    n = len(seen)
    budget = max(1, int(budget0))
    for _ in range(max(1, int(rungs))):
        out.append((budget, n))
        if n <= 1:
            break
        n = (n + 1) // 2
        budget *= max(2, int(eta))
    return {"candidates": seen, "rungs": out}


def successive_halving(knob, measure, rungs=2, budget0=2, eta=2,
                       log=None):
    """Run the rung schedule: ``measure(value, budget) -> score``
    (ascending = better).  Returns ``(results, trials)`` where
    ``results`` is the final rung's ``[(score, value), ...]`` sorted
    ascending (ties by grid position) and ``trials`` counts every
    measurement made.  A candidate whose measurement raises is dropped
    from the rung (scored ``inf``) — one pathological config must not
    kill the whole search."""
    if isinstance(knob, str):
        knob = _knobs.get_knob(knob)
    plan = schedule(knob, rungs=rungs, budget0=budget0, eta=eta)
    order = {v: i for i, v in enumerate(plan["candidates"])}
    survivors = list(plan["candidates"])
    trials = 0
    scored = []
    for budget, keep in plan["rungs"]:
        survivors = survivors[:keep]
        scored = []
        for value in survivors:         # deterministic order
            try:
                score = float(measure(value, budget))
            except Exception as e:
                if log is not None:
                    log(f"tuning trial {knob.name}={value!r} failed: "
                        f"{e!r}")
                score = float("inf")
            trials += 1
            _TRIALS.labels(knob=knob.name).inc()
            scored.append((score, value))
        scored.sort(key=lambda sv: (sv[0], order[sv[1]]))
        survivors = [v for _, v in scored]
    return scored, trials


def tune_knob(knob, measure, db=None, signature=None, plan_digest=None,
              rungs=2, budget0=2, eta=2, unit="s", log=None):
    """Search one knob and (when it wins cleanly) persist the winner.

    Returns a report dict: winner, per-candidate final-rung scores,
    the default's measured score, the best-vs-default delta, and the
    trial count.  An env-pinned knob is NOT searched — explicit
    overrides always win and the report records the pin instead
    (``tuning.resolve`` will keep honoring the pin regardless of any
    DB entry, so searching under it would measure a lie).
    """
    import os

    if isinstance(knob, str):
        knob = _knobs.get_knob(knob)
    raw = os.environ.get(knob.env_var)
    if raw not in (None, ""):
        return {"knob": knob.name, "pinned": knob.parse(raw),
                "source": "env", "trials": 0,
                "detail": f"{knob.env_var} is set; explicit overrides "
                          "always win — not searched"}
    from . import trial_override

    def _measure(value, budget):
        with trial_override(knob.name, value):
            return measure(value, budget)

    results, trials = successive_halving(
        knob, _measure, rungs=rungs, budget0=budget0, eta=eta, log=log)
    best_score, best_value = results[0]
    # the default's score from the FINAL rung when it survived there,
    # else a dedicated full-budget measurement — deltas must compare
    # equal budgets
    default_score = None
    for score, value in results:
        if value == knob.default:
            default_score = score
            break
    if default_score is None:
        final_budget = schedule(knob, rungs=rungs, budget0=budget0,
                                eta=eta)["rungs"][-1][0]
        default_score = float(_measure(knob.default, final_budget))
        trials += 1
        _TRIALS.labels(knob=knob.name).inc()
    report = {
        "knob": knob.name, "unit": unit, "trials": trials,
        "winner": best_value, "winner_score": best_score,
        "default": knob.default, "default_score": default_score,
        "delta_pct": round((default_score - best_score)
                           / default_score * 100.0, 2)
        if default_score else 0.0,
        "final_rung": [{"value": v, "score": s} for s, v in results],
    }
    if db is not None and best_score != float("inf"):
        report["stored"] = bool(db.put_winner(
            knob, best_value, signature=signature,
            plan_digest=plan_digest, score=best_score,
            default_score=default_score, trials=trials, unit=unit))
    return report
