"""Cross-rank telemetry aggregation: one merged, rank-labeled view of a
job of several processes, with per-phase straggler skew (counterpart of
``mxnet_tpu/telemetry_agg.py``).

Every rank has a ``telemetry.snapshot()``; this module merges them into

- **rank-labeled families**: every metric family from every rank, its
  samples carrying a ``rank`` label, in one document; and
- **per-phase skew**: ``mxnet_rank_step_skew_seconds`` observes, per
  phase, ``max - min`` of the per-rank durations at the newest step every
  rank has reported, so a straggler shows long before it stalls the job.

Transport, **never a device collective**: each rank publishes its snapshot
atomically as ``rank<N>.json`` in a shared directory
(``MXNET_TELEMETRY_AGG_DIR``) every ``MXNET_TELEMETRY_AGG_EVERY``-th tick
of the step boundary (``telemetry.step_end`` and ``lifecycle.check_stop``
tick it); rank 0 also merges the peers' files and serves the result at
``/agg`` beside ``/metrics``.  A rank publishing late or not at all
degrades the merge, never the job.  ``MXNET_TELEMETRY_AGG_TRANSPORT=kv``
gathers through a ``torch.distributed`` key-value store instead (the
launcher's: the default process group's store, or one handed to
:func:`configure`), in place of the reference's jax coordination-service
client.  The rank and world size come from the launcher (``RANK`` /
``WORLD_SIZE``, or ``MXNET_WORKER_ID`` / ``MXNET_NUM_WORKERS``).

:func:`merge_snapshots` is a pure, deterministic function of its inputs:
two merges of the same snapshots are identical.

:func:`merge_blackboxes` merges the flight recorder's per-rank
``blackbox.rank<N>.json`` dumps into a **blame verdict**: which
collective the job wedged in, at which sequence number, which rank fell
out of program order, or whose guard digests differ.  Black-box dumps
are always files: they are written while the distributed runtime is
presumed dead.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time

from . import env as _env
from . import telemetry as _telemetry

__all__ = ["merge_snapshots", "skew_from_snapshots", "configure",
           "tick", "publish", "publish_kv", "read_kv", "merge_dir",
           "read_dir", "merged", "read_blackboxes", "merge_blackboxes",
           "reset"]

_SKEW_HIST = _telemetry.histogram(
    "mxnet_rank_step_skew_seconds",
    "per-phase max-min spread of step-phase durations across ranks at "
    "the newest common step (straggler visibility)",
    labelnames=("phase",),
    buckets=[1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0,
             10.0])
_MERGES = _telemetry.counter(
    "mxnet_telemetry_agg_merges_total",
    "cross-rank snapshot merges performed by this process")
_AGG_RANKS = _telemetry.gauge(
    "mxnet_telemetry_agg_ranks",
    "ranks present in the latest cross-rank merge")
_LEDGER_SKEW = _telemetry.gauge(
    "mxnet_collective_ledger_skew",
    "max-min spread of the per-rank collective-ledger positions at "
    "the latest cross-rank merge (a growing spread is the pre-hang "
    "signature: some rank stopped issuing collectives)")
_LEDGER_SKEW_ALERTS = _telemetry.counter(
    "mxnet_ledger_skew_alerts_total",
    "ledger-skew pre-hang alerts: cross-rank position divergence "
    "above MXNET_LEDGER_SKEW_THRESHOLD for MXNET_LEDGER_SKEW_WINDOWS "
    "consecutive aggregation merges")

# episode state for the pre-hang alert — the goodput-SLO discipline
# (telemetry._goodput_slo_tick): N consecutive above-threshold merges
# fire ONE alert; a merge back below the threshold re-arms it
_SKEW_ALERT_STATE = {"above": 0, "fired": False}

_LOCK = threading.Lock()
_STATE = {
    "configured": False,
    "dir": None,
    "every": 0,
    "rank": 0,
    "world": 1,
    "ticks": 0,
    "merged": None,      # latest merged doc (aggregating rank only)
    "route": False,
    "warned": False,
    # snapshot-gather transport: "file" (shared dir) or "kv" (a
    # torch.distributed store: hosts without a shared filesystem).
    # Black-box dumps are always files: they are written while the
    # distributed runtime is presumed dead.
    "transport": "file",
    "kv_client": None,   # injected client (tests) or resolved lazily
    "kv_warned": False,
}

_KV_PREFIX = "mxnet/telemetry_agg/rank"

_RANK_FILE = re.compile(r"^rank(\d+)\.json$")


# --------------------------------------------------------------------------
# pure merge (deterministic: same snapshots in -> same document out)
# --------------------------------------------------------------------------
def merge_snapshots(snaps):
    """Merge ``{rank: telemetry-snapshot}`` into one document.

    Deterministic and pure: ranks are processed in sorted order, no
    clock reads feed the payload (the newest input snapshot's ``time``
    is carried through), so merging the same inputs twice yields the
    same document — the property an offline re-merge and the tests
    determinism assertion rely on.

    Output shape::

        {"time", "ranks": [...], "metrics": {name: {type, help,
         samples: [{labels: {..., "rank": "0"}, ...}]}},
         "skew": {"step": N|None, "phases": {phase: max-min}},
         "per_rank": {rank: {steps, last_step, compile_count,
                             goodput_ratio}}}
    """
    snaps = {int(r): s for r, s in dict(snaps).items()}
    ranks = sorted(snaps)
    metrics: dict = {}
    per_rank: dict = {}
    for rank in ranks:
        snap = snaps[rank]
        for name, fam in sorted((snap.get("metrics") or {}).items()):
            out = metrics.setdefault(
                name, {"type": fam.get("type"),
                       "help": fam.get("help", ""), "samples": []})
            for sample in fam.get("samples", ()):
                labeled = dict(sample)
                labels = dict(labeled.get("labels") or {})
                labels["rank"] = str(rank)
                labeled["labels"] = labels
                out["samples"].append(labeled)
        steps = snap.get("steps") or []
        per_rank[rank] = {
            "steps": len(steps),
            "last_step": steps[-1]["step"] if steps else None,
            "compile_count": (snap.get("compile") or {}).get("count"),
            "goodput_ratio": (snap.get("goodput") or {}).get(
                "productive_ratio"),
        }
    step, phases = skew_from_snapshots(snaps)
    return {
        "time": max((s.get("time") or 0) for s in snaps.values())
        if snaps else 0,
        "ranks": ranks,
        "metrics": metrics,
        "skew": {"step": step, "phases": phases},
        "per_rank": per_rank,
    }


def skew_from_snapshots(snaps):
    """``(step, {phase: max-min seconds})`` at the newest step EVERY
    rank has a timeline record for (``(None, {})`` when there is no
    common step — e.g. a rank that has not completed a step yet)."""
    per_rank_steps = {}
    for rank, snap in snaps.items():
        per_rank_steps[rank] = {rec["step"]: rec
                                for rec in (snap.get("steps") or [])}
    if not per_rank_steps or any(not d for d in per_rank_steps.values()):
        return None, {}
    common = set.intersection(*(set(d) for d in per_rank_steps.values()))
    if not common:
        return None, {}
    step = max(common)
    phases: dict = {}
    names = set()
    for d in per_rank_steps.values():
        names.update(d[step]["phases"])
    for name in sorted(names):
        vals = [d[step]["phases"].get(name, 0.0)
                for d in per_rank_steps.values()]
        phases[name] = max(vals) - min(vals)
    return step, phases


# --------------------------------------------------------------------------
# ledger-position skew: the pre-hang alert (flight-recorder follow-on)
# --------------------------------------------------------------------------
def _ledger_positions(doc):
    """``{rank: position}`` from a merged doc's rank-labeled
    ``mxnet_collective_ledger_position`` samples (a rank without the
    gauge — recorder off — is simply absent)."""
    fam = (doc.get("metrics") or {}).get(
        "mxnet_collective_ledger_position") or {}
    out = {}
    for sample in fam.get("samples", ()):
        r = (sample.get("labels") or {}).get("rank")
        try:
            out[int(r)] = float(sample.get("value"))
        except (TypeError, ValueError):
            continue
    return out


def _ledger_skew_tick(doc):
    """One aggregation-merge window of the pre-hang alert: when the
    cross-rank ledger-position spread stays above
    ``MXNET_LEDGER_SKEW_THRESHOLD`` for
    ``MXNET_LEDGER_SKEW_WINDOWS`` consecutive merges, fire ONE
    lifecycle alert naming the lagging rank(s); re-arm only after a
    merge back below the threshold — a sustained divergence pages
    once, not every merge.  The goodput-SLO hook pattern, moved one
    layer down: this fires while every rank is still alive, BEFORE
    the watchdog/black-box machinery has a corpse to blame."""
    threshold = _env.ledger_skew_threshold()
    if threshold <= 0:
        return
    positions = _ledger_positions(doc)
    if len(positions) < 2:
        return          # nothing to diverge from
    skew = int(max(positions.values()) - min(positions.values()))
    _LEDGER_SKEW.set(skew)
    if skew < threshold:
        _SKEW_ALERT_STATE["above"] = 0
        _SKEW_ALERT_STATE["fired"] = False
        return
    _SKEW_ALERT_STATE["above"] += 1
    if _SKEW_ALERT_STATE["fired"] or \
            _SKEW_ALERT_STATE["above"] < _env.ledger_skew_windows():
        return
    _SKEW_ALERT_STATE["fired"] = True
    _LEDGER_SKEW_ALERTS.inc()
    low = min(positions.values())
    laggards = sorted(r for r, p in positions.items() if p == low)
    try:
        from . import lifecycle as _lc

        _lc.note_ledger_skew(skew, threshold,
                             _SKEW_ALERT_STATE["above"], laggards)
    except Exception:   # alerting must never break a merge
        pass


# --------------------------------------------------------------------------
# black-box merge + blame (the flight-recorder half of this module)
# --------------------------------------------------------------------------
_BLACKBOX_FILE = re.compile(r"^blackbox\.rank(\d+)\.json$")


def read_blackboxes(directory):
    """``{rank: blackbox-doc}`` from every readable
    ``blackbox.rank<N>.json`` in the directory.  A torn/garbage file is
    skipped — each rank dumped alone while dying, so the merge is
    best-effort by construction."""
    boxes = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return boxes
    for name in sorted(names):
        m = _BLACKBOX_FILE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict) or "events" not in doc:
            continue
        boxes[int(m.group(1))] = doc
    return boxes


def _ledger_of(doc):
    """``{seq: collective-entry}`` from one black-box doc (ring order;
    a wrapped ring keeps only the tail — the newest window, which is
    the one that matters for blame)."""
    out = {}
    for e in doc.get("events") or ():
        if isinstance(e, dict) and e.get("kind") == "collective" \
                and isinstance(e.get("seq"), int):
            out[e["seq"]] = e
    return out


def _last_step_of(doc):
    """The newest training step this rank's ring mentions (the
    ``step`` context events telemetry.step_begin/step_end record), or
    None when the ring holds none — the step-alignment half of blame:
    seq numbers say WHERE in the collective program a rank stopped,
    the step events say how far the TRAINING LOOP got."""
    last = None
    for e in doc.get("events") or ():
        if isinstance(e, dict) and e.get("kind") == "step" \
                and isinstance(e.get("step"), int):
            if last is None or e["step"] > last:
                last = e["step"]
    return last


def _verdict(kind, detail, ranks=(), seq=None, tag=None, digest=None):
    return {"kind": kind, "detail": detail,
            "ranks": sorted(int(r) for r in ranks),
            "seq": seq, "tag": tag, "digest": digest}


def merge_blackboxes(boxes):
    """Merge ``{rank: blackbox-doc}`` into one report with a **blame
    verdict** — pure and deterministic (no clock reads; same boxes in →
    byte-identical document out, the property an offline blame's
    offline re-merge relies on).

    The ledgers align by the per-rank collective sequence number: the
    equal-call-count contract (parallel/collectives.py) means equal
    seq across ranks must carry equal tags.  Verdicts, in priority
    order:

    - ``numerical_divergence`` — the guard's quarantine evidence
      (``guard_checksum`` post-allreduce bucket digests /
      ``guard_canary`` recompute digests, bit-identical across ranks by
      construction) disagrees at a (step, key): silent data corruption
      or desync ON the named minority rank(s).  Checked first —
      explicit recorded evidence beats the inferred verdicts below.
    - ``desync`` — the first sequence number where ranks' tags diverge
      (a rank issued a different/extra collective); blamed ranks are
      the minority tag holders at that seq.
    - ``hang`` — the lagging rank(s): wedged *inside* their last
      entered collective (no exit stamp), failed in it (error stamp),
      or stopped *between* collectives (never entered the leaders'
      next seq).
    - ``all_wedged`` — every rank entered the SAME seq and none
      exited: the collective itself (interconnect, a dead device), not
      a lagging rank.
    - ``no_blame`` / ``single_rank`` / ``no_data`` — nothing to blame,
      one ring only, or no rings.
    """
    boxes = {int(r): d for r, d in dict(boxes).items()}
    ranks = sorted(boxes)
    ledgers = {r: _ledger_of(boxes[r]) for r in ranks}
    per_rank = {}
    for r in ranks:
        led = ledgers[r]
        last = led[max(led)] if led else None
        per_rank[r] = {
            "reason": boxes[r].get("reason"),
            "time": boxes[r].get("time"),
            "position": boxes[r].get("position"),
            "events": len(boxes[r].get("events") or ()),
            "last_seq": max(led) if led else 0,
            "first_seq": min(led) if led else 0,
            "last_tag": last.get("tag") if last else None,
            "last_exited": bool(last and "t1" in last
                                and "error" not in last),
            "last_error": (last or {}).get("error"),
            "last_step": _last_step_of(boxes[r]),
        }
    doc = {
        "format": 1,
        "ranks": ranks,
        "per_rank": per_rank,
        "time": max((boxes[r].get("time") or 0) for r in ranks)
        if ranks else 0,
    }
    verdict = _blame(ranks, ledgers, per_rank, boxes)
    # step alignment: when the blamed rank's ring carries step context
    # events, translate the seq-space verdict into loop-space too —
    # "rank 3 is 2 steps behind" reads at a glance what seq numbers
    # only imply.  Pure post-processing of per_rank, so the verdict
    # stays deterministic.
    steps = {r: per_rank[r]["last_step"] for r in ranks
             if per_rank[r]["last_step"] is not None}
    verdict["step_lag"] = None
    blamed_with_steps = sorted(r for r in verdict.get("ranks") or ()
                               if r in steps)
    if len(steps) > 1 and blamed_with_steps:
        lead = max(steps.values())
        b = min(blamed_with_steps, key=lambda r: (steps[r], r))
        lag = int(lead - steps[b])
        if lag > 0:
            verdict["step_lag"] = lag
            verdict["detail"] += (
                f"; rank {b} is {lag} step(s) behind "
                f"(step {steps[b]} vs leaders' step {lead})")
    doc["verdict"] = verdict
    return doc


def _blame(ranks, ledgers, per_rank, boxes):
    if not ranks:
        return _verdict("no_data", "no black-box files to merge")
    # -- numerical divergence: guard checksum/canary digests disagree --
    # The quarantine tier (mxnet_tpu/guard.py) stamps digests of data
    # that is bit-identical across ranks by construction; a mismatch at
    # the same (step, key) is positive evidence of SDC/desync on the
    # minority rank — stronger than anything inferred from ledger
    # positions, so it is checked before every other verdict.
    if len(ranks) > 1:
        stamped: dict = {}
        for r in ranks:
            for e in boxes[r].get("events") or ():
                if not isinstance(e, dict):
                    continue
                if e.get("kind") == "guard_checksum":
                    k = (e.get("step"), str(e.get("key")))
                    d = e.get("crc")
                elif e.get("kind") == "guard_canary":
                    k = (e.get("step"), "__canary__")
                    d = e.get("digest")
                else:
                    continue
                stamped.setdefault(k, {})[r] = (d, e.get("seq"))
        for k in sorted(stamped, key=lambda kk: (kk[0] is None,
                                                 kk[0] or 0, kk[1])):
            per = stamped[k]
            if len(per) < 2:
                continue
            vals = {r: v[0] for r, v in per.items()}
            if len(set(vals.values())) <= 1:
                continue
            counts: dict = {}
            for d in vals.values():
                counts[d] = counts.get(d, 0) + 1
            majority = max(sorted(counts, key=repr),
                           key=lambda d: counts[d])
            blamed = sorted(r for r, d in vals.items() if d != majority)
            if len(set(counts.values())) == 1 and len(counts) > 1:
                blamed = sorted(vals)       # tie: every holder suspect
            step, key = k
            b0 = blamed[0]
            v = _verdict(
                "numerical_divergence",
                f"guard digest for {key!r} at step {step} diverges: " +
                ", ".join(f"rank {r}={vals[r]!r}"
                          for r in sorted(vals)) +
                " — the stamped payload is bit-identical across ranks "
                "by construction, so the minority rank(s) hold "
                "corrupted values (SDC or silent desync)",
                ranks=blamed, seq=per[b0][1], tag=key,
                digest=vals[b0])
            v["step"] = step
            return v
    # -- desync: first seq where tags diverge across any two ranks -----
    if len(ranks) > 1:
        shared = set()
        for r in ranks:
            shared |= set(ledgers[r])
        for seq in sorted(shared):
            tags = {r: ledgers[r][seq].get("tag")
                    for r in ranks if seq in ledgers[r]}
            if len(tags) < 2 or len(set(tags.values())) <= 1:
                continue
            counts: dict = {}
            for t in tags.values():
                counts[t] = counts.get(t, 0) + 1
            majority = max(sorted(counts), key=lambda t: counts[t])
            blamed = sorted(r for r, t in tags.items() if t != majority)
            if len(set(counts.values())) == 1 and len(counts) > 1:
                blamed = sorted(tags)       # tie: every holder suspect
            return _verdict(
                "desync",
                f"collective tags diverge at seq {seq}: " +
                ", ".join(f"rank {r}={tags[r]!r}"
                          for r in sorted(tags)) +
                " — a rank issued an extra/different collective "
                "(equal-call-count contract broken)",
                ranks=blamed, seq=seq,
                tag=ledgers[blamed[0]][seq].get("tag") if blamed else None,
                digest=ledgers[blamed[0]][seq].get("digest")
                if blamed else None)
    # -- hang: who lags, and where exactly -----------------------------
    max_seqs = {r: per_rank[r]["last_seq"] for r in ranks}
    lead = max(max_seqs.values())
    laggards = sorted(r for r in ranks if max_seqs[r] < lead)
    # a configured world larger than the dumps we have: a rank that
    # died without dumping is the primary suspect
    world = max((boxes[r].get("world") or 0) for r in ranks)
    missing = sorted(set(range(world)) - set(ranks)) if world > len(ranks) \
        else []
    if missing and not laggards:
        wedged = [r for r in ranks if not per_rank[r]["last_exited"]
                  and max_seqs[r] > 0]
        w = wedged[0] if wedged else None
        detail = (f"rank(s) {missing} wrote no black box"
                  + (f"; rank {w} is wedged in "
                     f"{per_rank[w]['last_tag']!r} seq {max_seqs[w]} "
                     f"waiting on them" if w is not None else ""))
        return _verdict(
            "hang", detail, ranks=missing,
            seq=max_seqs[w] if w is not None else None,
            tag=per_rank[w]["last_tag"] if w is not None else None,
            digest=ledgers[w][max_seqs[w]].get("digest")
            if w is not None else None)
    if laggards:
        low = min(max_seqs[r] for r in laggards)
        blamed = sorted(r for r in laggards if max_seqs[r] == low)
        b = blamed[0]
        led = ledgers[b]
        last = led.get(low)
        if last is not None and "error" in last:
            return _verdict(
                "hang",
                f"rank {b} failed inside {last.get('tag')!r} seq {low} "
                f"({last['error']}) and issued nothing after it",
                ranks=blamed, seq=low, tag=last.get("tag"),
                digest=last.get("digest"))
        if last is not None and "t1" not in last:
            return _verdict(
                "hang",
                f"rank {b} entered {last.get('tag')!r} seq {low} but "
                f"never exited (wedged inside the collective; leaders "
                f"reached seq {lead})",
                ranks=blamed, seq=low, tag=last.get("tag"),
                digest=last.get("digest"))
        # stopped BETWEEN collectives: blame the first seq it never
        # entered, tagged from any leading rank's ledger
        nxt = low + 1
        tag = digest = None
        for r in ranks:
            if nxt in ledgers[r]:
                tag = ledgers[r][nxt].get("tag")
                digest = ledgers[r][nxt].get("digest")
                break
        return _verdict(
            "hang",
            f"rank {b} never entered {tag!r} seq {nxt} (last completed "
            f"seq {low}; leaders reached seq {lead})",
            ranks=blamed, seq=nxt, tag=tag, digest=digest)
    # -- no laggards: same position everywhere --------------------------
    unexited = sorted(r for r in ranks
                      if not per_rank[r]["last_exited"] and lead > 0)
    if unexited and len(unexited) == len(ranks) and len(ranks) > 1:
        tag = per_rank[ranks[0]]["last_tag"]
        return _verdict(
            "all_wedged",
            f"every rank entered {tag!r} seq {lead} and none exited — "
            "the collective itself is wedged (interconnect / dead "
            "device), not a lagging rank",
            ranks=ranks, seq=lead, tag=tag,
            digest=ledgers[ranks[0]][lead].get("digest"))
    if unexited:
        b = unexited[0]
        alone = " (single ring — no peer ledger to compare)" \
            if len(ranks) == 1 else " while peers completed it"
        return _verdict(
            "hang",
            f"rank(s) {unexited} entered {per_rank[b]['last_tag']!r} "
            f"seq {lead} but never exited{alone}",
            ranks=unexited, seq=lead, tag=per_rank[b]["last_tag"],
            digest=ledgers[b][lead].get("digest"))
    if len(ranks) == 1:
        return _verdict(
            "single_rank",
            f"one ring only (rank {ranks[0]}, reason "
            f"{per_rank[ranks[0]]['reason']!r}) — nothing to align "
            "against", ranks=ranks,
            seq=lead or None, tag=per_rank[ranks[0]]["last_tag"])
    return _verdict(
        "no_blame",
        f"all {len(ranks)} ranks completed the same ledger position "
        f"(seq {lead}) — no collective-order fault in the recorded "
        "window", ranks=[])


# --------------------------------------------------------------------------
# the file-based gather
# --------------------------------------------------------------------------
def configure(directory=None, every=None, rank=None, world=None,
              transport=None, kv_client=None):
    """Configure (or reconfigure) the aggregator explicitly.  Defaults
    come from the env knobs / launcher vars; ``every=0`` disables.
    ``transport="kv"`` gathers snapshots through a torch.distributed
    store instead of the shared directory (``kv_client``: a store, such
    as a ``torch.distributed.TCPStore``; default the default process
    group's store, resolved at the first tick)."""
    with _LOCK:
        _STATE["dir"] = directory if directory is not None \
            else _env.telemetry_agg_dir()
        _STATE["every"] = int(every if every is not None
                              else _env.telemetry_agg_every())
        _STATE["rank"] = int(rank if rank is not None else _launcher_rank())
        _STATE["world"] = int(world if world is not None
                              else _launcher_world())
        _STATE["transport"] = str(transport) if transport is not None \
            else _env.telemetry_agg_transport()
        _STATE["kv_client"] = kv_client
        _STATE["kv_warned"] = False
        _STATE["configured"] = True
        _STATE["ticks"] = 0
        if _STATE["every"] > 0 and not _STATE["dir"] \
                and _STATE["transport"] == "file" \
                and not _STATE["warned"]:
            _STATE["warned"] = True
            import warnings

            warnings.warn(
                "MXNET_TELEMETRY_AGG_EVERY is set but "
                "MXNET_TELEMETRY_AGG_DIR is not: cross-rank telemetry "
                "aggregation stays OFF (the ranks need a shared "
                "directory to publish into)", stacklevel=2)
    return dict(_STATE)


def _launcher_rank():
    # one shared implementation (env.launcher_rank) so this module's
    # rank label and the flight recorder's dump filename always agree
    return _env.launcher_rank()


def _launcher_world():
    return _env.launcher_world()


def tick():
    """One step-boundary tick (called by ``telemetry.step_end`` and
    ``lifecycle.check_stop``).  Disabled = one dict read + int check.
    Every ``every``-th tick: publish this rank's snapshot; on rank 0
    also merge the peers'.  Host-side IO only (file or KV RPC) —
    never a device collective."""
    with _LOCK:
        if not _STATE["configured"]:
            _configure_locked_from_env()
        transport = _STATE["transport"]
        if _STATE["every"] <= 0 or \
                (transport == "file" and not _STATE["dir"]):
            return None
        _STATE["ticks"] += 1
        if _STATE["ticks"] % _STATE["every"] != 0:
            return None
        rank = _STATE["rank"]
        world = _STATE["world"]
        directory = _STATE["dir"]
    if transport == "kv":
        client = _kv_client()
        if client is None:
            # no coordination service: fall back to the directory
            # gather when one is configured, else aggregation is off
            if not directory:
                return None
        else:
            publish_kv(client, rank)
            if rank == 0:
                doc = merge_snapshots(read_kv(client, world))
                _note_merge(doc)
                return doc
            return None
    publish(directory, rank)
    if rank == 0:
        doc = merge_dir(directory)
        with _LOCK:
            _STATE["merged"] = doc
            if not _STATE["route"]:
                _STATE["route"] = True
                _telemetry.register_http_route("/agg", _http_agg)
        return doc
    return None


def _note_merge(doc):
    """Shared bookkeeping for a completed rank-0 merge (either
    transport): cache it, feed the skew histogram, mount /agg."""
    _MERGES.inc()
    _AGG_RANKS.set(len(doc["ranks"]))
    for phase, skew in doc["skew"]["phases"].items():
        _SKEW_HIST.labels(phase=phase).observe(skew)
    _ledger_skew_tick(doc)
    with _LOCK:
        _STATE["merged"] = doc
        if not _STATE["route"]:
            _STATE["route"] = True
            _telemetry.register_http_route("/agg", _http_agg)


# --------------------------------------------------------------------------
# the KV-store gather (pods without a shared filesystem)
# --------------------------------------------------------------------------
def _kv_client():
    """The store of the KV transport: the one handed to
    :func:`configure`, else the default process group's (a launcher
    that initialised ``torch.distributed`` gives one).  Resolving it
    never starts a process group; without one it warns once and the
    transport falls back to the directory."""
    with _LOCK:
        if _STATE["kv_client"] is not None:
            return _STATE["kv_client"]
        warned = _STATE["kv_warned"]
    client = None
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            from torch.distributed.distributed_c10d import \
                _get_default_store

            client = _get_default_store()
    except Exception:
        client = None
    if client is None and not warned:
        with _LOCK:
            _STATE["kv_warned"] = True
        import warnings

        warnings.warn(
            "MXNET_TELEMETRY_AGG_TRANSPORT=kv but no torch.distributed "
            "store is live (no process group, none configured); falling "
            "back to the file gather"
            + ("" if _STATE["dir"] else " — and no "
               "MXNET_TELEMETRY_AGG_DIR either, so aggregation "
               "stays OFF"), stacklevel=2)
    return client


def publish_kv(client, rank):
    """Publish this rank's snapshot under ``…/rank<N>`` in the store
    (``set`` overwrites: the newest publish wins, like the file
    rename)."""
    snap = _telemetry.snapshot()
    snap["rank"] = int(rank)
    try:
        client.set(f"{_KV_PREFIX}{int(rank)}", json.dumps(snap))
        return True
    except Exception:
        # a failed publish degrades the merge, never the job
        return False


def read_kv(client, world):
    """``{rank: snapshot}`` for every rank with a published value: a
    missing or torn rank is skipped (``check`` first, so a missing key
    never blocks on the store's timeout)."""
    snaps = {}
    for r in range(max(1, int(world))):
        key = f"{_KV_PREFIX}{r}"
        try:
            if not client.check([key]):
                continue
            val = client.get(key)
        except Exception:
            continue
        try:
            snaps[r] = json.loads(val)
        except (TypeError, ValueError):
            continue
    return snaps


def _configure_locked_from_env():
    _STATE["dir"] = _env.telemetry_agg_dir()
    _STATE["every"] = _env.telemetry_agg_every()
    _STATE["rank"] = _launcher_rank()
    _STATE["world"] = _launcher_world()
    _STATE["transport"] = _env.telemetry_agg_transport()
    _STATE["configured"] = True
    if _STATE["every"] > 0 and not _STATE["dir"] \
            and _STATE["transport"] == "file" and not _STATE["warned"]:
        # the production (env-only) path must warn about the half-set
        # config exactly like explicit configure() does — silence here
        # would leave the operator discovering a 404 at /agg instead
        _STATE["warned"] = True
        import warnings

        warnings.warn(
            "MXNET_TELEMETRY_AGG_EVERY is set but "
            "MXNET_TELEMETRY_AGG_DIR is not: cross-rank telemetry "
            "aggregation stays OFF (the ranks need a shared directory "
            "to publish into)", stacklevel=2)


def publish(directory, rank):
    """Atomically write this rank's current snapshot to
    ``rank<N>.json`` (tmp + rename — a reader never sees a torn file;
    the newest publish simply wins)."""
    os.makedirs(directory, exist_ok=True)
    snap = _telemetry.snapshot()
    snap["rank"] = int(rank)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp_agg_")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, os.path.join(directory, f"rank{int(rank)}.json"))
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    return True


def read_dir(directory, max_age_s=600.0):
    """``{rank: snapshot}`` from every readable ``rank*.json`` in the
    directory (a torn/missing peer file is skipped — the merge is
    best-effort by design).

    Staleness filter: a rank that left the job (elastic shrink,
    restart under a new world size) stops publishing but its file
    persists; without a filter it would pin a frozen rank into every
    merge forever — and once the live ranks' timeline rings advance
    past its last step, the skew histogram would silently stop finding
    a common step.  Snapshots more than ``max_age_s`` older than the
    NEWEST snapshot in the directory are dropped (measured against the
    newest file, not the wall clock, so an offline re-merge of
    an old directory is deterministic and complete).  ``max_age_s <=
    0`` disables the filter."""
    snaps = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return snaps
    for name in sorted(names):
        m = _RANK_FILE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                snaps[int(m.group(1))] = json.load(f)
        except (OSError, ValueError):
            continue
    if snaps and max_age_s and max_age_s > 0:
        newest = max((s.get("time") or 0) for s in snaps.values())
        snaps = {r: s for r, s in snaps.items()
                 if (s.get("time") or 0) >= newest - max_age_s}
    return snaps


def merge_dir(directory):
    """Merge every rank file in ``directory`` and feed the straggler
    histogram (``mxnet_rank_step_skew_seconds``) with the per-phase
    skew at the newest common step.  Returns the merged doc."""
    snaps = read_dir(directory)
    doc = merge_snapshots(snaps)
    _MERGES.inc()
    _AGG_RANKS.set(len(doc["ranks"]))
    for phase, skew in doc["skew"]["phases"].items():
        _SKEW_HIST.labels(phase=phase).observe(skew)
    _ledger_skew_tick(doc)
    return doc


def merged():
    """The latest merged document on the aggregating rank (None before
    the first merge / on non-zero ranks)."""
    with _LOCK:
        return _STATE["merged"]


def _http_agg(method, path, query, body):
    doc = merged()
    if doc is None:
        return (404, "application/json",
                b'{"error": "no cross-rank merge yet"}')
    return 200, "application/json", json.dumps(doc).encode()


def reset():
    """Drop configuration + cached merge (test isolation)."""
    with _LOCK:
        _STATE.update(configured=False, dir=None, every=0, rank=0,
                      world=1, ticks=0, merged=None, warned=False,
                      transport="file", kv_client=None, kv_warned=False)
        _SKEW_ALERT_STATE.update(above=0, fired=False)
        if _STATE["route"]:
            _STATE["route"] = False
            _telemetry.unregister_http_route("/agg")
