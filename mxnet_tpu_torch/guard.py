"""Numerical-integrity guard: sentinels, step skip and rewind, and the
quarantine evidence (counterpart of ``mxnet_tpu/guard.py``).

The other robustness planes defend against failing processes (crashes,
hangs, preemptions).  This one defends against wrong values: a NaN
gradient outside the AMP path, a loss spike from a poisoned batch, a card
silently corrupting math mid-run (silent data corruption).

**Sentinels**: :meth:`Guard.check` computes ONE per-step integrity vector
on the device (:func:`integrity_stats`: the non-finite gradient count and
the global gradient norm from one multi-tensor pass each, and the loss)
and reads it to the host once.  The values are classified against a
trailing robust window (median/MAD: a spike cannot poison the baseline
that detects it) into one of the verdicts

    ``ok`` | ``nonfinite`` | ``loss_spike`` | ``grad_anomaly``

**Remediation ladder** (``MXNET_GUARD_*``): a verdict other than ok skips
the step (``MXNET_GUARD_SKIP``: the update is never applied, the AMP
overflow skip generalised); after ``MXNET_GUARD_REWIND_AFTER`` anomalies in
the window it rewinds to ``latest_valid_step()`` of a bound
``CheckpointManager`` with the exact train state, charged to the
``rewind`` goodput bucket.  On the fused ``TrainStep`` path, which
commits its update before a verdict can land, :meth:`Guard.poll_loss`
escalates a persistent anomaly to :class:`GuardRewind`, which
``checkpoint.run_with_recovery`` absorbs as a rewind.

**Quarantine**: :func:`stamp_bucket_checksum` stamps the digest of a
gradient bucket into the flight recorder (``MXNET_GUARD_CHECKSUM=1``;
``gluon.Trainer`` stamps its gradients each step), and :meth:`Guard.canary`
digests a deterministic recompute: ``telemetry_agg.merge_blackboxes``
names the rank whose digest differs.

Across processes, as in the reference: ``check`` sums the sentinel
vector over every process in one all-reduce, so every rank classifies the
same values and reaches the same verdict, and ``canary`` votes the
digests in one all-reduce of a one-hot digest table, raising
:class:`NumericalDivergence` on every rank, naming the minority.

Wiring: :func:`attach` wraps ``Trainer.step`` with the verdict gate
(attach after ``amp.init_trainer``: the guard's non-finite channel then
feeds the loss scaler, so a guarded AMP step reads the host once);
``TrainStep.run(guard=...)`` polls the loss sentinel.  Fault seams:
``guard.check``, ``guard.rewind``, ``guard.canary``.
"""
from __future__ import annotations

import collections
import logging
import time
import zlib

import numpy as np
import torch

from . import env as _env
from . import fault as _fault
from . import telemetry as _telemetry
from .base import MXNetError, world_size

__all__ = ["Guard", "NumericalDivergence", "GuardRewind", "VERDICTS",
           "attach", "nonfinite_total", "integrity_stats",
           "checksum_enabled", "stamp_bucket_checksum", "enabled"]

_LOGGER = logging.getLogger(__name__)

VERDICTS = ("ok", "nonfinite", "loss_spike", "grad_anomaly")

# steps of clean history before the robust window can call a spike —
# below this the guard only trips on hard non-finite evidence
MIN_HISTORY = 8

_CHECKS_TOTAL = _telemetry.counter(
    "mxnet_guard_checks_total",
    "fused integrity-sentinel checks issued (one host sync each on "
    "sync-stride cycles)")
_VERDICTS_TOTAL = _telemetry.counter(
    "mxnet_guard_verdicts_total",
    "agreed non-ok integrity verdicts by class",
    labelnames=("verdict",))
_SKIPS_TOTAL = _telemetry.counter(
    "mxnet_guard_skips_total",
    "optimizer steps skipped (update zeroed) on an anomalous verdict")
_REWINDS_TOTAL = _telemetry.counter(
    "mxnet_guard_rewinds_total",
    "rewinds to the latest valid checkpoint after repeated anomalies")
_CHECKSUMS_TOTAL = _telemetry.counter(
    "mxnet_guard_bucket_checksums_total",
    "post-allreduce per-bucket checksum stamps written to the flight "
    "recorder (quarantine mode)")
_CANARY_TOTAL = _telemetry.counter(
    "mxnet_guard_canary_votes_total",
    "deterministic canary-microbatch recompute votes taken")


class NumericalDivergence(MXNetError):
    """A rank's recomputed values diverge from the majority: silent data
    corruption localized to specific rank(s).  Raised on every rank at
    once (the vote is one collective), so ``run_with_recovery`` restarts
    the whole job together, charged to the ``rewind`` bucket."""

    def __init__(self, message, ranks=()):
        super().__init__(message)
        self.ranks = tuple(sorted(int(r) for r in ranks))


class GuardRewind(MXNetError):
    """Escalation from a guarded loop that cannot rewind in place (the
    fused ``TrainStep`` path commits its update before the verdict
    lands): ``run_with_recovery`` absorbs it as a rewind-class restart
    from the latest valid checkpoint."""


def enabled():
    """The master gate (``MXNET_GUARD``)."""
    return _env.guard_enabled()


def checksum_enabled():
    """Quarantine-tier per-bucket checksum stamps (``MXNET_GUARD_CHECKSUM``).

    Deliberately independent of the master gate so an operator can turn
    ON evidence collection for a suspected-SDC job without changing its
    step semantics."""
    return _env.guard_checksum()


# --------------------------------------------------------------------------
# device-side sentinel reductions (no host read)
# --------------------------------------------------------------------------
def _float_grads(params):
    return [g._data for p in params
            if p.grad_req != "null" and p._nd is not None
            for g in p.list_grad() if g._data.is_floating_point()]


def _nonfinite_counts(grads):
    """Per gradient, its non-finite elements, as one (n,) fp32 tensor: 0·x
    is NaN exactly where x is not finite, and the L0 norm counts the
    entries that are not 0 (two multi-tensor passes)."""
    zeros = torch._foreach_mul(grads, 0.0)
    return torch.stack(torch._foreach_norm(zeros, 0)).float()


def nonfinite_total(params):
    """The count of non-finite elements over every float gradient of
    ``params`` as one device scalar (float32), or None without a float
    gradient.  Nothing here reads back to the host: the caller decides
    where its one read is."""
    grads = _float_grads(params)
    if not grads:
        return None
    return _nonfinite_counts(grads).sum()


def integrity_stats(params=None, loss=None):
    """The per-step integrity vector as ONE device tensor
    ``[nonfinite_count, grad_sq_norm, loss, loss_present]`` (float32), no
    host read.  The count and the norm each take one multi-tensor pass
    over the float gradients.  The norm channel stays finite: it sums the
    squared norms of the gradients without a non-finite element (the
    reference zeroes only the non-finite elements; the two agree on every
    step without one, and a step with one is ``nonfinite`` either way).
    ``loss_present`` lets a sum over processes recover the mean loss."""
    grads = _float_grads(params) if params is not None else []
    dev = grads[0].device if grads else None
    if loss is not None:
        lv = getattr(loss, "_data", loss)
        if not isinstance(lv, torch.Tensor):
            lv = torch.as_tensor(np.asarray(lv), device=dev)
        dev = lv.device
        lv = lv.detach().float().mean()
        has = torch.ones((), dtype=torch.float32, device=dev)
    if grads:
        nfs = _nonfinite_counts(grads)
        sq = torch.stack(torch._foreach_norm(grads)).float().square()
        nf = nfs.sum()
        gsq = torch.where(nfs > 0, torch.zeros_like(sq), sq).sum()
    else:
        nf = torch.zeros((), dtype=torch.float32, device=dev)
        gsq = torch.zeros((), dtype=torch.float32, device=dev)
    if loss is None:
        lv = torch.zeros((), dtype=torch.float32, device=dev)
        has = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.stack([nf, gsq.to(nf.device), lv.to(nf.device),
                        has.to(nf.device)])


def _robust_spike(value, history, threshold):
    """One-sided robust z-test: is ``value`` above the window median by
    more than ``threshold`` robust deviations?  Scale is the MAD
    (consistency factor 1.4826) floored at 1e-3·max(1, |median|) so a
    perfectly flat window cannot make every epsilon a spike.  Pure and
    deterministic — identical history + value on every rank means an
    identical verdict on every rank."""
    if len(history) < MIN_HISTORY or threshold <= 0:
        return False
    med = float(np.median(history))
    mad = float(np.median([abs(v - med) for v in history]))
    scale = max(1.4826 * mad, 1e-3 * max(1.0, abs(med)))
    return (value - med) > threshold * scale


class Guard:
    """The per-run integrity plane: fused sentinel check + trailing
    robust window + the skip/rewind remediation ladder.

    One instance per training loop (``attach`` hangs it off the Trainer
    as ``trainer._guard``).  All thresholds default from the
    ``MXNET_GUARD_*`` knobs; constructor arguments override for tests.
    ``_testing_force`` runs the agreement collective's path on one
    process."""

    def __init__(self, window=None, loss_spike=None, grad_spike=None,
                 skip=None, rewind_after=None, sync_every=None,
                 _testing_force=False):
        self._window = window if window is not None \
            else _env.guard_window()
        self._loss_spike = loss_spike if loss_spike is not None \
            else _env.guard_loss_spike()
        self._grad_spike = grad_spike if grad_spike is not None \
            else _env.guard_grad_spike()
        self._skip = skip if skip is not None else _env.guard_skip()
        self._rewind_after = rewind_after if rewind_after is not None \
            else _env.guard_rewind_after()
        self._sync_every = max(1, sync_every if sync_every is not None
                               else _env.guard_sync_every())
        self._testing_force = _testing_force
        self._losses = collections.deque(maxlen=self._window)
        self._norms = collections.deque(maxlen=self._window)
        self._recent = collections.deque(maxlen=self._window)
        self._calls = 0
        self._agreed = "ok"
        self.last_stats = {"nonfinite": 0.0, "grad_norm": 0.0,
                           "loss": None}
        # rewind binding (all optional; unbound => the ladder tops out
        # at skip, with a once-per-run warning)
        self._manager = None
        self._net = None
        self._trainer = None
        self._dataloader = None
        self._scaler = None
        self._rewind_warned = False

    # -- rewind binding ----------------------------------------------------
    def bind_rewind(self, manager, net=None, trainer=None,
                    dataloader=None, scaler=None):
        """Arm the rewind tier: ``manager`` is a ``CheckpointManager``
        (its ``latest_valid_step``/``restore``/``read_train_state`` are
        the exact-resume machinery); net/trainer/dataloader/
        scaler are re-wound in place when provided."""
        self._manager = manager
        self._net = net
        self._trainer = trainer
        self._dataloader = dataloader
        self._scaler = scaler
        return self

    # -- the fused sentinel check -----------------------------------------
    def check(self, params=None, loss=None):
        """ONE integrity check: the device reduction and one host read,
        classified into a verdict.

        Called at every guarded step boundary.  Off-stride calls
        (``MXNET_GUARD_SYNC_EVERY`` > 1) read nothing and return the last
        verdict (``lifecycle.check_stop``'s amortization: an anomaly is
        seen within N steps).  With more than one process it raises: the
        agreement across processes waits for the port's collectives."""
        _fault.check("guard.check")
        _CHECKS_TOTAL.inc()
        self._calls += 1
        if self._calls % self._sync_every != 0:
            return self._agreed
        stats = integrity_stats(params, loss)
        if world_size() > 1 or self._testing_force:
            from .parallel.collectives import allreduce_hosts

            stats = allreduce_hosts(stats,
                                    _testing_force=self._testing_force)
        # THE one host read of a guarded step
        vec = stats.cpu().numpy()
        verdict = self._classify(float(vec[0]), float(vec[1]),
                                 float(vec[2]), float(vec[3]))
        self._agreed = verdict
        if verdict != "ok":
            _VERDICTS_TOTAL.labels(verdict=verdict).inc()
            self._flight_note("guard_verdict", verdict=verdict,
                              nonfinite=self.last_stats["nonfinite"],
                              grad_norm=self.last_stats["grad_norm"],
                              loss=self.last_stats["loss"])
            _LOGGER.warning(
                "guard verdict %s (nonfinite=%.0f grad_norm=%.4g "
                "loss=%s)", verdict, self.last_stats["nonfinite"],
                self.last_stats["grad_norm"], self.last_stats["loss"])
        return verdict

    def _classify(self, nf, gsq, loss_sum, loss_n):
        """Host-side classification of the agreed global vector against
        the trailing robust window.  Pure: identical inputs + window
        state give the identical verdict on every rank (the window is
        fed only by agreed values, so it stays identical too)."""
        loss = (loss_sum / loss_n) if loss_n > 0 else None
        norm = float(np.sqrt(max(gsq, 0.0)))
        self.last_stats = {"nonfinite": nf, "grad_norm": norm,
                           "loss": loss}
        if nf > 0 or (loss is not None and not np.isfinite(loss)) \
                or not np.isfinite(norm):
            verdict = "nonfinite"
        elif loss is not None and _robust_spike(loss, self._losses,
                                                self._loss_spike):
            verdict = "loss_spike"
        elif gsq > 0 and _robust_spike(norm, self._norms,
                                       self._grad_spike):
            verdict = "grad_anomaly"
        else:
            verdict = "ok"
        if verdict == "ok":
            # only clean steps feed the baseline: a burst of anomalies
            # cannot drag the median toward itself
            if loss is not None:
                self._losses.append(loss)
            if gsq > 0:
                self._norms.append(norm)
        self._recent.append(0 if verdict == "ok" else 1)
        return verdict

    # -- the remediation ladder -------------------------------------------
    def action(self, verdict):
        """Map an agreed verdict to ``commit`` | ``skip`` | ``rewind``.
        Deterministic in (verdict, window state, knobs) — all agreed or
        rank-uniform — so every rank takes the same action at the same
        step."""
        if verdict == "ok":
            return "commit"
        if self._rewind_after > 0 and \
                sum(self._recent) >= self._rewind_after:
            if self._manager is not None:
                return "rewind"
            if not self._rewind_warned:
                self._rewind_warned = True
                _LOGGER.warning(
                    "guard: %d anomalies in the window but no "
                    "CheckpointManager bound (Guard.bind_rewind) — "
                    "staying at skip", sum(self._recent))
        return "skip" if self._skip else "commit"

    def note_skip(self, verdict):
        """Account one zeroed update (telemetry + flight event)."""
        _SKIPS_TOTAL.inc()
        self._flight_note("guard_skip", verdict=verdict)

    def rewind(self):
        """Drop back to the newest VALID checkpoint and re-apply its
        exact train state (RNG, dataloader position, loss scale) —
        the exact resume, triggered by values instead of a
        crash.  Returns the step rewound to (None when no valid
        checkpoint exists — the caller falls back to skip).  Wall time
        is charged to the ``rewind`` goodput bucket."""
        _fault.check("guard.rewind")
        if self._manager is None:
            return None
        t0 = time.perf_counter()
        step = self._manager.latest_valid_step()
        if step is None:
            _LOGGER.warning("guard: rewind requested but no valid "
                            "checkpoint exists — skipping instead")
            return None
        self._manager.restore(self._net, self._trainer, step=step)
        ts = self._manager.read_train_state(step)
        if ts:
            from . import lifecycle as _lifecycle

            _lifecycle.restore_train_state(ts, self._dataloader,
                                           self._scaler)
            if ts.get("guard") is not None:
                self.load_state_dict(ts["guard"])
        # the anomalous episode is over: restart the ladder so the
        # resumed trajectory gets a fresh window (a stale anomaly count
        # would re-trip the rewind on its first wobble)
        self._recent.clear()
        self._losses.clear()
        self._norms.clear()
        self._agreed = "ok"
        _REWINDS_TOTAL.inc()
        dt = time.perf_counter() - t0
        _telemetry.goodput_note("rewind", dt)
        self._flight_note("guard_rewind", step=int(step),
                          seconds=round(dt, 6))
        _LOGGER.warning("guard: rewound to step %d after repeated "
                        "anomalies (%.3fs)", step, dt)
        return step

    # -- quarantine: canary recompute + cross-rank vote --------------------
    def canary(self, fn, step=None):
        """Recompute a caller-provided DETERMINISTIC microbatch (``fn()``,
        pure, identical on every rank) and digest its bytes (24-bit
        crc32), stamped into the flight recorder as ``guard_canary``.  One
        process returns the digest; the vote across ranks (a minority
        digest raising :class:`NumericalDivergence` everywhere) waits for
        the port's collectives and raises with more than one process."""
        _fault.check("guard.canary")
        _CANARY_TOTAL.inc()
        out = fn()
        digest = _crc32(out) & 0xFFFFFF
        self._flight_note("guard_canary", step=step, digest=int(digest))
        if world_size() <= 1 and not self._testing_force:
            return int(digest)
        from .parallel.collectives import allreduce_hosts, rank

        slots = torch.zeros(max(world_size(), 1), dtype=torch.float64)
        slots[rank()] = float(digest)
        table = [int(d) for d in allreduce_hosts(
            slots, _testing_force=self._testing_force).tolist()]
        counts = collections.Counter(table)
        majority = max(sorted(counts), key=lambda d: counts[d])
        minority = sorted(r for r, d in enumerate(table) if d != majority)
        if minority and len(set(counts.values())) > 1:
            self._flight_note("guard_canary_divergence", step=step,
                              ranks=minority, digests=table)
            raise NumericalDivergence(
                f"canary recompute diverged: rank(s) {minority} disagree "
                f"with the {counts[majority]}-rank majority digest "
                f"{majority:#08x} at step {step}: silent data corruption "
                f"on the minority rank(s)", ranks=minority)
        return int(digest)

    # -- exact-resume state -------------------------------------------------
    def state_dict(self):
        """Window + ladder state for bit-exact resume: a resumed run
        classifies its next step exactly as the original would have
        (``lifecycle.capture_train_state(guard=...)``)."""
        return {"losses": [float(v) for v in self._losses],
                "norms": [float(v) for v in self._norms],
                "recent": [int(v) for v in self._recent],
                "calls": int(self._calls),
                "agreed": str(self._agreed)}

    def load_state_dict(self, state):
        self._losses.clear()
        self._losses.extend(float(v) for v in state.get("losses", ()))
        self._norms.clear()
        self._norms.extend(float(v) for v in state.get("norms", ()))
        self._recent.clear()
        self._recent.extend(int(v) for v in state.get("recent", ()))
        self._calls = int(state.get("calls", 0))
        self._agreed = str(state.get("agreed", "ok"))

    # -- the fused-path (TrainStep) sentinel --------------------------------
    def poll_loss(self, loss, step=None):
        """Loss-only sentinel for the fused jit path, where gradients
        never surface and the update is committed
        before any verdict can land: a skip is impossible, so the
        ladder escalates straight to :class:`GuardRewind` — absorbed by
        ``run_with_recovery`` as a rewind-class restart from the latest
        valid checkpoint.  Returns the verdict."""
        verdict = self.check(loss=loss)
        if verdict == "ok":
            return verdict
        if self.action(verdict) == "rewind" or (
                self._rewind_after > 0
                and sum(self._recent) >= self._rewind_after):
            self._recent.clear()
            raise GuardRewind(
                f"guard verdict {verdict!r} persisted for "
                f"{self._rewind_after} steps on the fused path at "
                f"step {step} — escalating to a checkpoint rewind")
        self.note_skip(verdict)
        return verdict

    @staticmethod
    def _flight_note(kind, **fields):
        """Context event into the flight-recorder ring — lazy and
        failure-tolerant (telemetry's ``_flight_note`` shape)."""
        try:
            from . import flight_recorder as _flight

            clean = {k: v for k, v in fields.items() if v is not None}
            _flight.record_event(kind, **clean)
        except Exception:
            pass


# --------------------------------------------------------------------------
# quarantine: post-allreduce per-bucket checksum stamps
# --------------------------------------------------------------------------
def _crc32(value):
    """crc32 of a tensor's, an NDArray's or an array's bytes (read to the
    host)."""
    value = getattr(value, "_data", value)
    if isinstance(value, torch.Tensor):
        raw = value.detach().contiguous().reshape(-1).view(torch.uint8)
        data = raw.cpu().numpy().tobytes()
    else:
        data = np.ascontiguousarray(np.asarray(value)).tobytes()
    return zlib.crc32(data)


def stamp_bucket_checksum(key, flat, step=None):
    """Stamp the crc32 of a gradient bucket (a tensor, an NDArray or an
    array) into the flight-recorder ring (quarantine tier,
    ``MXNET_GUARD_CHECKSUM=1``; ``gluon.Trainer`` stamps its gradients
    each step).

    A reduced bucket is bit-identical on every rank by construction, so
    digests that differ at the same (step, key) across the merged
    black-box rings are evidence of corruption or desync on specific
    rank(s): ``telemetry_agg.merge_blackboxes`` names the minority.  The
    host read is the quarantine tier's deliberate cost, off by default.
    """
    try:
        from . import flight_recorder as _flight

        # the quarantine tier's deliberate read: the digest covers the
        # exact bytes the rank holds
        crc = _crc32(flat) & 0xFFFFFFFF
        _CHECKSUMS_TOTAL.inc()
        fields = {"key": str(key), "crc": int(crc),
                  "seq": _flight.position()}
        if step is not None:
            fields["step"] = int(step)
        _flight.record_event("guard_checksum", **fields)
    except Exception:
        # evidence collection must never take down the step loop
        _LOGGER.debug("guard checksum stamp failed", exc_info=True)


# --------------------------------------------------------------------------
# the Trainer verdict gate
# --------------------------------------------------------------------------
def attach(trainer, guard=None, manager=None, net=None, dataloader=None):
    """Wrap ``trainer.step`` with the guard verdict gate.

    Composes with AMP: call AFTER ``amp.init_trainer`` and the guarded
    step REPLACES the AMP wrapper's separate ``has_overflow`` sync —
    the fused sentinel's non-finite channel feeds
    ``LossScaler.update_scale`` directly, so a guarded AMP step pays
    exactly ONE host sync total and the overflow verdict is identical
    to the standalone scaler's (the parity test pins this).

    Per step: ``check`` → ``action`` → commit (the original step) /
    skip (update zeroed, counted) / rewind (bound via ``manager``).
    The staged loss for the loss-spike sentinel is fed with
    ``trainer._guard.observe_loss(loss)`` — optional; without it the
    loss channel is simply absent.  Returns ``trainer``."""
    g = guard if guard is not None else Guard()
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if manager is not None:
        g.bind_rewind(manager, net=net, trainer=trainer,
                      dataloader=dataloader, scaler=scaler)
    # the PLAIN class step, even when amp.init_trainer already replaced
    # the instance attribute: the unified gate below owns both the
    # verdict and the loss-scale bookkeeping the AMP wrapper did
    plain_step = type(trainer).step.__get__(trainer)
    g._staged_loss = None

    def observe_loss(loss):
        g._staged_loss = loss

    def guarded_step(batch_size, ignore_stale_grad=False):
        staged, g._staged_loss = g._staged_loss, None
        verdict = g.check(trainer._params, loss=staged)
        act = g.action(verdict)
        if act == "rewind":
            if g.rewind() is None:
                act = "skip"
        if verdict == "ok":
            if scaler is not None:
                eff = 1.0 if trainer._amp_unscaled \
                    else scaler.loss_scale
                trainer._scale = trainer._amp_original_scale / eff
                plain_step(batch_size,
                           ignore_stale_grad=ignore_stale_grad)
                trainer._scale = trainer._amp_original_scale
            else:
                plain_step(batch_size,
                           ignore_stale_grad=ignore_stale_grad)
        elif act == "skip":
            g.note_skip(verdict)
        if scaler is not None:
            trainer._amp_unscaled = False
            # the agreed non-finite channel IS the overflow verdict —
            # no second has_overflow sync
            scaler.update_scale(g.last_stats["nonfinite"] > 0)

    trainer._guard = g
    g.observe_loss = observe_loss
    trainer.step = guarded_step
    return trainer
