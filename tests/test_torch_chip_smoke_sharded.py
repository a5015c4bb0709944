"""Phase 16 of ``chip_smoke.py`` (the sharded training step) at a tiny
size on the CPU: (b)-(d) run as on the card, one pair of ranks started
as children of the script (``--mp-rank``, ``--mp-tiny``) over gloo, each
held to its one-rank step: tp = 2 within ``MP_TP_BOUND``, GPipe and 1F1B
within ``MP_PP_BOUND``, ring and Ulysses attention within ``MP_SP_BOUND``
of the plain attention, and each planted fault (the row-parallel
all-reduce left out, the kv heads off their query group, the
microbatches reversed in 1F1B's backward, the ring's source shard off by
one) beyond its bound.  (a) needs a NCCL communicator on a card, and the
launch counts a card's kernel: they run only there.  (e), the planner's
reading, runs here at full width (nothing allocated)."""
import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401


def test_two_rank_phase_on_the_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_LIFECYCLE_SIGNALS", "0")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the two ranks' threads
    launches, rank0 = chip_smoke.mp_two_rank_phase(0, tiny=True)
    assert launches == {"mp_tp_llama": 0, "mp_pp_gpipe": 0,
                        "mp_pp_1f1b": 0}            # no kernel on the CPU
    tp, pp, sp = rank0["tp"], rank0["pp"], rank0["sp"]
    assert tp["ratio"] <= chip_smoke.MP_TP_BOUND
    assert min(tp["faults"].values()) > chip_smoke.MP_TP_BOUND
    assert pp["gpipe"]["ratio"] <= chip_smoke.MP_PP_BOUND
    assert pp["1f1b"]["ratio"] <= chip_smoke.MP_PP_BOUND
    assert pp["fault"] > chip_smoke.MP_PP_BOUND
    assert max(sp["ring"]["err"], sp["ulysses"]["err"]) <= \
        chip_smoke.MP_SP_BOUND < sp["fault"]


def test_planner_reading_at_full_width(monkeypatch):
    monkeypatch.setenv("MXNET_PLANNER_HBM_GB", "80")
    monkeypatch.setattr(chip_smoke, "gpu_line", lambda: "the CPU")
    plan = chip_smoke.mp_planner_reading()
    assert plan.device_count() == chip_smoke.MP_PLAN_DEVICES
    assert plan.hbm["feasible"]
    assert len(plan.signature) == 2 + 9 * 32 + 1
