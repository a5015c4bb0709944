"""Phase 15 of ``chip_smoke.py`` (data parallelism across processes) at a
tiny size on the CPU: (b) and (c) run as on the card, two ranks started
through the repo's ``tools/launch.py -n 2`` over the dist_sync store
(here over gloo on the CPU, ``--dp-tiny``), each on its half of the
batch, held against this process's one-rank step at the whole batch:
SGD updated on the store (per key) and in the Trainer's flat buckets
within ``DP_SGD_BOUND`` of the update, ZeRO Adam within
``DP_ADAM_BOUND`` with half the state a rank, a planted data fault
beyond each bound on the per-key and the ZeRO path, and the agreements (a stop on rank 1 only, an overflow on rank 1 only,
SyncBatchNorm's global statistics, one checkpoint writer).  (a) needs a
CUDA card (a NCCL communicator) and runs only there."""
import numpy as np

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo.language import bert
from torch_threads import one_torch_thread  # noqa: F401


def test_two_rank_phase_on_the_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_LIFECYCLE_SIGNALS", "0")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the two ranks' threads
    cfg = bert.BertConfig(**chip_smoke.DP_TINY)
    ids, labels = chip_smoke.bert_batch(0, chip_smoke.DP_TINY_BATCH,
                                        chip_smoke.DP_TINY_SEQ,
                                        cfg.vocab_size)
    net = chip_smoke.init_bert(cfg, 0, mx.cpu(), chip_smoke.DP_TINY_SEQ)
    n = sum(p.data().size for p in net.collect_params().values())
    # (a)'s one-rank ZeRO Adam state: two fp32 moments a parameter
    launches = chip_smoke.dp_two_process_phase(0, cfg, ids, labels, 8 * n,
                                               tiny=True)
    assert launches == 0            # no kernel on the CPU


def test_dp_diff_measures_against_the_update():
    import torch

    init = [torch.zeros(3), torch.zeros(2)]
    want = [torch.tensor([1.0, 2.0, 0.0]), torch.tensor([0.0, 4.0])]
    got = [w.clone() for w in want]
    got[1][0] = 0.4
    r_max, r_l2 = chip_smoke._dp_diff(got, want, init)
    assert np.isclose(r_max, 0.1)
    assert np.isclose(r_l2, 0.4 / np.sqrt(21.0))


STOP_CHILDREN_DRIVE = r"""
import json, subprocess, sys, time
import chip_smoke as cs

cs.become_subreaper()
# a grandchild whose parent has ended, in a session of its own, that
# ignores SIGTERM; and a plain child
subprocess.run([sys.executable, "-c",
                "import subprocess, sys; subprocess.Popen([sys.executable, "
                "'-c', 'import signal, time; signal.signal(signal.SIGTERM, "
                "signal.SIG_IGN); print(1, flush=True); time.sleep(120)'], "
                "start_new_session=True)"], check=True)
child = subprocess.Popen(["sleep", "120"])
deadline = time.monotonic() + 30
while len(cs.descendants()) < 2 and time.monotonic() < deadline:
    time.sleep(0.05)
seen = sorted(cs.descendants())
left = cs.stop_children(say=lambda m: None, grace=1.0)
print(json.dumps({"seen": seen, "left": sorted(left),
                  "after": sorted(cs.descendants())}))
"""


def test_stop_children_stops_what_the_script_started(tmp_path):
    """The script ends every process it started, an orphaned grandchild
    that ignores SIGTERM in a session of its own included."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", STOP_CHILDREN_DRIVE],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=here))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["seen"]) == 2, out
    assert out["left"] == [] and out["after"] == [], out
    for pid in out["seen"]:
        assert not os.path.exists(f"/proc/{pid}"), pid
