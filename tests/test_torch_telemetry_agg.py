"""Cross-rank telemetry aggregation of the port
(``mxnet_tpu_torch.telemetry_agg``) against the reference's
(``mxnet_tpu.telemetry_agg``) on the CPU.

- ``merge_snapshots`` and ``skew_from_snapshots`` of the same snapshots
  give the same document in both (and a merge is deterministic).
- ``merge_blackboxes`` gives the same verdict, blamed ranks, sequence
  number and tag in both, for a hang, a desync, a numerical divergence
  and a single ring.
- Two CPU child processes publish their snapshots to one directory
  (``MXNET_TELEMETRY_AGG_DIR``, ``MXNET_TELEMETRY_AGG_EVERY=1``, the
  launcher's ``RANK``/``WORLD_SIZE``) and the parent merges them; the KV
  transport goes through a ``torch.distributed.TCPStore`` on localhost.
"""
import json
import os
import subprocess
import sys

import pytest

from mxnet_tpu import telemetry_agg as ragg
from mxnet_tpu_torch import telemetry, telemetry_agg as pagg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    pagg.reset()
    ragg.reset()
    yield
    pagg.reset()
    ragg.reset()


def _snap(rank, walls):
    steps = [{"step": i, "time": 100.0 + i, "wall_s": sum(p.values()),
              "phases": p} for i, p in enumerate(walls)]
    return {"time": 1000.0 + rank, "rank": rank, "steps": steps,
            "metrics": {"mxnet_steps_total": {
                "type": "counter", "help": "steps",
                "samples": [{"labels": {}, "value": float(len(steps))}]},
                "mxnet_serving_tokens_total": {
                "type": "counter", "help": "tokens",
                "samples": [{"labels": {"kind": "prompt"},
                             "value": 10.0 * rank}]}},
            "compile": {"count": rank}, "goodput": {"productive_ratio": 0.9}}


SNAPS = {0: _snap(0, [{"data": 0.1, "compute": 0.5}] * 3),
         1: _snap(1, [{"data": 0.3, "compute": 0.45}] * 2),
         2: _snap(2, [{"data": 0.12, "compute": 0.5, "other": 0.01}] * 4)}


def test_merge_and_skew_match_the_reference():
    got = pagg.merge_snapshots(SNAPS)
    assert got == ragg.merge_snapshots(SNAPS)
    assert got == pagg.merge_snapshots(json.loads(json.dumps(SNAPS)))
    assert got["skew"]["step"] == 1
    assert got["skew"]["phases"]["data"] == pytest.approx(0.2)
    assert pagg.skew_from_snapshots(SNAPS) == \
        ragg.skew_from_snapshots(SNAPS)


def _coll(seq, tag, exited=True, error=None):
    e = {"kind": "collective", "seq": seq, "tag": tag, "t0": 1.0 + seq}
    if exited:
        e["t1"] = 1.5 + seq
    if error:
        e["error"] = error
    return e


def _box(rank, events, world=2):
    return {"rank": rank, "world": world, "reason": "test", "time": 5.0,
            "position": len(events), "events": events}


BOXES = {
    "hang": {0: _box(0, [_coll(1, "a"), _coll(2, "b"), _coll(3, "c",
                                                          exited=False)]),
             1: _box(1, [_coll(1, "a"), _coll(2, "b")])},
    "desync": {0: _box(0, [_coll(1, "a"), _coll(2, "b")], 3),
               1: _box(1, [_coll(1, "a"), _coll(2, "x")], 3),
               2: _box(2, [_coll(1, "a"), _coll(2, "b")], 3)},
    "divergence": {r: _box(r, [_coll(1, "a"),
                               {"kind": "guard_checksum", "step": 4,
                                "key": "__grad_bucket0",
                                "crc": 7 if r == 1 else 9, "seq": 1},
                               {"kind": "step", "step": 4}], 3)
                   for r in range(3)},
    "single": {0: _box(0, [_coll(1, "a")], 1)},
}


@pytest.mark.parametrize("case", sorted(BOXES))
def test_blackbox_blame_matches_the_reference(case):
    got = pagg.merge_blackboxes(BOXES[case])
    want = ragg.merge_blackboxes(BOXES[case])
    assert got == want
    kind = got["verdict"]["kind"]
    assert kind == {"hang": "hang", "desync": "desync",
                    "divergence": "numerical_divergence",
                    "single": "single_rank"}[case]
    if case in ("hang", "desync", "divergence"):
        assert got["verdict"]["ranks"] == [1]


def test_two_child_processes_publish_and_the_parent_merges(tmp_path):
    code = ("from mxnet_tpu_torch import telemetry, telemetry_agg\n"
            "import time\n"
            "for i in range(3):\n"
            "    telemetry.step_begin(i)\n"
            "    with telemetry.phase('data'):\n"
            "        time.sleep(0.001)\n"
            "    telemetry.step_end()\n"
            "print(telemetry_agg.configure()['rank'])\n")
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank),
                   WORLD_SIZE="2", MXNET_TELEMETRY_AGG_DIR=str(tmp_path),
                   MXNET_TELEMETRY_AGG_EVERY="1")
        for var in ("MXNET_WORKER_ID", "DMLC_WORKER_ID",
                    "MXNET_NUM_WORKERS", "DMLC_NUM_WORKER"):
            env.pop(var, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip() for o, _ in outs] == ["0", "1"]
    assert sorted(os.listdir(tmp_path)) == ["rank0.json", "rank1.json"]
    doc = pagg.merge_dir(str(tmp_path))
    assert doc["ranks"] == [0, 1]
    assert doc["skew"]["step"] == 2 and "data" in doc["skew"]["phases"]
    assert doc == ragg.merge_snapshots(pagg.read_dir(str(tmp_path)))
    steps = doc["metrics"]["mxnet_steps_total"]["samples"]
    assert sorted(s["labels"]["rank"] for s in steps) == ["0", "1"]


def test_rank_zero_tick_merges_and_serves(tmp_path):
    pagg.configure(directory=str(tmp_path), every=2, rank=0, world=1)
    assert pagg.tick() is None          # the first tick of the stride
    doc = pagg.tick()
    assert doc["ranks"] == [0] and pagg.merged() == doc
    code, ctype, body = pagg._http_agg("GET", "/agg", {}, b"")
    assert code == 200 and json.loads(body)["ranks"] == [0]


def test_kv_transport_through_a_tcp_store():
    from torch.distributed import TCPStore

    store = TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False)
    assert pagg.publish_kv(store, 0)
    telemetry.step_begin(0)
    telemetry.step_end()
    assert pagg.publish_kv(store, 1)
    snaps = pagg.read_kv(store, 3)       # rank 2 never published
    assert sorted(snaps) == [0, 1] and snaps[1]["rank"] == 1
    pagg.configure(every=1, rank=0, world=2, transport="kv",
                   kv_client=store)
    doc = pagg.tick()
    assert doc["ranks"] == [0, 1]
