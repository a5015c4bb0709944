"""The tuning funnel of the port (``mxnet_tpu_torch.tuning``) against the
reference's (``mxnet_tpu.tuning``) on the CPU.

The registry is the reference's in names, types, env vars, scorer
families, grids and defaults, except the flash-attention tiles: the
reference's grids (128, 256, 512) are MXU lane tiles of the TPU kernel,
the port's (64, 128) the query and key tiles the Hopper kernel is built
at for D = 64 and 128 (default 128 in both).  The schedule, the
successive halving under one deterministic measure and the precedence
(trial > env pin > stored winner > default) are the same in both; the DB
round-trips, and a corrupt, truncated or mismatched entry is a miss; a
reference entry is a miss in the port by its fingerprint.
"""
import os
import shutil

import pytest

from mxnet_tpu import tuning as rtuning
from mxnet_tpu_torch import tuning as ptuning
from mxnet_tpu_torch.ops import flash_attention as pfa
from torch_threads import one_torch_thread  # noqa: F401

FLASH = ("flash_block_q", "flash_block_kv")
PORT_FLASH_GRID = (64, 128)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for knob in ptuning.all_knobs():
        monkeypatch.delenv(knob.env_var, raising=False)
    monkeypatch.delenv("MXNET_TUNE", raising=False)
    monkeypatch.delenv("MXNET_TUNE_DB_DIR", raising=False)
    ptuning.reset()
    rtuning.reset()
    yield
    ptuning.reset()
    rtuning.reset()


def test_registry_matches_the_reference_but_the_flash_tiles():
    assert ptuning.knob_names() == rtuning.knob_names()
    for pk, rk in zip(ptuning.all_knobs(), rtuning.all_knobs()):
        assert (pk.name, pk.env_var, pk.type, pk.kind) == \
            (rk.name, rk.env_var, rk.type, rk.kind)
        if pk.name in FLASH:
            assert rk.grid == (128, 256, 512)
            assert pk.grid == PORT_FLASH_GRID
            assert pk.default == rk.default == 128
        else:
            assert (pk.grid, pk.default) == (rk.grid, rk.default)
    # the port's flash grid is the kernel's tiles at D = 64 and 128
    for d in (64, 128):
        assert sorted({q for q, _ in pfa.KERNEL_TILES[d]}) == \
            list(PORT_FLASH_GRID)
        assert sorted({k for _, k in pfa.KERNEL_TILES[d]}) == \
            list(PORT_FLASH_GRID)
        assert pfa.KERNEL_TILES[d][0] == (128, 128)


@pytest.mark.parametrize("name", [k.name for k in rtuning.all_knobs()])
def test_schedule_and_halving_match(name):
    # the same Knob object through both drivers: the schedule is a pure
    # function of the grid, so the port's knob walks one schedule in both
    knob = ptuning.get_knob(name)
    for rungs, budget0, eta in ((2, 2, 2), (3, 1, 3)):
        assert ptuning.schedule(knob, rungs, budget0, eta) == \
            rtuning.schedule(knob, rungs, budget0, eta)

    def measure(value, budget):
        return (hash(str(value)) % 97) / (1 + budget)

    assert ptuning.successive_halving(knob, measure) == \
        rtuning.successive_halving(knob, measure)


@pytest.mark.parametrize("pkg", [ptuning, rtuning], ids=["port", "reference"])
def test_precedence(pkg, tmp_path, monkeypatch):
    knob = pkg.get_knob("prefetch_buffer")
    db = pkg.TuningDB(str(tmp_path))
    assert db.put_winner(knob, 4)
    assert pkg.resolve_info("prefetch_buffer", db=db) == (2, "default")
    monkeypatch.setenv("MXNET_TUNE", "1")
    pkg.reset()
    assert pkg.resolve_info("prefetch_buffer", db=db) == (4, "tuned")
    monkeypatch.setenv("MXNET_PREFETCH_BUFFER", "8")
    assert pkg.resolve_info("prefetch_buffer", db=db) == (8, "env")
    with pkg.trial_override("prefetch_buffer", 1):
        assert pkg.resolve_info("prefetch_buffer", db=db) == (1, "trial")
    assert pkg.resolve_info("prefetch_buffer", db=db) == (8, "env")


def test_tune_knob_stores_and_replays(tmp_path, monkeypatch):
    db = ptuning.TuningDB(str(tmp_path))
    sig = ("bert", 64, 128)
    report = ptuning.tune_knob("flash_block_kv",
                               lambda v, b: 1.0 if v == 64 else 2.0, db=db,
                               signature=sig)
    assert report["winner"] == 64 and report["stored"]
    # rung 0: 2 candidates; rung 1: the winner; then the default (pruned
    # at rung 0) once more at the final budget, for its delta
    assert report["trials"] == 4
    monkeypatch.setenv("MXNET_TUNE", "1")
    monkeypatch.setenv("MXNET_TUNE_DB_DIR", str(tmp_path))
    ptuning.reset()
    assert ptuning.resolve_info("flash_block_kv", signature=sig) == \
        (64, "tuned")
    # an env pin is never searched
    monkeypatch.setenv("MXNET_FLASH_BLOCK_KV", "128")
    pinned = ptuning.tune_knob("flash_block_kv", lambda v, b: 0.0, db=db)
    assert pinned["trials"] == 0 and pinned["pinned"] == 128


def _entry(db, knob):
    return os.path.join(db.directory, db.key(knob.name) + ".tune")


@pytest.mark.parametrize("damage", ["corrupt", "truncated", "fingerprint",
                                    "garbage", "out_of_grid"])
def test_damaged_entries_are_misses(tmp_path, damage):
    knob = ptuning.get_knob("serving_page_size")
    db = ptuning.TuningDB(str(tmp_path))
    assert db.put_winner(knob, 32)
    assert db.get_winner(knob) == 32
    path = _entry(db, knob)
    with open(path, "rb") as f:
        header, payload = f.read().split(b"\n", 1)
    if damage == "corrupt":
        payload = payload.replace(b"32", b"16")
    elif damage == "truncated":
        payload = payload[:len(payload) // 2]
    elif damage == "fingerprint":
        header = header.replace(b"torch=", b"torch=0.0.")
    elif damage == "garbage":
        header = b"{not json"
    else:
        # a well-formed entry whose value the grid no longer holds
        db2 = ptuning.TuningDB(str(tmp_path / "other"))
        db2.put(db2.key(knob.name), {"knob": knob.name, "value": "24"})
        assert db2.get_winner(knob) is None
        return
    with open(path, "wb") as f:
        f.write(header + b"\n" + payload)
    assert db.get_winner(knob) is None


def test_a_reference_entry_is_a_miss_in_the_port(tmp_path):
    rknob = rtuning.get_knob("serving_page_size")
    pknob = ptuning.get_knob("serving_page_size")
    rdb = rtuning.TuningDB(str(tmp_path / "ref"))
    assert rdb.put_winner(rknob, 32)
    assert rdb.get_winner(rknob) == 32
    pdb = ptuning.TuningDB(str(tmp_path / "port"))
    os.makedirs(pdb.directory)
    # the reference's file under the port's own key: its header carries
    # the jax fingerprint, so the port's verification rejects it
    shutil.copy(_entry(rdb, rknob), _entry(pdb, pknob))
    assert pdb.get_winner(pknob) is None
    assert pdb.put_winner(pknob, 32) and pdb.get_winner(pknob) == 32


def test_fingerprint_names_torch_cuda_and_the_device():
    from mxnet_tpu_torch.tuning import db as pdb

    fp = pdb._fingerprint()
    assert fp.startswith("torch=") and ";cuda=" in fp
    assert f";device={pdb.device_kind()};" in fp and "jax" not in fp


def test_flash_tiles_resolve_through_the_funnel(monkeypatch):
    import torch

    q = torch.zeros(1, 2, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    assert pfa._fa_block_sizes(q, k, False) == (128, 128)
    monkeypatch.setenv("MXNET_FLASH_BLOCK_Q", "64")
    assert pfa._fa_block_sizes(q, k, False) == (64, 128)
    with ptuning.trial_override("flash_block_kv", 64):
        assert pfa._fa_block_sizes(q, k, False) == (64, 64)
    # D = 256 has its one 64 x 64 tile: the default gives it; a pinned
    # query tile of 128 is not built there and raises, naming the tiles
    q256, k256 = torch.zeros(1, 2, 8, 256), torch.zeros(1, 2, 8, 256)
    monkeypatch.delenv("MXNET_FLASH_BLOCK_Q")
    assert pfa._fa_block_sizes(q256, k256, True) == (64, 64)
    monkeypatch.setenv("MXNET_FLASH_BLOCK_Q", "128")
    with pytest.raises(Exception, match="64 x 64"):
        pfa._fa_block_sizes(q256, k256, True)
