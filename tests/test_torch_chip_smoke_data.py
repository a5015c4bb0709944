"""The checks of ``chip_smoke.py``'s phase 12 (the data path) on the CPU at
a small size: the same functions the card runs, CPU against CPU.

(a) the Criteo-shaped LibSVM file, LibSVMIter's CSR batches, the CSR
products' check (within rounding on the same device) and the shifted row
pointer it must catch, and the FM example's lazy-SGD steps with a falling loss;
(b) the record batch at 1 and at 3 decode threads equal bit for bit and to
the oracle with the per-record seeds written out, and a shared decode
stream (planted) failing it; (c) phase 9 (d)'s recipe fed by the
DataLoader (here without worker processes: the two tests that spawn them
are in ``test_torch_gluon_data.py``) gives the list-fed losses bit for
bit, and the captured loader state restores a fresh loader to the same
next batches, which a skipped restore (planted) does not.
"""
import numpy as np
import pytest

import chip_smoke
from mxnet_tpu_torch.contrib import amp


@pytest.fixture(autouse=True)
def _amp_off():
    yield
    amp.disable()


def test_fm_checks_pass_and_catch_a_shifted_row_pointer(tmp_path):
    out = chip_smoke.data_fm(0, device="cpu", features=2 ** 12, batch=128,
                             steps=8, cpu_steps=3, directory=str(tmp_path))
    # the gathers' backward accumulates in a thread-dependent order
    assert max(out["devs"].values()) <= 1e-5
    assert out["fault"] > chip_smoke.DATA_TOL
    assert max(out["gaps"]) <= 1e-6 and len(out["gaps"]) == 3
    assert out["losses"][-1] < out["losses"][0]
    assert out["nnz_first"] == 128 * sum(chip_smoke.FM_FIELDS)


def test_record_checks_and_the_planted_decode(tmp_path):
    rec, nbytes = chip_smoke.write_image_records(str(tmp_path), 12, 40, 0)
    assert nbytes > 12 * 40 * 40 * 3
    kw = dict(batch=6, shape=(3, 32, 32))
    assert chip_smoke.record_batch_checks(rec, 3, **kw) == (True, True)
    with chip_smoke.planted_decode_fault():
        assert chip_smoke.record_batch_checks(rec, 3, **kw)[1] is False
    assert chip_smoke.record_batch_checks(rec, 3, **kw) == (True, True)


def _tiny_bert_cfg():
    from mxnet_tpu_torch.gluon.model_zoo.language import bert

    return bert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                           num_heads=2, intermediate_size=64,
                           max_position=32)


def test_dataloader_recipe_and_resume():
    out = chip_smoke.dataloader_recipe(0, device="cpu", cfg=_tiny_bert_cfg(),
                                       steps=4, workers=0, seq=16, batch=8,
                                       resume_at=2)
    assert out["losses"] == out["list_losses"]
    assert all(np.isfinite(out["losses"]))
    assert out["on_card"] and not any(out["inited"])
    assert len(out["tail"]) == 2
    assert out["state"]["dataloader"]["batch"] == 2
    assert chip_smoke.resume_checks(out, 0, device="cpu", workers=0) == \
        (False, True)    # (the restore skipped, restored)
