"""The checks of ``chip_smoke.py``'s phase 14 (the symbolic half) on the
CPU at a small size: the same functions the card runs, CPU against CPU.

(a) a 2-layer BERT exported and imported: the imported forward equal to
the Gluon net's bit for bit, hybridized too, the two planted faults
(query and key weights swapped in the params file, the attention's scale
changed in the symbol file) failing that equality, the fine-tuning steps
through the imported block within their bounds; (b) a ResNet-18 (NHWC,
32²) exported and trained through ``Module.load`` with a SoftmaxOutput
head: the fp32 and fp64 steps, the running stats written back, the
Trainer step, ``fit`` with ``do_checkpoint`` and the loaded checkpoint's
score; (c) ``check_consistency`` over two CPU contexts, an offset planted
on the last one raising.
"""
import pytest

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.language import bert
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _amp_off():
    yield
    amp.disable()


def test_bert_export_import_and_its_planted_faults(tmp_path):
    cfg = bert.BertConfig(vocab_size=96, hidden_size=32, num_layers=2,
                          num_heads=2, intermediate_size=64, max_position=32,
                          dropout=0.0)
    launches, times = chip_smoke.symbolic_bert(
        0, str(tmp_path), ctx=mx.cpu(), cfg=cfg, batch=2, check_batch=2,
        seq=16, timed=False)
    assert launches == 0 and times == {}      # no kernel on the CPU


@pytest.mark.parametrize("fault", ["swap_qk", "sm_scale"])
def test_planted_exports_change_only_their_target(fault, tmp_path):
    import json

    import numpy as np

    net = bert.BertForPretraining(bert.BertConfig(
        vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_position=32, dropout=0.0))
    net.initialize(ctx=mx.cpu())
    ids = mx.nd.array(np.zeros((1, 8)), ctx=mx.cpu(), dtype="int32")
    net(ids)
    prefix = str(tmp_path / "b")
    net.export(prefix, 0, ids)
    out = chip_smoke.planted_export(prefix, fault, str(tmp_path))
    a = mx.nd.load(prefix + "-0000.params", ctx=mx.cpu())
    b = mx.nd.load(out + "-0000.params", ctx=mx.cpu())
    changed = [k for k in a if not np.array_equal(a[k].asnumpy(),
                                                  b[k].asnumpy())]
    sa = json.load(open(prefix + "-symbol.json"))
    sb = json.load(open(out + "-symbol.json"))
    diff = [i for i, (x, y) in enumerate(zip(sa["nodes"], sb["nodes"]))
            if x != y]
    if fault == "swap_qk":
        assert sorted(changed) == ["arg:bert.encoder.0.attention.key.weight",
                                   "arg:bert.encoder.0.attention.query.weight"]
        assert diff == []
    else:
        assert changed == [] and len(diff) == 1
        assert sb["nodes"][diff[0]]["op"] == "_contrib_flash_attention"


def test_resnet_through_module(tmp_path):
    def small():
        return vision.resnet18_v1(layout="NHWC", classes=10)

    assert chip_smoke.symbolic_module(
        0, str(tmp_path), ctx=mx.cpu(), make_net=small, batch=2, size=32,
        fit_batches=2, timed=False, classes=10) is None


def test_consistency_and_its_planted_offset():
    chip_smoke.symbolic_consistency(
        0, ctx_list=[mx.cpu(0), mx.cpu(1)],
        shape=(2, 2, 2, 16, 16, 8, False, False), conv_batch=2)
