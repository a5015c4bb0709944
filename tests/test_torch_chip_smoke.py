"""The fp32 serving check of ``chip_smoke.py`` on the CPU at a small size:
it passes a correct engine, and each planted fault in the paged cache
(a decode position off by one, page-table rows of the batch swapped, a
prompt written into the wrong pages) fails it.  On the card the same check
runs at Llama-3-8B widths; here it shows the tolerance sits between fp32
rounding and what a paging fault does to the logits.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch.gluon.model_zoo.language import llama as port_llama
from mxnet_tpu_torch.ops import flash_attention as port_fa
from mxnet_tpu_torch.serving import ServingEngine


def _plant(engine, fault):
    """Wrap one engine seam so that it does ``fault``."""
    if fault == "decode_position":
        body = engine._decode_body
        engine._decode_body = lambda ids, pos, table: body(
            ids, (pos - 1).clamp_min(0), table)
    elif fault == "table_rows":
        table_rows = engine._kv.table_rows

        def swapped(sids, n_pages):
            rows = table_rows(sids, n_pages)
            real = sum(s is not None for s in sids)
            return rows[1:real] + rows[:1] + rows[real:] if real > 1 \
                else rows
        engine._kv.table_rows = swapped
    elif fault == "prefill_pages":
        body = engine._prefill_body
        engine._prefill_body = lambda ids, lb, table: body(
            ids, lb, table[1:] + table[:1])


@pytest.mark.parametrize("fault", [None, "decode_position", "table_rows",
                                   "prefill_pages"])
def test_fp32_serving_check_catches_paging_faults(fault, monkeypatch):
    cfg = port_llama.LlamaConfig(vocab_size=512, hidden_size=128,
                                 num_layers=2, num_heads=4, num_kv_heads=2,
                                 intermediate_size=256, max_seq_len=256)
    net = port_llama.init_random_(
        port_llama.LlamaForCausalLM(cfg, device="cpu"), 0)
    engine = ServingEngine(net, batch_buckets=[1, 2, 4],
                           prefill_buckets=[32, 64], kv_pages=64,
                           page_size=8, max_batch=4, device="cpu").start()
    _plant(engine, fault)
    r = np.random.RandomState(0)
    prompts = [r.randint(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in (20, 37, 50, 61)]
    temps = [0.0, 0.8, 0.0, 0.0]
    monkeypatch.setattr(chip_smoke, "MAX_NEW", 6)
    try:
        results, rows = chip_smoke.serve(engine, prompts, temps, 0)
    finally:
        engine.close()
    if fault is None:
        chip_smoke.check_fp32_run(port_llama, port_fa, net, prompts, temps,
                                  results, rows)
    else:
        with pytest.raises(SystemExit, match="CHECK FAILED"):
            chip_smoke.check_fp32_run(port_llama, port_fa, net, prompts,
                                      temps, results, rows)
    assert port_llama.flash_attention is port_fa.flash_attention
