"""The port's flash attention (mxnet_tpu_torch.ops.flash_attention) held
against the reference on the CPU.

The port's plain version ``_mha_with_lse`` is compared with the reference's
actual Pallas kernel body, ``_fa_forward_pallas`` run under
``pltpu.force_tpu_interpret_mode()``, and the port's public
``flash_attention`` with the reference's.  Inputs are made with numpy from
a seed and handed to both packages.  Tolerance: 1e-5 absolute on ``o`` and
``lse`` in fp32 (both sides sum in fp32 in different orders; the measured
gap is ~1e-6).  The CUDA kernel itself runs only on the card: chip_smoke.py
holds it against ``_mha_with_lse`` there.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mxnet_tpu.ops import flash_attention as ref_fa
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as port_fa

ATOL = 1e-5


def _qkv(seed, b, hq, hkv, lq, lk, d):
    r = np.random.RandomState(seed)
    return (r.randn(b, hq, lq, d).astype("float32"),
            r.randn(b, hkv, lk, d).astype("float32"),
            r.randn(b, hkv, lk, d).astype("float32"))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lq,lk", [(256, 256), (128, 256)])
def test_plain_matches_pallas_kernel_body(d, causal, lq, lk):
    q, k, v = _qkv(0, 1, 2, 2, lq, lk, d)
    scale = 1.0 / np.sqrt(d)
    with pltpu.force_tpu_interpret_mode():
        o_ref, lse_ref = ref_fa._fa_forward_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
            128, 128)
    o, lse = port_fa._mha_with_lse(*_t(q, k, v), causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("hq,hkv,lq,lk,d,causal", [
    (4, 2, 37, 37, 32, True),     # GQA, ragged length, D=32
    (8, 2, 5, 61, 64, True),      # decode offset Lq < Lk, ragged
    (4, 1, 100, 100, 128, False),
    (2, 2, 1, 17, 32, True),      # one query row
])
def test_public_flash_attention_matches_reference(hq, hkv, lq, lk, d,
                                                  causal):
    q, k, v = _qkv(1, 2, hq, hkv, lq, lk, d)
    o_ref = ref_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    o = port_fa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0,
                               atol=ATOL)
    # and the lse of the plain version against the reference's
    rk, rv = (np.repeat(a, hq // hkv, axis=1) for a in (k, v))
    _, lse_ref = ref_fa._mha_with_lse(jnp.asarray(q), jnp.asarray(rk),
                                      jnp.asarray(rv), causal,
                                      1.0 / np.sqrt(d))
    _, lse = port_fa._mha_with_lse(*_t(q, k, v), causal, 1.0 / np.sqrt(d))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0,
                               atol=ATOL)


def test_cpu_tensors_never_launch_the_kernel():
    q, k, v = _t(*_qkv(2, 1, 4, 2, 64, 64, 64))
    before = port_fa._flash_fwd_cuda.launches
    port_fa.flash_attention(q, k, v, causal=True)
    port_fa.flash_attention(q, k, v, causal=False, sm_scale=0.3)
    assert port_fa._flash_fwd_cuda.launches == before == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = _t(*_qkv(3, 1, 2, 2, 16, 16, 64))
    with pytest.raises(MXNetError, match="CUDA"):
        port_fa._flash_fwd_cuda(q, k, v, True, 0.125)
    assert port_fa._flash_fwd_cuda.launches == 0


def test_causal_with_more_queries_than_keys_raises():
    q, k, v = _t(*_qkv(4, 1, 2, 2, 32, 16, 32))
    with pytest.raises(MXNetError, match="Lq <= Lk"):
        port_fa.flash_attention(q, k, v, causal=True)
    # non-causal attention over fewer keys is fine
    assert port_fa.flash_attention(q, k, v).shape == q.shape


@pytest.mark.parametrize("shapes", [
    ((1, 3, 8, 32), (1, 2, 8, 32)),     # kv heads do not divide q heads
    ((1, 2, 8, 32), (1, 2, 8, 64)),     # head dims differ
    ((1, 2, 0, 32), (1, 2, 8, 32)),     # empty query
])
def test_bad_shapes_raise(shapes):
    qs, ks = shapes
    with pytest.raises(MXNetError):
        port_fa.flash_attention(torch.zeros(qs), torch.zeros(ks),
                                torch.zeros(ks))


def test_kernel_sources_and_build_without_nvcc(monkeypatch, tmp_path):
    assert "flash_attn_fwd" in _kernels.sources()
    # the library name follows the source's content: an edit rebuilds
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_kernels, "_CSRC", src)
    first = _kernels._target("k")
    (src / "k.cu").write_text("// v2\n")
    assert _kernels._target("k") != first
    # with no nvcc anywhere a build raises instead of falling back
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_kernels, "_BUILD", tmp_path / "build")
    with pytest.raises(MXNetError, match="nvcc"):
        _kernels.load("k")
