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


# ---------------------------------------------------------------------------
# the stride rule of the kernel's tensor maps (pure Python, CPU tensors)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_strides_contiguous(dtype):
    t = torch.zeros(2, 4, 16, 64, dtype=dtype)
    assert port_fa._kernel_strides("q", t) == [4 * 16 * 64, 16 * 64, 64]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_strides_take_transposed_views(dtype):
    # the projections' (B, L, H, D) output, viewed as (B, H, L, D): no copy
    t = torch.zeros(2, 16, 4, 64, dtype=dtype).transpose(1, 2)
    assert not t.is_contiguous()
    assert port_fa._kernel_strides("q", t) == [16 * 4 * 64, 64, 4 * 64]


def test_kernel_strides_replace_unused_size_one_strides():
    # a size-1 dim never addresses memory: a stride TMA would refuse there
    # becomes the tensor's span (a multiple of 16 bytes)
    t = torch.zeros(3 * 64, dtype=torch.bfloat16).as_strided(
        (1, 3, 1, 64), (5, 64, 3, 1))   # 10 and 6 bytes: TMA refuses both
    st = port_fa._kernel_strides("q", t)
    assert st[1] == 64 and st[0] % 8 == 0 and st[2] % 8 == 0 and st[2] > 0


def test_kernel_strides_refuse_a_strided_head_dim():
    t = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(MXNetError, match="dense head dim"):
        port_fa._kernel_strides("k", t)


@pytest.mark.parametrize("view", ["row_stride", "base_pointer"])
def test_kernel_strides_refuse_misaligned_tensors(view):
    if view == "row_stride":
        # rows 68 bf16 apart: 136 bytes, not a multiple of 16
        t = torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16)[..., :64]
        match = "multiples of 16 bytes"
    else:
        # the base one element past a 16-byte boundary
        t = torch.zeros(1 + 2 * 8 * 64, dtype=torch.bfloat16)[1:] \
            .view(1, 2, 8, 64)
        match = "16-byte aligned"
    with pytest.raises(MXNetError, match=match):
        port_fa._kernel_strides("v", t)


def test_cpu_flash_attention_takes_views_unchanged():
    # on the CPU the plain version runs as before, whatever the layout
    q, k, v = _qkv(5, 1, 4, 2, 24, 24, 32)
    o = port_fa.flash_attention(*_t(q, k, v), causal=True)
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
             .transpose(1, 2) for a in (q, k, v)]
    o_views = port_fa.flash_attention(*views, causal=True)
    np.testing.assert_array_equal(o.numpy(), o_views.numpy())
