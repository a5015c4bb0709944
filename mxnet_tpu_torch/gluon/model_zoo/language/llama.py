"""Llama-3-family decoder in PyTorch (counterpart of
``mxnet_tpu/gluon/model_zoo/language/llama.py``, dense MLP only).

Module attribute names reproduce the reference's structural parameter
names, so ``state_dict()`` keys equal the keys of the reference's
``serving_params(net)`` (``model.layers.0.self_attn.q_proj.weight``, ...)
and weights carry over one to one (:func:`load_reference_params`).  Weight
layouts are the reference's: ``nn.Linear``'s (out, in) is ``Dense``'s
(units, in_units), the embedding is (vocab, hidden).

The serving path is the pure functions at the bottom (``prefill_apply`` /
``decode_apply`` over a name -> tensor dict), written op for op like the
modules' ``forward`` so that incremental decode reproduces the full-context
forward.  Prefill attention goes through ``ops.flash_attention``: the Hopper
kernel on the card, the plain version on the CPU.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import MXNetError
from ....context import resolve_device
from ....ops.attention_ops import rms_norm, rope, swiglu
from ....ops.flash_attention import NEG_INF, flash_attention

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama3_8b",
           "llama_tiny", "RMSNorm", "serving_params", "prefill_apply",
           "decode_apply", "load_reference_params", "init_random_"]


class LlamaConfig:
    def __init__(self, vocab_size=128256, hidden_size=4096, num_layers=32,
                 num_heads=32, num_kv_heads=8, intermediate_size=14336,
                 rope_base=500000.0, max_seq_len=8192, rms_eps=1e-5,
                 dtype="float32", num_experts=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.intermediate_size = intermediate_size
        self.rope_base = rope_base
        self.max_seq_len = max_seq_len
        self.rms_eps = rms_eps
        self.dtype = dtype
        self.num_experts = num_experts
        if hidden_size % num_heads:
            raise MXNetError(
                f"num_heads ({num_heads}) must divide hidden_size "
                f"({hidden_size})")
        if num_heads % num_kv_heads:
            raise MXNetError(
                f"num_kv_heads ({num_kv_heads}) must divide num_heads "
                f"({num_heads}) for GQA")
        self.head_dim = hidden_size // num_heads


def _linear(n_in, n_out, fk):
    return nn.Linear(n_in, n_out, bias=False, **fk)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-5, **fk):
        super().__init__()
        self._eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **fk))

    def forward(self, x):
        return rms_norm(x, self.weight, eps=self._eps)


class LlamaAttention(nn.Module):
    def __init__(self, cfg, **fk):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self._cfg = cfg
        self.q_proj = _linear(d, cfg.num_heads * hd, fk)
        self.k_proj = _linear(d, cfg.num_kv_heads * hd, fk)
        self.v_proj = _linear(d, cfg.num_kv_heads * hd, fk)
        self.o_proj = _linear(cfg.num_heads * hd, d, fk)

    def forward(self, x):
        cfg = self._cfg
        b, l = x.shape[0], x.shape[1]
        hd = cfg.head_dim
        q = self.q_proj(x).reshape(b, l, cfg.num_heads, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(b, l, cfg.num_kv_heads, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(b, l, cfg.num_kv_heads, hd).transpose(1, 2)
        q = rope(q, base=cfg.rope_base)
        k = rope(k, base=cfg.rope_base)
        o = flash_attention(q, k, v, causal=True, sm_scale=1.0 / math.sqrt(hd))
        o = o.transpose(1, 2).reshape(b, l, cfg.num_heads * hd)
        return self.o_proj(o)


class LlamaMLP(nn.Module):
    def __init__(self, cfg, **fk):
        super().__init__()
        self.gate_proj = _linear(cfg.hidden_size, cfg.intermediate_size, fk)
        self.up_proj = _linear(cfg.hidden_size, cfg.intermediate_size, fk)
        self.down_proj = _linear(cfg.intermediate_size, cfg.hidden_size, fk)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg, **fk):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, **fk)
        self.self_attn = LlamaAttention(cfg, **fk)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps,
                                                **fk)
        self.mlp = LlamaMLP(cfg, **fk)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg, **fk):
        super().__init__()
        self._cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **fk)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, **fk)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, **fk)

    def forward(self, input_ids):
        idx = input_ids.long().clamp(0, self._cfg.vocab_size - 1)
        h = self.embed_tokens(idx)
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """The causal LM.  ``device=None`` means the first CUDA card (raises
    without one); tests pass ``device="cpu"``.  Parameters are created on
    ``device`` in ``cfg.dtype``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.num_experts > 0:
            raise MXNetError("incremental decode does not support MoE FFNs "
                             "yet")
        self._cfg = cfg
        fk = {"device": resolve_device(device),
              "dtype": getattr(torch, cfg.dtype)}
        self.model = LlamaModel(cfg, **fk)
        self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, fk)

    def forward(self, input_ids):
        return self.lm_head(self.model(input_ids))

    @property
    def config(self):
        return self._cfg

    @property
    def device(self):
        return self.lm_head.weight.device

    @property
    def dtype(self):
        return self.lm_head.weight.dtype

    # -- incremental (KV-cached) decode over a dense cache -----------------
    def init_decode_cache(self, batch, max_len=None):
        """Dense per-layer KV cache for :meth:`decode_step`: ``{"k", "v"}``
        of shape (num_layers, batch, num_kv_heads, max_len, head_dim) in the
        parameter dtype, plus ``"len"`` (tokens cached so far, uniform over
        the batch)."""
        cfg = self._cfg
        shape = (cfg.num_layers, batch, cfg.num_kv_heads,
                 max_len or cfg.max_seq_len, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "len": 0}

    @torch.no_grad()
    def prefill(self, ids, cache):
        """Run the prompt through the full-context forward, write every
        layer's roped k/v into ``cache`` (in place), and return the logits
        (B, L, V)."""
        ids = torch.as_tensor(np.asarray(ids), device=self.device)
        logits, ks, vs = prefill_apply(serving_params(self), self._cfg, ids)
        L = ids.shape[1]
        cache["k"][:, :, :, :L] = ks
        cache["v"][:, :, :, :L] = vs
        cache["len"] = L
        return logits

    @torch.no_grad()
    def decode_step(self, ids, cache, positions=None):
        """Single-token forward against the cache: feeds ``ids`` (B,) at
        ``positions`` (default ``cache["len"]`` for every row), writes the
        new k/v into the cache in place, and returns logits (B, V)."""
        ids = torch.as_tensor(np.asarray(ids), device=self.device)
        b = ids.shape[0]
        if positions is None:
            pos = torch.full((b,), cache["len"], dtype=torch.long,
                             device=self.device)
        else:
            pos = torch.as_tensor(np.asarray(positions),
                                  device=self.device).long()
        rows = torch.arange(b, device=self.device)

        def join(i, k_new, v_new):
            cache["k"][i][rows, :, pos] = k_new[:, :, 0]
            cache["v"][i][rows, :, pos] = v_new[:, :, 0]
            return cache["k"][i], cache["v"][i], pos + 1

        logits = decode_apply(serving_params(self), self._cfg, ids, pos, join)
        if positions is None:
            cache["len"] += 1
        return logits


# ==========================================================================
# Weights: carry-over from the reference, and random full-width weights.
# ==========================================================================
def _is_norm(name):
    return name.endswith("norm.weight")


@torch.no_grad()
def load_reference_params(net, params):
    """Copy the reference's weights into ``net``.  ``params`` maps the
    reference's structural names to numpy arrays, as
    ``{k: np.asarray(v) for k, v in serving_params(jax_net).items()}``
    gives them.  The key sets must be equal and every shape must match;
    values are cast to the module's dtype on its device."""
    own = dict(net.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError(f"reference params do not match the model: "
                         f"missing {missing[:5]}, extra {extra[:5]}")
    for name, p in own.items():
        src = np.asarray(params[name])
        if tuple(src.shape) != tuple(p.shape):
            raise MXNetError(f"{name}: reference shape {tuple(src.shape)} "
                             f"!= model shape {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(src)))


@torch.no_grad()
def init_random_(net, seed):
    """Fill the weights in place from a seeded ``torch.Generator`` on the
    net's device: N(0, 0.02) everywhere, RMSNorm weights at 1.  This is how
    a full-width model gets weights without a download."""
    gen = torch.Generator(device=net.device)
    gen.manual_seed(int(seed))
    for name, p in sorted(net.named_parameters()):
        if _is_norm(name):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=gen)
    return net


# ==========================================================================
# The serving-path forwards: pure functions over a structural-name dict.
# ==========================================================================
def serving_params(net):
    """Structural-name parameter dict for the pure serving forwards
    (``model.layers.0.self_attn.q_proj.weight`` ...).  Values are the live
    parameter tensors, detached (no copy): a served model does not train."""
    return OrderedDict((name, p.detach())
                       for name, p in sorted(net.named_parameters()))


def _dense_nb(x, weight):
    """No-bias dense layer, weight layout (units, in_units)."""
    return F.linear(x, weight)


def _embed(params, cfg, ids):
    """Embedding lookup with the reference's clip of out-of-range ids."""
    idx = ids.long().clamp(0, cfg.vocab_size - 1)
    return F.embedding(idx, params["model.embed_tokens.weight"])


def _proj_qkv(params, cfg, pre, h, pos2):
    """q/k/v projections + rope for one attention block (shared by prefill
    and decode, so cached k/v and the decode-step q come from one code)."""
    b, l = h.shape[0], h.shape[1]
    hd = cfg.head_dim
    q = _dense_nb(h, params[pre + "self_attn.q_proj.weight"]) \
        .reshape(b, l, cfg.num_heads, hd).transpose(1, 2)
    k = _dense_nb(h, params[pre + "self_attn.k_proj.weight"]) \
        .reshape(b, l, cfg.num_kv_heads, hd).transpose(1, 2)
    v = _dense_nb(h, params[pre + "self_attn.v_proj.weight"]) \
        .reshape(b, l, cfg.num_kv_heads, hd).transpose(1, 2)
    q = rope(q, positions=pos2, base=cfg.rope_base)
    k = rope(k, positions=pos2, base=cfg.rope_base)
    return q, k, v


def _mlp_block(params, cfg, pre, h):
    g = _dense_nb(h, params[pre + "mlp.gate_proj.weight"])
    u = _dense_nb(h, params[pre + "mlp.up_proj.weight"])
    return _dense_nb(swiglu(g, u), params[pre + "mlp.down_proj.weight"])


def _decode_attention(q, k, v, n_valid, sm_scale):
    """Single-query attention over a (padded) key context.

    q (B, Hq, 1, D); k/v (B, Hkv, S, D); ``n_valid`` (B,) counts the valid
    keys of each row (key j is visible iff j < n_valid).  fp32 scores,
    NEG_INF mask (exp of it is exactly 0.0, so padded keys add exact zeros),
    max-shift softmax, value product in the value dtype — the row that the
    full-context ``_mha_with_lse`` computes.  The GQA group of query heads
    is one matrix row block per kv head, so k/v are never repeated."""
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)
    scores = torch.matmul(qg.float(), k.float().transpose(-1, -2)) * sm_scale
    mask = torch.arange(s, device=q.device)[None, :] < n_valid[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype), v)                    # (B, Hkv, rep, D)
    return o.reshape(b, hq, 1, d)


def _prefill_trunk(params, cfg, ids, kv_sink):
    """The decoder stack over ``ids`` (B, L); ``kv_sink(layer, k, v)``
    receives every layer's roped k/v (B, Hkv, L, D).  Returns the final
    normed hidden states (B, L, hidden)."""
    if cfg.num_experts > 0:
        raise MXNetError("incremental decode does not support MoE FFNs yet")
    x = _embed(params, cfg, ids)
    b, l = x.shape[0], x.shape[1]
    hd = cfg.head_dim
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        h = rms_norm(x, params[pre + "input_layernorm.weight"],
                     eps=cfg.rms_eps)
        q, k, v = _proj_qkv(params, cfg, pre, h, None)
        kv_sink(i, k, v)
        o = flash_attention(q, k, v, causal=True,
                            sm_scale=1.0 / math.sqrt(hd))
        o = o.transpose(1, 2).reshape(b, l, cfg.num_heads * hd)
        x = x + _dense_nb(o, params[pre + "self_attn.o_proj.weight"])
        h2 = rms_norm(x, params[pre + "post_attention_layernorm.weight"],
                      eps=cfg.rms_eps)
        x = x + _mlp_block(params, cfg, pre, h2)
    return rms_norm(x, params["model.norm.weight"], eps=cfg.rms_eps)


def prefill_apply(params, cfg, ids):
    """Full-context forward that also returns every layer's roped k/v.

    ``ids`` (B, L) integer tensor.  Returns ``(logits (B, L, V), k
    (num_layers, B, num_kv_heads, L, head_dim), v (same))``; the logits are
    the computation of ``LlamaForCausalLM.forward``."""
    ks, vs = [], []

    def collect(i, k, v):
        ks.append(k)
        vs.append(v)

    x = _prefill_trunk(params, cfg, ids, collect)
    logits = _dense_nb(x, params["lm_head.weight"])
    return logits, torch.stack(ks), torch.stack(vs)


def decode_apply(params, cfg, ids, positions, kv_join):
    """One single-token decode step, pure apart from what ``kv_join`` does.

    ``ids`` (B,) — the tokens to feed; ``positions`` (B,) — each row's
    sequence position.  ``kv_join(layer, k_new, v_new) -> (K, V, n_valid)``
    owns the cache: it merges the new roped k/v (B, num_kv_heads, 1,
    head_dim) into layer ``layer``'s context and returns the full (padded)
    key/value tensors plus each row's valid-key count (``positions + 1``).
    Dense caches and the serving engine's paged pool both plug in here.
    Returns logits (B, vocab)."""
    if cfg.num_experts > 0:
        raise MXNetError("incremental decode does not support MoE FFNs yet")
    hd = cfg.head_dim
    x = _embed(params, cfg, ids)[:, None, :]                       # (B, 1, d)
    b = x.shape[0]
    pos2 = positions.long()[:, None]                               # rope (B,1)
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        h = rms_norm(x, params[pre + "input_layernorm.weight"],
                     eps=cfg.rms_eps)
        q, k, v = _proj_qkv(params, cfg, pre, h, pos2)
        K, V, n_valid = kv_join(i, k, v)
        o = _decode_attention(q, K, V, n_valid, 1.0 / math.sqrt(hd))
        o = o.transpose(1, 2).reshape(b, 1, cfg.num_heads * hd)
        x = x + _dense_nb(o, params[pre + "self_attn.o_proj.weight"])
        h2 = rms_norm(x, params[pre + "post_attention_layernorm.weight"],
                      eps=cfg.rms_eps)
        x = x + _mlp_block(params, cfg, pre, h2)
    x = rms_norm(x, params["model.norm.weight"], eps=cfg.rms_eps)
    return _dense_nb(x, params["lm_head.weight"])[:, 0, :]         # (B, V)


def llama3_8b(device=None, **overrides):
    """Llama-3-8B dimensions (the ``LlamaConfig`` defaults)."""
    return LlamaForCausalLM(LlamaConfig(**overrides), device=device)


def llama_tiny(device=None, **overrides):
    """Test-scale Llama (same architecture, small dims)."""
    kw = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=256, max_seq_len=256)
    kw.update(overrides)
    return LlamaForCausalLM(LlamaConfig(**kw), device=device)
