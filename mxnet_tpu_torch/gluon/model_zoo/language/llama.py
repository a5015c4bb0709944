"""Llama-3-family decoder as Gluon HybridBlocks (counterpart of
``mxnet_tpu/gluon/model_zoo/language/llama.py``).

One net trains and serves.  The blocks, their prefixes and their
parameters (names, shapes, creation order) are the reference's, so
``gluon.load_reference_params`` carries the reference's weights over by
position and ``TrainStep`` / ``Trainer`` train the net like any Gluon
block.  RMSNorm, RoPE, SwiGLU and the switch-MoE FFN are op-table ops
(``F.rms_norm`` ...); attention is ``F.flash_attention`` (the Hopper kernel
forward and the blockwise backward on the card, the plain version on the
CPU).  ``remat=True`` rematerializes each decoder layer under ``TrainStep``.
Weight layouts are Gluon's: ``Dense`` weights are (units, in_units), the
embedding is (vocab, hidden).

The serving path is the pure functions at the bottom (``prefill_apply`` /
``decode_apply`` over the structural-name dict ``serving_params(net)``
returns, ``model.layers.0.self_attn.q_proj.weight`` ...), written op for op
like the blocks' forward so that incremental decode reproduces the
full-context forward.  ``pipeline_decompose`` (pipeline parallelism) is not
ported.
"""
from __future__ import annotations

import math
import warnings
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from .... import autograd as _ag
from ....base import MXNetError
from ....context import Context, resolve_device
from ....ndarray.ndarray import NDArray
from ....ops.attention_ops import rms_norm, rope, swiglu
from ....ops.flash_attention import NEG_INF, flash_attention
from ....parallel.functional import rematerialize
from ... import nn
from ...block import HybridBlock
from ...parameter import _TRACE

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama3_8b",
           "llama_tiny", "RMSNorm", "serving_params", "prefill_apply",
           "decode_apply", "load_reference_params", "init_random_"]


class LlamaConfig:
    """Llama-3-8B dimensions by default.  ``dtype`` is the parameters'
    dtype: an extension of the port.  The reference stores ``dtype`` and
    never reads it (its nets are built in fp32 and cast with
    ``net.cast("bfloat16")``, which the port also has); here
    ``llama3_8b(dtype="bfloat16")`` builds the bf16 net directly, with no
    fp32 copy on the way.  ``num_experts`` > 0 replaces the dense SwiGLU MLP with a
    switch-MoE FFN (top-1 routing, ``moe_capacity_factor``), whose
    load-balance loss times ``moe_aux_loss_weight`` rides the backward
    (0 disables it).  ``remat`` rematerializes each decoder layer's
    activations in the backward under ``TrainStep``."""

    def __init__(self, vocab_size=128256, hidden_size=4096, num_layers=32,
                 num_heads=32, num_kv_heads=8, intermediate_size=14336,
                 rope_base=500000.0, max_seq_len=8192, rms_eps=1e-5,
                 dtype="float32", remat=False,
                 num_experts=0, moe_capacity_factor=1.25,
                 moe_aux_loss_weight=0.01):
        self.num_experts = num_experts
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_aux_loss_weight = moe_aux_loss_weight
        self.remat = remat
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
        if hidden_size % num_heads:
            raise MXNetError(
                f"num_heads ({num_heads}) must divide hidden_size "
                f"({hidden_size})")
        if num_heads % num_kv_heads:
            raise MXNetError(
                f"num_kv_heads ({num_kv_heads}) must divide num_heads "
                f"({num_heads}) for GQA")
        self.head_dim = hidden_size // num_heads


def _dense(cfg, units, in_units, prefix):
    return nn.Dense(units, use_bias=False, flatten=False, in_units=in_units,
                    dtype=cfg.dtype, prefix=prefix)


class RMSNorm(HybridBlock):
    def __init__(self, dim, eps=1e-5, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        self._eps = eps
        self.weight = self.params.get("weight", shape=(dim,), init="ones",
                                      dtype=dtype)

    def hybrid_forward(self, F, x, weight):
        return F.rms_norm(x, weight, eps=self._eps)


class LlamaAttention(HybridBlock):
    def __init__(self, cfg, **kwargs):
        super().__init__(**kwargs)
        d, hd = cfg.hidden_size, cfg.head_dim
        self._cfg = cfg
        with self.name_scope():
            self.q_proj = _dense(cfg, cfg.num_heads * hd, d, "q_proj_")
            self.k_proj = _dense(cfg, cfg.num_kv_heads * hd, d, "k_proj_")
            self.v_proj = _dense(cfg, cfg.num_kv_heads * hd, d, "v_proj_")
            self.o_proj = _dense(cfg, d, cfg.num_heads * hd, "o_proj_")

    def hybrid_forward(self, F, x):
        cfg = self._cfg
        b, l = x.shape[0], x.shape[1]
        hd = cfg.head_dim
        q = self.q_proj(x).reshape((b, l, cfg.num_heads, hd)).transpose(
            (0, 2, 1, 3))
        k = self.k_proj(x).reshape((b, l, cfg.num_kv_heads, hd)).transpose(
            (0, 2, 1, 3))
        v = self.v_proj(x).reshape((b, l, cfg.num_kv_heads, hd)).transpose(
            (0, 2, 1, 3))
        q = F.rope(q, base=cfg.rope_base)
        k = F.rope(k, base=cfg.rope_base)
        o = F.flash_attention(q, k, v, causal=True,
                              sm_scale=1.0 / math.sqrt(hd))
        o = o.transpose((0, 2, 1, 3)).reshape((b, l, cfg.num_heads * hd))
        return self.o_proj(o)


class LlamaMLP(HybridBlock):
    def __init__(self, cfg, **kwargs):
        super().__init__(**kwargs)
        h, i = cfg.hidden_size, cfg.intermediate_size
        with self.name_scope():
            self.gate_proj = _dense(cfg, i, h, "gate_proj_")
            self.up_proj = _dense(cfg, i, h, "up_proj_")
            self.down_proj = _dense(cfg, h, i, "down_proj_")

    def hybrid_forward(self, F, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaMoEMLP(HybridBlock):
    """Switch-MoE SwiGLU FFN.  The expert weights are stacked on a leading
    expert axis, gate/up (E, H, I) and down (E, I, H), with the router at
    (H, E), so ``moe_apply``'s dispatch and combine apply directly."""

    def __init__(self, cfg, **kwargs):
        super().__init__(**kwargs)
        self._cfg = cfg
        E, H, I = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        dt = cfg.dtype
        with self.name_scope():
            self.router = self.params.get("router_weight", shape=(H, E),
                                          dtype=dt)
            self.gate_proj = self.params.get("gate_proj_weight",
                                             shape=(E, H, I), dtype=dt)
            self.up_proj = self.params.get("up_proj_weight", shape=(E, H, I),
                                           dtype=dt)
            self.down_proj = self.params.get("down_proj_weight",
                                             shape=(E, I, H), dtype=dt)

    def hybrid_forward(self, F, x, router, gate_proj, up_proj, down_proj):
        cfg = self._cfg
        return F.moe_swiglu(x, router, gate_proj, up_proj, down_proj,
                            capacity_factor=cfg.moe_capacity_factor,
                            aux_loss_weight=cfg.moe_aux_loss_weight)


class LlamaDecoderLayer(HybridBlock):
    def __init__(self, cfg, **kwargs):
        super().__init__(**kwargs)
        self._remat = cfg.remat
        h, dt = cfg.hidden_size, cfg.dtype
        with self.name_scope():
            self.input_layernorm = RMSNorm(h, cfg.rms_eps, dt,
                                           prefix="input_layernorm_")
            self.self_attn = LlamaAttention(cfg, prefix="self_attn_")
            self.post_attention_layernorm = RMSNorm(
                h, cfg.rms_eps, dt, prefix="post_attention_layernorm_")
            if cfg.num_experts > 0:
                self.mlp = LlamaMoEMLP(cfg, prefix="mlp_")
            else:
                self.mlp = LlamaMLP(cfg, prefix="mlp_")

    def _body(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))

    def hybrid_forward(self, F, x):
        if self._remat:
            if _TRACE.ctx is not None and _ag.is_recording():
                # under a functionalized forward that records (TrainStep):
                # the layer's activations are recomputed in the backward
                return NDArray._wrap(rematerialize(
                    lambda t: self._body(NDArray._wrap(t))._data, x._data))
            if _ag.is_recording():
                warnings.warn(
                    "LlamaConfig(remat=True) has no effect under the eager "
                    "autograd tape; use parallel.TrainStep for "
                    "rematerialized training", stacklevel=2)
        return self._body(x)


class LlamaModel(HybridBlock):
    def __init__(self, cfg, **kwargs):
        super().__init__(**kwargs)
        self._cfg = cfg
        with self.name_scope():
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                             dtype=cfg.dtype,
                                             prefix="embed_tokens_")
            self.layers = nn.HybridSequential(prefix="layers_")
            with self.layers.name_scope():
                for i in range(cfg.num_layers):
                    self.layers.add(LlamaDecoderLayer(cfg, prefix=f"{i}_"))
            self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                                prefix="norm_")

    def hybrid_forward(self, F, input_ids):
        h = self.embed_tokens(input_ids)
        h = self.layers(h)
        return self.norm(h)


class LlamaForCausalLM(HybridBlock):
    """The causal LM.  A Gluon block: construct, then ``initialize(ctx=...)``
    (``llama3_8b`` / ``llama_tiny`` do both).  Called with an NDArray it
    returns an NDArray; called with a torch tensor, as a ``torch.nn.Module``,
    it returns a tensor, recorded for torch autograd iff grad mode is on."""

    def __init__(self, cfg, **kwargs):
        super().__init__(**kwargs)
        self._cfg = cfg
        with self.name_scope():
            self.model = LlamaModel(cfg, prefix="model_")
            self.lm_head = _dense(cfg, cfg.vocab_size, cfg.hidden_size,
                                  "lm_head_")

    def forward(self, input_ids):
        if isinstance(input_ids, torch.Tensor):
            with _ag._scope(recording=torch.is_grad_enabled()):
                return super().forward(NDArray._wrap(input_ids))._data
        return super().forward(input_ids)

    def hybrid_forward(self, F, input_ids):
        return self.lm_head(self.model(input_ids))

    @property
    def config(self):
        return self._cfg

    @property
    def device(self):
        return self.lm_head.weight.data()._data.device

    @property
    def dtype(self):
        return self.lm_head.weight.data()._data.dtype

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
    """Copy the reference's weights into ``net`` by structural name.
    ``params`` maps the reference's structural names to numpy arrays, as
    ``{k: np.asarray(v) for k, v in serving_params(jax_net).items()}``
    gives them.  The key sets must be equal and every shape must match;
    values are cast to the parameters' dtype on their device.
    (``gluon.load_reference_params`` carries weights by position
    instead.)"""
    own = net._collect_params_with_prefix()
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
        p.set_data(torch.from_numpy(np.array(src)))


@torch.no_grad()
def init_random_(net, seed):
    """Fill the weights in place from a seeded ``torch.Generator`` on the
    net's device: N(0, 0.02) everywhere, RMSNorm weights at 1.  This is how
    a full-width model gets weights without a download."""
    gen = torch.Generator(device=net.device)
    gen.manual_seed(int(seed))
    for name, t in serving_params(net).items():
        if _is_norm(name):
            t.fill_(1.0)
        else:
            t.normal_(0.0, 0.02, generator=gen)
    return net


# ==========================================================================
# The serving-path forwards: pure functions over a structural-name dict.
# ==========================================================================
def serving_params(net):
    """Structural-name parameter dict for the pure serving forwards
    (``model.layers.0.self_attn.q_proj.weight`` ...), from
    ``_collect_params_with_prefix``.  Values are the live parameter
    tensors, detached (no copy): a served model does not train."""
    return OrderedDict(
        (name, p.data()._data.detach())
        for name, p in sorted(net._collect_params_with_prefix().items()))


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


def _built(cfg, device):
    """``LlamaForCausalLM(cfg)`` initialized on ``device`` (None: the first
    CUDA card; raises without one) with Gluon's default initializer."""
    net = LlamaForCausalLM(cfg)
    net.initialize(ctx=Context.from_device(resolve_device(device)))
    return net


def llama3_8b(device=None, **overrides):
    """Llama-3-8B dimensions (the ``LlamaConfig`` defaults), initialized
    on ``device``."""
    return _built(LlamaConfig(**overrides), device)


def llama_tiny(device=None, **overrides):
    """Test-scale Llama (same architecture, small dims), initialized on
    ``device``."""
    kw = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=256, max_seq_len=256)
    kw.update(overrides)
    return _built(LlamaConfig(**kw), device)
