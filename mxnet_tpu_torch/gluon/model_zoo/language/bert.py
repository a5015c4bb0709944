"""BERT as Gluon HybridBlocks (counterpart of
``mxnet_tpu/gluon/model_zoo/language/bert.py``; BERT-base dims are the
default).

Blocks, parameter names and their order are the reference's, so weights
carry over with ``gluon.load_reference_params``.  Self-attention goes
through ``F.flash_attention`` (the op table's ``_contrib_flash_attention``):
the Hopper kernel forward and the blockwise backward on the card, the plain
version on the CPU.  ``pipeline_decompose`` (pipeline parallelism) is not
ported.
"""
from __future__ import annotations

import math

from ... import nn
from ...block import HybridBlock

__all__ = ["BertConfig", "BertSelfAttention", "BertLayer", "BertModel",
           "BertForPretraining", "bert_base", "bert_large", "bert_tiny"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_eps=1e-12):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.head_dim = hidden_size // num_heads


class BertSelfAttention(HybridBlock):
    def __init__(self, cfg, **kwargs):
        super().__init__(**kwargs)
        self._cfg = cfg
        d = cfg.hidden_size
        self.query = nn.Dense(d, flatten=False, in_units=d)
        self.key = nn.Dense(d, flatten=False, in_units=d)
        self.value = nn.Dense(d, flatten=False, in_units=d)
        self.out = nn.Dense(d, flatten=False, in_units=d)
        self.dropout = nn.Dropout(cfg.dropout)

    def hybrid_forward(self, F, x):
        cfg = self._cfg
        b, l = x.shape[0], x.shape[1]
        hd = cfg.head_dim

        def heads(t):
            # a (B, H, L, D) view of the projection: the kernel reads it
            # through its strides, no copy
            return t.reshape((b, l, cfg.num_heads, hd)).transpose((0, 2, 1, 3))

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        o = F.flash_attention(q, k, v, causal=False,
                              sm_scale=1.0 / math.sqrt(hd))
        o = o.transpose((0, 2, 1, 3)).reshape((b, l, cfg.hidden_size))
        return self.dropout(self.out(o))


class BertLayer(HybridBlock):
    def __init__(self, cfg, **kwargs):
        super().__init__(**kwargs)
        self.attention = BertSelfAttention(cfg)
        self.attn_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps)
        self.intermediate = nn.Dense(cfg.intermediate_size, flatten=False,
                                     in_units=cfg.hidden_size)
        self.output = nn.Dense(cfg.hidden_size, flatten=False,
                               in_units=cfg.intermediate_size)
        self.out_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.dropout)

    def hybrid_forward(self, F, x):
        x = self.attn_norm(x + self.attention(x))
        h = F.gelu(self.intermediate(x))
        return self.out_norm(x + self.dropout(self.output(h)))


class BertModel(HybridBlock):
    def __init__(self, cfg=None, **kwargs):
        super().__init__(**kwargs)
        cfg = cfg or BertConfig()
        self._cfg = cfg
        self.word_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embed = nn.Embedding(cfg.max_position, cfg.hidden_size)
        self.token_type_embed = nn.Embedding(cfg.type_vocab_size,
                                             cfg.hidden_size)
        self.embed_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps)
        self.embed_dropout = nn.Dropout(cfg.dropout)
        self.encoder = nn.HybridSequential(prefix="")
        for _ in range(cfg.num_layers):
            self.encoder.add(BertLayer(cfg))
        self.pooler = nn.Dense(cfg.hidden_size, activation="tanh",
                               flatten=False, in_units=cfg.hidden_size)

    def hybrid_forward(self, F, input_ids, token_types=None):
        b, l = input_ids.shape[0], input_ids.shape[1]
        # the positions live where the ids do (the reference's arange has
        # no context; here the default context is the first card)
        pos = F.arange(0, l, dtype="int32", ctx=input_ids.context)
        h = self.word_embed(input_ids)
        positions = self.position_embed(pos)
        h = h + positions.reshape((1, l, -1))
        if token_types is not None:
            h = h + self.token_type_embed(token_types)
        h = self.embed_dropout(self.embed_norm(h))
        h = self.encoder(h)
        pooled = self.pooler(h.slice_axis(axis=1, begin=0, end=1)
                             .reshape((b, -1)))
        return h, pooled


class BertForPretraining(HybridBlock):
    """MLM + NSP heads over BertModel (GluonNLP BERTForPretrain shape)."""

    def __init__(self, cfg=None, **kwargs):
        super().__init__(**kwargs)
        cfg = cfg or BertConfig()
        self._cfg = cfg
        self.bert = BertModel(cfg)
        self.mlm_dense = nn.Dense(cfg.hidden_size, flatten=False,
                                  in_units=cfg.hidden_size)
        self.mlm_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps)
        self.mlm_decoder = nn.Dense(cfg.vocab_size, flatten=False,
                                    in_units=cfg.hidden_size)
        self.nsp = nn.Dense(2, flatten=False, in_units=cfg.hidden_size)

    def hybrid_forward(self, F, input_ids, token_types=None):
        seq, pooled = self.bert(input_ids, token_types)
        mlm = self.mlm_decoder(self.mlm_norm(F.gelu(self.mlm_dense(seq))))
        return mlm, self.nsp(pooled)


def bert_base(**overrides):
    return BertModel(BertConfig(**overrides))


def bert_large(**overrides):
    kw = dict(hidden_size=1024, num_layers=24, num_heads=16,
              intermediate_size=4096)
    kw.update(overrides)
    return BertModel(BertConfig(**kw))


def bert_tiny(**overrides):
    kw = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
              intermediate_size=128, max_position=128)
    kw.update(overrides)
    return BertModel(BertConfig(**kw))
