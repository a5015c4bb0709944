"""Language models of the port: Llama-3 family and BERT, Gluon blocks
trained through ``TrainStep``; the Llama is also served by
``ServingEngine``."""
from .bert import (BertConfig, BertForPretraining, BertLayer, BertModel,
                   BertSelfAttention, bert_base, bert_large, bert_tiny)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, RMSNorm,
                    llama3_8b, llama_tiny)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama3_8b",
           "llama_tiny", "RMSNorm", "BertConfig", "BertSelfAttention",
           "BertLayer", "BertModel", "BertForPretraining", "bert_base",
           "bert_large", "bert_tiny"]
