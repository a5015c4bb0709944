"""Language models of the port: BERT (Gluon blocks, trained through
``TrainStep``) and Llama (``llama``, served by ``ServingEngine``)."""
from .bert import (BertConfig, BertForPretraining, BertLayer, BertModel,
                   BertSelfAttention, bert_base, bert_large, bert_tiny)

__all__ = ["BertConfig", "BertSelfAttention", "BertLayer", "BertModel",
           "BertForPretraining", "bert_base", "bert_large", "bert_tiny"]
