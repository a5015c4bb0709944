"""Gluon of the port: parameters, blocks (``hybridize()`` caching the
forward, as CUDA graphs on the card), layers, recurrent layers and cells
(``gluon.rnn``), the contrib layers, losses, the Trainer, the model zoo
(``torch.nn`` modules underneath) and the data path (``gluon.data``:
datasets, samplers, the DataLoader, the device prefetcher, ``vision``)."""
from . import contrib, data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict, load_reference_params)
from .trainer import Trainer

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock", "Trainer",
           "nn", "rnn", "loss", "model_zoo", "utils", "data", "contrib",
           "load_reference_params"]
