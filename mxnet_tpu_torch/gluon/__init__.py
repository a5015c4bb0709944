"""Gluon of the port: parameters, blocks, layers, losses, the Trainer, the
model zoo (``torch.nn`` modules underneath) and the device prefetcher
(``gluon.data``)."""
from . import contrib, data, loss, model_zoo, nn, utils
from .block import Block, HybridBlock
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, load_reference_params)
from .trainer import Trainer

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "Block", "HybridBlock", "Trainer", "nn", "loss", "model_zoo",
           "utils", "data", "contrib", "load_reference_params"]
