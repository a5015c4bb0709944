"""Gluon of the port: parameters, blocks, layers, losses, the Trainer and
the model zoo (``torch.nn`` modules underneath)."""
from . import loss, model_zoo, nn, utils
from .block import Block, HybridBlock
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, load_reference_params)
from .trainer import Trainer

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "Block", "HybridBlock", "Trainer", "nn", "loss", "model_zoo",
           "utils", "load_reference_params"]
