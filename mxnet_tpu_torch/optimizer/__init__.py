"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import (NAG, SGD, SGLD, AdaDelta, AdaGrad, Adam, Adamax,
                        FTML, Ftrl, LAMB, Nadam, Optimizer, RMSProp, Signum,
                        SignSGD, Test, Updater, create, get_updater, register)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "FTML", "Signum", "SignSGD", "LAMB", "Nadam",
           "Adamax", "SGLD", "Test", "Updater", "get_updater", "create",
           "register"]
