"""Gluon contrib of the port: the contrib layers (``gluon.contrib.nn``)
and the ``Estimator`` training loop."""
from . import nn
from .estimator import Estimator

__all__ = ["nn", "Estimator"]
