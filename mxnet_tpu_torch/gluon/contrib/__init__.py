"""Gluon contrib of the port: the ``Estimator`` training loop (the
contrib layers of ``gluon.contrib.nn`` are not ported yet)."""
from .estimator import Estimator

__all__ = ["Estimator"]
