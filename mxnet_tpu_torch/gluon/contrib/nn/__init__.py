"""Gluon contrib layers (counterpart of
``mxnet_tpu/gluon/contrib/nn/__init__.py``): ``Concurrent`` and
``HybridConcurrent`` (children on one input, outputs concatenated),
``Identity`` and ``SyncBatchNorm``.

``SyncBatchNorm`` in one process is ``BatchNorm`` over the channel axis,
as the reference's is on one device.  Its cross-process form (statistics
reduced over every process's batch) is not ported: with more than one
process of ``torch.distributed`` it raises.
"""
from __future__ import annotations

import torch

from .... import autograd
from ....base import MXNetError
from ...block import HybridBlock
from ...nn.basic_layers import BatchNorm, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SyncBatchNorm"]


class Concurrent(Sequential):
    """Run every child on the input and concatenate their outputs along
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as F

        return F.concat(*(block(x) for block in self._children.values()),
                        dim=self.axis)


class HybridConcurrent(HybridSequential):
    """The HybridBlock form of :class:`Concurrent`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*(block(x) for block in self._children.values()),
                        dim=self.axis)


class Identity(HybridBlock):
    """Returns its input."""

    def hybrid_forward(self, F, x):
        return x


class SyncBatchNorm(BatchNorm):
    """BatchNorm over axis 1 whose statistics would span every device
    (reference: gluon.contrib.nn.SyncBatchNorm).  ``num_devices`` is the
    reference's argument; one process computes ``BatchNorm`` exactly."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        if autograd.is_training() and not self._use_global_stats and \
                torch.distributed.is_available() and \
                torch.distributed.is_initialized() and \
                torch.distributed.get_world_size() > 1:
            raise MXNetError(
                "SyncBatchNorm across processes is not ported: its "
                "statistics would need a reduction over every process's "
                "batch (ROADMAP A6)")
        return BatchNorm.hybrid_forward(self, F, x, gamma, beta,
                                        running_mean, running_var)
