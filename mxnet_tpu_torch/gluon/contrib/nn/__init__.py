"""Gluon contrib layers (counterpart of
``mxnet_tpu/gluon/contrib/nn/__init__.py``): ``Concurrent`` and
``HybridConcurrent`` (children on one input, outputs concatenated),
``Identity`` and ``SyncBatchNorm``.

``SyncBatchNorm`` in one process is ``BatchNorm`` over the channel axis,
as the reference's is on one device.  Across processes, as in the
reference's two regimes: inside ``TrainStep(mesh=)`` every BatchNorm
already normalises by the global batch (``ops.nn.BATCH_STATS``, forward
and backward exact); eagerly with more than one process the forward
statistics are all-reduced (sum, sum of squares, count), so the
normalisation and the running stats use the global batch, and the
backward treats the synced statistics as constants, as the reference's
docstring says.
"""
from __future__ import annotations

import numpy as np

from .... import autograd
from ....base import world_size
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
    """BatchNorm over axis 1 whose statistics span every process
    (reference: gluon.contrib.nn.SyncBatchNorm; see the module
    docstring).  ``num_devices`` is the reference's argument."""

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
        from ....ops import nn as _nn
        from ...block import _TRACE

        training = autograd.is_training() and not self._use_global_stats
        eager = _TRACE.ctx is None and \
            getattr(_nn.BATCH_STATS, "reduce", None) is None
        if not (training and eager and world_size() > 1):
            return BatchNorm.hybrid_forward(self, F, x, gamma, beta,
                                            running_mean, running_var)
        from ....parallel.collectives import allreduce_hosts

        axis = self._axis % len(x.shape)
        axes = tuple(i for i in range(len(x.shape)) if i != axis)
        c = x.shape[axis]
        xs = x.asnumpy().astype("float64")
        stats = np.concatenate([xs.sum(axis=axes).ravel(),
                                (xs * xs).sum(axis=axes).ravel(),
                                [float(xs.size // c)]])
        g = allreduce_hosts(stats.astype("float32"))
        n = g[-1]
        mean = g[:c] / n
        var = g[c:2 * c] / n - mean * mean
        bshape = [1] * len(x.shape)
        bshape[axis] = c
        ctx = x.context
        mean_nd = F.array(mean.reshape(bshape).astype("float32"), ctx=ctx)
        std_nd = F.array((1.0 / np.sqrt(var + self._epsilon))
                         .reshape(bshape).astype("float32"), ctx=ctx)
        gam = gamma if self._scale else F.ones_like(gamma)
        out = (x - mean_nd) * std_nd * gam.reshape(bshape) \
            + beta.reshape(bshape)
        m = self._momentum
        new_mean = running_mean * m + \
            F.array(mean.astype("float32"), ctx=ctx) * (1 - m)
        new_var = running_var * m + \
            F.array(var.astype("float32"), ctx=ctx) * (1 - m)
        self._update_running_state(self.running_mean, new_mean)
        self._update_running_state(self.running_var, new_var)
        return out
