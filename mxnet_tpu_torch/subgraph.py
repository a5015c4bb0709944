"""The fused operators of the subgraph API's built-in backend (counterpart
of the ``_sg_fused_*`` ops of ``mxnet_tpu/subgraph.py``):
``FullyConnected`` + ``Activation`` and ``Convolution`` + ``Activation``
as one op each, over the port's own definitions.

The partitioning side (``register_backend``, ``register_pass``, the passes
that rewrite a Symbol into these ops, ``optimize_for``) works on Symbols
and waits for the port of ``symbol`` (ROADMAP.md A8); until then the ops
are reached directly, as ``mx.nd._sg_fused_dense_act`` and
``mx.nd._sg_fused_conv_act``.
"""
from __future__ import annotations

from .ops.registry import OP_TABLE, register

__all__ = []


@register("_sg_fused_dense_act")
def _sg_fused_dense_act(x, weight, *maybe_bias, num_hidden=None,
                        no_bias=False, flatten=True, act_type="relu"):
    """FullyConnected then Activation, as one op."""
    fc = OP_TABLE["FullyConnected"].fn
    act = OP_TABLE["Activation"].fn
    return act(fc(x, weight, *maybe_bias, num_hidden=num_hidden,
                  no_bias=no_bias, flatten=flatten), act_type=act_type)


@register("_sg_fused_conv_act")
def _sg_fused_conv_act(x, weight, *maybe_bias, kernel=None, stride=None,
                       dilate=None, pad=None, num_filter=None, num_group=1,
                       no_bias=False, layout=None, cudnn_tune=None,
                       cudnn_off=None, workspace=None, act_type="relu"):
    """Convolution then Activation, as one op."""
    conv = OP_TABLE["Convolution"].fn
    act = OP_TABLE["Activation"].fn
    return act(conv(x, weight, *maybe_bias, kernel=kernel, stride=stride,
                    dilate=dilate, pad=pad, num_filter=num_filter,
                    num_group=num_group, no_bias=no_bias, layout=layout),
               act_type=act_type)
