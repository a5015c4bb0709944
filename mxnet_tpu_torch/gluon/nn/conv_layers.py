"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): Conv2D, MaxPool2D, AvgPool2D and
GlobalAvgPool2D.  Under a channel-last layout the Conv2D weight keeps
MXNet's (channels, kh, kw, in_channels / groups) shape, so weights carry
over from the reference one to one."""
from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _pair(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        self._channel_last = layout is not None and layout.endswith("C")
        if self._channel_last:
            wshape = (channels,) + tuple(kernel_size) + \
                (in_channels // groups,)
        else:
            wshape = (channels, in_channels // groups) + tuple(kernel_size)
        self.weight = self.params.get("weight", shape=wshape,
                                      init=weight_initializer,
                                      allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get("bias", shape=(channels,),
                                        init=bias_initializer,
                                        allow_deferred_init=True)
        else:
            self.bias = None
        self.act = Activation(activation, prefix=activation + "_") \
            if activation else None

    def infer_shape(self, x, *args):
        g = self._kwargs["num_group"]
        w = list(self.weight.shape)
        if self._channel_last:
            self.weight.shape = tuple(w[:-1]) + (x.shape[-1] // g,)
        else:
            self.weight.shape = (w[0], x.shape[1] // g) + tuple(w[2:])

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.Convolution(x, weight, **self._kwargs)
        else:
            out = F.Convolution(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout=None, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides is not None else None,
                         _pair(padding, 2), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides is not None else None,
                         _pair(padding, 2), ceil_mode, False, "avg",
                         layout=layout, count_include_pad=count_include_pad,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "avg",
                         layout=layout, **kwargs)
