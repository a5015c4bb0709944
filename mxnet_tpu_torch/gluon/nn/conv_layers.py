"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): Conv1D/2D/3D and their
transposes, max and average pooling in 1, 2 and 3 dimensions, the global
poolings and ReflectionPad2D, over the table's Convolution, Deconvolution,
Pooling and pad ops.  Under a channel-last layout the weights keep MXNet's
layouts ((channels, *kernel, in_channels / groups) for a convolution, (in,
*kernel, channels / groups) for a transpose), so weights carry over from
the reference one to one."""
from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _pair(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._in_channels = in_channels
        nd = len(kernel_size)
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        self._op_name = op_name
        self._channel_last = layout is not None and layout.endswith("C")
        if op_name == "Convolution":
            if self._channel_last:
                # MXNet NHWC kernel convention: (num_filter, *k, C/group)
                wshape = (channels,) + tuple(kernel_size) + \
                    (in_channels // groups,)
            else:
                wshape = (channels, in_channels // groups) + tuple(kernel_size)
        else:  # Deconvolution: (in, out/g, *k); channel-last (in, *k, out/g)
            if self._channel_last:
                wshape = (in_channels,) + tuple(kernel_size) + \
                    (channels // groups,)
            else:
                wshape = (in_channels, channels // groups) + \
                    tuple(kernel_size)
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
        if self._op_name == "Convolution":
            if self._channel_last:
                self.weight.shape = tuple(w[:-1]) + (x.shape[-1] // g,)
            else:
                self.weight.shape = (w[0], x.shape[1] // g) + tuple(w[2:])
        elif self._channel_last:  # Deconvolution, (in, *k, out/g)
            self.weight.shape = (x.shape[-1],) + tuple(w[1:-1]) + \
                (self._channels // g,)
        else:
            self.weight.shape = (x.shape[1], self._channels // g) + \
                tuple(w[2:])

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, **self._kwargs)
        else:
            out = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


class _ConvND(_Conv):
    """Conv{N}D: a convolution over the last ``_N`` axes (``layout``
    defaults to channels first)."""

    _N = 2

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        n = self._N
        super().__init__(channels, _pair(kernel_size, n), _pair(strides, n),
                         _pair(padding, n), _pair(dilation, n), groups,
                         layout or _LAYOUTS[n], in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class _ConvNDTranspose(_Conv):
    """Conv{N}DTranspose: the Deconvolution op, ``output_padding`` its
    ``adj``."""

    _N = 2

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout=None,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        n = self._N
        super().__init__(channels, _pair(kernel_size, n), _pair(strides, n),
                         _pair(padding, n), _pair(dilation, n), groups,
                         layout or _LAYOUTS[n], in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_pair(output_padding, n), **kwargs)


class Conv1D(_ConvND):
    _N = 1


class Conv2D(_ConvND):
    _N = 2


class Conv3D(_ConvND):
    _N = 3


class Conv1DTranspose(_ConvNDTranspose):
    _N = 1


class Conv2DTranspose(_ConvNDTranspose):
    _N = 2


class Conv3DTranspose(_ConvNDTranspose):
    _N = 3


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


class _MaxPool(_Pooling):
    _N = 2

    def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                 ceil_mode=False, **kwargs):
        n = self._N
        super().__init__(_pair(pool_size, n),
                         _pair(strides, n) if strides is not None else None,
                         _pair(padding, n), ceil_mode, False, "max",
                         layout=layout or _LAYOUTS[n], **kwargs)


class _AvgPool(_Pooling):
    _N = 2

    def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                 ceil_mode=False, count_include_pad=True, **kwargs):
        n = self._N
        super().__init__(_pair(pool_size, n),
                         _pair(strides, n) if strides is not None else None,
                         _pair(padding, n), ceil_mode, False, "avg",
                         layout=layout or _LAYOUTS[n],
                         count_include_pad=count_include_pad, **kwargs)


class _GlobalPool(_Pooling):
    _N, _TYPE = 2, "avg"

    def __init__(self, layout=None, **kwargs):
        n = self._N
        super().__init__((1,) * n, None, (0,) * n, False, True, self._TYPE,
                         layout=layout or _LAYOUTS[n], **kwargs)


class MaxPool1D(_MaxPool):
    _N = 1


class MaxPool2D(_MaxPool):
    _N = 2


class MaxPool3D(_MaxPool):
    _N = 3


class AvgPool1D(_AvgPool):
    _N = 1


class AvgPool2D(_AvgPool):
    _N = 2


class AvgPool3D(_AvgPool):
    _N = 3


class GlobalMaxPool1D(_GlobalPool):
    _N, _TYPE = 1, "max"


class GlobalMaxPool2D(_GlobalPool):
    _N, _TYPE = 2, "max"


class GlobalMaxPool3D(_GlobalPool):
    _N, _TYPE = 3, "max"


class GlobalAvgPool1D(_GlobalPool):
    _N = 1


class GlobalAvgPool2D(_GlobalPool):
    _N = 2


class GlobalAvgPool3D(_GlobalPool):
    _N = 3


class ReflectionPad2D(HybridBlock):
    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
