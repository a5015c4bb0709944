"""ResNet v1/v2 (18/34/50/101/152), counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``: the same blocks, layer
order and parameter names, in ``layout="NCHW"`` (the MXNet default) or
``"NHWC"`` (channel-last: activations (N, H, W, C), convolution weights
(O, kh, kw, I), BatchNorm over axis -1).  ``thumbnail=True`` is the
3x3-stem variant for small (CIFAR-size) inputs; ``stem="s2d"`` (v1) puts
a space-to-depth rearrangement and a 5x5 stride-1 convolution in place of
the 7x7 stride-2 stem, with the same channel order in both layouts, so
that a stem weight carries across them by the usual OIHW <-> OHWI
transpose.  Pretrained weights are not in the repository."""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


_NO_PRETRAINED = ("pretrained weights are not in the repository; load "
                  "reference weights with "
                  "gluon.parameter.load_reference_params")


def _bn_axis(layout):
    return -1 if layout.endswith("C") else 1


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


def _downsample_v1(channels, stride, in_channels, layout, ax):
    ds = nn.HybridSequential(prefix="")
    ds.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                     use_bias=False, in_channels=in_channels, layout=layout))
    ds.add(nn.BatchNorm(axis=ax))
    return ds


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.downsample = _downsample_v1(channels, stride, in_channels,
                                         layout, ax) if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.downsample = _downsample_v1(channels, stride, in_channels,
                                         layout, ax) if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, layout=layout) \
            if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout)
        self.bn3 = nn.BatchNorm(axis=ax)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, layout=layout) \
            if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.Activation(self.bn3(x), act_type="relu")
        x = self.conv3(x)
        return x + residual


class _SpaceToDepthInput(HybridBlock):
    """(N, C, H, W) -> (N, 4C, H/2, W/2) (or the NHWC form), channels in
    (row in the 2x2 block, column, channel) order in both layouts: the
    NCHW form is the space_to_depth op, whose order this is."""

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self._cl = layout.endswith("C")

    def hybrid_forward(self, F, x):
        if self._cl:
            n, h, w, c = x.shape
            x = F.reshape(x, shape=(n, h // 2, 2, w // 2, 2, c))
            x = F.transpose(x, axes=(0, 1, 3, 2, 4, 5))
            return F.reshape(x, shape=(n, h // 2, w // 2, 4 * c))
        return F.space_to_depth(x, block_size=2)


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", stem="conv7", **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1: need one channel count per stage "
                             "plus the stem's")
        if stem not in ("conv7", "s2d"):
            raise MXNetError(f"ResNetV1: stem {stem!r} is not conv7 or s2d")
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential(prefix="")
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, layout))
        else:
            if stem == "s2d":
                self.features.add(_SpaceToDepthInput(layout=layout))
                self.features.add(nn.Conv2D(channels[0], 5, 1, 2,
                                            use_bias=False, layout=layout))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout))
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          stride, i + 1, channels[i], layout))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV2: need one channel count per stage "
                             "plus the stem's")
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential(prefix="")
        self.features.add(nn.BatchNorm(axis=ax, scale=False, center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                        use_bias=False, layout=layout))
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          stride, i + 1, in_channels, layout))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(axis=ax))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _make_layer(block, layers, channels, stride, stage_index, in_channels,
                layout):
    layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels, layout=layout, prefix=""))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels,
                        layout=layout, prefix=""))
    return layer


resnet_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
               34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
               50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
               101: ("bottle_neck", [3, 4, 23, 3],
                     [64, 256, 512, 1024, 2048]),
               152: ("bottle_neck", [3, 8, 36, 3],
                     [64, 256, 512, 1024, 2048])}

resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [{"basic_block": BasicBlockV1,
                          "bottle_neck": BottleneckV1},
                         {"basic_block": BasicBlockV2,
                          "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """The ResNet of ``version`` (1 or 2) and depth ``num_layers``.  The net
    holds no data until ``initialize()`` places it (on ``ctx``, default
    the first CUDA card)."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}")
    if pretrained:
        raise MXNetError(_NO_PRETRAINED)
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    return resnet_class(block_class, layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
