"""ResNet v1's ``stem="s2d"`` (space-to-depth input, a 5x5 stride-1 stem
convolution) of the port against the reference on the CPU in NCHW and
NHWC at 32 x 32, batch 2, predict mode: logits and every gradient within
1e-4 of the larger of 1 and the magnitude (test_torch_model_zoo_vision.py's
helpers and rule), and the stem's channel order the same in both layouts,
so that weights carry across them by the OIHW -> OHWI transpose."""
import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon.model_zoo import vision

from test_torch_model_zoo_vision import CPU, _close, _compare
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet_s2d_matches_reference(layout):
    shape = (2, 32, 32, 3) if layout == "NHWC" else (2, 3, 32, 32)
    _compare("resnet18_v1", shape, stem="s2d", layout=layout)


def test_resnet_s2d_weights_carry_across_layouts():
    """An NCHW s2d net's weights, convolutions transposed OIHW -> OHWI,
    give an NHWC s2d net the same logits on the transposed input (the
    space-to-depth channel order is the same in both layouts)."""
    x = np.random.RandomState(3).uniform(-1, 1, (2, 3, 32, 32)) \
        .astype("float32")
    nchw = vision.resnet18_v1(classes=7, stem="s2d")
    nchw.initialize(mx.init.Xavier(), ctx=CPU)
    with autograd.predict_mode():
        y1 = nchw(nd.array(x, ctx=CPU)).asnumpy()
    nhwc = vision.resnet18_v1(classes=7, stem="s2d", layout="NHWC")
    nhwc.initialize(ctx=CPU)
    xt = x.transpose(0, 2, 3, 1)
    nhwc(nd.array(xt, ctx=CPU))
    for p1, p2 in zip(nchw.collect_params().values(),
                      nhwc.collect_params().values()):
        a = p1.data().asnumpy()
        p2.set_data(a.transpose(0, 2, 3, 1) if a.ndim == 4 else a)
    with autograd.predict_mode():
        y2 = nhwc(nd.array(xt, ctx=CPU)).asnumpy()
    _close(y2, y1, "s2d across layouts")


def test_resnet_v2_matches_reference():
    _compare("resnet18_v2", (2, 3, 32, 32))
