"""The port's vision model zoo against the reference on the CPU, after
tests/test_model_zoo.py:20-116,186: every family at its published widths
(the reference's class count cut to 7), logits and every parameter's and
the input's gradient within 1e-4 of the larger of 1 and the magnitude
(fp32 through up to 121 layers), BatchNorm's parameters and statistics
drawn away from 1 and 0.

Each family runs at the smallest input it takes (AlexNet 63, VGG 32,
SqueezeNet 1.0 35 and 1.1 31; MobileNet takes any size and runs at 32,
where its last stride-2 stage halves 2 to 1), batch 2, in predict mode
(Dropout off, BatchNorm on its statistics).  The weights are drawn from
a numpy seed for the port's net, set into the reference's, and carried
back by ``load_reference_params``; the reference runs hybridized (one jit
compile for its forward and backward).  ``get_model``'s names are the
reference's.  DenseNet-121 and Inception-v3 are in
test_torch_model_zoo_vision_deep.py, ResNet's ``stem="s2d"`` in
test_torch_model_zoo_resnet_s2d.py (this file's helpers)."""
import numpy as np
import pytest

import mxnet_tpu as rmx
from mxnet_tpu.gluon.model_zoo import vision as rvision
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import load_reference_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
TOL = 1e-4


def _close(port, ref, what=""):
    ref = np.asarray(ref, dtype=np.float64)
    port = np.asarray(port, dtype=np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _values(port, seed):
    """Seeded weights for the settled ``port``: N(0, 1/fan-in) for weights,
    BatchNorm's parameters and statistics drawn away from 1 and 0, small
    biases."""
    r = np.random.RandomState(seed)
    out = {}
    for name, p in port.collect_params().items():
        shape = p.shape
        if name.endswith(("gamma", "running_var")):
            v = 1 + 0.2 * r.rand(*shape)
        elif name.endswith(("beta", "running_mean", "bias")):
            v = 0.2 * r.randn(*shape)
        else:
            v = r.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        out[name] = v.astype("float32")
    return out


def _build(name, shape, seed=0, **kw):
    """(reference net, port net, the input): the port settles its shapes on
    the input, both nets take the same seeded weights (the reference's
    set directly, the port's carried from it by load_reference_params),
    and the reference is hybridized, so that one jit compile runs its
    forward and backward."""
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype("float32")
    port = vision.get_model(name, classes=7, **kw)
    port.initialize(ctx=CPU)
    with autograd.predict_mode():
        port(nd.array(x, ctx=CPU))
    values = list(_values(port, seed + 1).values())
    ref = rvision.get_model(name, classes=7, **kw)
    rparams = list(ref.collect_params().values())
    assert len(rparams) == len(values)
    for p, v in zip(rparams, values):
        p.shape = v.shape
        p._deferred_init = ()
        p._init_impl(rmx.nd.array(v), [rmx.cpu()])
    ref.hybridize()
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()})
    return ref, port, x


def _run(pkg, net, x, train):
    """Logits and the gradients of their weighted sum, with the
    parameters' in collect_params() order and the input's last."""
    xa = pkg.nd.array(x, ctx=pkg.cpu())
    xa.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = net(xa)
        w = np.random.RandomState(9).randn(*out.shape).astype("float32")
        loss = (out * pkg.nd.array(w, ctx=pkg.cpu())).sum()
    loss.backward()
    grads = [p.grad().asnumpy() for p in net.collect_params().values()
             if p.grad_req != "null"]
    return out.asnumpy(), grads + [xa.grad.asnumpy()]


def _compare(name, shape, train=False, **kw):
    ref, port, x = _build(name, shape, **kw)
    prev = rmx.nd.set_eager_jit(False)
    try:
        rout, rgrads = _run(rmx, ref, x, train)
    finally:
        rmx.nd.set_eager_jit(prev)
    pout, pgrads = _run(mx, port, x, train)
    assert pout.shape == rout.shape == (shape[0], 7)
    _close(pout, rout, f"{name} logits")
    assert len(pgrads) == len(rgrads)
    for i, (p, r) in enumerate(zip(pgrads, rgrads)):
        _close(p, r, f"{name} gradient {i}")
    return port


FAMILIES = [("alexnet", 63), ("vgg16_bn", 32), ("squeezenet1_0", 35),
            ("squeezenet1_1", 31), ("mobilenet1_0", 32),
            ("mobilenet_v2_1_0", 32)]


@pytest.mark.parametrize("name,size", FAMILIES, ids=[f for f, _ in FAMILIES])
def test_family_matches_reference(name, size):
    _compare(name, (2, 3, size, size))


def test_get_model_takes_every_reference_name():
    assert set(vision._models) == set(rvision._models)
    for name in ("alexnet", "vgg19_bn", "mobilenet0_25",
                 "mobilenet_v2_0_5", "squeezenet1_0", "densenet201",
                 "inceptionv3", "resnet152_v2"):
        assert type(vision.get_model(name, classes=3)).__name__ == \
            type(rvision.get_model(name, classes=3)).__name__
    with pytest.raises(MXNetError, match="not found"):
        vision.get_model("resnet9000")
    with pytest.raises(MXNetError, match="pretrained"):
        vision.get_model("alexnet", pretrained=True)


def test_hybridized_family_equals_eager():
    """A zoo net through the cached forward computes what it computes
    eagerly (the CPU entry runs the same ops)."""
    net = vision.get_model("squeezenet1_1", classes=7)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    x = nd.array(np.random.RandomState(4).uniform(-1, 1, (2, 3, 31, 31))
                 .astype("float32"), ctx=CPU)
    eager = net(x).asnumpy()
    net.hybridize()
    net(x)
    np.testing.assert_array_equal(net(x).asnumpy(), eager)


def test_contrib_layers():
    from mxnet_tpu_torch.gluon.contrib import nn as cnn

    x = nd.array(np.random.RandomState(5).randn(2, 3, 4, 4)
                 .astype("float32"), ctx=CPU)
    cat = cnn.HybridConcurrent(axis=1)
    cat.add(cnn.Identity(), mx.gluon.nn.Activation("relu"))
    out = cat(x).asnumpy()
    np.testing.assert_array_equal(out[:, :3], x.asnumpy())
    np.testing.assert_array_equal(out[:, 3:], np.maximum(x.asnumpy(), 0))
    cc = cnn.Concurrent(axis=-1)
    cc.add(cnn.Identity(), cnn.Identity())
    assert cc(x).shape == (2, 3, 4, 8)
    # SyncBatchNorm in one process is BatchNorm over axis 1
    sbn, bn = cnn.SyncBatchNorm(), mx.gluon.nn.BatchNorm()
    for b in (sbn, bn):
        b.initialize(ctx=CPU)
    with autograd.record():
        ys, yb = sbn(x), bn(x)
    np.testing.assert_array_equal(ys.asnumpy(), yb.asnumpy())
    np.testing.assert_array_equal(sbn.running_mean.data().asnumpy(),
                                  bn.running_mean.data().asnumpy())
