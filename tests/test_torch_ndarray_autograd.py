"""The port's op table, NDArray and autograd (mxnet_tpu_torch.ops,
.ndarray, .autograd) held against the reference on the CPU.

Every op of the training path runs through the reference's pure jax
function and the port's pure torch function on the same numpy inputs
(seeded).  Forwards agree within ATOL = 1e-5, and gradients (jax.vjp
against torch autograd, the same random cotangent) within GRAD_ATOL =
1e-5, each scaled by the larger of 1 and the reference's largest
magnitude: fp32, and the frameworks sum in different orders, so the
error grows with the size of the sums (a weight gradient of a
convolution sums 180 products per element here).
Then the NDArray surface: invoke, the generated nd functions, record /
backward with each grad_req, and the AMP cast policy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu.ops  # noqa: F401  (populates the reference table)
from mxnet_tpu.contrib.amp import lists as ref_lists
from mxnet_tpu.ops.registry import get_op as ref_get_op
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.contrib.amp import lists as port_lists
from mxnet_tpu_torch.ops.registry import get_op as port_get_op

ATOL = 1e-5
GRAD_ATOL = 1e-5
CPU = mx.cpu()


def _rand(r, shape, positive=False):
    x = r.randn(*shape).astype("float32")
    return np.abs(x) + 0.5 if positive else x


def _scale(ref):
    ref = np.asarray(ref, dtype=np.float32)
    return max(1.0, float(np.abs(ref).max())) if ref.size else 1.0


def _check_op(name, arrays, attrs, atol=ATOL, grad_atol=GRAD_ATOL,
              grad=True, state=(), seed=0):
    """Every output's forward and, with ``grad``, the vjp of output 0
    against the same cotangent, for every float input not listed in
    ``state`` (inputs that are state, not differentiable operands)."""
    ref_fn = ref_get_op(name).fn
    port_fn = port_get_op(name).fn
    j_in = [jnp.asarray(a) for a in arrays]
    t_in = [torch.from_numpy(np.array(a)).requires_grad_(
        grad and i not in state and np.issubdtype(a.dtype, np.floating))
        for i, a in enumerate(arrays)]
    if grad:
        ref_out, vjp = jax.vjp(lambda *a: ref_fn(*a, **attrs), *j_in)
    else:
        ref_out = ref_fn(*j_in, **attrs)
    port_out = port_fn(*t_in, **attrs)
    ref_outs = list(ref_out) if isinstance(ref_out, tuple) else [ref_out]
    port_outs = list(port_out) if isinstance(port_out, tuple) else \
        [port_out]
    assert len(ref_outs) == len(port_outs)
    for ro, po in zip(ref_outs, port_outs):
        assert tuple(ro.shape) == tuple(po.shape), name
        np.testing.assert_allclose(po.detach().numpy(), np.asarray(ro),
                                   rtol=0, atol=atol * _scale(ro),
                                   err_msg=name)
    if not grad:
        return
    cot = np.asarray(np.random.RandomState(seed + 1).randn(
        *ref_outs[0].shape), dtype=np.float32)
    cots = [jnp.asarray(cot)] + [jnp.zeros_like(o) for o in ref_outs[1:]]
    ref_grads = vjp(tuple(cots) if isinstance(ref_out, tuple) else cots[0])
    port_grads = torch.autograd.grad(
        port_outs[0], [t for t in t_in if t.requires_grad],
        torch.from_numpy(cot), allow_unused=True)
    it = iter(port_grads)
    for t, rg in zip(t_in, ref_grads):
        if not t.requires_grad:
            continue
        pg = next(it)
        pg = torch.zeros_like(t) if pg is None else pg
        np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=0,
                                   atol=grad_atol * _scale(rg),
                                   err_msg=f"{name} grad")


# -- ops/nn.py ---------------------------------------------------------------
@pytest.mark.parametrize("flatten,bias", [(True, True), (False, True),
                                          (True, False)])
def test_fully_connected(flatten, bias):
    r = np.random.RandomState(0)
    x = _rand(r, (3, 2, 5) if flatten else (3, 4, 5))
    w = _rand(r, (6, 10 if flatten else 5))
    arrays = [x, w] + ([_rand(r, (6,))] if bias else [])
    _check_op("FullyConnected", arrays,
              dict(num_hidden=6, no_bias=not bias, flatten=flatten))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride,pad,dilate,groups,bias", [
    ((1, 1), (1, 1), (1, 1), 1, False),
    ((2, 2), (1, 1), (1, 1), 1, True),
    ((1, 2), (0, 2), (2, 1), 1, True),
    ((1, 1), (1, 1), (1, 1), 4, False),
])
def test_convolution(layout, stride, pad, dilate, groups, bias):
    r = np.random.RandomState(1)
    c_in, c_out = 16, 8
    if layout == "NCHW":
        x = _rand(r, (2, c_in, 9, 10))
        w = _rand(r, (c_out, c_in // groups, 3, 3)) * 0.2
    else:
        x = _rand(r, (2, 9, 10, c_in))
        w = _rand(r, (c_out, 3, 3, c_in // groups)) * 0.2
    arrays = [x, w] + ([_rand(r, (c_out,))] if bias else [])
    _check_op("Convolution", arrays,
              dict(kernel=(3, 3), stride=stride, pad=pad, dilate=dilate,
                   num_filter=c_out, num_group=groups, no_bias=not bias,
                   layout=layout))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("attrs", [
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(2, 2), pool_type="max", stride=(2, 2)),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), pool_type="avg", stride=(1, 1), pad=(1, 1),
         count_include_pad=False),
    dict(kernel=(1, 1), pool_type="avg", global_pool=True),
    dict(kernel=(1, 1), pool_type="max", global_pool=True),
])
def test_pooling(layout, attrs):
    r = np.random.RandomState(2)
    shape = (2, 3, 7, 8) if layout == "NCHW" else (2, 7, 8, 3)
    _check_op("Pooling", [_rand(r, shape)], dict(attrs, layout=layout))


def test_pooling_full_convention_is_refused():
    x = torch.zeros(1, 1, 5, 5)
    with pytest.raises(MXNetError, match="not ported"):
        port_get_op("Pooling").fn(x, kernel=(2, 2), stride=(2, 2),
                                  pooling_convention="full")


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation(act):
    _check_op("Activation", [_rand(np.random.RandomState(3), (4, 7))],
              dict(act_type=act))


@pytest.mark.parametrize("name", ["softmax", "log_softmax"])
@pytest.mark.parametrize("axis,temperature", [(-1, None), (1, None),
                                              (-1, 2.0)])
def test_softmax_family(name, axis, temperature):
    _check_op(name, [_rand(np.random.RandomState(4), (3, 5, 6))],
              dict(axis=axis, temperature=temperature))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("axis,shape", [(1, (4, 3, 5, 6)), (-1, (4, 5, 6, 3)),
                                        (1, (8, 3))])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm(training, axis, shape, fix_gamma):
    """Outputs and the new moving stats (train: biased batch variance,
    ``moving * 0.9 + batch * 0.1``; eval: the moving stats unchanged), and
    the gradients of x, gamma and beta (the moving stats are state:
    Gluon's are grad_req 'null')."""
    r = np.random.RandomState(5)
    c = shape[axis]
    x = _rand(r, shape) * 2.0 + 0.5
    arrays = [x, _rand(r, (c,)) + 1.0, _rand(r, (c,)),
              _rand(r, (c,)) * 0.1, np.abs(_rand(r, (c,))) + 0.5]
    _check_op("BatchNorm", arrays,
              dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma, axis=axis,
                   training=training), state=(3, 4))


def test_batch_norm_running_var_is_biased_and_momentum_weighs_the_old():
    """Spelled out on numbers: n = 2 per channel makes the biased and
    unbiased variances differ by 2x."""
    x = torch.tensor([[1.0], [3.0]])          # mean 2, biased var 1
    one = torch.ones(1)
    _, mean, var = port_get_op("BatchNorm").fn(
        x, one, torch.zeros(1), torch.zeros(1), one, momentum=0.9,
        fix_gamma=False, axis=1, training=True)
    assert mean.item() == pytest.approx(0.9 * 0.0 + 0.1 * 2.0)
    assert var.item() == pytest.approx(0.9 * 1.0 + 0.1 * 1.0)


# -- ops/tensor.py -----------------------------------------------------------
@pytest.mark.parametrize("name", ["broadcast_add", "broadcast_sub",
                                  "broadcast_mul", "broadcast_div",
                                  "broadcast_mod", "broadcast_power"])
@pytest.mark.parametrize("shapes", [((3, 4), (3, 4)), ((3, 4), (1, 4)),
                                    ((2, 1, 4), (3, 1))])
def test_binary_broadcast(name, shapes):
    r = np.random.RandomState(6)
    pos = name in ("broadcast_div", "broadcast_mod", "broadcast_power")
    _check_op(name, [_rand(r, shapes[0], positive=pos),
                     _rand(r, shapes[1], positive=pos)], {})


@pytest.mark.parametrize("name", ["broadcast_add", "broadcast_sub",
                                  "broadcast_mul", "broadcast_div",
                                  "broadcast_mod", "broadcast_power"])
@pytest.mark.parametrize("reverse", [False, True])
def test_binary_scalar(name, reverse):
    x = _rand(np.random.RandomState(7), (3, 4), positive=True)
    _check_op(name + "_scalar", [x], dict(scalar=1.7, reverse=reverse))


@pytest.mark.parametrize("name", ["broadcast_equal", "broadcast_not_equal",
                                  "broadcast_greater",
                                  "broadcast_greater_equal",
                                  "broadcast_lesser",
                                  "broadcast_lesser_equal"])
def test_comparisons(name):
    r = np.random.RandomState(8)
    a = r.randint(0, 3, (4, 5)).astype("float32")
    b = r.randint(0, 3, (1, 5)).astype("float32")
    _check_op(name, [a, b], {}, grad=False)
    _check_op(name + "_scalar", [a], dict(scalar=1.0, reverse=True),
              grad=False)


@pytest.mark.parametrize("name", ["negative", "abs", "square", "zeros_like"])
def test_unary(name):
    x = _rand(np.random.RandomState(9), (3, 5))
    _check_op(name, [x], {}, grad=name != "zeros_like")


@pytest.mark.parametrize("name", ["sum", "mean"])
@pytest.mark.parametrize("axis,keepdims,exclude", [
    (None, False, False), (1, False, False), ((0, 2), True, False),
    (0, False, True), (-1, True, False)])
def test_reductions(name, axis, keepdims, exclude):
    _check_op(name, [_rand(np.random.RandomState(10), (3, 4, 5))],
              dict(axis=axis, keepdims=keepdims, exclude=exclude))


@pytest.mark.parametrize("name,attrs", [
    ("reshape", dict(shape=(6, 10))), ("flatten", {}),
    ("transpose", dict(axes=(2, 0, 1))), ("transpose", {}),
    ("cast", dict(dtype="float32"))])
def test_shape_ops(name, attrs):
    _check_op(name, [_rand(np.random.RandomState(11), (3, 4, 5))], attrs)


@pytest.mark.parametrize("axis,keepdims", [(-1, False), (1, True), (0, False)])
def test_pick(axis, keepdims):
    r = np.random.RandomState(12)
    data = _rand(r, (4, 6))
    n = data.shape[axis]
    other = data.shape[1 - axis % 2]
    # float labels with out-of-range entries: cast and clipped
    index = r.randint(-1, n + 1, (other,)).astype("float32")
    _check_op("pick", [data, index], dict(axis=axis, keepdims=keepdims))


def test_cast_to_bfloat16_and_back():
    x = _rand(np.random.RandomState(13), (5,))
    t = port_get_op("cast").fn(torch.from_numpy(x), dtype="bfloat16")
    assert t.dtype == torch.bfloat16
    ref = ref_get_op("cast").fn(jnp.asarray(x), dtype="bfloat16")
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("name", ["zeros", "ones"])
def test_creation(name):
    ref = ref_get_op(name).fn(shape=(2, 3), dtype="float32")
    out = port_get_op(name).fn(shape=(2, 3), dtype="float32", device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- ops/optimizer_ops.py ----------------------------------------------------
@pytest.mark.parametrize("name,n_state,attrs", [
    ("sgd_update", 0, dict(lr=0.1, wd=1e-3, rescale_grad=0.5)),
    ("sgd_update", 0, dict(lr=0.1, clip_gradient=0.3)),
    ("sgd_mom_update", 1, dict(lr=0.1, momentum=0.9, wd=1e-3,
                               rescale_grad=0.25)),
    ("sgd_mom_update", 1, dict(lr=0.05, momentum=0.5, clip_gradient=0.2)),
    ("adam_update", 2, dict(lr=0.01, beta1=0.8, beta2=0.99, wd=1e-3,
                            rescale_grad=0.5)),
    ("adam_update", 2, dict(lr=0.01, clip_gradient=0.5, epsilon=1e-6)),
])
def test_optimizer_update(name, n_state, attrs):
    r = np.random.RandomState(14)
    arrays = [_rand(r, (4, 5)), _rand(r, (4, 5))] + \
        [np.abs(_rand(r, (4, 5))) for _ in range(n_state)]
    _check_op(name, arrays, attrs, grad=False)


def test_amp_lists_are_the_references():
    assert port_lists.TARGET_DTYPE_OPS == ref_lists.TARGET_DTYPE_OPS
    assert port_lists.FP32_OPS == ref_lists.FP32_OPS


# -- NDArray / invoke / autograd ---------------------------------------------
def test_ndarray_surface():
    a = nd.array([[1, 2], [3, 4]], ctx=CPU)
    assert a.dtype == np.float32 and a.shape == (2, 2) and a.context == CPU
    b = nd.array(np.arange(4, dtype=np.int64), ctx=CPU)
    assert b.dtype == np.int32
    c = (a + 1) * 2 - a / 2
    np.testing.assert_allclose(c.asnumpy(), (a.asnumpy() + 1) * 2
                               - a.asnumpy() / 2)
    np.testing.assert_allclose((1 - a).asnumpy(), 1 - a.asnumpy())
    np.testing.assert_allclose((2 ** a).asnumpy(), 2 ** a.asnumpy())
    np.testing.assert_allclose((-a).asnumpy(), -a.asnumpy())
    np.testing.assert_array_equal((a > 2).asnumpy(), [[0, 0], [1, 1]])
    assert a.reshape(0, -1).shape == (2, 2) and a.reshape(-1).shape == (4,)
    assert a.T.shape == (2, 2) and a.flatten().shape == (2, 2)
    assert a.astype("bfloat16").dtype == "bfloat16"
    assert float(a.sum().asscalar()) == 10.0
    a[:] = 0.0
    assert float(a.sum().asscalar()) == 0.0
    a += 3
    np.testing.assert_array_equal(a.asnumpy(), 3.0)
    d = nd.zeros((2, 3), ctx=CPU)
    nd.broadcast_add(a, nd.ones((2, 2), ctx=CPU), out=d[:, :2])
    np.testing.assert_array_equal(d.asnumpy(), [[4, 4, 0], [4, 4, 0]])
    # generated functions bind positional scalars to the op's attributes
    e = nd.broadcast_add(nd.ones((2, 1), ctx=CPU), nd.ones((1, 3), ctx=CPU))
    assert e.shape == (2, 3)
    np.testing.assert_array_equal(nd.sum(e, 1).asnumpy(), [6.0, 6.0])
    assert nd.array(5.0, ctx=CPU).shape == (1,)


@pytest.mark.parametrize("grad_req", ["write", "add", "null"])
def test_record_backward_grad_req(grad_req):
    x = nd.array([1.0, 2.0, 3.0], ctx=CPU)
    x.attach_grad(grad_req=grad_req)
    for _ in range(2):
        with autograd.record():
            y = x * x + x          # x used twice: contributions sum
        y.backward()
    expect = {"write": 2 * x.asnumpy() + 1, "add": 2 * (2 * x.asnumpy() + 1),
              "null": np.zeros(3)}[grad_req]
    np.testing.assert_allclose(x.grad.asnumpy(), expect)


def test_backward_with_head_gradient_and_unreached_variable():
    x = nd.array([1.0, 2.0], ctx=CPU)
    z = nd.array([5.0, 5.0], ctx=CPU)
    x.attach_grad()
    z.attach_grad()
    z.grad[:] = 7.0
    with autograd.record():
        y = x * 3
    y.backward(nd.array([1.0, 10.0], ctx=CPU))
    np.testing.assert_allclose(x.grad.asnumpy(), [3.0, 30.0])
    np.testing.assert_allclose(z.grad.asnumpy(), [7.0, 7.0])   # untouched


def test_scopes_and_unrecorded_heads():
    x = nd.array([1.0, 2.0], ctx=CPU)
    x.attach_grad()
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        with autograd.pause():
            assert not autograd.is_recording()
            w = x * 2                       # not recorded
        with autograd.predict_mode():
            assert not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training()
    y = x * 2                               # outside record: no graph
    for head in (w, y):
        with pytest.raises(MXNetError, match="not computed under"):
            head.backward()


def test_amp_casts_by_op_list_and_grads_stay_fp32():
    x = nd.array(np.ones((2, 3), "float32"), ctx=CPU)
    w = nd.array(np.ones((4, 3), "float32"), ctx=CPU)
    w.attach_grad()
    amp.init("bfloat16")
    try:
        with autograd.record():
            y = nd.FullyConnected(x, w, num_hidden=4, no_bias=True)
            s = nd.log_softmax(y)
            loss = nd.sum(s)
    finally:
        amp.disable()
    assert y.dtype == "bfloat16"          # target-dtype op
    assert s.dtype == np.float32          # fp32 op
    loss.backward()
    assert w.grad.dtype == np.float32
    assert nd.FullyConnected(x, w, num_hidden=4, no_bias=True).dtype == \
        np.float32                        # policy off again


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: nd.zeros((2,)), lambda: nd.array([1.0]),
                 lambda: mx.gpu(0).device):
        with pytest.raises(MXNetError, match="no CUDA device"):
            make()
