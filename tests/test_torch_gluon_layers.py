"""The port's remaining Gluon losses, activations, layers, initializers and
``gluon.utils`` held against the reference on the CPU.

Losses, activations and layers: the reference's block and the port's on
the same seeded inputs, the reference's weights (LayerNorm-style gammas
and betas moved off 1 and 0) carried over with ``load_reference_params``;
the output, and under a seeded cotangent the gradient of every float
input and parameter, within 1e-5 of the larger of 1 and the reference's
magnitude (fp32).  Bilinear and LSTMBias fill the same values exactly;
Orthogonal (whose draws differ) is held by its property, an orthonormal
matrix times ``scale``; Mixed by the pattern each parameter matched.
"""
import hashlib
import math

import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import load_reference_params, utils
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
TOL = 1e-5


def _close(port, ref, msg=""):
    ref = np.asarray(ref, dtype=np.float32)
    port = port.asnumpy() if hasattr(port, "asnumpy") else np.asarray(port)
    assert port.shape == ref.shape, msg
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=TOL * scale,
                               err_msg=msg)


def _run(pkg, block, arrays, diff, cot_seed=9):
    """Forward ``block`` on ``arrays`` (numpy) under record, backward a
    seeded cotangent: (output, gradients of the ``diff`` inputs,
    gradients of the parameters)."""
    ref = pkg == "ref"
    ag = rmx.autograd if ref else autograd
    xs = [None if a is None else (rmx.nd.array(a) if ref else
                                  nd.array(a, ctx=CPU, dtype=a.dtype))
          for a in arrays]
    for i in diff:
        xs[i].attach_grad()
    with ag.record():
        out = block(*xs)
    cot = np.random.RandomState(cot_seed).randn(*out.shape).astype(
        "float32")
    out.backward(rmx.nd.array(cot) if ref else nd.array(cot, ctx=CPU))
    params = [p for p in block.collect_params().values()
              if p.grad_req != "null"]
    return (out.asnumpy(), [xs[i].grad.asnumpy() for i in diff],
            [p.grad().asnumpy() for p in params])


def _check(make, arrays, diff=(0,), seed=3):
    """The block ``make(gluon namespace)`` of each package on ``arrays``."""
    ref, port = make(rmx.gluon), make(gluon)
    ref.initialize()
    port.initialize(ctx=CPU)
    ref(*[None if a is None else rmx.nd.array(a) for a in arrays])
    port(*[None if a is None else nd.array(a, ctx=CPU, dtype=a.dtype)
           for a in arrays])
    r = np.random.RandomState(seed)
    for name, p in ref.collect_params().items():
        if name.endswith(("gamma", "beta", "alpha", "bias")):
            base = 1.0 if name.endswith("gamma") else 0.0
            p.set_data(rmx.nd.array(
                (base + 0.3 * r.randn(*p.shape)).astype("float32")))
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()})
    rout, rg, rpg = _run("ref", ref, arrays, diff)
    pout, pg, ppg = _run("port", port, arrays, diff)
    _close(pout, rout, "output")
    for i, (a, b) in enumerate(zip(pg, rg)):
        _close(a, b, f"gradient of input {diff[i]}")
    assert len(ppg) == len(rpg)
    for i, (a, b) in enumerate(zip(ppg, rpg)):
        _close(a, b, f"gradient of parameter {i}")
    return pout


def _r(seed, *shape, lo=None, hi=None):
    r = np.random.RandomState(seed)
    if lo is not None:
        return r.uniform(lo, hi, shape).astype("float32")
    return r.randn(*shape).astype("float32")


def _signs(seed, *shape):
    return np.where(np.random.RandomState(seed).rand(*shape) > 0.5, 1.0,
                    -1.0).astype("float32")


def _bits(seed, *shape):
    return np.random.RandomState(seed).randint(0, 2, shape).astype("float32")


def _ctc_inputs():
    labels = np.array([[1, 2, 2, -1], [3, 1, 4, 2], [2, -1, -1, -1]],
                      "float32")
    return [_r(1, 3, 8, 5), labels]


def _ctc_lengths():
    return [_r(1, 3, 8, 5), np.array([[1, 2, 2, 0], [3, 1, 4, 2],
                                      [2, 0, 0, 0]], "float32"),
            np.array([8, 6, 7], "float32"), np.array([3, 4, 1], "float32")]


# (id, loss factory, inputs, differentiated inputs)
LOSSES = [
    ("l1", lambda g: g.loss.L1Loss(), [_r(1, 4, 6), _r(2, 4, 6)], (0,)),
    ("l1_weighted", lambda g: g.loss.L1Loss(weight=0.5),
     [_r(1, 4, 3, 2), _r(2, 4, 6), _r(3, 4, 1, 1, lo=0, hi=1)], (0,)),
    ("sigmoid_bce", lambda g: g.loss.SigmoidBinaryCrossEntropyLoss(),
     [_r(1, 4, 6), _bits(2, 4, 6)], (0,)),
    ("sigmoid_bce_pos_weight", lambda g: g.loss.SigmoidBCELoss(),
     [_r(1, 4, 6), _bits(2, 4, 6), None, _r(3, 1, 6, lo=0.5, hi=2)],
     (0,)),
    ("sigmoid_bce_from_sigmoid",
     lambda g: g.loss.SigmoidBCELoss(from_sigmoid=True),
     [_r(1, 4, 6, lo=0.05, hi=0.95), _bits(2, 4, 6)], (0,)),
    ("kldiv_logits", lambda g: g.loss.KLDivLoss(),
     [np.log(_r(1, 4, 6, lo=0.1, hi=1)), _r(2, 4, 6, lo=0.05, hi=1)],
     (0,)),
    ("kldiv_softmax", lambda g: g.loss.KLDivLoss(from_logits=False),
     [_r(1, 4, 6), _r(2, 4, 6, lo=0.05, hi=1)], (0,)),
    ("ctc", lambda g: g.loss.CTCLoss(), _ctc_inputs(), (0,)),
    ("ctc_lengths",
     lambda g: g.loss.CTCLoss(layout="NTC", label_layout="NT"),
     _ctc_lengths(), (0,)),
    ("huber", lambda g: g.loss.HuberLoss(rho=0.5),
     [_r(1, 4, 6), _r(2, 4, 6)], (0,)),
    ("hinge", lambda g: g.loss.HingeLoss(margin=0.8),
     [_r(1, 4, 6), _signs(2, 4, 6)], (0,)),
    ("squared_hinge", lambda g: g.loss.SquaredHingeLoss(),
     [_r(1, 4, 6), _signs(2, 4, 6)], (0,)),
    ("logistic_signed", lambda g: g.loss.LogisticLoss(),
     [_r(1, 4, 6), _signs(2, 4, 6)], (0,)),
    ("logistic_binary", lambda g: g.loss.LogisticLoss(label_format="binary"),
     [_r(1, 4, 6), _bits(2, 4, 6)], (0,)),
    ("triplet", lambda g: g.loss.TripletLoss(margin=0.5),
     [_r(1, 4, 6), _r(2, 4, 6), _r(3, 4, 6)], (0, 1, 2)),
    ("cosine_embedding", lambda g: g.loss.CosineEmbeddingLoss(margin=0.1),
     [_r(1, 4, 6), _r(2, 4, 6), _signs(3, 4)], (0, 1)),
]


@pytest.mark.parametrize("make,arrays,diff", [c[1:] for c in LOSSES],
                         ids=[c[0] for c in LOSSES])
def test_loss_matches_reference(make, arrays, diff):
    out = _check(make, arrays, diff)
    assert out.shape[0] == arrays[0].shape[0]


ACTIVATIONS = [
    ("leaky_relu", lambda g: g.nn.LeakyReLU(0.1)),
    ("prelu", lambda g: g.nn.PReLU()),
    ("elu", lambda g: g.nn.ELU(0.7)),
    ("selu", lambda g: g.nn.SELU()),
    ("swish", lambda g: g.nn.Swish(1.5)),
    ("gelu", lambda g: g.nn.GELU()),
]


@pytest.mark.parametrize("make", [c[1] for c in ACTIVATIONS],
                         ids=[c[0] for c in ACTIVATIONS])
def test_activation_matches_reference(make):
    _check(make, [_r(4, 3, 5, 4)])


LAYERS = [
    ("group_norm", lambda g: g.nn.GroupNorm(num_groups=2), (2, 4, 3, 3)),
    ("instance_norm", lambda g: g.nn.InstanceNorm(), (2, 3, 5)),
    ("instance_norm_scale", lambda g: g.nn.InstanceNorm(scale=True),
     (2, 3, 4, 4)),
    ("lambda_name", lambda g: g.nn.Lambda("tanh"), (2, 3, 4)),
    ("lambda_fn", lambda g: g.nn.Lambda(lambda x: x * 2 + 1), (2, 3, 4)),
    ("hybrid_lambda_name", lambda g: g.nn.HybridLambda("sigmoid"),
     (2, 3, 4)),
    ("hybrid_lambda_fn",
     lambda g: g.nn.HybridLambda(lambda F, x: F.relu(x) * x), (2, 3, 4)),
    ("conv1d", lambda g: g.nn.Conv1D(4, 3, strides=2, padding=1,
                                     activation="relu"), (2, 3, 9)),
    ("conv1d_nwc", lambda g: g.nn.Conv1D(4, 3, dilation=2, layout="NWC"),
     (2, 9, 3)),
    ("conv3d", lambda g: g.nn.Conv3D(4, (2, 3, 3), padding=(0, 1, 1),
                                     groups=2), (1, 2, 4, 5, 5)),
    ("conv1d_transpose",
     lambda g: g.nn.Conv1DTranspose(4, 3, strides=2, padding=1,
                                    output_padding=1), (2, 3, 5)),
    ("conv2d_transpose",
     lambda g: g.nn.Conv2DTranspose(4, 3, strides=2, padding=1,
                                    output_padding=1), (2, 3, 4, 4)),
    ("conv2d_transpose_nhwc",
     lambda g: g.nn.Conv2DTranspose(4, 3, strides=2, padding=1,
                                    layout="NHWC", use_bias=False),
     (2, 4, 4, 3)),
    ("conv3d_transpose", lambda g: g.nn.Conv3DTranspose(2, 3, strides=2),
     (1, 2, 3, 3, 3)),
    ("max_pool1d", lambda g: g.nn.MaxPool1D(3, 2, padding=1), (2, 3, 9)),
    ("max_pool3d", lambda g: g.nn.MaxPool3D(2), (1, 2, 4, 4, 4)),
    ("avg_pool1d", lambda g: g.nn.AvgPool1D(3, 2, padding=1,
                                            count_include_pad=False),
     (2, 3, 9)),
    ("avg_pool3d_ceil", lambda g: g.nn.AvgPool3D(2, ceil_mode=True),
     (1, 2, 5, 5, 5)),
    ("global_avg_pool1d", lambda g: g.nn.GlobalAvgPool1D(), (2, 3, 7)),
    ("global_avg_pool3d", lambda g: g.nn.GlobalAvgPool3D(), (1, 2, 3, 4, 5)),
    ("global_max_pool1d", lambda g: g.nn.GlobalMaxPool1D(), (2, 3, 7)),
    ("global_max_pool2d", lambda g: g.nn.GlobalMaxPool2D(), (2, 3, 4, 5)),
    ("global_max_pool3d", lambda g: g.nn.GlobalMaxPool3D(), (1, 2, 3, 4, 5)),
    ("reflection_pad2d", lambda g: g.nn.ReflectionPad2D(2), (1, 2, 5, 5)),
]


@pytest.mark.parametrize("make,shape", [c[1:] for c in LAYERS],
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_reference(make, shape):
    _check(make, [_r(5, *shape)])


POOLS = [((2, 3, 9), dict(kernel=(3,), stride=(2,), pad=(1,),
                          pool_type="max", pooling_convention="full")),
         ((2, 3, 7, 6), dict(kernel=(3, 2), stride=(2, 2), pool_type="avg",
                             pooling_convention="full")),
         ((2, 3, 7, 6), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                             pool_type="avg", pooling_convention="full",
                             count_include_pad=False)),
         ((1, 2, 5, 5, 5), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                pool_type="max", pooling_convention="full")),
         ((2, 6, 5, 3), dict(kernel=(2, 2), stride=(1, 2), pool_type="sum",
                             layout="NHWC")),
         ((2, 3, 8), dict(kernel=(3,), stride=(2,), pool_type="lp",
                          pooling_convention="full"))]


@pytest.mark.parametrize("shape,attrs", POOLS,
                         ids=[f"{a['pool_type']}-{len(s) - 2}d"
                              for s, a in POOLS])
def test_pooling_conventions_match_reference(shape, attrs):
    """The Pooling op's ceil mode ("full"), sum and L2 pooling, which the
    ceil_mode layers reach."""
    class Pool:
        def __init__(self, g):
            self.F = rmx.nd if g is rmx.gluon else nd

        def __call__(self, x):
            return self.F.Pooling(x, **attrs)

        def initialize(self, **kw):
            pass

        def collect_params(self):
            return {}

    _check(Pool, [_r(6, *shape)])


def test_layer_names_follow_the_reference():
    def alias(block):
        return block.prefix.rstrip("_").rstrip("0123456789")

    for make in [c[1] for c in LAYERS + ACTIVATIONS]:
        assert alias(make(gluon)) == alias(make(rmx.gluon))


# -- initializers ----------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 2, 5, 6), (3, 1, 3, 3)])
def test_bilinear_fills_the_reference_values(shape):
    ra = rmx.nd.zeros(shape)
    pa = nd.zeros(shape, ctx=CPU)
    rmx.init.Bilinear()("up_weight", ra)
    mx.init.Bilinear()("up_weight", pa)
    np.testing.assert_array_equal(pa.asnumpy(), ra.asnumpy())


@pytest.mark.parametrize("forget_bias", [1.0, 2.5])
def test_lstm_bias_fills_the_reference_values(forget_bias):
    """By ``init_weight`` and by the per-parameter override in
    ``InitDesc.attrs``, which the name-suffix dispatch would send to zero
    for a bias."""
    ra = rmx.nd.ones((16,))
    pa = nd.ones((16,), ctx=CPU)
    rmx.init.LSTMBias(forget_bias).init_weight("i2h_bias", ra)
    mx.init.LSTMBias(forget_bias).init_weight("i2h_bias", pa)
    np.testing.assert_array_equal(pa.asnumpy(), ra.asnumpy())
    assert pa.asnumpy()[4:8].tolist() == [forget_bias] * 4
    rd = rmx.initializer.InitDesc(
        "i2h_bias", attrs={"__init__": rmx.init.LSTMBias(forget_bias).dumps()})
    pd = mx.initializer.InitDesc(
        "i2h_bias", attrs={"__init__": mx.init.LSTMBias(forget_bias).dumps()})
    ra, pa = rmx.nd.ones((8,)), nd.ones((8,), ctx=CPU)
    rmx.init.Uniform()(rd, ra)
    mx.init.Uniform()(pd, pa)
    np.testing.assert_array_equal(pa.asnumpy(), ra.asnumpy())
    assert mx.init.LSTMBias(forget_bias).dumps() == \
        rmx.init.LSTMBias(forget_bias).dumps()


@pytest.mark.parametrize("shape", [(6, 4), (3, 2, 4), (5, 5)])
def test_orthogonal_is_orthonormal_times_scale(shape):
    """Rows (more columns) or columns (more rows) of the flattened weight
    are orthonormal times ``scale``, as the reference's; the draw differs
    with the seed."""
    scale = 1.7
    for arr, init in ((rmx.nd.zeros(shape), rmx.init.Orthogonal(scale)),
                      (nd.zeros(shape, ctx=CPU), mx.init.Orthogonal(scale))):
        init("w_weight", arr)
        q = arr.asnumpy().reshape(shape[0], -1).astype(np.float64)
        gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
        np.testing.assert_allclose(gram, scale ** 2 * np.eye(len(gram)),
                                   atol=1e-5)
    mx.random.seed(1)
    a = nd.zeros(shape, ctx=CPU)
    mx.init.Orthogonal()("w_weight", a)
    mx.random.seed(2)
    b = nd.zeros(shape, ctx=CPU)
    mx.init.Orthogonal()("w_weight", b)
    assert not np.array_equal(a.asnumpy(), b.asnumpy())


def test_mixed_initializes_by_pattern():
    for lib, init, kw in ((rmx.nd, rmx.init, {}), (nd, mx.init, {"ctx": CPU})):
        mixed = init.Mixed([".*_alpha", ".*"],
                           [init.Constant(0.5), init.Uniform(0.1)])
        b, w = lib.zeros((5,), **kw), lib.zeros((40, 40), **kw)
        mixed("fc_alpha", b)
        mixed("fc_weight", w)
        assert (b.asnumpy() == 0.5).all()
        w = w.asnumpy()
        assert np.abs(w).max() <= 0.1 and w.std() > 0.03
        with pytest.raises(ValueError):
            init.Mixed(["conv.*"], [init.Zero()])("fc_weight", w)


def test_initializer_dumps_round_trip():
    from mxnet_tpu_torch.initializer import _create_from_dumps

    for init in (mx.init.Xavier(magnitude=2), mx.init.Constant(0.3),
                 mx.init.Orthogonal(0.5)):
        name = type(init).__name__
        assert init.dumps() == getattr(rmx.init, name)(
            **init._kwargs).dumps()
        back = _create_from_dumps(init.dumps())
        assert type(back) is type(init) and back._kwargs == init._kwargs
    assert isinstance(_create_from_dumps("zeros"), mx.init.Zero)


# -- gluon.utils -----------------------------------------------------------
@pytest.mark.parametrize("axis,even", [(0, True), (1, False)])
def test_split_data_matches_reference(axis, even):
    x = _r(6, 6, 5)
    ref = rmx.gluon.utils.split_data(rmx.nd.array(x), 3 if even else 2,
                                     axis, even)
    port = utils.split_data(nd.array(x, ctx=CPU), 3 if even else 2, axis,
                            even)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.asnumpy(), r.asnumpy())
    with pytest.raises(MXNetError):
        utils.split_data(nd.array(x, ctx=CPU), 4)
    loaded = utils.split_and_load(x, [CPU])
    assert len(loaded) == 1 and loaded[0].context == CPU
    np.testing.assert_array_equal(loaded[0].asnumpy(), x)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_reference(max_norm):
    arrays = [_r(7, 4, 5), _r(8, 9), _r(9, 2, 3, 2)]
    ref = [rmx.nd.array(a) for a in arrays]
    port = [nd.array(a, ctx=CPU) for a in arrays]
    rn = rmx.gluon.utils.clip_global_norm(ref, max_norm)
    pn = utils.clip_global_norm(port, max_norm)
    assert isinstance(pn, float) and pn == pytest.approx(rn, rel=TOL)
    for p, r in zip(port, ref):
        _close(p, r.asnumpy())
    if max_norm > pn:
        for p, a in zip(port, arrays):
            np.testing.assert_array_equal(p.asnumpy(), a)


def test_clip_global_norm_refuses_a_non_finite_norm():
    a = _r(7, 4, 5)
    a[1, 2] = np.nan
    port = [nd.array(a, ctx=CPU)]
    with pytest.raises(MXNetError):
        utils.clip_global_norm(port, 1.0)
    np.testing.assert_array_equal(port[0].asnumpy(), a)
    assert np.isnan(utils.clip_global_norm(port, 1.0,
                                           check_isfinite=False))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_clip_global_norm_is_exact_over_a_large_table(dtype):
    """Over a gradient of BERT-base's word-embedding size (30522 x 768)
    and a bias, the norm is that of the fp32 values (the reference's
    cast) to 1e-12, and the rescale leaves each array at its value times
    max_norm / norm to within the array dtype's rounding."""
    r = np.random.RandomState(0)
    arrays = [(r.randn(30522, 768) * 1e-2).astype(dtype),
              r.randn(768).astype(dtype)]
    exact = math.sqrt(sum(float(np.square(a.astype("float32")
                                          .astype("float64")).sum())
                          for a in arrays))
    port = [nd.array(a, ctx=CPU, dtype=dtype) for a in arrays]
    got = utils.clip_global_norm(port, 1.0)
    assert abs(got - exact) <= 1e-12 * exact
    eps = np.finfo(dtype).eps
    for p, a in zip(port, arrays):
        np.testing.assert_allclose(p.asnumpy(), a * (1.0 / (got + 1e-8)),
                                   rtol=2 * eps, atol=0)


def test_check_sha1_and_download(tmp_path):
    f = tmp_path / "blob.bin"
    f.write_bytes(b"mxnet" * 1000)
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert utils.check_sha1(str(f), digest)
    assert not utils.check_sha1(str(f), "0" * 40)
    with pytest.raises(MXNetError):
        utils.download("http://localhost/none")
