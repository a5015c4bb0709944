"""``mx.sym`` and the Executor of the port against the reference's, on the
CPU: the same symbols built in both packages give the same JSON (as
parsed objects, ``attrs.framework`` apart), the same argument, aux and
output lists, shapes and types; a file written by either loads in the
other; the Executor's forward and backward under each ``grad_req`` agree
within 1e-5 on seed-made inputs."""
import json

import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


def mlp(sym):
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=3, name="fc2")
    return sym.SoftmaxOutput(net, sym.var("softmax_label"), name="softmax",
                             normalization="batch")


def conv_bn(sym):
    data = sym.var("data")
    net = sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                          name="conv")
    net = sym.BatchNorm(net, fix_gamma=False, name="bn")
    net = sym.Activation(net, act_type="relu", name="act")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool")
    net = sym.Flatten(net, name="flat")
    return sym.FullyConnected(net, num_hidden=5, name="fc")


def grouped(sym):
    a = sym.var("a")
    b = sym.var("b")
    return sym.Group([sym.broadcast_mul(a, b, name="mul"),
                      sym.broadcast_add(a, b, name="add"),
                      sym.split(a, num_outputs=2, axis=1, name="split")])


def composed(sym):
    data = sym.var("data")
    net1 = sym.FullyConnected(data, num_hidden=4, name="fc1")
    pre = sym.Activation(sym.var("data2"), act_type="tanh", name="pre")
    return net1(data=pre)


BUILDERS = {"mlp": (mlp, {"data": (4, 6), "softmax_label": (4,)}),
            "conv_bn": (conv_bn, {"data": (2, 3, 8, 8)}),
            "grouped": (grouped, {"a": (2, 6), "b": (2, 6)}),
            "composed": (composed, {"data2": (3, 5)})}


def _parsed(js):
    out = json.loads(js)
    out["attrs"].pop("framework")
    return out


@pytest.mark.parametrize("case", sorted(BUILDERS))
def test_json_and_lists_match_the_reference(case):
    build, shapes = BUILDERS[case]
    r, p = build(rmx.sym), build(mx.sym)
    assert _parsed(p.tojson()) == _parsed(r.tojson())
    assert json.loads(p.tojson())["attrs"]["framework"] == \
        ["str", "mxnet_tpu_torch"]
    assert p.list_arguments() == r.list_arguments()
    assert p.list_auxiliary_states() == r.list_auxiliary_states()
    assert p.list_outputs() == r.list_outputs()
    assert p.list_inputs() == r.list_inputs()
    assert p.infer_shape(**shapes) == r.infer_shape(**shapes)
    assert p.infer_shape_partial(**shapes) == r.infer_shape_partial(**shapes)
    assert p.infer_type() == r.infer_type()
    assert [s.list_outputs() for s in p.get_internals()] == \
        [s.list_outputs() for s in r.get_internals()]


@pytest.mark.parametrize("case", sorted(BUILDERS))
def test_files_cross_both_ways(case, tmp_path):
    build, _ = BUILDERS[case]
    r, p = build(rmx.sym), build(mx.sym)
    r.save(str(tmp_path / "r.json"))
    p.save(str(tmp_path / "p.json"))
    from_r = mx.sym.load(str(tmp_path / "r.json"))
    from_p = rmx.sym.load(str(tmp_path / "p.json"))
    assert _parsed(from_r.tojson()) == _parsed(r.tojson())
    assert _parsed(from_p.tojson()) == _parsed(p.tojson())


def _feed(sym, shapes, seed):
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: rs.randn(*s).astype("f")
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    if "softmax_label" in args:
        args["softmax_label"] = rs.randint(0, 3, args["softmax_label"].shape
                                           ).astype("f")
    aux = {n: (rs.rand(*s) + 0.5).astype("f")
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind(pkg, sym, args, aux, grad_req):
    ctx = CPU if pkg is mx else rmx.cpu()

    def arr(v):
        return pkg.nd.array(v, ctx=ctx)

    grads = {n: arr(np.zeros_like(v)) for n, v in args.items()}
    return sym.bind(ctx, args={n: arr(v) for n, v in args.items()},
                    args_grad=grads, grad_req=grad_req,
                    aux_states={n: arr(v) for n, v in aux.items()})


@pytest.mark.parametrize("grad_req", ["write", "add", "null"])
@pytest.mark.parametrize("case", ["mlp", "conv_bn", "composed"])
def test_executor_forward_backward_match_the_reference(case, grad_req):
    """Two training forwards and backwards (head gradients from a seed),
    then an inference forward: outputs, every gradient buffer and the aux
    states within 1e-5 of the reference's."""
    build, shapes = BUILDERS[case]
    r, p = build(rmx.sym), build(mx.sym)
    args, aux = _feed(p, shapes, seed=3)
    rex = _bind(rmx, r, args, aux, grad_req)
    pex = _bind(mx, p, args, aux, grad_req)
    rs = np.random.RandomState(4)
    for _ in range(2):
        ro = rex.forward(is_train=True)
        po = pex.forward(is_train=True)
        for a, b in zip(ro, po):
            np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=0,
                                       atol=TOL)
        heads = [rs.randn(*o.shape).astype("f") for o in po]
        rex.backward([rmx.nd.array(h) for h in heads])
        pex.backward([mx.nd.array(h, ctx=CPU) for h in heads])
    for n in p.list_arguments():
        np.testing.assert_allclose(pex.grad_dict[n].asnumpy(),
                                   rex.grad_dict[n].asnumpy(), rtol=0,
                                   atol=TOL, err_msg=n)
        if grad_req == "null":
            assert not pex.grad_dict[n].asnumpy().any(), n
    for n in p.list_auxiliary_states():
        np.testing.assert_allclose(pex.aux_dict[n].asnumpy(),
                                   rex.aux_dict[n].asnumpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
    for a, b in zip(rex.forward(), pex.forward()):
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=0, atol=TOL)
    assert list(pex.output_dict) == list(rex.output_dict)


def test_grad_req_add_accumulates():
    a = mx.sym.var("a")
    c = a * 3.0
    ex = c.bind(CPU, {"a": mx.nd.array([1.0, 2.0], ctx=CPU)},
                args_grad={"a": mx.nd.zeros((2,), ctx=CPU)}, grad_req="add")
    for _ in range(2):
        ex.forward(is_train=True)
        ex.backward(mx.nd.ones((2,), ctx=CPU))
    np.testing.assert_array_equal(ex.grad_dict["a"].asnumpy(), 6.0)


def test_simple_bind_softmax_training_matches_the_reference():
    r, p = mlp(rmx.sym), mlp(mx.sym)
    rex = r.simple_bind(rmx.cpu(), data=(4, 6), softmax_label=(4,))
    pex = p.simple_bind(CPU, data=(4, 6), softmax_label=(4,))
    rs = np.random.RandomState(0)
    for n in ("fc1_weight", "fc2_weight", "fc1_bias", "fc2_bias"):
        v = rs.randn(*pex.arg_dict[n].shape).astype("f")
        rex.arg_dict[n][:] = rmx.nd.array(v)
        pex.arg_dict[n][:] = mx.nd.array(v, ctx=CPU)
    x = rs.randn(4, 6).astype("f")
    y = np.array([0, 1, 2, 0], dtype="f")
    rex.forward(is_train=True, data=x, softmax_label=y)
    pex.forward(is_train=True, data=x, softmax_label=y)
    probs = pex.outputs[0].asnumpy()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs, rex.outputs[0].asnumpy(), atol=TOL)
    rex.backward()
    pex.backward()
    for n in ("fc1_weight", "fc2_weight", "fc1_bias", "fc2_bias"):
        np.testing.assert_allclose(pex.grad_dict[n].asnumpy(),
                                   rex.grad_dict[n].asnumpy(), atol=TOL)
    re2, pe2 = rex.reshape(data=(2, 6), softmax_label=(2,)), \
        pex.reshape(data=(2, 6), softmax_label=(2,))
    assert pe2.arg_dict["data"].shape == re2.arg_dict["data"].shape == (2, 6)
    np.testing.assert_array_equal(pe2.arg_dict["fc1_weight"].asnumpy(),
                                  pex.arg_dict["fc1_weight"].asnumpy())


def test_list_arguments_and_auto_params():
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
    assert fc.list_arguments() == ["data", "fc_weight", "fc_bias"]
    assert fc.list_outputs() == ["fc_output"]
    fc = mx.sym.FullyConnected(data, num_hidden=4, no_bias=True, name="fc")
    assert fc.list_arguments() == ["data", "fc_weight"]
    bn = mx.sym.BatchNorm(data, name="bn")
    assert bn.list_arguments() == ["data", "bn_gamma", "bn_beta"]
    assert bn.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]


def test_aux_classified_by_graph_position_not_name():
    x = mx.sym.var("data")
    w = mx.sym.var("decoy_running_mean")
    h = mx.sym.FullyConnected(x, w, num_hidden=4, no_bias=True, name="fc")
    out = mx.sym.BatchNorm(h, mx.sym.var("g"), mx.sym.var("b"),
                           mx.sym.var("stat_a"), mx.sym.var("stat_b"),
                           name="bn")
    assert "decoy_running_mean" in out.list_arguments()
    assert out.list_auxiliary_states() == ["stat_a", "stat_b"]


def test_get_internals_and_children():
    data = mx.sym.var("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=4, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    feat = act.get_internals()["fc1_output"]
    assert feat.list_arguments() == ["data", "fc1_weight", "fc1_bias"]
    assert act.get_children().list_outputs() == ["fc1_output"]


def _meta_refusing(sym):
    x = sym.var("x")
    return sym.Group([sym.Dropout(x, p=0.5, name="drop"),
                      sym.random_uniform(shape=(3, 2), name="u"),
                      sym.shuffle(x, name="sh"),
                      sym.flash_attention(x, x, x, name="fa"),
                      sym.CTCLoss(sym.var("acts"), sym.var("labels"),
                                  name="ctc")])


def test_infer_shape_of_ops_that_refuse_meta_tensors():
    """The ops with no meta kernel (CTC) or a draw from a generator get
    their shapes from a CPU run on zeros, the attention from its rule,
    as the reference's eval_shape gives them, and the port's generator is
    left as it was; the ops whose shape depends on their values raise in
    both packages."""
    shapes = dict(x=(2, 2, 4, 8), acts=(5, 2, 4), labels=(2, 3))
    state = mx.random.get_state()
    got = _meta_refusing(mx.sym).infer_shape(**shapes)
    assert got == _meta_refusing(rmx.sym).infer_shape(**shapes)
    assert got[1] == [(2, 2, 4, 8), (3, 2), (2, 2, 4, 8), (2, 2, 4, 8), (2,)]
    assert mx.random.get_state() == state
    for pkg in (mx, rmx):
        s = pkg.sym
        for masked in (s.boolean_mask(s.var("x"), s.var("m"), name="bm"),
                       s.where_index(s.var("x"), name="wi")):
            with pytest.raises(pkg.MXNetError):
                masked.infer_shape(x=(4, 3), m=(4,))


def test_constant_loads_and_evaluates(tmp_path):
    c = mx.sym.constant(np.arange(6, dtype="int32").reshape(2, 3),
                        name="c")
    s = mx.sym.broadcast_add(mx.sym.var("x"), mx.sym.Cast(c, dtype="float32"),
                             name="add")
    path = str(tmp_path / "c.json")
    s.save(path)
    loaded = mx.sym.load(path)
    out = loaded.bind(CPU, {"x": mx.nd.ones((2, 3), ctx=CPU)}).forward()[0]
    np.testing.assert_array_equal(out.asnumpy(), np.arange(6).reshape(2, 3)
                                  + 1)


def test_concatenate_matches_the_reference():
    rs = np.random.RandomState(0)
    parts = [rs.randn(n, 3).astype("f") for n in (2, 1, 4)]
    got = mx.nd.concatenate([mx.nd.array(a, ctx=CPU) for a in parts])
    want = rmx.nd.concatenate([rmx.nd.array(a) for a in parts])
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    got = mx.nd.concatenate([mx.nd.array(a.T, ctx=CPU) for a in parts],
                            axis=1, always_copy=False)
    want = rmx.nd.concatenate([rmx.nd.array(a.T) for a in parts], axis=1)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_entry_points_default_to_the_card():
    if mx.num_gpus():
        pytest.skip("a card is present")
    s = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2, name="fc")
    with pytest.raises(mx.MXNetError):
        s.simple_bind(data=(2, 3))
