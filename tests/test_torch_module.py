"""``mx.mod`` of the port against the reference's on the CPU: SGD-momentum
steps of a ``Module`` within 1e-5 of the reference's on the same seed-made
batches and weights; checkpoints that cross both ways (the next step's
loss within 1e-5); ``predict``, ``score``, ``get_input_grads``, a
two-bucket ``BucketingModule``, ``fit`` with ``callback.do_checkpoint``,
``install_monitor``, and ``ImageRecordIter`` feeding ``Module.fit``."""
import logging

import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx

CPU = mx.cpu()
TOL = 1e-5
BATCH, DIM, CLASSES = 8, 6, 3


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


def mlp(sym):
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=CLASSES, name="fc2")
    return sym.SoftmaxOutput(net, sym.var("softmax_label"), name="softmax",
                             normalization="batch")


def convnet(sym):
    data = sym.var("data")
    net = sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                          name="conv")
    net = sym.BatchNorm(net, fix_gamma=False, name="bn")
    net = sym.Activation(net, act_type="relu", name="act")
    net = sym.Flatten(net, name="flat")
    net = sym.FullyConnected(net, num_hidden=CLASSES, name="fc")
    return sym.SoftmaxOutput(net, sym.var("softmax_label"), name="softmax",
                             normalization="batch")


NETS = {"mlp": (mlp, (BATCH, DIM)), "convnet": (convnet, (BATCH, 2, 6, 6))}


def _weights(sym, data_shape, seed):
    rs = np.random.RandomState(seed)
    shapes, _, aux_shapes = sym.infer_shape(data=data_shape,
                                            softmax_label=(data_shape[0],))
    arg = {n: (rs.randn(*s) * 0.3).astype("f")
           for n, s in zip(sym.list_arguments(), shapes)
           if n not in ("data", "softmax_label")}
    aux = {n: (rs.rand(*s) + 0.5).astype("f")
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return arg, aux


def _batches(data_shape, n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*data_shape).astype("f"),
             rs.randint(0, CLASSES, data_shape[0]).astype("f"))
            for _ in range(n)]


def _module(pkg, build, data_shape, arg, aux, **kw):
    ctx = CPU if pkg is mx else pkg.cpu()
    mod = pkg.mod.Module(build(pkg.sym), context=ctx)
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", (data_shape[0],))], **kw)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in arg.items()},
                    aux_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-3)))
    return mod


def _batch(pkg, x, y):
    ctx = CPU if pkg is mx else pkg.cpu()
    return pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=ctx)],
                            label=[pkg.nd.array(y, ctx=ctx)])


def _step(pkg, mod, x, y):
    """One step; returns the batch's cross-entropy from the outputs."""
    mod.forward_backward(_batch(pkg, x, y))
    probs = mod.get_outputs()[0].asnumpy()
    mod.update()
    return float(-np.log(probs[np.arange(len(y)), y.astype(int)]).mean())


def _params_close(got, want, atol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", sorted(NETS))
def test_three_sgd_momentum_steps_match_the_reference(case):
    build, shape = NETS[case]
    arg, aux = _weights(build(mx.sym), shape, seed=1)
    pm = _module(mx, build, shape, arg, aux)
    rm = _module(rmx, build, shape, arg, aux)
    for x, y in _batches(shape, 3, seed=2):
        assert abs(_step(mx, pm, x, y) - _step(rmx, rm, x, y)) < TOL
    for got, want in zip(pm.get_params(), rm.get_params()):
        _params_close(got, want)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_both_ways(writer, tmp_path):
    """A checkpoint (symbol, params, optimizer states) written after two
    steps by one package resumes in the other's Module.load: the next
    step's loss and weights within 1e-5 of the writer's own next step."""
    build, shape = NETS["convnet"]
    arg, aux = _weights(build(mx.sym), shape, seed=3)
    pkgs = (mx, rmx) if writer == "port" else (rmx, mx)
    src, dst = pkgs
    mod = _module(src, build, shape, arg, aux)
    batches = _batches(shape, 3, seed=4)
    for x, y in batches[:2]:
        _step(src, mod, x, y)
    prefix = str(tmp_path / "ckpt")
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
    ctx = CPU if dst is mx else dst.cpu()
    resumed = dst.mod.Module.load(prefix, 2, load_optimizer_states=True,
                                  context=ctx)
    resumed.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (shape[0],))])
    resumed.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-3)))
    x, y = batches[2]
    assert abs(_step(dst, resumed, x, y) - _step(src, mod, x, y)) < TOL
    for got, want in zip(resumed.get_params(), mod.get_params()):
        _params_close(got, want)


def test_predict_score_and_input_grads_match_the_reference():
    build, shape = NETS["mlp"]
    arg, aux = _weights(build(mx.sym), shape, seed=5)
    rs = np.random.RandomState(6)
    x = rs.randn(20, DIM).astype("f")
    y = rs.randint(0, CLASSES, 20).astype("f")
    outs = {}
    for pkg in (mx, rmx):
        ctx = CPU if pkg is mx else pkg.cpu()
        with ctx:
            it = pkg.io.NDArrayIter(x, y, batch_size=BATCH,
                                    label_name="softmax_label")
        mod = _module(pkg, build, shape, arg, aux, inputs_need_grad=True)
        pred = mod.predict(it)
        score = dict(mod.score(it, "acc"))
        mod.forward(_batch(pkg, x[:BATCH], y[:BATCH]), is_train=True)
        mod.backward()
        outs[pkg] = (pred.asnumpy(), score, mod.get_input_grads()[0].asnumpy())
    (pp, ps, pg), (rp, rsc, rg) = outs[mx], outs[rmx]
    assert pp.shape == rp.shape == (20, CLASSES)
    np.testing.assert_allclose(pp, rp, rtol=0, atol=TOL)
    assert ps == rsc
    np.testing.assert_allclose(pg, rg, rtol=0, atol=TOL)


def _bucket_gen(sym):
    def gen(seq_len):
        data = sym.var("data")
        pooled = sym.sum(data, axis=1, keepdims=True, name="pool")
        net = sym.FullyConnected(pooled, num_hidden=4, name="fc")
        out = sym.SoftmaxOutput(net, sym.var("softmax_label"),
                                name="softmax")
        return out, ("data",), ("softmax_label",)
    return gen


def test_two_bucket_module_matches_the_reference():
    rs = np.random.RandomState(7)
    w = (rs.randn(4, 1) * 0.5).astype("f")
    b = np.zeros(4, "f")
    mods = {}
    for pkg in (mx, rmx):
        ctx = CPU if pkg is mx else pkg.cpu()
        mod = pkg.mod.BucketingModule(_bucket_gen(pkg.sym),
                                      default_bucket_key=8, context=ctx)
        mod.bind(data_shapes=[("data", (4, 8))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(arg_params={"fc_weight": pkg.nd.array(w, ctx=ctx),
                                    "fc_bias": pkg.nd.array(b, ctx=ctx)},
                        aux_params={})
        mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),))
        mods[pkg] = mod
    data = np.random.RandomState(8)
    for L in (8, 4, 8, 4):
        x = data.randn(4, L).astype("f")
        y = data.randint(0, 4, 4).astype("f")
        outs = []
        for pkg, mod in mods.items():
            batch = _batch(pkg, x, y)
            batch.bucket_key = L
            batch.provide_data = [("data", (4, L))]
            batch.provide_label = [("softmax_label", (4,))]
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=TOL)
    pm = mods[mx]
    assert sorted(pm._buckets) == [4, 8]
    arg8, _ = pm._buckets[8].get_params()
    arg4, _ = pm._buckets[4].get_params()
    np.testing.assert_array_equal(arg8["fc_weight"].asnumpy(),
                                  arg4["fc_weight"].asnumpy())
    _params_close(arg8, mods[rmx]._buckets[8].get_params()[0])


def test_fit_with_do_checkpoint_and_load_score_equal(tmp_path):
    rs = np.random.RandomState(0)
    centers = rs.randn(CLASSES, DIM) * 3
    y = rs.randint(0, CLASSES, 64)
    x = (centers[y] + rs.randn(64, DIM)).astype("f")
    with CPU:
        it = mx.io.NDArrayIter(x, y.astype("f"), batch_size=16,
                               label_name="softmax_label")
    mx.random.seed(0)
    mod = mx.mod.Module(mlp(mx.sym), context=CPU)
    prefix = str(tmp_path / "fit")
    mod.fit(it, num_epoch=6, optimizer_params=(("learning_rate", 0.5),),
            initializer=mx.init.Xavier(),
            epoch_end_callback=mx.callback.do_checkpoint(prefix, period=3))
    acc = dict(mod.score(it, "acc"))["accuracy"]
    assert acc > 0.9
    loaded = mx.mod.Module.load(prefix, 6, context=CPU)
    loaded.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                for_training=False)
    assert dict(loaded.score(it, "acc"))["accuracy"] == acc
    np.testing.assert_array_equal(loaded.predict(it).asnumpy(),
                                  mod.predict(it).asnumpy())


def test_install_monitor_taps_outputs_and_arguments(capsys):
    build, shape = NETS["mlp"]
    arg, aux = _weights(build(mx.sym), shape, seed=9)
    mod = _module(mx, build, shape, arg, aux)
    mon = mx.mon.Monitor(1, pattern="fc1.*")
    mod.install_monitor(mon)
    mon.tic()
    x, y = _batches(shape, 1, seed=10)[0]
    mod.forward(_batch(mx, x, y), is_train=False)
    rows = mon.toc()
    names = [k for _, k, _ in rows]
    assert names == ["fc1_output", "fc1_weight", "fc1_bias"]
    w = arg["fc1_weight"]
    assert float(rows[1][2].strip("[]")) == pytest.approx(
        np.linalg.norm(w) / np.sqrt(w.size), rel=1e-5)


def test_one_device_and_local_kvstore_only():
    with pytest.raises(mx.MXNetError, match="A6"):
        mx.mod.Module(mlp(mx.sym), context=[CPU, CPU])
    mod = mx.mod.Module(mlp(mx.sym), context=[CPU])
    mod.bind(data_shapes=[("data", (BATCH, DIM))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params()
    # every store of mx.kv binds; without a process group none updates
    # the weights itself (the two-process Module is in
    # tests/test_torch_dist_train.py)
    for kv in ("device", "dist_sync"):
        mod.init_optimizer(kvstore=kv, force_init=True)
        assert mod._kvstore.type == kv and not mod._update_on_kvstore
    mod.init_optimizer(kvstore=None, force_init=True)
    assert mod._kvstore is None


def test_image_record_iter_feeds_module(tmp_path):
    """The port's counterpart of the reference's
    test_native_io.py::test_image_record_iter_feeds_module."""
    rec = str(tmp_path / "data.rec")
    w = mx.recordio.MXRecordIO(rec, "w")
    rng = np.random.RandomState(0)
    for i in range(37):
        img = rng.randint(0, 255, (10, 12, 3)).astype("uint8")
        w.write(mx.recordio.pack_img(mx.recordio.IRHeader(0, float(i % 5), i,
                                                          0), img))
    w.close()
    with CPU:
        it = mx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 8),
                                   batch_size=8, shuffle=True)
    data = mx.sym.var("data")
    net = mx.sym.Flatten(data)
    net = mx.sym.FullyConnected(net, num_hidden=5, name="fc")
    sym = mx.sym.SoftmaxOutput(net, mx.sym.var("softmax_label"),
                               normalization="batch")
    mod = mx.mod.Module(sym, context=CPU, logger=logging)
    mod.fit(it, num_epoch=2, optimizer_params=(("learning_rate", 0.01),))
    assert mod.params_initialized
    arg, _ = mod.get_params()
    assert np.isfinite(arg["fc_weight"].asnumpy()).all()
