"""``TrainStep(mesh=)`` and ``Module`` over a distributed store, held
against the reference's data-parallel mesh on the CPU.

The reference runs ``TrainStep(mesh=make_mesh(devices=devices[:2]))`` on
the whole batch (GSPMD shards it over two virtual devices); the port runs
two spawned gloo processes (``tests/torch_dist_pool.py``), each with
``TrainStep(mesh=make_mesh())`` on its half.  Weights come from the
reference (``load_reference_params``), dropout is 0.

- BERT (``BertForPretraining``, 1 layer, hidden 64) with Adam: the three
  losses within 1e-5 and every parameter within 1e-2 of lr after 3 steps
  (Adam's first steps are about lr times the sign of each gradient entry,
  so the bound is a fraction of lr; ``test_torch_bert.py``'s bound).
- A tiny ResNet (a BasicBlockV1 stage, BatchNorm in it) with SGD and
  momentum: BatchNorm's moments must be the GLOBAL batch's, forward and
  backward, as GSPMD makes them in the reference; losses, parameters and
  running stats within 1e-4 of the magnitude after 3 steps.  The same
  step with per-process moments (the hook turned off) is planted and
  must miss the bound.
- ``Module`` over ``dist_sync`` (one context a process) equals the
  reference's Module on the whole batch within 1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as rmx
from mxnet_tpu.gluon.model_zoo.language import bert as ref_bert
from mxnet_tpu.gluon.model_zoo.vision import resnet as ref_resnet
from mxnet_tpu.parallel import make_mesh as ref_make_mesh
from mxnet_tpu.parallel.data_parallel import TrainStep as RefTrainStep

from torch_dist_pool import DistPool
from torch_threads import one_torch_thread  # noqa: F401

BERT = dict(vocab_size=96, hidden_size=64, num_layers=1, num_heads=4,
            intermediate_size=128, max_position=32, dropout=0.0)
RESNET = dict(layers=[1], channels=[8, 8], classes=10, size=8)
ADAM = {"learning_rate": 1e-3, "epsilon": 1e-6}
SGD = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = DistPool(2, tmp_path_factory.mktemp("dtrain"))
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _no_eager_jit():
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


def _ref_bert_loss(outs, labels):
    import jax
    import jax.numpy as jnp

    mlm, nsp = outs
    logp = jax.nn.log_softmax(mlm, axis=-1)
    mlm_l = -jnp.take_along_axis(logp, labels[:, :-1, None], axis=-1)
    nsp_logp = jax.nn.log_softmax(nsp, axis=-1)
    nsp_l = -jnp.take_along_axis(nsp_logp, labels[:, -1:], axis=-1)
    return jnp.mean(mlm_l) + jnp.mean(nsp_l)


def _ref_ce(logits, labels):
    import jax
    import jax.numpy as jnp

    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, labels[:, None], axis=-1)


def _bert_batches(steps=3, batch=4, seq=16):
    r = np.random.RandomState(31)
    out = []
    for _ in range(steps):
        ids = r.randint(0, BERT["vocab_size"], (batch, seq)).astype("int32")
        labels = np.concatenate(
            [r.randint(0, BERT["vocab_size"], (batch, seq)),
             r.randint(0, 2, (batch, 1))], axis=1).astype("int32")
        out.append((ids, labels))
    return out


def _resnet_batches(steps=3, batch=4):
    r = np.random.RandomState(32)
    return [(r.randn(batch, 3, RESNET["size"], RESNET["size"]).astype("f"),
             r.randint(0, RESNET["classes"], (batch,)).astype("int32"))
            for _ in range(steps)]


def _ref_run(net, loss, batches, optimizer, opt_args):
    import jax

    step = RefTrainStep(net, loss, optimizer=optimizer,
                        optimizer_params=dict(opt_args),
                        mesh=ref_make_mesh(devices=jax.devices()[:2]))
    losses = [float(step(x, y)) for x, y in batches]
    step.write_back()
    return losses, [p.data().asnumpy()
                    for p in net.collect_params().values()]


def _weights(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def test_bert_trainstep_mesh_matches_the_reference_dp2(pool):
    ref = ref_bert.BertForPretraining(ref_bert.BertConfig(**BERT))
    ref.initialize()
    ref(rmx.nd.zeros((1, 16), dtype="int32"))
    r = np.random.RandomState(9)
    for name, p in ref.collect_params().items():
        if name.endswith(("gamma", "beta", "bias")):
            base = 1.0 if name.endswith("gamma") else 0.0
            p.set_data(rmx.nd.array(
                (base + 0.1 * r.randn(*p.shape)).astype("float32")))
    weights = _weights(ref)
    batches = _bert_batches()
    want_losses, want = _ref_run(ref, _ref_bert_loss, batches, "adam", ADAM)
    got = pool.run("t_trainstep_mesh", "bert", BERT, weights, batches,
                   "adam", ADAM)
    for g in got:
        np.testing.assert_allclose(g["losses"], want_losses, rtol=0,
                                   atol=1e-5)
        for a, b in zip(g["params"], want):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-2 * ADAM["learning_rate"])


def _ref_resnet():
    net = ref_resnet.ResNetV1(ref_resnet.BasicBlockV1, RESNET["layers"],
                              RESNET["channels"], classes=RESNET["classes"],
                              thumbnail=True)
    net.initialize(rmx.init.Xavier())
    net(rmx.nd.zeros((1, 3, RESNET["size"], RESNET["size"])))
    r = np.random.RandomState(10)
    for name, p in net.collect_params().items():
        if name.endswith(("gamma", "beta")):
            base = 1.0 if name.endswith("gamma") else 0.0
            p.set_data(rmx.nd.array(
                (base + 0.1 * r.randn(*p.shape)).astype("float32")))
    return net


def _close(got, want, tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(
            1.0, float(np.abs(b).max())))


@pytest.fixture(scope="module")
def resnet_ref():
    """(weights, batches, the reference's losses and parameters): one
    reference run for both cases."""
    prev = rmx.nd.set_eager_jit(False)
    try:
        ref = _ref_resnet()
        weights = _weights(ref)
        batches = _resnet_batches()
        return (weights, batches) + _ref_run(ref, _ref_ce, batches, "sgd",
                                             SGD)
    finally:
        rmx.nd.set_eager_jit(prev)


@pytest.mark.parametrize("planted", [False, True],
                         ids=["global_moments", "planted_local_moments"])
def test_resnet_batchnorm_trainstep_mesh_matches_the_reference_dp2(
        pool, resnet_ref, planted):
    weights, batches, want_losses, want = resnet_ref
    got = pool.run("t_trainstep_mesh", "resnet", RESNET, weights, batches,
                   "sgd", SGD, planted)
    if planted:
        with pytest.raises(AssertionError):
            _close(got[0]["params"], want, 1e-4)
        return
    for g in got:
        np.testing.assert_allclose(g["losses"], want_losses, rtol=0,
                                   atol=1e-4)
        _close(g["params"], want, 1e-4)


def _ref_module(sym, arg, x, y):
    mod = rmx.mod.Module(sym, context=rmx.cpu())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params={k: rmx.nd.array(v) for k, v in arg.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("rescale_grad", 1.0 / x.shape[0])))
    batch = rmx.io.DataBatch([rmx.nd.array(x)], [rmx.nd.array(y)])
    for _ in range(2):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    out, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in out.items()}


def test_module_over_dist_sync_matches_the_whole_batch(pool):
    data = rmx.sym.var("data")
    fc1 = rmx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = rmx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = rmx.sym.FullyConnected(act, num_hidden=3, name="fc2")
    sym = rmx.sym.SoftmaxOutput(fc2, rmx.sym.var("softmax_label"),
                                name="softmax")
    rs = np.random.RandomState(13)
    arg = {"fc1_weight": rs.randn(8, 5).astype("f") * 0.3,
           "fc1_bias": np.zeros(8, "f"),
           "fc2_weight": rs.randn(3, 8).astype("f") * 0.3,
           "fc2_bias": np.zeros(3, "f")}
    x = rs.randn(6, 5).astype("f")
    y = rs.randint(0, 3, (6,)).astype("f")
    want = _ref_module(sym, arg, x, y)
    got = pool.run("t_module", sym.tojson(), arg, x, y, "dist_sync")
    for g in got:
        for k, v in want.items():
            np.testing.assert_allclose(g[k], v, rtol=0, atol=1e-5)


def test_trainstep_mesh_keeps_remat_run_amp_and_write_back(pool,
                                                           resnet_ref):
    """With ``mesh=``, ``remat=True`` and ``run()`` give the step-by-step
    parameters bit for bit (the same arithmetic), write_back lands them
    in the net, and the bf16 AMP step trains (finite, moving losses)."""
    weights, batches, want_losses, _ = resnet_ref
    got = pool.run("t_trainstep_mesh_modes", "resnet", RESNET, weights,
                   batches, "sgd", SGD)
    for g in got:
        base = g["call"]
        np.testing.assert_allclose(base["losses"], want_losses, atol=1e-4)
        for mode in ("remat", "run"):
            assert g[mode]["losses"] == base["losses"], mode
            for a, b in zip(g[mode]["params"], base["params"]):
                np.testing.assert_array_equal(a, b)
        bf = g["bfloat16"]
        assert np.all(np.isfinite(bf["losses"]))
        assert any(not np.array_equal(a, b) for a, b in
                   zip(bf["params"], base["params"]))
