"""``mx.kv`` of the port held against the reference's ``kvstore`` on the
CPU.

Single process: every case of ``tests/test_kvstore.py`` runs through both
packages on the same numpy inputs (``CASES``), and the port's results
must equal the reference's (the sums are of at most 3 fp32 values, the
updates one SGD step: exact; the 2-bit and int8 round trips: exact); the
convergence case runs on the port with the reference's own assertion.
All eleven of the reference's type strings create the store class the
reference registers, with its ``type``, ``rank`` and ``num_workers``.
Optimizer-state files cross the packages both ways (plain, ``MXKVOPT1``
bundle with host row-sparse state, the legacy bundled dict).

Two processes (``tests/torch_dist_pool.py``, gloo): a multi-key
``dist_sync`` / ``dist_device_sync`` push (two keys in one bucket, one
past ``MXNET_KVSTORE_BIGARRAY_BOUND``) pulls the sum of both ranks'
values within 1e-6; with 2-bit compression the reference's
``TwoBitCompression.round_trip`` of that sum, exactly; with int8 the sum
of the reference's ``_int8_quantize`` round trips of each rank's value,
within 1e-6.  ``Trainer`` over ``dist_sync`` with and without
``update_on_kvstore`` (SGD with momentum, Adam) on each rank's half of
the batch equals the reference's Trainer on the whole batch after 3
steps within 1e-5 of the magnitude (sums in another order).
"""
import pickle

import numpy as np
import pytest

import mxnet_tpu as rmx
from mxnet_tpu import kvstore as rkv
from mxnet_tpu.ndarray.sparse import row_sparse_array as r_rsp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kvstore as pkv
from mxnet_tpu_torch.ndarray.sparse import row_sparse_array as p_rsp

from torch_dist_pool import DistPool

CPU = mx.cpu()
TYPES = ("local", "device", "nccl", "local_allreduce_cpu",
         "local_allreduce_device", "dist_sync", "dist_device_sync",
         "dist_async", "dist_tpu_sync", "dist_sync_device", "dist")


class Pkg:
    """One package's surface, so that a case runs through either."""

    def __init__(self, name):
        self.name = name
        if name == "reference":
            self.mx, self.kv, self.rsp = rmx, rkv, r_rsp
            self.ctx = {}
        else:
            self.mx, self.kv, self.rsp = mx, pkv, p_rsp
            self.ctx = {"ctx": CPU}

    def arr(self, a, **kw):
        return self.mx.nd.array(np.asarray(a, "f"), **self.ctx, **kw)

    def zeros(self, shape):
        return self.mx.nd.zeros(shape, **self.ctx)

    def sgd(self, **kw):
        return self.mx.optimizer.create("sgd", **kw)


@pytest.fixture(scope="module", autouse=True)
def _no_eager_jit():
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


def case_init_pull(P):
    kv = P.kv.create("local")
    kv.init("3", P.arr(np.ones((2, 3))))
    out = P.zeros((2, 3))
    kv.pull("3", out=out)
    return [out.asnumpy()]


def case_push_aggregates(P):
    kv = P.kv.create("device")
    kv.init("k", P.zeros((2, 2)))
    kv.push("k", [P.arr(np.full((2, 2), v)) for v in (1, 2, 3)])
    out = P.zeros((2, 2))
    kv.pull("k", out=out)
    return [out.asnumpy()]


def case_multiple_keys(P):
    kv = P.kv.create("local")
    kv.init(["a", "b"], [P.zeros((2,)), P.arr(np.ones(3))])
    kv.push(["a", "b"], [P.arr(np.ones(2)), P.arr(np.ones(3))])
    oa, ob = P.zeros((2,)), P.zeros((3,))
    kv.pull(["a", "b"], out=[oa, ob])
    return [oa.asnumpy(), ob.asnumpy()]


def case_pushpull(P):
    kv = P.kv.create("local")
    kv.init("x", P.zeros((4,)))
    v = P.arr(np.ones(4))
    kv.pushpull("x", v)
    return [v.asnumpy()]


def case_update_on_kvstore(P):
    kv = P.kv.create("local")
    kv.init(0, P.arr(np.ones((2, 2))))
    kv.set_optimizer(P.mx.optimizer.SGD(learning_rate=0.5))
    kv.push(0, [P.arr(np.ones((2, 2)))])
    out = P.zeros((2, 2))
    kv.pull(0, out=out)
    return [out.asnumpy()]


def case_row_sparse_pull(P):
    kv = P.kv.create("local")
    kv.init("emb", P.arr(np.arange(12.).reshape(4, 3)))
    out = P.zeros((2, 3))
    kv.row_sparse_pull("emb", out=out, row_ids=P.arr([1, 3]))
    return [out.asnumpy()]


def case_gradient_compression(P):
    kv = P.kv.create("local")
    kv.init("g", P.zeros((4,)))
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    outs = []
    for _ in range(2):      # the second push carries the residual
        kv.push("g", [P.arr([1.0, -1.0, 0.3, 0.0])])
        out = P.zeros((4,))
        kv.pull("g", out=out)
        outs.append(out.asnumpy())
    return outs


def case_dist_single_process(P):
    kv = P.kv.create("dist_tpu_sync")
    kv.init("w", P.arr(np.ones(2)))
    kv.push("w", [P.arr(np.ones(2))])
    out = P.zeros((2,))
    kv.pull("w", out=out)
    return [out.asnumpy(), np.asarray([kv.num_workers, kv.rank])]


def case_int8_local(P):
    kv = P.kv.create("local")
    kv.init("g8", P.zeros((6,)))
    kv.set_gradient_compression({"type": "int8"})
    kv.push("g8", [P.arr([1.0, -0.5, 0.25, 0.0, 0.77, -1.0])])
    out = P.zeros((6,))
    kv.pull("g8", out=out)
    return [out.asnumpy()]


def case_int8_round_trip_bf16(P):
    kv = P.kv.create("local")
    kv.set_gradient_compression({"type": "int8"})
    g = P.mx.nd.array(np.ones((3,)) * 0.7, dtype="bfloat16", **P.ctx)
    rt = kv._compression.round_trip(g)
    return [np.asarray(rt.asnumpy(), "f"), np.asarray([str(rt.dtype)
                                                       .endswith("bfloat16")])]


def case_mixed_dense_push_row_sparse_pull(P):
    kv = P.kv.create("local")
    kv.set_optimizer(P.mx.optimizer.SGD(learning_rate=0.5))
    kv.init("w", P.arr(np.arange(12.0).reshape(4, 3)))
    outs = []
    for _ in range(3):
        kv.push("w", [P.arr(np.ones((4, 3)))])
        out = P.zeros((2, 3))
        kv.row_sparse_pull("w", out=out, row_ids=P.arr([0, 2]))
        outs.append(out.asnumpy())
    assert not isinstance(kv._store["w"], P.kv._HostRowSparseTable)
    return outs


def case_sparse_push_history_survives_demote(P):
    kv = P.kv.create("local")
    kv.set_optimizer(P.sgd(learning_rate=0.5))
    kv.init("e", P.zeros((6, 2)))
    out = P.zeros((1, 2))
    kv.row_sparse_pull("e", out=out, row_ids=P.arr([1]))
    assert isinstance(kv._store["e"], P.kv._HostRowSparseTable)
    kv.push("e", [P.arr(np.ones((6, 2)))])
    assert not isinstance(kv._store["e"], P.kv._HostRowSparseTable)
    kv.push("e", P.rsp((np.ones((2, 2), "f"), [1, 4]), shape=(6, 2),
                       **P.ctx))
    host = kv._store["e"]
    assert isinstance(host, P.kv._HostRowSparseTable)
    assert host.sparse_pushes >= 1
    kv.push("e", [P.arr(np.ones((6, 2)))])
    assert kv._store["e"] is host
    kv.row_sparse_pull("e", out=out, row_ids=P.arr([1]))
    return [out.asnumpy(), host.table.copy()]


CASES = [case_init_pull, case_push_aggregates, case_multiple_keys,
         case_pushpull, case_update_on_kvstore, case_row_sparse_pull,
         case_gradient_compression, case_dist_single_process,
         case_int8_local, case_int8_round_trip_bf16,
         case_mixed_dense_push_row_sparse_pull,
         case_sparse_push_history_survives_demote]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_single_process_case_matches_the_reference(case):
    want = case(Pkg("reference"))
    got = case(Pkg("port"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_type_strings_make_the_reference_classes():
    for t in TYPES:
        ref, port = rkv.create(t), mx.kv.create(t)
        assert type(port).__name__ == type(ref).__name__, t
        assert (port.type, port.rank, port.num_workers) == \
            (ref.type, ref.rank, ref.num_workers) == (t, 0, 1)
    with pytest.raises(mx.MXNetError):
        mx.kv.create("nope")


def test_gradient_compression_training_converges():
    """The reference's case on the port: 2-bit-compressed training still
    converges (the error-feedback residual keeps the signal)."""
    from mxnet_tpu_torch import autograd, gluon

    rs = np.random.RandomState(7)
    X = rs.randn(64, 4).astype("f")
    Y = X @ np.array([[1.5], [-2.0], [0.5], [3.0]], "f")
    net = gluon.nn.Dense(1, use_bias=False, in_units=4)
    net.initialize(mx.init.Zero(), ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01}, kvstore="device",
                            compression_params={"type": "2bit",
                                                "threshold": 0.5})
    losses = []
    x, y = mx.nd.array(X, ctx=CPU), mx.nd.array(Y, ctx=CPU)
    for _ in range(400):
        with autograd.record():
            loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])
    assert all(np.isfinite(v) for v in losses)


def _sparse_kv(P):
    kv = P.kv.create("local")
    kv.set_optimizer(P.sgd(learning_rate=0.5, momentum=0.9))
    kv.init("w", P.zeros((4, 2)))
    kv.push("w", [P.arr(np.ones((4, 2)))])
    return kv


@pytest.mark.parametrize("src,dst", [("port", "reference"),
                                     ("reference", "port")])
def test_optimizer_state_files_cross_the_packages(src, dst, tmp_path):
    S, D = Pkg(src), Pkg(dst)
    plain, bundled = str(tmp_path / "p.st"), str(tmp_path / "b.st")
    kv = _sparse_kv(S)
    kv.save_optimizer_states(plain)
    kv.push("w", S.rsp((np.ones((1, 2), "f"), [2]), shape=(4, 2), **S.ctx))
    kv.save_optimizer_states(bundled)
    with open(plain, "rb") as f:
        assert not f.read().startswith(b"MXKVOPT1")
    with open(bundled, "rb") as f:
        assert f.read().startswith(b"MXKVOPT1")
    # the legacy bundled layout: a bare pickled dict with a marker key
    legacy = str(tmp_path / "l.st")
    host = {k: v.state for k, v in kv._store.items()
            if hasattr(v, "state") and v.state is not None}
    with open(legacy, "wb") as f:
        f.write(pickle.dumps({"__kv_host_states__": host,
                              "updater": kv._updater.get_states(False)}))
    for fname in (plain, bundled, legacy):
        kv2 = D.kv.create("local")
        kv2.set_optimizer(D.sgd(learning_rate=0.5, momentum=0.9))
        kv2.init("w", D.zeros((4, 2)))
        kv2.load_optimizer_states(fname)
        if fname == plain:
            mom = kv2._updater.states["w"] if "w" in kv2._updater.states \
                else kv2._updater.states[list(kv2._updater.states)[0]]
            np.testing.assert_array_equal(np.asarray(mom.asnumpy()),
                                          np.full((4, 2), -0.5, "f"))
        else:
            (state,) = kv2._pending_host_state.values()
            np.testing.assert_array_equal(np.asarray(state[0][0]),
                                          np.asarray(host["w"][0][0]))


# -- two processes --------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def pool(tmp_path_factory):
    # autouse: the ranks start with the module and import the port while
    # the single-process cases run
    p = DistPool(2, tmp_path_factory.mktemp("kv"))
    yield p
    p.close()


def _two_bit(total):
    comp = rkv.TwoBitCompression(0.5)
    return np.asarray(comp.round_trip(rmx.nd.array(total), key="k")._get())


def _int8_sum(per_rank):
    import jax.numpy as jnp

    from mxnet_tpu.parallel.collectives import _int8_quantize

    total = 0.0
    for v in per_rank:
        q, s = _int8_quantize(jnp.asarray(v))
        total = total + np.asarray(q, np.float32) * float(s)
    return total


@pytest.mark.parametrize("kind", ["dist_sync", "dist_device_sync"])
@pytest.mark.parametrize("compression", [None, "2bit", "int8"])
def test_dist_push_pull_sums_over_processes(pool, kind, compression):
    rs = np.random.RandomState(11)
    values = {"a": rs.randn(2, 5).astype("f"),
              "b": rs.randn(2, 3, 2).astype("f"),
              "c": rs.randn(2, 40).astype("f")}
    comp = None if compression is None else \
        {"type": compression, "threshold": 0.5}
    got = pool.run("t_kv_dist", kind, comp, values, 20)
    for g in got:
        assert (g["rank"], g["num_workers"]) in ((0, 2), (1, 2))
        for k, v in values.items():
            if compression is None:
                want = v.sum(0)
                np.testing.assert_allclose(g["out"][k], want, atol=1e-6)
            elif compression == "2bit":
                np.testing.assert_array_equal(g["out"][k], _two_bit(v.sum(0)))
            else:
                np.testing.assert_allclose(g["out"][k], _int8_sum(list(v)),
                                           atol=1e-6)
    issued = got[0]["issued"]
    assert issued == got[1]["issued"]
    # a and b ride one bucket, c (past the bound) its own collective
    assert issued == ({"allreduce_q8_multi": 1, "allreduce_q8": 1,
                       "barrier": 1} if compression == "int8" else
                      {"allreduce": 2, "barrier": 1})


def _ref_mlp():
    net = rmx.gluon.nn.HybridSequential()
    net.add(rmx.gluon.nn.Dense(16, activation="relu"), rmx.gluon.nn.Dense(4))
    net.initialize()
    net(rmx.nd.zeros((1, 8)))
    return net


def _ref_train(net, data, optimizer, opt_args, kvstore="device",
               update_on_kvstore=None, trainer=None):
    trainer = trainer or rmx.gluon.Trainer(
        net.collect_params(), optimizer, dict(opt_args), kvstore=kvstore,
        update_on_kvstore=update_on_kvstore)
    for x, y in data:
        with rmx.autograd.record():
            loss = ((net(rmx.nd.array(x)) - rmx.nd.array(y)) ** 2).sum(axis=1)
        loss.backward()
        trainer.step(x.shape[0])
    return [p.data().asnumpy() for p in net.collect_params().values()], \
        trainer


def _data(seed, steps=3, batch=8):
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, 8).astype("f"), rs.randn(batch, 4).astype("f"))
            for _ in range(steps)]


def _close(got, want, tol=1e-5):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(
            1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("optimizer,opt_args,update_on_kvstore", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, True),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, False),
    ("adam", {"learning_rate": 0.01}, True)])
def test_trainer_over_dist_sync_matches_the_whole_batch(
        pool, optimizer, opt_args, update_on_kvstore):
    net = _ref_mlp()
    weights = {k: p.data().asnumpy() for k, p in
               net.collect_params().items()}
    data = _data(12)
    want, _ = _ref_train(net, data, optimizer, opt_args,
                         update_on_kvstore=update_on_kvstore)
    got = pool.run("t_mlp_trainer", weights, data, "dist_sync", optimizer,
                   opt_args, update_on_kvstore, 3, False)
    for g in got:
        _close(g["params"], want)
    assert all(np.array_equal(a, b) for a, b in
               zip(got[0]["params"], got[1]["params"]))
