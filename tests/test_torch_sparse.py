"""nd.sparse of the port against the reference (one device).

- row_sparse and csr storage: ``tostype``/``cast_storage`` both ways,
  construction from parts, ``sparse_retain``, ``add_rowsparse`` and the
  dense ops' storage fallback: equal;
- ``nd.dot`` of a CSR and a dense operand (matrix and vector, plain and
  ``transpose_a``, ``out=``, ``@`` and the method) and the gradient it
  sends to the dense operand: within 1e-5 of the reference;
- SGD's lazy row-sparse update (plain, momentum, weight decay, clip,
  ``lazy_update=False``) and the dense fallback of the other optimizers:
  within 1e-6 of the reference through ``Updater``.

The FM example's losses are held in ``test_torch_fm_example.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ndarray import sparse as rsp
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.ndarray import sparse as psp
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()


def _sparse_dense(seed, shape, keep=0.35):
    rng = np.random.RandomState(seed)
    d = rng.randn(*shape).astype("f")
    d[rng.uniform(size=shape) > keep] = 0
    return d


def test_storage_roundtrips_match_reference():
    dense = _sparse_dense(0, (7, 5))
    dense[[1, 4]] = 0
    with CPU:
        for stype in ("csr", "row_sparse"):
            p = mx.nd.array(dense).tostype(stype)
            r = rmx.nd.array(dense).tostype(stype)
            assert p.stype == r.stype == stype
            np.testing.assert_array_equal(p.asnumpy(), r.asnumpy())
            for part in ("data", "indices") + (("indptr",) if stype == "csr"
                                                else ()):
                a, b = getattr(p, part).asnumpy(), getattr(r, part).asnumpy()
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            back = mx.nd.cast_storage(p, "default")
            assert back.stype == "default"
            np.testing.assert_array_equal(back.asnumpy(), dense)
            assert p.tostype(stype) is p
        # the dense ops' storage fallback
        rs = psp.row_sparse_array((np.ones((1, 3), "f"), [1]), shape=(4, 3))
        assert float(mx.nd.sum(rs).asscalar()) == 3.0
        assert (rs + 1).asnumpy().sum() == 15.0
    with pytest.raises(mx.MXNetError):
        psp.csr_matrix(np.ones((2, 2, 2), "f"))


def test_parts_retain_add_match_reference():
    with CPU:
        for pkg in (psp, rsp):
            a = pkg.row_sparse_array((np.arange(6, dtype="f").reshape(3, 2),
                                      [1, 3, 5]), shape=(8, 2))
            b = pkg.row_sparse_array((np.ones((2, 2), "f") * 2, [3, 6]),
                                     shape=(8, 2))
            kept = pkg.retain(a, [1, 5, 7])
            added = pkg.add_rowsparse(a, b)
            c = pkg.csr_matrix((np.array([1.0, 2.0], "f"), [0, 2], [0, 1, 2]),
                               shape=(2, 4))
            z = pkg.zeros("row_sparse", (3, 2))
            out = [kept.indices.asnumpy(), kept.asnumpy(),
                   added.indices.asnumpy(), added.asnumpy(), c.asnumpy(),
                   z.asnumpy(), pkg.zeros("csr", (2, 3)).asnumpy()]
            if pkg is psp:
                got = out
                assert mx.nd.sparse_retain(a, mx.nd.array([3])).indices \
                    .asnumpy().tolist() == [3]
    for g, w in zip(got, out):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("vector", [False, True])
def test_csr_dot_and_gradient_match_reference(transpose_a, vector):
    dense = _sparse_dense(1, (9, 13))
    rows = 9 if transpose_a else 13
    rng = np.random.RandomState(2)
    rhs = rng.randn(rows).astype("f") if vector else \
        rng.randn(rows, 4).astype("f")
    head = rng.randn(*((13 if transpose_a else 9,) +
                       (() if vector else (4,)))).astype("f")
    outs = []
    for m, ag in ((mx, autograd), (rmx, rmx.autograd)):
        with CPU:
            csr = m.nd.array(dense).tostype("csr")
            w = m.nd.array(rhs)
            w.attach_grad()
            with ag.record():
                y = m.nd.dot(csr, w, transpose_a=transpose_a)
                loss = (y * m.nd.array(head)).sum()
            loss.backward()
            outs.append((y.asnumpy(), w.grad.asnumpy()))
    (py, pg), (ry, rg) = outs
    want = (dense.T if transpose_a else dense) @ rhs
    np.testing.assert_allclose(py, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(py, ry, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pg, rg, rtol=1e-5, atol=1e-5)
    assert py.shape == ry.shape


def test_csr_dot_surface():
    dense = np.eye(3, 4, dtype="f")
    with CPU:
        csr = psp.csr_matrix(dense)
        rhs = mx.nd.ones((4, 2))
        for out in (mx.nd.dot(csr, np.ones((4, 2), "f")), csr @ rhs,
                    csr.dot(rhs), psp.dot(csr, rhs)):
            np.testing.assert_array_equal(out.asnumpy(), dense @ np.ones(
                (4, 2)))
        buf = mx.nd.zeros((3, 2))
        assert mx.nd.dot(csr, rhs, out=buf) is buf
        np.testing.assert_array_equal(buf.asnumpy(), dense @ np.ones((4, 2)))
        with pytest.raises(mx.MXNetError):
            mx.nd.dot(csr, mx.nd.ones((5, 2)))
        with pytest.raises(mx.MXNetError):
            psp.dot(csr, rhs, transpose_b=True)
        # a dense dot still goes through the op table
        np.testing.assert_array_equal(
            mx.nd.dot(mx.nd.ones((3, 4)), rhs).asnumpy(), np.full((3, 2), 4))


OPTS = [("sgd", dict(learning_rate=0.5)),
        ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
        ("sgd", dict(learning_rate=0.2, clip_gradient=0.3, rescale_grad=2.0)),
        ("sgd", dict(learning_rate=0.2, lazy_update=False, momentum=0.5)),
        ("adam", dict(learning_rate=0.1)),
        ("adagrad", dict(learning_rate=0.1))]


@pytest.mark.parametrize("name,kw", OPTS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(OPTS)])
def test_row_sparse_updates_match_reference(name, kw):
    rng = np.random.RandomState(3)
    w0 = rng.randn(8, 3).astype("f")
    grads = [(rng.randn(3, 3).astype("f"), [1, 4, 6]),
             (rng.randn(2, 3).astype("f"), [0, 4])]
    outs = []
    for m in (mx, rmx):
        with CPU:
            w = m.nd.array(w0)
            upd = m.optimizer.get_updater(m.optimizer.create(name, **kw))
            for vals, idx in grads:
                upd(0, m.nd.sparse.row_sparse_array((vals, idx),
                                                    shape=(8, 3)), w)
            outs.append(w.asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    if name == "sgd" and kw.get("lazy_update", True) and "wd" not in kw:
        np.testing.assert_array_equal(outs[0][[2, 3, 5, 7]],
                                      w0[[2, 3, 5, 7]])   # untouched rows
