"""Factorization machine on sparse (csr) features, on the PyTorch/CUDA port
(``mxnet_tpu_torch``): the local mode of ``factorization_machine.py``.

The csr x dense products go through ``nd.dot``'s sparse path (a gather and
an index_add over the nonzeros; the gradient reaches the dense factors),
so the model trains without making the feature matrix dense.  Parameters
are NDArrays updated by hand (``p -= lr * p.grad``, as the original's
local mode), or, with ``lazy_update=True``, by SGD's lazy row-sparse
update on the rows the batch touches.  Both follow the same random stream
as the original, so their losses are the original's.

The original's ``--kvstore`` mode waits for the port's KVStore.

CPU: python factorization_machine_torch.py --cpu --steps 60 [--lazy]
"""
import argparse

import numpy as np


def fm_loss(x_csr, x_sq_csr, w0, w, V, y):
    """Mean logistic loss of the order-2 FM: w0 + x.w + 0.5 * sum_k
    ((x.V_k)^2 - (x^2).(V_k^2))."""
    from mxnet_tpu_torch import nd

    linear = nd.dot(x_csr, w)[:, 0]
    xv = nd.dot(x_csr, V)
    x2v2 = nd.dot(x_sq_csr, V * V)
    pairwise = 0.5 * (xv * xv - x2v2).sum(axis=1)
    logit = w0 + linear + pairwise
    return (nd.log(1 + nd.exp(-nd.abs(logit)))
            + nd.relu(logit) - logit * y).mean()


def squared(x_csr):
    """The csr matrix with its values squared."""
    from mxnet_tpu_torch.ndarray.sparse import CSRNDArray

    return CSRNDArray.create(x_csr.data._data ** 2, x_csr.indices._data,
                             x_csr.indptr._data, x_csr.shape, x_csr.context)


def sgd_step(x_csr, y, w0, params, lr, updater=None, x_sq=None):
    """One step on the batch (x_csr, y); returns the loss NDArray.
    ``updater`` (an SGD ``Updater``): the lazy update of ``params`` (w, V)
    on the rows the batch touches; without it, ``p -= lr * p.grad``."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray.sparse import row_sparse_array

    if x_sq is None:
        x_sq = squared(x_csr)
    with autograd.record():
        loss = fm_loss(x_csr, x_sq, w0, *params, y)
    loss.backward()
    if updater is None:
        for p in params:
            p -= lr * p.grad
    else:
        rows = torch.unique(x_csr.indices._data.long())
        for i, p in enumerate(params):
            grad = row_sparse_array((p.grad._data[rows], rows), shape=p.shape)
            updater(i, grad, p)
    w0 -= lr * w0.grad
    return loss


def run(num_features=1000, rank=8, batch_size=128, steps=200, lr=1.0,
        density=0.02, log_every=20, seed=0, lazy_update=False, ctx=None):
    """Train; returns the per-step losses (the original's random stream, so
    the original's local mode gives the same trajectory)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, optimizer

    ctx = ctx or mx.current_context()
    rs = np.random.RandomState(seed)
    D, K, B = num_features, rank, batch_size

    # ground-truth sparse logistic model for synthetic clicks
    true_w = rs.randn(D) * (rs.rand(D) < 0.1)

    def sample_batch():
        dense = (rs.rand(B, D) < density) * rs.rand(B, D).astype("f")
        y = (dense @ true_w + 0.1 * rs.randn(B) > 0).astype("f")
        return dense.astype("f"), y

    w0 = nd.zeros((1,), ctx=ctx)
    w0.attach_grad()
    w = nd.array(np.zeros((D, 1), "f"), ctx=ctx)
    V = nd.array((rs.randn(D, K) * 0.01).astype("f"), ctx=ctx)
    for p in (w, V):
        p.attach_grad()
    updater = optimizer.get_updater(optimizer.create(
        "sgd", learning_rate=lr, lazy_update=True)) if lazy_update else None

    losses = []
    for step in range(steps):
        dense, y_np = sample_batch()
        x_csr = nd.array(dense, ctx=ctx).tostype("csr")
        x_sq = nd.array(np.square(dense), ctx=ctx).tostype("csr")
        loss = sgd_step(x_csr, nd.array(y_np, ctx=ctx), w0, (w, V), lr,
                        updater, x_sq)
        losses.append(float(loss.asscalar()))
        if log_every and step % log_every == 0:
            print(f"step {step}: logloss {losses[-1]:.4f}")
    print(f"final logloss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-features", type=int, default=1000)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--density", type=float, default=0.02)
    ap.add_argument("--lazy", action="store_true",
                    help="SGD's lazy row-sparse update")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import mxnet_tpu_torch as mx

    losses = run(num_features=args.num_features, rank=args.rank,
                 batch_size=args.batch_size, steps=args.steps, lr=args.lr,
                 density=args.density, lazy_update=args.lazy,
                 ctx=mx.cpu() if args.cpu else mx.gpu(0))
    assert losses[-1] < losses[0]


if __name__ == "__main__":
    main()
