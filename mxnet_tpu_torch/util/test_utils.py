"""Test oracles (counterpart of ``mxnet_tpu/util/test_utils.py``):
``assert_almost_equal`` with per-dtype tolerances, ``check_numeric_gradient``
by central differences, ``check_symbolic_forward`` / ``_backward`` over a
bound Symbol, ``check_consistency`` across contexts (``[mx.cpu(),
mx.gpu()]``: the card against the CPU) and ``rand_ndarray``.  Arrays go on
``ctx``, by default the current context."""
from __future__ import annotations

import numpy as _np

from ..context import cpu, current_context
from ..ndarray.ndarray import NDArray, array

__all__ = ["default_context", "assert_almost_equal", "almost_equal",
           "rand_ndarray", "rand_shape_nd", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward",
           "check_consistency", "symbol_forward", "same"]

_DTYPE_RTOL = {_np.dtype(_np.float16): 1e-2, _np.dtype(_np.float32): 1e-4,
               _np.dtype(_np.float64): 1e-6}
_DTYPE_ATOL = {_np.dtype(_np.float16): 1e-2, _np.dtype(_np.float32): 1e-5,
               _np.dtype(_np.float64): 1e-7}


def default_context():
    return current_context()


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def same(a, b):
    return _np.array_equal(_as_np(a), _as_np(b))


def almost_equal(a, b, rtol=None, atol=None):
    a, b = _as_np(a), _as_np(b)
    rtol = rtol or _DTYPE_RTOL.get(a.dtype, 1e-4)
    atol = atol or _DTYPE_ATOL.get(a.dtype, 1e-5)
    return _np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    a_np, b_np = _as_np(a), _as_np(b)
    rtol = rtol if rtol is not None else _DTYPE_RTOL.get(a_np.dtype, 1e-4)
    atol = atol if atol is not None else _DTYPE_ATOL.get(a_np.dtype, 1e-5)
    if not _np.allclose(a_np, b_np, rtol=rtol, atol=atol, equal_nan=True):
        err = _np.abs(a_np - b_np)
        rel = err / (_np.abs(b_np) + atol)
        raise AssertionError(
            f"{names[0]} != {names[1]} (rtol={rtol}, atol={atol}): max abs err "
            f"{err.max():.3e}, max rel err {rel.max():.3e}\n"
            f"{names[0]}: {a_np.ravel()[:8]}...\n{names[1]}: {b_np.ravel()[:8]}...")


def rand_shape_nd(ndim, dim=10):
    return tuple(_np.random.randint(1, dim + 1, size=ndim).tolist())


def rand_ndarray(shape, stype="default", density=None, dtype=_np.float32,
                 ctx=None):
    """Uniform in [-1, 1); a sparse ``stype`` ("csr", "row_sparse") keeps
    each entry with probability ``density`` (default 0.5)."""
    x = _np.random.uniform(-1, 1, size=shape).astype(dtype)
    if stype == "default":
        return array(x, ctx=ctx)
    keep = _np.random.uniform(size=shape) < (0.5 if density is None
                                             else density)
    return array(x * keep, ctx=ctx).tostype(stype)


def check_numeric_gradient(f, inputs, grads=None, eps=1e-3, rtol=1e-2,
                           atol=1e-3, ctx=None):
    """Finite-difference check of f's gradients computed via autograd.

    f: callable(*NDArrays) -> NDArray (summed for the gradient)
    inputs: list of numpy arrays (float32/float64)
    """
    from .. import autograd

    nds = [array(x.astype(_np.float64).astype(_np.float32), ctx=ctx)
           for x in inputs]
    for nd in nds:
        nd.attach_grad()
    with autograd.record():
        out = f(*nds)
        loss = out.sum()
    loss.backward()
    analytic = [nd.grad.asnumpy() for nd in nds]

    for i, x in enumerate(inputs):
        numeric = _np.zeros_like(x, dtype=_np.float64)
        flat = x.astype(_np.float64).ravel()
        for j in range(flat.size):
            xp = flat.copy()
            xm = flat.copy()
            xp[j] += eps
            xm[j] -= eps
            args_p = [a.copy() for a in inputs]
            args_m = [a.copy() for a in inputs]
            args_p[i] = xp.reshape(x.shape).astype(_np.float32)
            args_m[i] = xm.reshape(x.shape).astype(_np.float32)
            fp = float(f(*[array(a, ctx=ctx) for a in args_p]).sum().asscalar())
            fm = float(f(*[array(a, ctx=ctx) for a in args_m]).sum().asscalar())
            numeric.ravel()[j] = (fp - fm) / (2 * eps)
        if not _np.allclose(analytic[i], numeric, rtol=rtol, atol=atol):
            raise AssertionError(
                f"numeric gradient check failed for input {i}:\n"
                f"analytic: {analytic[i].ravel()[:6]}\n"
                f"numeric:  {numeric.ravel()[:6]}")


def _bind(sym, location, aux_states, ctx, grad_req="null"):
    """``sym`` bound on ``ctx`` to ``location`` (a list in
    ``list_arguments()`` order or a dict of numpy arrays / NDArrays)."""
    names = sym.list_arguments()
    if not isinstance(location, dict):
        location = dict(zip(names, location))
    args = {k: array(v, ctx=ctx) for k, v in location.items()}
    aux_names = sym.list_auxiliary_states()
    if aux_states is not None and not isinstance(aux_states, dict):
        aux_states = dict(zip(aux_names, aux_states))
    aux = {k: array(v, ctx=ctx) for k, v in (aux_states or {}).items()}
    grads = None
    if grad_req != "null":
        grads = {k: array(_np.zeros(a.shape, "float32"), ctx=ctx)
                 for k, a in args.items()}
    return sym.bind(ctx, args=args, args_grad=grads, grad_req=grad_req,
                    aux_states=aux)


def _expected_list(expected, names):
    if isinstance(expected, dict):
        return [expected[n] for n in names], names
    return list(expected), names


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=None,
                           aux_states=None, ctx=None, equal_nan=False):
    """Bind ``sym`` to ``location``, run the inference forward and hold
    each output to ``expected`` (a list in output order, or a dict by
    output name).  Returns the outputs as numpy arrays."""
    ctx = ctx or default_context()
    ex = _bind(sym, location, aux_states, ctx)
    outs = [o.asnumpy() for o in ex.forward(is_train=False)]
    want, names = _expected_list(expected, sym.list_outputs())
    for name, got, exp in zip(names, outs, want):
        assert_almost_equal(got, exp, rtol=rtol, atol=atol,
                            names=(f"forward {name}", "expected"))
    return outs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None, equal_nan=False):
    """Bind ``sym`` to ``location``, run a training forward and the
    backward with head gradients ``out_grads``, and hold each argument's
    gradient to ``expected`` (a list in argument order, or a dict of some
    arguments).  Returns the gradients by name as numpy arrays."""
    ctx = ctx or default_context()
    ex = _bind(sym, location, aux_states, ctx, grad_req=grad_req)
    ex.forward(is_train=True)
    if out_grads is not None:
        out_grads = [array(g, ctx=ctx) for g in (
            [out_grads[n] for n in sym.list_outputs()]
            if isinstance(out_grads, dict) else out_grads)]
    ex.backward(out_grads)
    grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()
             if g is not None}
    want = expected if isinstance(expected, dict) else \
        dict(zip(sym.list_arguments(), expected))
    for name, exp in want.items():
        assert_almost_equal(grads[name], exp, rtol=rtol, atol=atol,
                            names=(f"gradient of {name}", "expected"))
    return grads


def symbol_forward(sym):
    """A callable running ``sym``'s inference forward on NDArrays given in
    the order of its arguments and then its aux states, on their
    context; it returns the first output."""
    names = sym.list_arguments()

    def f(*nds):
        return sym.bind(nds[0].context, args=dict(zip(names, nds)),
                        aux_states=list(nds[len(names):])).forward()[0]

    return f


def check_consistency(f, inputs, ctx_list=None, dtypes=("float32",),
                      rtol=None, atol=None):
    """Run ``f`` on the same inputs on each context and dtype and hold every
    run to the first (fp32 within 1e-4 / 1e-5, bfloat16 within 1e-1).
    ``f``: a callable on NDArrays, or a Symbol (``inputs`` then in the
    order of its ``list_arguments()`` and then its
    ``list_auxiliary_states()``; its first output is compared).  Raises
    AssertionError on a mismatch; returns the first run's output."""
    from ..symbol.symbol import Symbol

    ctx_list = ctx_list or [cpu()]
    if isinstance(f, Symbol):
        f = symbol_forward(f)
    ref = None
    for ctx in ctx_list:
        for dt in dtypes:
            nds = [array(x, ctx=ctx, dtype=dt) for x in inputs]
            out = _as_np(f(*nds))
            if ref is None:
                ref = out
            else:
                rt = rtol or (1e-1 if dt == "bfloat16" else 1e-4)
                at = atol or (1e-1 if dt == "bfloat16" else 1e-5)
                if not _np.allclose(ref, out.astype(ref.dtype), rtol=rt, atol=at):
                    raise AssertionError(
                        f"inconsistent results on {ctx}/{dt}: "
                        f"{ref.ravel()[:5]} vs {out.ravel()[:5]}")
    return ref
