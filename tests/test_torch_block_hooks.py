"""Forward hooks in both packages: registered, fired, detached with the
reference's ``handle.detach()``, fired again (nothing more runs), eager
and hybridized.  The hooks see the block and its inputs (and output) as
the reference's do; what a hook returns is ignored in both."""
import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from torch_threads import one_torch_thread  # noqa: F401


def _run(pkg, hybridize, ctx):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(3, in_units=4), pkg.gluon.nn.Dense(2,
                                                                  in_units=3))
    net.initialize(**ctx)
    if hybridize:
        net.hybridize()
    seen = []
    pre = net.register_forward_pre_hook(
        lambda blk, args: seen.append(("pre", len(args),
                                       tuple(args[0].shape))) or "ignored")
    post = net.register_forward_hook(
        lambda blk, args, out: seen.append(("post", tuple(out.shape))) or 7)
    x = pkg.nd.array(np.ones((5, 4), "f"), **ctx)
    out1 = net(x).asnumpy()
    pre.detach()
    post.detach()
    out2 = net(x).asnumpy()
    np.testing.assert_array_equal(out1, out2)
    return seen


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
def test_hooks_fire_and_detach_as_in_the_reference(hybridize):
    prev = rmx.nd.set_eager_jit(False)
    try:
        want = _run(rmx, hybridize, {})
    finally:
        rmx.nd.set_eager_jit(prev)
    got = _run(mx, hybridize, {"ctx": mx.cpu()})
    assert got == want == [("pre", 1, (5, 4)), ("post", (5, 2))]


def test_torch_remove_works_beside_detach():
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    calls = []
    h = net.register_forward_hook(lambda *a: calls.append(1))
    net(mx.nd.ones((1, 3), ctx=mx.cpu()))
    h.remove()
    with net.register_forward_pre_hook(lambda *a: calls.append(0)):
        net(mx.nd.ones((1, 3), ctx=mx.cpu()))
    net(mx.nd.ones((1, 3), ctx=mx.cpu()))
    assert calls == [1, 0]
