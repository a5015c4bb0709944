"""``gluon.rnn`` of the port against the reference on the CPU, after
tests/test_gluon.py:184-225: the fused layers (``RNN`` relu and tanh,
``LSTM``, ``GRU``; stacked, bidirectional, both layouts, with and
without given states), the cells (``RNNCell``, ``LSTMCell``,
``GRUCell``), ``SequentialRNNCell``, the ``ResidualCell``,
``DropoutCell`` and ``ZoneoutCell`` modifiers (at rate 0: their masks
come from each package's own generator), ``unroll`` in NTC and TNC and
``begin_state``.  The same seeded weights go into both nets (the port's
carried from the reference's by ``load_reference_params``); outputs,
final states and the gradients of every parameter and the input agree
within 1e-5 of the larger of 1 and the magnitude (fp32)."""
import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import load_reference_params
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
TOL = 1e-5


def _close(port, ref, what=""):
    ref = np.asarray(ref, dtype=np.float64)
    port = np.asarray(port, dtype=np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _carry(ref, port, settle, seed=0):
    """Settle the port's shapes with ``settle(port)``, draw seeded
    weights for it, set them into the reference and carry them back."""
    port.initialize(ctx=CPU)
    settle(port)
    r = np.random.RandomState(seed)
    values = []
    for name, p in port.collect_params().items():
        v = 0.2 * r.randn(*p.shape) if name.endswith("bias") else \
            r.randn(*p.shape) / np.sqrt(p.shape[-1])
        values.append(v.astype("float32"))
    rparams = list(ref.collect_params().values())
    assert len(rparams) == len(values)
    for p, v in zip(rparams, values):
        p.shape = v.shape
        p._deferred_init = ()
        p._init_impl(rmx.nd.array(v), [rmx.cpu()])
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()})


def _seq(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    return [x]


def _grads(pkg, net, arrays, run):
    """Outputs of ``run(arrays)`` and the gradients of their seeded
    weighted sum: every parameter's, then each array's."""
    for a in arrays:
        a.attach_grad()
    with pkg.autograd.record():
        outs = _flat(run(*arrays))
        total = None
        for i, o in enumerate(outs):
            w = np.random.RandomState(20 + i).randn(*o.shape) \
                .astype("float32")
            term = (o * pkg.nd.array(w, ctx=o.context)).sum()
            total = term if total is None else total + term
    total.backward()
    grads = [p.grad().asnumpy() for p in net.collect_params().values()]
    return [o.asnumpy() for o in outs], grads + [a.grad.asnumpy()
                                                 for a in arrays]


def _compare(ref, port, inputs, run_ref, run_port):
    prev = rmx.nd.set_eager_jit(False)
    try:
        rout, rgrad = _grads(rmx, ref, [rmx.nd.array(x) for x in inputs],
                             run_ref)
    finally:
        rmx.nd.set_eager_jit(prev)
    with CPU:
        pout, pgrad = _grads(mx, port, [nd.array(x) for x in inputs],
                             run_port)
    assert len(pout) == len(rout) and len(pgrad) == len(rgrad)
    for i, (p, r) in enumerate(zip(pout, rout)):
        assert p.shape == r.shape
        _close(p, r, f"output {i}")
    for i, (p, r) in enumerate(zip(pgrad, rgrad)):
        _close(p, r, f"gradient {i}")


LAYERS = [("LSTM", {"num_layers": 2, "bidirectional": True}, "TNC"),
          ("GRU", {}, "NTC"),
          ("RNN", {"num_layers": 2, "activation": "relu"}, "TNC"),
          ("RNN", {"activation": "tanh", "bidirectional": True}, "NTC")]


@pytest.mark.parametrize("states", [False, True])
@pytest.mark.parametrize("cls,kw,layout", LAYERS,
                         ids=[f"{c}-{lay}-{i}" for i, (c, _, lay)
                              in enumerate(LAYERS)])
def test_layer_matches_reference(cls, kw, layout, states):
    T, N, C, H = 5, 3, 4, 6
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    ref = getattr(rmx.gluon.rnn, cls)(H, layout=layout, **kw)
    port = getattr(gluon.rnn, cls)(H, layout=layout, **kw)
    x = _seq(*shape)
    _carry(ref, port, lambda n: n(nd.array(x, ctx=CPU)))
    n_states = 2 if cls == "LSTM" else 1
    dirs = 2 if kw.get("bidirectional") else 1
    s_shape = (kw.get("num_layers", 1) * dirs, N, H)
    inputs = [x] + ([_seq(*s_shape, seed=2 + i) for i in range(n_states)]
                    if states else [])

    def run(net):
        def go(xa, *st):
            return net(xa, list(st)) if states else net(xa)
        return go

    _compare(ref, port, inputs, run(ref), run(port))


def test_begin_state_matches_reference():
    for cls in ("LSTM", "GRU"):
        ref = getattr(rmx.gluon.rnn, cls)(6, num_layers=2,
                                          bidirectional=True)
        port = getattr(gluon.rnn, cls)(6, num_layers=2, bidirectional=True)
        rs, ps = ref.begin_state(batch_size=3), \
            port.begin_state(batch_size=3, ctx=CPU)
        assert [s.shape for s in ps] == [s.shape for s in rs] == \
            [(4, 3, 6)] * len(rs)
        assert all(not s.asnumpy().any() for s in ps)
    cell = gluon.rnn.LSTMCell(5)
    assert [s.shape for s in cell.begin_state(2, ctx=CPU)] == [(2, 5)] * 2


def _cell(pkg, kind):
    rnn = pkg.gluon.rnn
    if kind == "rnn":
        return rnn.RNNCell(6, activation="tanh")
    if kind == "lstm":
        return rnn.LSTMCell(6)
    if kind == "gru":
        return rnn.GRUCell(6)
    if kind == "sequential":
        seq = rnn.SequentialRNNCell()
        seq.add(rnn.LSTMCell(6))
        seq.add(rnn.GRUCell(6))
        return seq
    if kind == "residual":
        return rnn.ResidualCell(rnn.GRUCell(4))
    if kind == "dropout":
        return rnn.DropoutCell(0.0, base_cell=rnn.LSTMCell(6))
    if kind == "zoneout":
        return rnn.ZoneoutCell(rnn.LSTMCell(6), 0.0, 0.0)


CELLS = ["rnn", "lstm", "gru", "sequential", "residual", "dropout",
         "zoneout"]


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind", CELLS)
def test_cell_unroll_matches_reference(kind, layout):
    T, N, C = 5, 2, 4
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    x = _seq(*shape, seed=3)
    ref, port = _cell(rmx, kind), _cell(mx, kind)

    def settle(net):
        net.unroll(T, nd.array(x, ctx=CPU), layout=layout)

    _carry(ref, port, settle)

    def run(net, pkg):
        def go(xa):
            states = net.begin_state(N, ctx=pkg.cpu()) if pkg is mx else \
                net.begin_state(N)
            with pkg.autograd.train_mode():
                return net.unroll(T, xa, begin_state=states, layout=layout)
        return go

    _compare(ref, port, [x], run(ref, rmx), run(port, mx))


def test_unroll_without_merging_gives_a_list():
    cell = gluon.rnn.GRUCell(3)
    cell.initialize(ctx=CPU)
    outs, states = cell.unroll(4, nd.array(_seq(2, 4, 5), ctx=CPU),
                               layout="NTC", merge_outputs=False)
    assert isinstance(outs, list) and len(outs) == 4
    assert outs[0].shape == (2, 3) and len(states) == 1


def test_lstm_cell_unroll_equals_the_layer():
    """The LSTM layer's weights in an LSTMCell: unroll computes what the
    fused layer computes (within 1e-5, fp32)."""
    T, N, C, H = 7, 3, 5, 4
    x = nd.array(_seq(T, N, C, seed=4), ctx=CPU)
    layer = gluon.rnn.LSTM(H)
    layer.initialize(mx.init.Xavier(), ctx=CPU)
    h0 = [nd.array(_seq(1, N, H, seed=5 + i), ctx=CPU) for i in range(2)]
    out, (hf, cf) = layer(x, h0)
    cell = gluon.rnn.LSTMCell(H, input_size=C)
    cell.initialize(ctx=CPU)
    for (_, a), (_, b) in zip(sorted(layer.collect_params().items()),
                              sorted(cell.collect_params().items())):
        b.set_data(a.data())
    outs, (h, c) = cell.unroll(T, x, begin_state=[s[0] for s in h0],
                               layout="TNC")
    _close(outs.asnumpy(), out.asnumpy())
    _close(h.asnumpy(), hf.asnumpy()[0])
    _close(c.asnumpy(), cf.asnumpy()[0])


class _WordLM(mx.gluon.HybridBlock):
    """GluonNLP's word LM at a tiny size: Embedding -> LSTM -> Dense."""

    def __init__(self, vocab, hidden, layers):
        super().__init__()
        self.embedding = gluon.nn.Embedding(vocab, hidden)
        self.encoder = gluon.rnn.LSTM(hidden, num_layers=layers,
                                      input_size=hidden)
        self.decoder = gluon.nn.Dense(vocab, flatten=False,
                                      in_units=hidden)

    def hybrid_forward(self, F, ids, h, c):
        out, (h, c) = self.encoder(self.embedding(ids), [h, c])
        return self.decoder(out), h, c


def test_hybridized_word_lm_equals_eager():
    vocab, hidden, layers, T, N = 11, 6, 2, 5, 3
    net = _WordLM(vocab, hidden, layers)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    ids = nd.array(np.random.RandomState(6).randint(0, vocab, (T, N)),
                   ctx=CPU)
    h, c = (nd.zeros((layers, N, hidden), ctx=CPU) for _ in range(2))
    res = []
    for hybrid in (False, True):
        if hybrid:
            net.hybridize()
        with autograd.record():
            logits, h1, c1 = net(ids, h, c)
            loss = logits.sum() + h1.sum() + c1.sum()
        loss.backward()
        res.append([logits.asnumpy(), h1.asnumpy()] +
                   [p.grad().asnumpy() for p in
                    net.collect_params().values()])
    for a, b in zip(*res):
        np.testing.assert_array_equal(a, b)
