"""``HybridBlock.export`` and ``gluon.SymbolBlock`` of the port against the
reference's, on the CPU.

- The port's export of a 2-layer BERT encoder (64 wide, 4 heads, sequence
  16, the attention included) and of a conv + BatchNorm net at 16² names
  the same ops, in the same topological order, with the same attrs,
  inputs and parameter names as the reference's export of the same net:
  an op that escaped the trace would be missing.  Node names are the
  packages' own global counters and are not compared.
- Deploy files cross both ways: each package's ``SymbolBlock.imports`` of
  the other's files gives the exporting net's outputs within 1e-5, and
  the gradients of a loss through the imported encoder agree within 1e-5;
  training-mode forwards of the imported conv net move its BatchNorm
  statistics as the reference's do, within 1e-6.
- The whole BERT model exports in the port (the reference's tracer has no
  ``slice_axis`` and its loader cannot read a constant: ROADMAP.md C13,
  C14) and its import equals the Gluon net bit for bit, eager and
  hybridized.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo.language import bert as rbert
from mxnet_tpu_torch.gluon import load_reference_params
from mxnet_tpu_torch.gluon.model_zoo.language import bert as pbert
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
TOL = 1e-5
BERT = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=32, dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


def _close(port, ref, atol=TOL):
    port = port.asnumpy() if hasattr(port, "asnumpy") else port
    ref = ref.asnumpy() if hasattr(ref, "asnumpy") else ref
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol * scale)


def _convnet(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=8), nn.Activation("relu"),
            nn.MaxPool2D(), nn.Flatten(), nn.Dense(5, in_units=8 * 64))
    return net


def _pair(make, seed=0):
    rmx.random.seed(seed)
    ref = make(rmx)
    ref.initialize(rmx.init.Xavier())
    port = make(mx)
    port.initialize(ctx=CPU)
    params = {k: p.data().asnumpy().copy()
              for k, p in ref.collect_params().items()}
    rs = np.random.RandomState(seed + 7)
    for k, v in params.items():
        if k.endswith(("running_mean", "running_var")):
            v[:] = rs.rand(*v.shape) + (0.5 if k.endswith("var") else -0.5)
            ref.collect_params()[k].set_data(rmx.nd.array(v))
    load_reference_params(port, params)
    return ref, port


def _encoders(seed=0):
    rmx.random.seed(seed)
    ref = rbert.BertModel(rbert.BertConfig(**BERT))
    ref.initialize(rmx.init.Normal(0.05))
    h = np.zeros((1, 2, BERT["hidden_size"]), dtype="float32")
    ref.encoder(rmx.nd.array(h))       # settles the deferred shapes
    port = pbert.BertModel(pbert.BertConfig(**BERT))
    port.initialize(ctx=CPU)
    port.encoder(mx.nd.array(h, ctx=CPU))
    load_reference_params(port.encoder, {
        k: p.data().asnumpy() for k, p in
        ref.encoder.collect_params().items()})
    return ref.encoder, port.encoder


def _hidden(seed=1):
    return np.random.RandomState(seed).randn(2, 16, 64).astype("f")


def _image(seed=1, n=2):
    return np.random.RandomState(seed).randn(n, 3, 16, 16).astype("f")


NETS = {"bert_encoder": (_encoders, _hidden),
        "conv_bn": (lambda: _pair(_convnet), _image)}


def _structure(path):
    js = json.load(open(path))
    nodes = [(n["op"], n["name"] if n["op"] == "null" else None,
              n.get("attrs", {}), n["inputs"]) for n in js["nodes"]]
    return nodes, js["arg_nodes"], js["heads"]


_EXPORTED = {}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """case -> (reference net, port net, input, directory of both exports),
    made once for the module (the reference's eager BERT is slow)."""
    def get(case):
        if case not in _EXPORTED:
            make, data = NETS[case]
            ref, port = make()
            x = data()
            path = tmp_path_factory.mktemp(case)
            ref.export(str(path / "ref"), 0, rmx.nd.array(x))
            port.export(str(path / "port"), 0, mx.nd.array(x, ctx=CPU))
            _EXPORTED[case] = (ref, port, x, path)
        return _EXPORTED[case]

    yield get
    _EXPORTED.clear()


@pytest.mark.parametrize("case", sorted(NETS))
def test_export_is_structurally_the_references(case, exported):
    tmp_path = exported(case)[3]
    ref_nodes, ref_args, ref_heads = _structure(tmp_path / "ref-symbol.json")
    nodes, args, heads = _structure(tmp_path / "port-symbol.json")
    assert [n[0] for n in nodes] == [n[0] for n in ref_nodes]
    assert nodes == ref_nodes
    assert (args, heads) == (ref_args, ref_heads)
    if case == "bert_encoder":
        assert [n[0] for n in nodes].count("_contrib_flash_attention") == 2
    ref_params = rmx.nd.load(str(tmp_path / "ref-0000.params"))
    params = mx.nd.load(str(tmp_path / "port-0000.params"), ctx=CPU)
    assert sorted(params) == sorted(ref_params)
    for k, v in params.items():
        np.testing.assert_array_equal(v.asnumpy(), ref_params[k].asnumpy())


@pytest.mark.parametrize("case", sorted(NETS))
def test_files_cross_both_ways(case, exported):
    ref, port, x, tmp_path = exported(case)
    want = ref(rmx.nd.array(x))
    in_port = mx.gluon.SymbolBlock.imports(
        str(tmp_path / "ref-symbol.json"), ["data"],
        str(tmp_path / "ref-0000.params"), ctx=CPU)
    in_ref = rmx.gluon.SymbolBlock.imports(
        str(tmp_path / "port-symbol.json"), ["data"],
        str(tmp_path / "port-0000.params"))
    _close(in_port(mx.nd.array(x, ctx=CPU)), want)
    _close(in_ref(rmx.nd.array(x)), port(mx.nd.array(x, ctx=CPU)))
    # Module.load reads the same files
    mod = mx.mod.Module.load(str(tmp_path / "ref"), 0, label_names=[],
                             context=CPU)
    mod.bind(data_shapes=[("data", x.shape)], for_training=False)
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=CPU)]),
                is_train=False)
    _close(mod.get_outputs()[0], want)


def _loss_grads(pkg, blk, x):
    ctx = CPU if pkg is mx else rmx.cpu()
    xa = pkg.nd.array(x, ctx=ctx)
    xa.attach_grad()
    w = pkg.nd.array(np.random.RandomState(5).randn(*x.shape).astype("f"),
                     ctx=ctx)
    with pkg.autograd.record():
        loss = (blk(xa) * w).sum()
    loss.backward()
    grads = {"data": xa.grad.asnumpy()}
    for name, p in blk.collect_params().items():
        if p.grad_req != "null":
            grads[name] = p.grad().asnumpy()
    return grads


def test_gradients_through_the_imported_encoder_match(exported):
    """Each package imports the other's file; the gradients of the same
    loss with respect to the input and every weight (the attention's
    projections included) agree within 1e-5."""
    tmp_path = exported("bert_encoder")[3]
    x = _hidden(3)
    in_port = mx.gluon.SymbolBlock.imports(
        str(tmp_path / "ref-symbol.json"), ["data"],
        str(tmp_path / "ref-0000.params"), ctx=CPU)
    in_ref = rmx.gluon.SymbolBlock.imports(
        str(tmp_path / "port-symbol.json"), ["data"],
        str(tmp_path / "port-0000.params"))
    got, want = _loss_grads(mx, in_port, x), _loss_grads(rmx, in_ref, x)
    assert sorted(got) == sorted(want)
    assert any("attention.query" in k for k in got)
    for k in want:
        _close(got[k], want[k])


def test_training_forward_moves_the_moving_stats_as_the_reference(exported):
    tmp_path = exported("conv_bn")[3]
    blks = [pkg.gluon.SymbolBlock.imports(
        str(tmp_path / "ref-symbol.json"), ["data"],
        str(tmp_path / "ref-0000.params"), **kw)
        for pkg, kw in ((mx, {"ctx": CPU}), (rmx, {}))]
    for step in range(2):
        x = _image(10 + step, n=4) * 2 + 1
        outs = []
        for pkg, blk in zip((mx, rmx), blks):
            ctx = CPU if pkg is mx else rmx.cpu()
            with pkg.autograd.record():
                outs.append(blk(pkg.nd.array(x, ctx=ctx)))
        _close(outs[0], outs[1])
    port, ref = blks
    aux = port._sym_aux_names
    assert len(aux) == 2
    for name in aux:
        got = port.params.get(name).data().asnumpy()
        np.testing.assert_allclose(got, ref.params.get(name).data().asnumpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        assert not np.allclose(got, rmx.nd.load(
            str(tmp_path / "ref-0000.params"))[f"aux:{name}"].asnumpy())


def test_hybridized_symbolblock_writes_aux_back(exported):
    """Under hybridize() (the functional cache on the CPU) a training
    forward writes the moving stats back as the eager forward does."""
    tmp_path = exported("conv_bn")[3]
    blks = [mx.gluon.SymbolBlock.imports(
        str(tmp_path / "port-symbol.json"), ["data"],
        str(tmp_path / "port-0000.params"), ctx=CPU) for _ in range(2)]
    blks[1].hybridize()
    x = mx.nd.array(_image(4, n=4) * 3 - 1, ctx=CPU)
    outs = []
    for blk in blks:
        with mx.autograd.record():
            outs.append(blk(x))
    np.testing.assert_array_equal(outs[1].asnumpy(), outs[0].asnumpy())
    for name in blks[0]._sym_aux_names:
        np.testing.assert_array_equal(
            blks[1].params.get(name).data().asnumpy(),
            blks[0].params.get(name).data().asnumpy())
    assert blks[1]._cached_graph


def test_whole_bert_round_trip_is_bit_exact(tmp_path):
    cfg = pbert.BertConfig(**BERT)
    mx.random.seed(0)
    net = pbert.BertModel(cfg)
    net.initialize(mx.init.Normal(0.05), ctx=CPU)
    ids = mx.nd.array(np.random.RandomState(2).randint(0, 100, (2, 16)),
                      ctx=CPU, dtype="int32")
    net.hybridize()
    want = net(ids)
    prefix = str(tmp_path / "bert")
    net.export(prefix)      # the last hybridized call's signature
    ops = [n["op"] for n in json.load(open(prefix + "-symbol.json"))["nodes"]]
    assert ops.count("_contrib_flash_attention") == cfg.num_layers
    assert "slice_axis" in ops
    blk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                       prefix + "-0000.params", ctx=CPU)
    got = blk(ids)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    blk.hybridize()
    for a, b in zip(blk(ids), want):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_export_without_inputs_raises():
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)
    with pytest.raises(mx.MXNetError):
        net.export("never_written")


def test_export_slice_and_dropout_round_trip(tmp_path):
    class M(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.d = mx.gluon.nn.Dense(6, in_units=3)
            self.drop = mx.gluon.nn.Dropout(0.5)

        def forward(self, x):
            return self.drop(self.d(x)[:, 0:4])

    m = M()
    m.initialize(ctx=CPU)
    x = mx.nd.array(np.random.RandomState(0).randn(2, 3), ctx=CPU)
    prefix = str(tmp_path / "s")
    m.export(prefix, 0, x)
    blk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                       prefix + "-0000.params", ctx=CPU)
    np.testing.assert_array_equal(blk(x).asnumpy(), m(x).asnumpy())
    ref = rmx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                        prefix + "-0000.params")
    _close(ref(rmx.nd.array(x.asnumpy())), m(x))


def test_arg_named_like_aux_stays_an_argument(tmp_path):
    class Odd(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fake_running_var = self.params.get("fake_running_var",
                                                    shape=(8, 4))

        def hybrid_forward(self, F, x, fake_running_var):
            return F.dot(x, fake_running_var)

    net = Odd()
    net.initialize(ctx=CPU)
    x = mx.nd.array(np.random.RandomState(3).randn(2, 8), ctx=CPU)
    prefix = str(tmp_path / "odd")
    net.export(prefix, 0, x)
    sym, arg, aux = mx.model.load_checkpoint(prefix, 0)
    assert list(arg) == ["fake_running_var"] and not aux
    blk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                       prefix + "-0000.params", ctx=CPU)
    assert blk.params.get("fake_running_var").grad_req == "write"
    np.testing.assert_array_equal(blk(x).asnumpy(), net(x).asnumpy())


def test_untraceable_routes_raise():
    """A host read, an in-place write or a function outside the op table
    inside the forward raises at export instead of baking a constant."""
    class Reads(mx.gluon.HybridBlock):
        def forward(self, x):
            return x * float(x.sum().asscalar())

    class Writes(mx.gluon.HybridBlock):
        def forward(self, x):
            x[0] = 1.0
            return x

    class Applies(mx.gluon.HybridBlock):
        def forward(self, x):
            return mx.nd.ndarray.apply_fn(lambda t: t * 2, [x])

    x = mx.nd.ones((2, 3), ctx=CPU)
    for blk in (Reads(), Writes(), Applies()):
        with pytest.raises(mx.MXNetError):
            blk.export("never_written", 0, x)
