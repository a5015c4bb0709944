"""The ``.params`` container across the two packages: ``nd.save`` /
``nd.load``, ``ParameterDict.save`` / ``load`` and ``Block.save_parameters``
/ ``load_parameters``.

For every dtype of the reference's type table and a 0-d array, the port's
file is byte for byte the reference's for the same arrays, and each
package reads the other's file back to the same values (the reference
holds 64-bit types as 32-bit ones with JAX's x64 off, so its values are
compared at its own dtype).  bfloat16 travels as raw 16-bit words: the
port never needs a numpy bfloat16 type.

Parameter files are keyed by structural names
(``_collect_params_with_prefix``), which agree between the packages for
BERT, Llama and the ResNets, so a file one package writes loads into the
other's net of the same architecture whatever its block counters.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as rmx
from mxnet_tpu.gluon.model_zoo import vision as ref_vision
from mxnet_tpu.gluon.model_zoo.language import bert as ref_bert
from mxnet_tpu.gluon.model_zoo.language import llama as ref_llama
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision as port_vision
from mxnet_tpu_torch.gluon.model_zoo.language import bert as port_bert
from mxnet_tpu_torch.gluon.model_zoo.language import llama as port_llama
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
DTYPES = ["float32", "float64", "float16", "bfloat16", "uint8", "int32",
          "int8", "int64", "bool"]


@pytest.fixture(scope="module", autouse=True)
def _reference_eager():
    prev = rmx.nd.set_eager_jit(False)
    yield
    rmx.nd.set_eager_jit(prev)


def _numpy_arrays(seed=0):
    """{name: numpy array} of every dtype (bfloat16 as ml_dtypes', which
    the reference takes), and a 0-d array."""
    r = np.random.RandomState(seed)
    out = {}
    for dt in DTYPES:
        shape = (3, 5)
        if dt == "bool":
            a = r.rand(*shape) > 0.5
        elif dt.startswith(("int", "uint")):
            info = np.iinfo(dt)
            a = r.randint(max(info.min, -1000), min(info.max, 1000),
                          shape).astype(dt)
        else:
            a = (100 * r.randn(*shape)).astype(
                ml_dtypes.bfloat16 if dt == "bfloat16" else dt)
        out[dt] = a
    out["scalar"] = np.asarray(np.float32(3.25))
    return out


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_port_file_is_the_reference_file(tmp_path):
    arrays = _numpy_arrays()
    ref_path, port_path = tmp_path / "ref.params", tmp_path / "port.params"
    rmx.nd.save(str(ref_path), arrays)
    nd.save(str(port_path), {k: nd.NDArray._wrap(_torch(a))
                             for k, a in arrays.items()})
    assert _read(port_path) == _read(ref_path)
    # a list (no names) too
    rmx.nd.save(str(ref_path), list(arrays.values()))
    nd.save(str(port_path), [_torch(a) for a in arrays.values()])
    assert _read(port_path) == _read(ref_path)


def test_each_package_reads_the_others_file(tmp_path):
    arrays = _numpy_arrays(1)
    ref_path, port_path = tmp_path / "ref.params", tmp_path / "port.params"
    rmx.nd.save(str(ref_path), arrays)
    nd.save(str(port_path), {k: _torch(a) for k, a in arrays.items()})
    port_read = nd.load(str(ref_path), ctx=CPU)
    ref_read = rmx.nd.load(str(port_path))
    for k, a in arrays.items():
        got = port_read[k]._data
        assert got.shape == torch.Size(a.shape)
        assert torch.equal(got, _torch(a)), k
        ref_val = ref_read[k].asnumpy()
        assert ref_val.shape == a.shape
        np.testing.assert_array_equal(ref_val, a.astype(ref_val.dtype),
                                      err_msg=k)
    assert port_read["scalar"].shape == ()


def test_load_defaults_to_the_current_context(tmp_path):
    path = str(tmp_path / "a.params")
    nd.save(path, {"x": torch.ones(2)})
    with CPU:
        assert nd.load(path)["x"].context == CPU


def test_truncated_and_foreign_files_raise(tmp_path):
    path = str(tmp_path / "a.params")
    nd.save(path, {"x": torch.ones(8)})
    blob = _read(path)
    with open(path, "wb") as f:
        f.write(blob[:40])
    with pytest.raises(MXNetError, match="truncated"):
        nd.load(path, ctx=CPU)
    with open(path, "wb") as f:
        f.write(b"\0" * 64)
    with pytest.raises(MXNetError, match="magic"):
        nd.load(path, ctx=CPU)


def test_asnumpy_is_a_copy():
    a = nd.array([1.0, 2.0], ctx=CPU)
    host = a.asnumpy()
    a += 1
    np.testing.assert_array_equal(host, [1.0, 2.0])


def _dense_pair():
    ref = rmx.gluon.nn.HybridSequential()
    ref.add(rmx.gluon.nn.Dense(4, in_units=3), rmx.gluon.nn.Dense(2,
                                                                  in_units=4))
    ref.initialize()
    port = gluon.nn.HybridSequential()
    port.add(gluon.nn.Dense(4, in_units=3), gluon.nn.Dense(2, in_units=4))
    port.initialize(ctx=CPU)
    return ref, port


def _params_equal(ref_net, port_net):
    ref = ref_net._collect_params_with_prefix()
    port = port_net._collect_params_with_prefix()
    assert list(ref) == list(port)
    for k in ref:
        np.testing.assert_array_equal(port[k].data().asnumpy(),
                                      ref[k].data().asnumpy(), err_msg=k)


def test_save_parameters_crosses_packages(tmp_path):
    ref, port = _dense_pair()
    path = str(tmp_path / "m.params")
    ref.save_parameters(path)
    port.load_parameters(path, ctx=CPU)
    _params_equal(ref, port)
    port[0].weight.set_data(torch.full((4, 3), 0.5))
    port.save_params(path)                 # the legacy alias
    ref.load_parameters(path)
    _params_equal(ref, port)


def test_load_parameters_options(tmp_path):
    _, port = _dense_pair()
    path = str(tmp_path / "m.params")
    port.save_parameters(path)
    small = gluon.nn.HybridSequential()
    small.add(gluon.nn.Dense(4, in_units=3))
    small.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="not in"):
        small.load_parameters(path, ctx=CPU)
    small.load_parameters(path, ctx=CPU, ignore_extra=True)
    big = gluon.nn.HybridSequential()
    big.add(gluon.nn.Dense(4, in_units=3), gluon.nn.Dense(2, in_units=4),
            gluon.nn.Dense(1, in_units=2))
    big.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="missing"):
        big.load_parameters(path, ctx=CPU)
    big.load_parameters(path, ctx=CPU, allow_missing=True)
    # dtypes: the parameter's by default, the file's with dtype_source
    port.cast("float16")
    port.load_parameters(path, ctx=CPU)
    assert port[0].weight.data().dtype == np.float16
    port.load_parameters(path, ctx=CPU, cast_dtype=True,
                         dtype_source="saved")
    assert port[0].weight.data().dtype == np.float32
    # deferred shapes are settled by the file
    deferred = gluon.nn.HybridSequential()
    deferred.add(gluon.nn.Dense(4), gluon.nn.Dense(2))
    deferred.initialize(ctx=CPU)
    deferred.load_parameters(path, ctx=CPU)
    assert deferred[0].weight.shape == (4, 3)


def test_parameter_dict_save_load(tmp_path):
    _, port = _dense_pair()
    params = port.collect_params()
    prefix = os.path.commonprefix(list(params))
    path = str(tmp_path / "p.params")
    params.save(path, strip_prefix=prefix)
    saved = nd.load(path, ctx=CPU)
    assert all(not k.startswith(prefix) for k in saved)
    for p in params.values():
        p.set_data(torch.zeros(p.shape))
    params.load(path, ctx=CPU, restore_prefix=prefix)
    for k, p in params.items():
        assert torch.equal(p.data()._data, saved[k[len(prefix):]]._data)
    with pytest.raises(MXNetError, match="prefix"):
        params.save(path, strip_prefix="nope_")


def _bert_pair():
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64, max_position=32)
    return (ref_bert.BertForPretraining(ref_bert.BertConfig(**cfg)),
            port_bert.BertForPretraining(port_bert.BertConfig(**cfg)))


def _llama_pair():
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=64)
    return (ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig(**cfg)),
            port_llama.LlamaForCausalLM(port_llama.LlamaConfig(**cfg)))


def _resnet_pair(name):
    return (ref_vision.get_model(name, classes=10),
            port_vision.get_model(name, classes=10))


PAIRS = {"bert": _bert_pair, "llama": _llama_pair,
         "resnet18_v1": lambda: _resnet_pair("resnet18_v1"),
         "resnet50_v2": lambda: _resnet_pair("resnet50_v2")}


@pytest.mark.parametrize("model", list(PAIRS))
def test_structural_names_agree(model):
    ref, port = PAIRS[model]()
    ref_names = list(ref._collect_params_with_prefix())
    port_names = list(port._collect_params_with_prefix())
    assert port_names == ref_names


@pytest.mark.parametrize("model", ["bert", "llama"])
def test_reference_model_file_loads_by_name(model, tmp_path):
    ref, port = PAIRS[model]()
    ref.initialize()
    port.initialize(ctx=CPU)
    # deferred shapes settle at the first forward
    ref(rmx.nd.zeros((1, 8), dtype="int32"))
    port(nd.zeros((1, 8), ctx=CPU, dtype="int32"))
    path = os.path.join(tmp_path, "model.params")
    ref.save_parameters(path)
    port.load_parameters(path, ctx=CPU)
    _params_equal(ref, port)
