"""The port's evaluation metrics (``mxnet_tpu_torch.metric``) held against
the reference's on the CPU: every metric and every short name, fed two
batches of the same seeded labels and predictions (NDArrays of each
package), ``get()`` within 1e-6 (numpy on both sides, fp32 inputs)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as rmx
from mxnet_tpu import metric as ref_metric
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import metric, nd
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()
TOL = 1e-6
N, K = 16, 5


def _mae_sum(label, pred):
    return float(np.abs(label - pred.argmax(axis=1)).sum()), label.size


# (name, args, kwargs, data kind): every metric class, the short names
# create() resolves, a list (a CompositeEvalMetric) and callables
METRICS = [
    ("accuracy", (), {}, "class"),
    ("acc", (), {}, "class"),
    ("topkaccuracy", (), {"top_k": 3}, "class"),
    ("top_k_accuracy", (), {"top_k": 2}, "class"),
    ("top_k_acc", (), {"top_k": 4}, "class"),
    ("f1", (), {}, "binary"),
    ("mcc", (), {}, "binary"),
    ("mae", (), {}, "regression"),
    ("mse", (), {}, "regression"),
    ("rmse", (), {}, "regression"),
    ("crossentropy", (), {}, "prob"),
    ("ce", (), {}, "prob"),
    ("negativeloglikelihood", (), {}, "prob"),
    ("nll_loss", (), {}, "prob"),
    ("perplexity", (), {"ignore_label": 0}, "prob"),
    ("pearsoncorrelation", (), {}, "regression"),
    ("pearsonr", (), {}, "regression"),
    ("loss", (), {}, "loss"),
    (["acc", "ce"], (), {}, "prob"),
    (_mae_sum, (), {"name": "mae_sum"}, "class"),
]


def _batch(kind, seed):
    r = np.random.RandomState(seed)
    if kind == "class":
        return r.randint(0, K, (N,)).astype("float32"), \
            r.rand(N, K).astype("float32")
    if kind == "binary":
        return r.randint(0, 2, (N,)).astype("float32"), \
            r.rand(N, 2).astype("float32")
    if kind == "prob":
        p = r.rand(N, K).astype("float32") + 0.05
        return r.randint(0, K, (N,)).astype("float32"), \
            (p / p.sum(axis=1, keepdims=True)).astype("float32")
    if kind == "loss":
        return None, r.rand(N, 3).astype("float32")
    return r.randn(N).astype("float32"), r.randn(N).astype("float32")


def _feed(m, lib, kind, kw):
    for seed in (0, 1):
        label, pred = _batch(kind, seed)
        labels = [lib.array(label, **kw)] if label is not None else [None]
        m.update(labels, [lib.array(pred, **kw)])


def _values(got):
    name, value = got
    return (name if isinstance(name, list) else [name],
            value if isinstance(value, list) else [value])


@pytest.mark.parametrize("spec,args,kwargs,kind", METRICS,
                         ids=[s if isinstance(s, str) else
                              ("composite" if isinstance(s, list) else
                               "custom") for s, *_ in METRICS])
def test_metric_matches_reference(spec, args, kwargs, kind):
    ref = ref_metric.create(spec, *args, **kwargs)
    port = metric.create(spec, *args, **kwargs)
    assert type(port).__name__ == type(ref).__name__
    _feed(ref, rmx.nd, kind, {})
    _feed(port, nd, kind, {"ctx": CPU})
    (rn, rv), (pn, pv) = _values(ref.get()), _values(port.get())
    assert pn == rn
    np.testing.assert_allclose(pv, rv, rtol=TOL, atol=TOL)
    assert port.get_name_value() == list(zip(pn, pv))
    port.reset()
    ref.reset()
    assert np.isnan(_values(port.get())[1]).all()


@pytest.mark.parametrize("top_k", [1, K, K + 2])
@pytest.mark.parametrize("source", ["ndarray", "numpy"])
def test_top_k_accuracy_edges(top_k, source):
    """TopKAccuracy takes the top k where the scores live (an NDArray's
    on its device, a numpy array's in numpy); k at and beyond the class
    count counts every label, as the reference's slice of its sort does."""
    ref, port = ref_metric.TopKAccuracy(top_k), metric.TopKAccuracy(top_k)
    for seed in (0, 1):
        label, pred = _batch("class", seed)
        ref.update([rmx.nd.array(label)], [rmx.nd.array(pred)])
        port.update([nd.array(label, ctx=CPU)],
                    [nd.array(pred, ctx=CPU) if source == "ndarray"
                     else pred])
    assert port.get()[0] == ref.get()[0]
    np.testing.assert_allclose(port.get()[1], ref.get()[1], rtol=TOL,
                               atol=TOL)


def test_np_metric_and_tensors():
    """``metric.np`` wraps a numpy function; update also takes torch
    tensors (bfloat16 read back as float32)."""
    def err(label, pred):
        return float(np.abs(label - pred).mean())

    ref, port = ref_metric.np(err), metric.np(err)
    label, pred = _batch("regression", 2)
    ref.update([rmx.nd.array(label)], [rmx.nd.array(pred)])
    port.update([torch.from_numpy(label)],
                [torch.from_numpy(pred).to(torch.bfloat16)])
    assert port.get()[0] == ref.get()[0] == "custom(err)"
    bf = torch.from_numpy(pred).to(torch.bfloat16).float().numpy()
    assert port.get()[1] == pytest.approx(err(label, bf), rel=TOL)
    assert abs(port.get()[1] - ref.get()[1]) < 1e-2


def test_composite_add_and_unknown_names():
    comp = metric.CompositeEvalMetric()
    comp.add("acc")
    comp.add(metric.TopKAccuracy(top_k=2))
    label, pred = _batch("class", 3)
    comp.update([nd.array(label, ctx=CPU)], [nd.array(pred, ctx=CPU)])
    names, values = comp.get()
    assert names == ["accuracy", "top_k_accuracy_2"] and len(values) == 2
    with pytest.raises(mx.MXNetError):
        metric.create("no_such_metric")
