"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``): Accuracy,
TopKAccuracy, F1, MCC, MAE, MSE, RMSE, CrossEntropy, NegativeLogLikelihood,
Perplexity, PearsonCorrelation, Loss, CustomMetric, ``np()``,
CompositeEvalMetric, ``create`` and the reference's short names.  Each
``update`` reads its labels and predictions back to the host and
accumulates in numpy, as the reference does."""
from __future__ import annotations

import math

import numpy as _np
import torch

from .base import Registry, MXNetError

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC", "MAE",
           "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "PearsonCorrelation", "Loss", "CustomMetric",
           "CompositeEvalMetric", "create", "np"]

_REG = Registry("metric")


def register(cls):
    _REG.register(cls)
    return cls


# reference short names (python/mxnet/metric.py registers these aliases)
_ALIASES = {"acc": "accuracy", "ce": "crossentropy", "nll_loss":
            "negativeloglikelihood", "top_k_accuracy": "topkaccuracy",
            "top_k_acc": "topkaccuracy", "pearsonr": "pearsoncorrelation"}


def create(metric, *args, **kwargs):
    if isinstance(metric, str):
        metric = _ALIASES.get(metric.lower(), metric)
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return _REG.create(metric, *args, **kwargs)


def _to_np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return _np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def _check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise MXNetError(f"label/pred count mismatch: {len(labels)} vs "
                         f"{len(preds)}")


def _argmax(pred, axis):
    """``pred``'s argmax along ``axis``, taken where ``pred`` lives (the
    first maximum, as numpy's): a device array's scores are not read back
    whole."""
    if hasattr(pred, "_data"):
        pred = pred._data
    if isinstance(pred, torch.Tensor):
        return torch.argmax(pred.detach(), dim=axis)
    return _np.asarray(pred).argmax(axis=axis)


def _top_k(pred, k):
    """The indices of ``pred``'s ``k`` largest scores along axis 1, taken
    where ``pred`` lives, so that only (batch, k) indices are read back
    (scores tied at the k-th place may be picked otherwise than by
    numpy's sort, which fixes no order among them either)."""
    if hasattr(pred, "_data"):
        pred = pred._data
    if isinstance(pred, torch.Tensor):
        k = min(k, pred.shape[1])
        return torch.topk(pred.detach(), k, dim=1).indices.cpu().numpy()
    return _np.argsort(-_np.asarray(pred), axis=1)[:, :k]


@register
class Accuracy(EvalMetric):
    """The share of predictions equal to the labels; scores with more
    axes than the labels are reduced by argmax along ``axis`` first, on
    their device."""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        _check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label)
            if len(pred.shape) > label.ndim:
                pred = _argmax(pred, self.axis)
            pred = _to_np(pred)
            pred = pred.astype("int32").ravel()
            label = label.astype("int32").ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).astype("int32").ravel()
            arg = _top_k(pred, self.top_k)
            self.sum_metric += (arg == label[:, None]).any(axis=1).sum()
            self.num_inst += len(label)


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = 0

    def reset(self):
        super().reset()
        if hasattr(self, "tp"):
            self.reset_stats()

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel().astype("int32")
            pred = _to_np(pred)
            pred = _binary_pred(pred)
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())
            prec = self.tp / max(self.tp + self.fp, 1)
            rec = self.tp / max(self.tp + self.fn, 1)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self.tp = self.fp = self.fn = self.tn = 0

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = self.tn = 0

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel().astype("int32")
            pred = _to_np(pred)
            pred = _binary_pred(pred)
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())
            self.tn += int(((pred == 0) & (label == 0)).sum())
            denom = math.sqrt((self.tp + self.fp) * (self.tp + self.fn) *
                              (self.tn + self.fp) * (self.tn + self.fn))
            mcc = (self.tp * self.tn - self.fp * self.fn) / denom \
                if denom else 0.0
            self.sum_metric = mcc
            self.num_inst = 1


def _binary_pred(pred):
    """Binary predictions: column 1 of (n, 2) probabilities, else the
    values themselves, above 0.5."""
    p = pred[:, 1] if pred.ndim == 2 else pred.ravel()
    return (p > 0.5).astype("int32")


def _align_label(label, pred):
    """Reference behavior: 1-d labels broadcast against (n, k) preds."""
    if label.shape == pred.shape:
        return label
    if label.ndim == 1:
        label = label.reshape(label.shape[0], 1)
    if label.size == pred.size:
        return label.reshape(pred.shape)
    return label  # rely on numpy broadcasting


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            err = _np.abs(_align_label(label, pred) - pred).mean()
            self.sum_metric += err * len(label)
            self.num_inst += len(label)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            err = ((_align_label(label, pred) - pred) ** 2).mean()
            self.sum_metric += err * len(label)
            self.num_inst += len(label)


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            err = ((_align_label(label, pred) - pred) ** 2).mean()
            self.sum_metric += math.sqrt(err) * len(label)
            self.num_inst += len(label)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype("int32")
            pred = _to_np(pred)
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += len(label)


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype("int32")
            pred = _to_np(pred).reshape(-1, _to_np(pred).shape[-1])
            prob = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = _np.where(ignore, 1.0, prob)
                num -= int(ignore.sum())
            loss += -_np.log(_np.maximum(prob, 1e-10)).sum()
            num += len(label)
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label).ravel(), _to_np(pred).ravel()
            r = _np.corrcoef(label, pred)[0, 1]
            self.sum_metric += r
            self.num_inst += 1


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = _to_np(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            v = self._feval(_to_np(label), _to_np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", name)
    return CustomMetric(feval, name=feval.__name__,
                        allow_extra_outputs=allow_extra_outputs)


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
