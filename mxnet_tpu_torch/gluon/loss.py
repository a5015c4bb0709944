"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``): L1, L2,
sigmoid binary and softmax cross-entropy, KL divergence, CTC, Huber, hinge,
squared hinge, logistic, triplet and cosine-embedding losses.  Each
returns the per-sample loss: the mean over every axis but the batch axis
(CTC, triplet and cosine embedding: one value per sample by
construction)."""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L1Loss", "L2Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "CosineEmbeddingLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return f"{type(self).__name__}(batch_axis={self._batch_axis}, " \
            f"w={self._weight})"


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L2Loss(Loss):
    """weight / 2 * (label - pred)^2."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    F.Activation(-F.abs(pred), act_type="softrelu")
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * \
                    (F.Activation(-F.abs(pred), act_type="softrelu")
                     + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label +
                         F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight) +
                         F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """-log softmax(pred)[label] for a sparse (class-index) label, or
    -sum(label * log softmax(pred)) for a dense one; ``from_logits`` means
    ``pred`` is already a log-probability."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class CTCLoss(Loss):
    def __init__(self, layout="NTC", label_layout="NT", weight=None, **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, 0, 1)
        if self._label_layout == "TN":
            label = F.swapaxes(label, 0, 1)
        args = [pred, label]
        if pred_lengths is not None:
            args.append(pred_lengths)
        if label_lengths is not None:
            args.append(label_lengths)
        # CTCLoss op takes lengths positionally: label_lengths alone would
        # land in the data_lengths slot
        if pred_lengths is None and label_lengths is not None:
            raise ValueError("label_lengths requires pred_lengths too")
        loss = F.CTCLoss(*args,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = input1.reshape((input1.shape[0], -1))
        input2 = input2.reshape((input2.shape[0], -1))
        sim = F.sum(input1 * input2, axis=1) / (
            F.norm(input1, axis=1) * F.norm(input2, axis=1) + 1e-12)
        label = label.reshape((-1,))
        loss = F.where(label == 1, 1 - sim, F.relu(sim - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)
