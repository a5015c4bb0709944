"""Automatic mixed precision (counterpart of
``mxnet_tpu/contrib/amp/amp.py``).

Every op call funnels through ``ndarray.invoke``, so one hook there applies
the cast policy of :mod:`.lists` at op level, by op name: a listed op's
float inputs are cast inside the call, so torch autograd casts the
gradients back to the fp32 master weights.  This is the reference's policy
op for op; ``torch.autocast`` is not used, because its op lists are not
these.

Loss scaling for a Gluon ``Trainer``: ``init_trainer`` attaches a
:class:`LossScaler` (static 1 for bfloat16, dynamic for float16) and makes
``trainer.step`` skip the update on a non-finite gradient; ``scale_loss``
scales the loss for backward and ``unscale`` divides the gradients back,
once per step, for clipping between backward and step.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ...base import MXNetError, torch_dtype
from ...ndarray.ndarray import _AMP
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "disable", "init_trainer", "scale_loss", "unscale",
           "convert_model", "convert_hybrid_block", "list_fp16_ops",
           "list_fp32_ops"]

_DEFAULT_TARGET = "bfloat16"


def _make_wrap(target_dtype, target_ops, fp32_ops):
    tgt = torch_dtype(target_dtype)

    def wrap(od, fn):
        if od.name in target_ops:
            to = tgt
        elif od.name in fp32_ops:
            to = torch.float32
        else:
            return fn

        def cast_fn(*tensors):
            return fn(*(t.to(to) if t.is_floating_point() and t.dtype != to
                        else t for t in tensors))

        return cast_fn

    return wrap


def init(target_dtype=_DEFAULT_TARGET, target_dtype_ops=None, fp32_ops=None,
         conditional_fp32_ops=None, excluded_sym_names=None):
    """Enable AMP globally (reference: amp.init): 'bfloat16' (no loss
    scaling needed) or 'float16' (pair it with a dynamic LossScaler via
    init_trainer).  ``target_dtype_ops`` and ``fp32_ops`` replace the
    default lists."""
    if target_dtype not in ("bfloat16", "float16"):
        raise MXNetError(f"unsupported AMP target_dtype {target_dtype!r}")
    t_ops = frozenset(target_dtype_ops if target_dtype_ops is not None
                      else lists.TARGET_DTYPE_OPS)
    f_ops = frozenset(fp32_ops if fp32_ops is not None else lists.FP32_OPS)
    _AMP.update(on=True, target=target_dtype,
                wrap=_make_wrap(target_dtype, t_ops, f_ops))


def disable():
    """Turn AMP off."""
    _AMP.update(on=False, target=None, wrap=None)


@contextmanager
def _cast_scope(target_dtype=_DEFAULT_TARGET):
    """Scoped AMP: ``TrainStep(dtype=...)`` runs the model's forward under
    the policy without flipping global state for the caller."""
    prev = dict(_AMP)
    try:
        init(target_dtype)
        yield
    finally:
        _AMP.update(prev)


def init_trainer(trainer, loss_scaler=None):
    """Attach loss scaling to a Gluon Trainer (reference: amp.init_trainer):
    its ``step()`` skips the update when a gradient is non-finite, and
    then updates the scale.  Default scaler: dynamic under float16, static
    at 1 under bfloat16.  With the numerical-integrity guard,
    ``guard.attach`` comes after this (its step then owns the verdict and
    the scale, one host read); a guard-attached trainer raises."""
    if not _AMP["on"]:
        raise MXNetError("call amp.init() before amp.init_trainer()")
    if getattr(trainer, "_guard", None) is not None:
        raise MXNetError(
            "amp.init_trainer on a guard-attached trainer: attach order "
            "is amp first, then guard.attach (the guard step subsumes "
            "the AMP overflow sync)")
    if loss_scaler is None:
        loss_scaler = LossScaler(dynamic=(_AMP["target"] == "float16"))
    trainer._amp_loss_scaler = loss_scaler
    trainer._amp_original_scale = trainer._scale
    trainer._amp_unscaled = False

    orig_step = trainer.step

    def amp_step(batch_size, ignore_stale_grad=False):
        scaler = trainer._amp_loss_scaler
        overflow = scaler.has_overflow(trainer._params)
        if not overflow:
            # gradients unscale() already divided are not divided again
            eff = 1.0 if trainer._amp_unscaled else scaler.loss_scale
            trainer._scale = trainer._amp_original_scale / eff
            orig_step(batch_size, ignore_stale_grad=ignore_stale_grad)
            trainer._scale = trainer._amp_original_scale
        trainer._amp_unscaled = False
        scaler.update_scale(overflow)

    trainer.step = amp_step
    return trainer


@contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``"""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        yield loss
        return
    s = scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield type(loss)(l * s for l in loss)
    else:
        yield loss * s


def unscale(trainer):
    """Divide the current gradients by the loss scale in place, for
    clipping between backward and step; one multi-tensor multiply.  Once
    per step: a second call before ``trainer.step()`` does nothing, and
    the step does not divide again."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    if trainer._amp_unscaled:
        return
    grads = [g._data for p in trainer._params
             if p.grad_req != "null" and p._nd is not None
             for g in p.list_grad()]
    with torch.no_grad():
        torch._foreach_mul_(grads, 1.0 / scaler.loss_scale)
    trainer._amp_unscaled = True


def convert_model(block, target_dtype=_DEFAULT_TARGET,
                  excluded_params=("gamma", "beta", "moving_mean",
                                   "moving_var", "running_mean",
                                   "running_var")):
    """Cast a trained block's float parameters to ``target_dtype`` for
    inference (reference: amp.convert_model); the norm layers' parameters
    (names ending in ``excluded_params``) stay fp32."""
    for name, p in block.collect_params().items():
        if any(name.endswith(sfx) for sfx in excluded_params):
            continue
        if p._nd is None or not p._nd._data.is_floating_point():
            continue
        p.cast(target_dtype)
    return block


convert_hybrid_block = convert_model


def list_fp16_ops():
    return list(lists.TARGET_DTYPE_OPS)


def list_fp32_ops():
    return list(lists.FP32_OPS)
