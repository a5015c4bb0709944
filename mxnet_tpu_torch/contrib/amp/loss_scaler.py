"""Dynamic loss scaling (counterpart of
``mxnet_tpu/contrib/amp/loss_scaler.py``).

Needed for float16 (5-bit exponent): gradients below ~6e-5 underflow, so
the loss is multiplied by a large scale before backward and the gradients
divided by it before the update; on overflow (inf/nan gradients) the step
is skipped and the scale divided by ``scale_factor``, and after
``scale_window`` clean steps it is multiplied by it.  bfloat16 shares
fp32's exponent range: its scaler is static at 1 and still reports
overflow.  The agreement of the verdict across processes waits for the
port's collectives.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LossScaler", "nonfinite_total"]


def _float_grads(params):
    return [g._data for p in params
            if p.grad_req != "null" and p._nd is not None
            for g in p.list_grad() if g._data.is_floating_point()]


def nonfinite_total(params):
    """The count of non-finite elements over every float gradient of
    ``params`` as one device scalar (float32), or None when there is no
    float gradient; nothing here reads back to the host (the port's copy
    of the reference's ``guard.nonfinite_total``, three launches a
    gradient: ``has_overflow`` needs only the verdict and takes it in one
    multi-tensor pass)."""
    counts = [torch.sum(torch.isfinite(v).logical_not_(), dtype=torch.float32)
              for v in _float_grads(params)]
    return torch.stack(counts).sum() if counts else None


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_scale=1.0, dynamic=True):
        self.loss_scale = float(init_scale) if dynamic else 1.0
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._min_scale = min_scale
        self._dynamic = dynamic
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient of ``params`` is non-finite: one
        multi-tensor check on the device (torch's AMP check, at an unscale
        of 1, which leaves every value as it is) and one read of its
        flag."""
        grads = _float_grads(params)
        if not grads:
            return False
        found = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found, torch.ones_like(found))
        return bool(found.item())

    def state_dict(self):
        """The scale and the clean-step counter, for an exact resume."""
        return {"loss_scale": float(self.loss_scale),
                "unskipped": int(self._unskipped)}

    def load_state_dict(self, state):
        self.loss_scale = float(state["loss_scale"])
        self._unskipped = int(state["unskipped"])

    def update_scale(self, overflow):
        """Adjust the scale after a step; returns True if the step should
        be skipped (overflow observed)."""
        if not self._dynamic:
            return bool(overflow)
        if overflow:
            self.loss_scale = max(self._min_scale,
                                  self.loss_scale / self._scale_factor)
            self._unskipped = 0
            return True
        self._unskipped += 1
        if self._unskipped >= self._scale_window:
            self.loss_scale = float(
                min(np.finfo(np.float32).max,
                    self.loss_scale * self._scale_factor))
            self._unskipped = 0
        return False
