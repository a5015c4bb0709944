"""The Estimator training loop (counterpart of
``mxnet_tpu/gluon/contrib/estimator.py``): ``fit()`` drives a net, its
loss, its Trainer and metrics over batches, polls
``lifecycle.check_stop()`` at every batch boundary and, on a stop,
publishes a final synchronous checkpoint before it raises
``lifecycle.GracefulExit``."""
from __future__ import annotations

import time

from ... import autograd
from ... import lifecycle as _lifecycle
from ... import metric as metric_mod
from ... import telemetry as _telemetry
from ...base import MXNetError

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd"]


class EventHandler:
    pass


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class Estimator:
    """A ``fit()`` loop over a net, a loss, a Trainer and metrics."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None, val_metrics=None):
        self.net = net
        self.loss = loss
        self.train_metrics = [metric_mod.create(m) for m in
                              (train_metrics or ["accuracy"])]
        self.trainer = trainer
        self.context = context
        # batches trained across fit() calls: the step number of the
        # preemption checkpoint and of capture_train_state
        self.global_step = 0

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batch_size=None, telemetry=False, checkpoint_manager=None):
        """Train for ``epochs`` over ``train_data`` (an iterable of
        ``(data, label)`` batches); returns each epoch's metrics and
        throughput.

        ``telemetry=True`` opens a telemetry step per batch, with the
        phases ``data``, ``forward_backward`` and ``optimizer``.

        Preemption: every batch boundary polls ``lifecycle.check_stop()``.
        On a stop, a synchronous checkpoint of the net, the Trainer and
        the exact-resume train state (a loader's position, the RNG, the
        step) is published through ``checkpoint_manager`` (when one is
        passed and ``MXNET_PREEMPTION_CHECKPOINT`` allows), then
        ``lifecycle.GracefulExit`` is raised.  The checkpoint is numbered
        by ``global_step``: give ``fit`` a directory of its own, as an
        epoch-numbered save there would sort below it."""
        if self.trainer is None:
            raise MXNetError("Estimator needs a trainer")
        history = []
        for epoch in range(epochs):
            for m in self.train_metrics:
                m.reset()
            tic = time.time()
            nsamples = 0
            it = iter(train_data)
            while True:
                if telemetry:
                    _telemetry.step_begin()
                with _telemetry.maybe_phase(telemetry, "data"):
                    batch = next(it, None)
                if batch is None:
                    if telemetry:
                        _telemetry.step_abort()
                    break
                data, label = batch[0], batch[1]
                bs = data.shape[0]
                with _telemetry.maybe_phase(telemetry, "forward_backward"):
                    with autograd.record():
                        out = self.net(data)
                        loss = self.loss(out, label)
                    loss.backward()
                with _telemetry.maybe_phase(telemetry, "optimizer"):
                    self.trainer.step(bs)
                nsamples += bs
                self.global_step += 1
                for m in self.train_metrics:
                    m.update([label], [out])
                if telemetry:
                    _telemetry.step_end()
                if _lifecycle.check_stop():
                    self._stop_gracefully(train_data, checkpoint_manager)
            elapsed = time.time() - tic
            stats = {name: val for name, val in
                     (m.get() for m in self.train_metrics)}
            stats["throughput"] = nsamples / max(elapsed, 1e-9)
            stats["epoch"] = epoch
            history.append(stats)
        return history

    def _stop_gracefully(self, train_data, checkpoint_manager):
        """Publish the final synchronous checkpoint (weights, optimizer,
        train state) and raise GracefulExit."""
        step = self.global_step
        if checkpoint_manager is not None:
            train_state = _lifecycle.capture_train_state(
                step=step,
                dataloader=train_data if hasattr(train_data, "state_dict")
                else None,
                trainer=self.trainer)
            _lifecycle.publish_final_checkpoint(
                checkpoint_manager, step, self.net, self.trainer,
                train_state=train_state)
        raise _lifecycle.GracefulExit(
            _lifecycle.stop_reason() or "stop requested", step=step)
