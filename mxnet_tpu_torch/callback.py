"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``):
``Speedometer``, ``do_checkpoint``, ``log_train_metric`` and
``ProgressBar``."""
from __future__ import annotations

import logging
import sys
import time

from . import telemetry as _tel

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric", "ProgressBar"]


class Speedometer:
    """Logs samples/sec every ``frequent`` batches (wall clock between
    calls).  ``telemetry=True`` also sets the
    ``mxnet_speedometer_samples_per_sec`` gauge and adds to
    ``mxnet_speedometer_batches_total``, so the speed can be scraped from
    a running job."""

    def __init__(self, batch_size, frequent=50, auto_reset=True,
                 telemetry=False):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset
        self.telemetry = telemetry

    def _emit(self, speed):
        _tel.gauge("mxnet_speedometer_samples_per_sec",
                   "throughput over the last Speedometer window").set(speed)
        _tel.counter("mxnet_speedometer_batches_total",
                     "batches seen by Speedometer").inc(self.frequent)

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                if self.telemetry:
                    self._emit(speed)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec\t%s", param.epoch, count,
                                 speed, "\t".join(f"{n}={v:f}"
                                                  for n, v in name_value))
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """An epoch-end callback ``(iter_no, sym, arg, aux)`` that saves
    ``arg:``/``aux:``-tagged parameters to ``<prefix>-<epoch>.params``
    every ``period`` epochs, and the symbol, when given, to
    ``<prefix>-symbol.json`` (so ``mx.mod.Module.load`` reads the
    checkpoint, as MXNet's ``save_checkpoint`` writes it)."""
    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            from .ndarray.serialization import save

            if sym is not None:
                sym.save(f"{prefix}-symbol.json")

            data = {}
            if arg:
                data.update({f"arg:{k}": v for k, v in arg.items()})
            if aux:
                data.update({f"aux:{k}": v for k, v in aux.items()})
            save(f"{prefix}-{iter_no + 1:04d}.params", data)

    return _callback


def log_train_metric(period, auto_reset=False):
    """A batch-end callback that logs the metric every ``period``
    batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class ProgressBar:
    """Draws ``count / total`` as a bar on stdout."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, count):
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = round(100.0 * count / float(self.total), 1)
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write(f"[{prog_bar}] {percents}%\r")
        sys.stdout.flush()
