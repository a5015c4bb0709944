"""Monitor: a per-step tap of tensor statistics (counterpart of
``mxnet_tpu/monitor.py``).  Installed on a Gluon block it sees each
block's outputs (forward hooks); on an Executor (``Module.install_monitor``)
each node's outputs and, at ``toc``, the arguments, filtered by a regular
expression on their names."""
from __future__ import annotations

import re

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                return x.norm() / (x.size ** 0.5)
        self.stat_func = stat_func
        self.interval = interval
        self.queue = []
        self.step = 0
        self.activated = False
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.exes = []

    def _stat(self, name, arr):
        if self.activated and self.re_pattern.match(name):
            self.queue.append((self.step, name, self.stat_func(arr)))

    def install(self, target):
        """Tap an Executor's node outputs, or a Gluon block tree's block
        outputs."""
        from .executor import Executor

        if isinstance(target, Executor):
            target.set_monitor_callback(self._stat)
            self.exes.append(target)
            return

        def hook(blk, inputs, output):
            outs = output if isinstance(output, (list, tuple)) else [output]
            for i, o in enumerate(outs):
                if isinstance(o, NDArray):
                    self._stat(f"{blk.name}_output{i}", o)

        target.apply(lambda b: b.register_forward_hook(hook))

    def tic(self):
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []

    def toc(self):
        if not self.activated:
            return []
        for exe in self.exes:
            for name, arr in exe.arg_dict.items():
                self._stat(name, arr)
        self.activated = False
        res = []
        for n, k, v_nd in self.queue:
            res.append((n, k, str(v_nd.asnumpy())))
        self.queue = []
        self.step += 1
        if self.sort:
            res.sort(key=lambda x: x[1])
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            print(f"Batch: {n:7d} {k:30s} {v}")
