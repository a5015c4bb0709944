"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``; MXNet's
``python/mxnet/gluon/data/sampler.py``).

Exact-resume contract (lifecycle.capture_train_state): samplers expose
``state_dict()``/``load_state_dict()`` and an optional ``set_epoch(e)``
so a resumed DataLoader can regenerate the SAME index sequence a killed
run was consuming.  ``RandomSampler`` therefore shuffles from its own
seeded RNG — a per-epoch permutation that is a pure function of
``(seed, epoch)`` — instead of the global numpy RNG, whose state at
epoch start is unrecoverable after a preemption.
"""
from __future__ import annotations

import numpy as _np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    # exact-resume hooks: stateless samplers inherit the no-ops
    def state_dict(self):
        return {}

    def load_state_dict(self, state):
        pass


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """Shuffled indices, deterministic per ``(seed, epoch)``.

    ``seed`` defaults to a draw from the global numpy RNG (so unseeded
    behavior still varies run to run) but is RECORDED: ``state_dict()``
    carries it, and a resumed sampler replays the exact permutations.
    Each ``__iter__`` consumes one epoch (the counter advances); a
    driver that owns epoch numbering (DataLoader) pins it with
    ``set_epoch`` instead."""

    def __init__(self, length, seed=None):
        self._length = length
        if seed is None:
            seed = int(_np.random.randint(0, 2 ** 31 - 1))
        self._seed = int(seed)
        self._epoch = 0

    def set_epoch(self, epoch):
        """Pin the epoch the next ``__iter__`` permutes for."""
        self._epoch = int(epoch)

    def __iter__(self):
        rs = _np.random.RandomState(
            (self._seed + self._epoch) % (2 ** 32))
        self._epoch += 1
        return iter(rs.permutation(self._length).tolist())

    def __len__(self):
        return self._length

    def state_dict(self):
        return {"seed": self._seed, "epoch": self._epoch}

    def load_state_dict(self, state):
        if not state:   # state from a stateless sampler config: keep ours
            return
        self._seed = int(state.get("seed", self._seed))
        self._epoch = int(state.get("epoch", self._epoch))


class BatchSampler(Sampler):
    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(f"last_batch must be keep/discard/rollover, "
                                 f"got {self._last_batch}")

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._prev)) // self._batch_size

    def set_epoch(self, epoch):
        se = getattr(self._sampler, "set_epoch", None)
        if se is not None:
            se(epoch)

    def state_dict(self):
        # _prev is the rollover carry consumed at the NEXT epoch's start;
        # capturing it keeps last_batch="rollover" exactly resumable
        return {"sampler": self._sampler.state_dict()
                if hasattr(self._sampler, "state_dict") else {},
                "prev": list(self._prev)}

    def load_state_dict(self, state):
        if hasattr(self._sampler, "load_state_dict"):
            self._sampler.load_state_dict(state.get("sampler") or {})
        self._prev = [int(i) for i in state.get("prev") or []]
