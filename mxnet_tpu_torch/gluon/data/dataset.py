"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``; MXNet's
``python/mxnet/gluon/data/dataset.py``)."""
from __future__ import annotations

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, "all arrays must have the same length"
            self._data.append(a)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The raw records of an indexed RecordIO file (``.rec`` beside its
    ``.idx``), in the index's order."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO

        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
