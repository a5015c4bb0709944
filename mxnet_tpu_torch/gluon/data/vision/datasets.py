"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; MXNet's
``python/mxnet/gluon/data/vision/datasets.py``): MNIST, FashionMNIST,
CIFAR10/100 read from their published files under ``root`` (nothing is
downloaded: a missing file raises), ImageRecordDataset, ImageFolderDataset,
and ``SyntheticImageDataset``, deterministic images from a seed.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as _np

from ....base import MXNetError
from ..dataset import Dataset, ArrayDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "SyntheticImageDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from local idx-format files (train-images-idx3-ubyte.gz etc.)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._base = "train" if train else "t10k"
        super().__init__(root, train, transform)

    def _get_data(self):
        img = os.path.join(self._root, f"{self._base}-images-idx3-ubyte.gz")
        lbl = os.path.join(self._root, f"{self._base}-labels-idx1-ubyte.gz")
        for p in (img, lbl):
            if not os.path.exists(p):
                raise MXNetError(
                    f"MNIST file {p} not found (nothing is downloaded); "
                    "place the files locally or use SyntheticImageDataset")
        with gzip.open(lbl, "rb") as f:
            struct.unpack(">II", f.read(8))
            label = _np.frombuffer(f.read(), dtype=_np.uint8).astype(_np.int32)
        with gzip.open(img, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = _np.frombuffer(f.read(), dtype=_np.uint8)
            data = data.reshape(n, rows, cols, 1)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        batches = [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]
        data, labels = [], []
        for b in batches:
            p = os.path.join(self._root, "cifar-10-batches-py", b)
            if not os.path.exists(p):
                raise MXNetError(f"CIFAR-10 file {p} not found (nothing is "
                                 "downloaded); place the files locally")
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="latin1")
            data.append(d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            labels.extend(d["labels"])
        self._data = _np.concatenate(data)
        self._label = _np.asarray(labels, dtype=_np.int32)


class CIFAR100(_DownloadedDataset):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=True, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        name = "train" if self._train else "test"
        p = os.path.join(self._root, "cifar-100-python", name)
        if not os.path.exists(p):
            raise MXNetError(f"CIFAR-100 file {p} not found (nothing is "
                             "downloaded)")
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="latin1")
        self._data = d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        key = "fine_labels" if self._fine else "coarse_labels"
        self._label = _np.asarray(d[key], dtype=_np.int32)


class ImageRecordDataset(Dataset):
    """(image, label) of each record of an indexed image RecordIO file."""

    def __init__(self, filename, flag=1, transform=None):
        from ....recordio import MXIndexedRecordIO, unpack_img

        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")
        self._flag = flag
        self._transform = transform
        self._unpack_img = unpack_img

    def __getitem__(self, idx):
        record = self._record.read_idx(self._record.keys[idx])
        header, img = self._unpack_img(record, flag=self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._record.keys)


class ImageFolderDataset(Dataset):
    """``root/<label name>/<image>`` files (.jpg, .jpeg, .png through PIL;
    .npy with numpy), labelled by their folder's sorted position."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if filename.lower().endswith((".jpg", ".jpeg", ".png", ".npy")):
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ....image import imread

        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = _np.load(path)
        else:
            img = imread(path, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class SyntheticImageDataset(Dataset):
    """Deterministic uint8 images and int32 labels from ``seed`` (the
    reference's stand-in for a download)."""

    def __init__(self, length=1024, shape=(32, 32, 3), num_classes=10,
                 transform=None, seed=0):
        self._length = length
        self._shape = tuple(shape)
        self._num_classes = num_classes
        self._transform = transform
        rng = _np.random.RandomState(seed)
        self._data = rng.randint(0, 256, (length,) + self._shape,
                                 dtype=_np.uint8)
        self._label = rng.randint(0, num_classes, (length,)).astype(_np.int32)

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return self._length
