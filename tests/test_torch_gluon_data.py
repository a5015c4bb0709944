"""gluon.data of the port against the reference: datasets, samplers, the
DataLoader (eager, thread pool, spawned process workers), its exact-resume
state crossing both packages, ``lifecycle.capture_train_state`` with a real
loader, the vision datasets read from files in their published formats,
and the vision transforms.

Process workers spawn interpreters, so two tests use them, with two
workers each.
"""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon import data as rdata
from mxnet_tpu_torch import lifecycle
from mxnet_tpu_torch.gluon import data as pdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ptf
from mxnet_tpu.gluon.data.vision import transforms as rtf
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()


def _np(batch):
    if isinstance(batch, (tuple, list)):
        return [_np(b) for b in batch]
    return batch.asnumpy()


def _epoch(loader):
    with CPU:
        return [_np(b) for b in loader]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _equal(x, y)
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def _dataset(pkg, n=23):
    x = np.arange(n * 3, dtype="float32").reshape(n, 3)
    y = np.arange(n, dtype="int32") % 4
    return pkg.ArrayDataset(x, y)


# -- datasets and samplers --------------------------------------------------
def test_datasets_and_transforms_match_reference():
    for pkg in (pdata, rdata):
        ds = pkg.SimpleDataset(list(range(5)))
        assert len(ds) == 5 and ds[3] == 3
    p, r = _dataset(pdata), _dataset(rdata)
    assert len(p) == len(r) == 23
    for i in (0, 7, 22):
        np.testing.assert_array_equal(p[i][0], r[i][0])
        assert p[i][1] == r[i][1]
    pt = p.transform(lambda x, y: (x * 2, y + 1))
    rt = r.transform(lambda x, y: (x * 2, y + 1), lazy=False)
    pf = p.transform_first(lambda x: x - 1, lazy=False)
    rf = r.transform_first(lambda x: x - 1)
    for i in range(23):
        np.testing.assert_array_equal(pt[i][0], rt[i][0])
        np.testing.assert_array_equal(pf[i][0], rf[i][0])
        assert pt[i][1] == rt[i][1] and pf[i][1] == rf[i][1]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_reference_index_for_index(last_batch):
    assert list(pdata.SequentialSampler(5, start=2)) == \
        list(rdata.SequentialSampler(5, start=2))
    p = pdata.BatchSampler(pdata.RandomSampler(23, seed=11), 5, last_batch)
    r = rdata.BatchSampler(rdata.RandomSampler(23, seed=11), 5, last_batch)
    for epoch in range(3):
        p.set_epoch(epoch)
        r.set_epoch(epoch)
        assert list(p) == list(r)
        assert len(p) == len(r)
        assert p.state_dict() == r.state_dict()
    # the permutation is RandomState(seed + epoch)'s
    s = pdata.RandomSampler(23, seed=11)
    s.set_epoch(4)
    assert list(s) == np.random.RandomState(15).permutation(23).tolist()


# -- the DataLoader ---------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(batch_size=5),
    dict(batch_size=5, shuffle=True, last_batch="discard"),
    dict(batch_size=4, num_workers=2, shuffle=True),
    dict(batch_size=6, num_workers=3, last_batch="rollover"),
], ids=["eager", "shuffled", "threads", "threads-rollover"])
def test_dataloader_batches_match_reference(kw):
    np.random.seed(5)
    p = pdata.DataLoader(_dataset(pdata), **kw)
    np.random.seed(5)   # RandomSampler's seed comes from the global RNG
    r = rdata.DataLoader(_dataset(rdata), **kw)
    for _ in range(2):
        got = _epoch(p)
        _equal(got, [_np(b) for b in r])
    assert got[0][0].dtype == np.float32 and got[0][1].dtype == np.int32


def test_dataloader_batches_land_on_the_current_context():
    loader = pdata.DataLoader(_dataset(pdata), batch_size=4, num_workers=2)
    with CPU:
        x, y = next(iter(loader))
    assert x.context == CPU and y.context == CPU
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        next(iter(loader))    # the default context is the card
    with CPU:
        pf = pdata.DataLoader(_dataset(pdata), batch_size=4,
                              prefetch_to_device=CPU, pin_memory=True)
        _equal(_epoch(pf), _epoch(pdata.DataLoader(_dataset(pdata),
                                                   batch_size=4)))


@pytest.mark.parametrize("restore_into", ["port", "reference"])
def test_dataloader_state_dict_crosses_packages(restore_into):
    """A loader's state_dict() from one package, mid-epoch (epoch 1, after
    3 batches), restores the other's loader to the same next batches."""
    src_pkg, dst_pkg = (rdata, pdata) if restore_into == "port" else \
        (pdata, rdata)
    src = src_pkg.DataLoader(_dataset(src_pkg), batch_size=4,
                             sampler=src_pkg.RandomSampler(23, seed=3))
    with CPU:
        list(src)
        it = iter(src)
        for _ in range(3):
            next(it)
        state = src.state_dict()
        want = [_np(b) for b in it]
    assert state["epoch"] == 1 and state["batch"] == 3
    dst = dst_pkg.DataLoader(_dataset(dst_pkg), batch_size=4,
                             sampler=dst_pkg.RandomSampler(23, seed=99))
    dst.load_state_dict(state)
    with CPU:
        _equal([_np(b) for b in dst], want)


def test_capture_train_state_resumes_a_real_loader():
    loader = pdata.DataLoader(_dataset(pdata), batch_size=3, shuffle=True)
    with CPU:
        it = iter(loader)
        for _ in range(4):
            next(it)
        state = lifecycle.capture_train_state(step=4, dataloader=loader)
        want = [_np(b) for b in it]
        fresh = pdata.DataLoader(_dataset(pdata), batch_size=3, shuffle=True)
        assert lifecycle.restore_train_state(state, dataloader=fresh) == 4
        _equal([_np(b) for b in fresh], want)
        # without the restore, a fresh loader starts its own epoch 0
        other = pdata.DataLoader(_dataset(pdata), batch_size=3, shuffle=True)
        assert [b.tolist() for b, _ in
                (_np(x) for x in other)][:len(want)] != \
            [b.tolist() for b, _ in want]


class _WorkerProbe(pdata.Dataset):
    """Records, with every sample, whether its process hides the cards and
    whether it initialised CUDA (the fields phase 12 (c) reads)."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        import torch

        return (np.float32(i), os.environ.get("CUDA_VISIBLE_DEVICES") == "",
                torch.cuda.is_initialized(), os.getpid())


def _probe_batchify(samples):
    """A custom module-level (picklable) batchify: numpy fields, the ids
    doubled."""
    ids, hidden, inited, pids = zip(*samples)
    return (np.asarray(ids) * 2, np.asarray(hidden), np.asarray(inited),
            np.asarray(pids, dtype="int64"))


def test_process_workers_match_threads_and_persist():
    """Spawned workers give the eager and the threaded loader's batches,
    the pool persists across epochs, an abandoned epoch does not hang,
    close() releases the workers (and removes the file the dataset
    reached them through) and the loader stays usable."""
    ds = _dataset(pdata, 12)
    eager = _epoch(pdata.DataLoader(ds, batch_size=5))
    threads = _epoch(pdata.DataLoader(ds, batch_size=5, num_workers=2))
    with pdata.DataLoader(ds, batch_size=5, num_workers=2,
                          thread_pool=False) as dl:
        procs = _epoch(dl)
        pool, path = dl._proc_pool, dl._pool_file
        assert pool is not None and os.path.exists(path)
        _equal(_epoch(dl), procs)
        assert dl._proc_pool is pool
        with CPU:
            for _ in iter(dl):
                break           # abandoned mid-epoch
    assert dl._proc_pool is None
    assert not os.path.exists(path)     # the workers' dataset file is gone
    _equal(eager, threads)
    _equal(eager, procs)
    _equal(_epoch(dl), procs)    # a fresh pool on demand
    dl.close()


def test_process_workers_never_see_a_card():
    """Every worker hides the cards (CUDA_VISIBLE_DEVICES empty), reports
    CUDA uninitialised and runs in a spawned process of its own, while the
    parent's environment is left as it was; a custom batchify runs in the
    workers."""
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    with pdata.DataLoader(_WorkerProbe(), batch_size=2, num_workers=2,
                          thread_pool=False,
                          batchify_fn=_probe_batchify) as dl:
        batches = _epoch(dl)
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == before
    ids, hidden, inited, pids = (np.concatenate([b[k] for b in batches])
                                 for k in range(4))
    np.testing.assert_array_equal(ids, np.arange(6) * 2)
    assert hidden.all() and not inited.any()
    assert os.getpid() not in set(pids.tolist())


# -- vision datasets from published files -----------------------------------
def _write_mnist(root, base, n=7, rows=5, cols=4):
    rng = np.random.RandomState(1)
    os.makedirs(root, exist_ok=True)
    with gzip.open(os.path.join(root, f"{base}-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols))
        f.write(rng.randint(0, 256, n * rows * cols).astype("uint8")
                .tobytes())
    with gzip.open(os.path.join(root, f"{base}-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(rng.randint(0, 10, n).astype("uint8").tobytes())


def _write_cifar(root):
    rng = np.random.RandomState(2)
    d10 = os.path.join(root, "c10", "cifar-10-batches-py")
    os.makedirs(d10)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(d10, name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (3, 3072))
                         .astype("uint8"),
                         "labels": rng.randint(0, 10, 3).tolist()}, f)
    d100 = os.path.join(root, "c100", "cifar-100-python")
    os.makedirs(d100)
    for name in ("train", "test"):
        with open(os.path.join(d100, name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (4, 3072))
                         .astype("uint8"),
                         "fine_labels": rng.randint(0, 100, 4).tolist(),
                         "coarse_labels": rng.randint(0, 20, 4).tolist()},
                        f)


def test_vision_datasets_read_the_published_formats(tmp_path):
    from mxnet_tpu.gluon.data import vision as rv
    from mxnet_tpu_torch.gluon.data import vision as pv

    _write_mnist(str(tmp_path / "mnist"), "train")
    _write_mnist(str(tmp_path / "mnist"), "t10k", n=3)
    _write_cifar(str(tmp_path))
    cases = [("MNIST", dict(root=str(tmp_path / "mnist"))),
             ("MNIST", dict(root=str(tmp_path / "mnist"), train=False)),
             ("FashionMNIST", dict(root=str(tmp_path / "mnist"))),
             ("CIFAR10", dict(root=str(tmp_path / "c10"))),
             ("CIFAR10", dict(root=str(tmp_path / "c10"), train=False)),
             ("CIFAR100", dict(root=str(tmp_path / "c100"))),
             ("CIFAR100", dict(root=str(tmp_path / "c100"),
                               fine_label=False, train=False)),
             ("SyntheticImageDataset", dict(length=9, seed=4))]
    for name, kw in cases:
        p, r = getattr(pv, name)(**kw), getattr(rv, name)(**kw)
        assert len(p) == len(r) > 0, name
        for i in range(len(p)):
            np.testing.assert_array_equal(p[i][0], r[i][0])
            assert p[i][1] == r[i][1] and \
                np.asarray(p[i][1]).dtype == np.asarray(r[i][1]).dtype
    with pytest.raises(mx.MXNetError, match="not found"):
        pv.CIFAR10(root=str(tmp_path / "nowhere"))


def test_image_record_and_folder_datasets(tmp_path):
    from mxnet_tpu.gluon.data import vision as rv
    from mxnet_tpu_torch import recordio as rio
    from mxnet_tpu_torch.gluon.data import vision as pv

    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = rio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(3)
    for i in range(5):
        w.write_idx(i, rio.pack_img(rio.IRHeader(0, float(i), i, 0),
                                    rng.randint(0, 255, (6, 5, 3))
                                    .astype("uint8")))
    w.close()
    for cls in ("ImageRecordDataset",):
        p, r = getattr(pv, cls)(rec), getattr(rv, cls)(rec)
        for i in range(5):
            np.testing.assert_array_equal(p[i][0], r[i][0])
            assert p[i][1] == r[i][1]
    raw = pdata.RecordFileDataset(rec)
    assert len(raw) == 5 and raw[2] == rdata.RecordFileDataset(rec)[2]
    for label in ("cat", "dog"):
        os.makedirs(tmp_path / "folder" / label)
        for j in range(2):
            np.save(tmp_path / "folder" / label / f"{j}.npy",
                    rng.randint(0, 255, (4, 4, 3)).astype("uint8"))
    p = pv.ImageFolderDataset(str(tmp_path / "folder"))
    r = rv.ImageFolderDataset(str(tmp_path / "folder"))
    assert p.synsets == r.synsets == ["cat", "dog"]
    for i in range(4):
        np.testing.assert_array_equal(p[i][0], r[i][0])
        assert p[i][1] == r[i][1]


# -- vision transforms ------------------------------------------------------
def _img(shape=(13, 17, 3), seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype("uint8")


@pytest.mark.parametrize("name,args", [
    ("ToTensor", ()), ("Normalize", ((0.4, 0.5, 0.6), (0.2, 0.3, 0.25))),
    ("Cast", ("float16",)), ("CenterCrop", ((8, 6),)),
    ("RandomHorizontalFlip", ()), ("RandomVerticalFlip", ()),
    ("RandomBrightness", (0.3,)), ("RandomContrast", (0.3,)),
    ("RandomSaturation", (0.3,)), ("RandomLighting", (0.1,)),
    ("RandomColorJitter", (0.2, 0.2, 0.2)),
])
def test_numpy_transforms_equal_reference(name, args):
    src = _img()
    if name == "Normalize":
        src = src.transpose(2, 0, 1).astype("float32") / 255
    for seed in range(3):
        np.random.seed(seed)
        with CPU:
            got = getattr(ptf, name)(*args)(src).asnumpy()
        np.random.seed(seed)
        want = getattr(rtf, name)(*args)(src).asnumpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _resize_close(got, want):
    """fp32 within 1e-5; uint8 at most one level off, on under 1% of the
    pixels (a value within rounding of an integer truncates either way)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resize_transforms_match_reference(dtype):
    src = _img((31, 23, 3)).astype(dtype)
    for t_args in (((11, 9),), ((40, 50),), (12, True)):
        with CPU:
            got = ptf.Resize(*t_args)(src).asnumpy()
        _resize_close(got, rtf.Resize(*t_args)(src).asnumpy())
    for seed in range(3):
        np.random.seed(seed)
        with CPU:
            got = ptf.RandomResizedCrop(10)(src).asnumpy()
        np.random.seed(seed)
        _resize_close(got, rtf.RandomResizedCrop(10)(src).asnumpy())
    with CPU:
        composed = ptf.Compose([ptf.Resize(16), ptf.CenterCrop(12),
                                ptf.ToTensor()])(src).asnumpy()
    want = rtf.Compose([rtf.Resize(16), rtf.CenterCrop(12),
                        rtf.ToTensor()])(src).asnumpy()
    np.testing.assert_allclose(composed, want, atol=1 / 255 + 1e-6)


def test_reference_package_stays_the_reference():
    assert rmx.gluon.data.DataLoader is not pdata.DataLoader
