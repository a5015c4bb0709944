"""mx.io and mx.image of the port against the reference.

- ``ImageRecordIter``: batches equal to the reference's bit for bit (crop,
  mirror, mean/std, shuffle over two epochs, a padded tail) at 1 and at 4
  decode threads, and with ``resize`` (PIL) as well; its grayscale and
  ``round_batch=False`` shapes;
- ``NDArrayIter``, ``CSVIter``, ``MNISTIter`` and ``LibSVMIter`` (its CSR
  parts, the wrapped tail and ``pad``), ``ResizeIter`` and
  ``PrefetchingIter``: batches equal to the reference's;
- the augmenters and ``CreateAugmenter``/``CreateDetAugmenter`` under one
  ``np.random.seed``: equal where the reference computes in numpy;
  ``imresize`` within 1e-5 in fp32 and, in uint8, at most one level off on
  under 1% of the pixels; ``ImageIter`` and ``ImageDetIter`` batches.
"""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import image as rimg
from mxnet_tpu import io as rio_
from mxnet_tpu import recordio as ref_rio
from mxnet_tpu_torch import image as pimg
from mxnet_tpu_torch import io as pio
from mxnet_tpu_torch import recordio as rio
from torch_threads import one_torch_thread  # noqa: F401

CPU = mx.cpu()


def _rec(tmp_path, n=21, hw=(36, 40), seed=0, name="i"):
    rec, idx = str(tmp_path / f"{name}.rec"), str(tmp_path / f"{name}.idx")
    w = rio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = rng.randint(0, 255, hw + (3,)).astype("uint8")
        w.write_idx(i, rio.pack_img(rio.IRHeader(0, float(i % 7), i, 0),
                                    img))
    w.close()
    return rec, idx


def _batches(it, limit=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        if limit and len(out) == limit:
            break
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (d, l, p), (rd, rl, rp) in zip(got, want):
        assert d.dtype == rd.dtype and d.shape == rd.shape
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(l, rl)
        assert p == rp


IMAGENET = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
                std_g=57.12, std_b=57.375)


@pytest.mark.parametrize("kw", [
    dict(data_shape=(3, 28, 32), rand_crop=True, rand_mirror=True,
         shuffle=True, seed=3, **IMAGENET),
    dict(data_shape=(3, 36, 40)),
    dict(data_shape=(3, 24, 24), resize=30, rand_crop=True, seed=1),
    dict(data_shape=(3, 48, 48), rand_mirror=True),
    dict(data_shape=(1, 20, 20), num_parts=2, part_index=1, shuffle=True),
], ids=["crop-mirror-shuffle", "center", "resize", "upscale", "gray-shard"])
def test_image_record_iter_matches_reference(tmp_path, kw):
    rec, _ = _rec(tmp_path)
    ref = rio_.ImageRecordIter(path_imgrec=rec, batch_size=8, **kw)
    want = [_batches(ref)]
    ref.reset()
    want.append(_batches(ref))
    for threads in (1, 4):
        with CPU:
            it = pio.ImageRecordIter(path_imgrec=rec, batch_size=8,
                                     preprocess_threads=threads, **kw)
            got = [_batches(it)]
            it.reset()
            got.append(_batches(it))
        it.close()
        for g, w in zip(got, want):
            _same(g, w)
    assert got[0][-1][2] == 8 * len(got[0]) - (21 if "num_parts" not in kw
                                                else 10)


def test_image_record_iter_shapes_and_context(tmp_path):
    rec, _ = _rec(tmp_path, n=13)
    with CPU:
        it = pio.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 8),
                                 batch_size=4, round_batch=False)
    sizes = [b.data[0].shape[0] for b in it]
    assert sizes == [4, 4, 4, 1]
    with CPU:
        it = pio.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 8),
                                 batch_size=4)
    # made under the CPU context: its batches stay there on any thread
    batch = next(it)
    assert batch.data[0].context == CPU
    assert it.provide_data[0].shape == (4, 3, 8, 8)
    assert it.provide_label[0].shape == (4,)
    it.close()
    with pytest.raises(mx.MXNetError):
        it.next()


def test_ndarray_csv_mnist_iters_match_reference(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(11, 2, 3).astype("f")
    y = rng.randint(0, 3, 11).astype("f")
    for kw in (dict(last_batch_handle="pad"),
               dict(last_batch_handle="discard"),
               dict(shuffle=True)):
        np.random.seed(4)
        with CPU:
            p = pio.NDArrayIter(x, y, batch_size=4, **kw)
            got = _batches(p)
        np.random.seed(4)
        _same(got, _batches(rio_.NDArrayIter(x, y, batch_size=4, **kw)))
        assert p.provide_data[0].shape == (4, 2, 3)

    dpath, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dpath, x.reshape(11, 6), delimiter=",")
    np.savetxt(lpath, y[:, None], delimiter=",")
    for kw in (dict(batch_size=4), dict(batch_size=25),
               dict(batch_size=4, round_batch=False)):
        with CPU:
            got = _batches(pio.CSVIter(data_csv=dpath, data_shape=(2, 3),
                                       label_csv=lpath, **kw))
        _same(got, _batches(rio_.CSVIter(data_csv=dpath, data_shape=(2, 3),
                                         label_csv=lpath, **kw)))

    images = rng.randint(0, 256, (10, 5, 5)).astype(np.uint8)
    labels = rng.randint(0, 10, (10,)).astype(np.uint8)
    ipath, l2 = str(tmp_path / "img.idx.gz"), str(tmp_path / "lbl.idx")
    with gzip.open(ipath, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, 8, 3))
        f.write(struct.pack(">III", *images.shape))
        f.write(images.tobytes())
    with open(l2, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, 8, 1))
        f.write(struct.pack(">I", labels.shape[0]))
        f.write(labels.tobytes())
    for kw in (dict(flat=False), dict(flat=True, shuffle=True, seed=7)):
        with CPU:
            p = pio.MNISTIter(image=ipath, label=l2, batch_size=4, **kw)
            got = _batches(p)
            p.reset()
            got += _batches(p)
        r = rio_.MNISTIter(image=ipath, label=l2, batch_size=4, **kw)
        want = _batches(r)
        r.reset()
        _same(got, want + _batches(r))
    with pytest.raises(mx.MXNetError):
        pio.MNISTIter(image=dpath, label=l2)


def _csr_parts(csr):
    return (csr.data.asnumpy(), csr.indices.asnumpy(), csr.indptr.asnumpy(),
            csr.shape)


@pytest.mark.parametrize("batch_size", [2, 3, 12])
def test_libsvm_iter_matches_reference(tmp_path, batch_size):
    """CSR batches part for part (data, indices, indptr, shape), the
    labels, the tail wrapped to the head and its pad; an external label
    file."""
    path = str(tmp_path / "d.libsvm")
    rows = ["1 0:1.5 3:2.0", "0 1:1.0", "1 2:3.0 4:0.5", "0 0:2.0 4:1.0",
            "1 3:1.0"]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    lpath = str(tmp_path / "l.txt")
    np.savetxt(lpath, np.arange(5, dtype="f"))
    for kw in (dict(), dict(label_libsvm=lpath)):
        with CPU:
            p = pio.LibSVMIter(data_libsvm=path, data_shape=(5,),
                               batch_size=batch_size, **kw)
            got = list(p)
        want = list(rio_.LibSVMIter(data_libsvm=path, data_shape=(5,),
                                    batch_size=batch_size, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.data[0].stype == "csr"
            for a, b in zip(_csr_parts(g.data[0]), _csr_parts(w.data[0])):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(g.data[0].asnumpy(),
                                          w.data[0].asnumpy())
            np.testing.assert_array_equal(g.label[0].asnumpy(),
                                          w.label[0].asnumpy())
            assert g.pad == w.pad
    with pytest.raises(mx.MXNetError):
        pio.LibSVMIter(data_libsvm=path, data_shape=(5, 1))


def test_resize_and_prefetching_iters_match_reference():
    x = np.arange(40, dtype="f").reshape(10, 4)
    for pkg in (pio, rio_):
        with CPU:
            base = pkg.NDArrayIter(x, np.arange(10, dtype="f"), batch_size=3)
            r = pkg.ResizeIter(base, 5)
            data = [b.data[0].asnumpy() for b in r]
            r.reset()
            data2 = [b.data[0].asnumpy() for b in r]
            pf = pkg.PrefetchingIter(pkg.NDArrayIter(x, batch_size=4))
            pdata_ = [b.data[0].asnumpy() for b in pf]
            pf.reset()
            pdata_ += [b.data[0].asnumpy() for b in pf]
        if pkg is pio:
            got = (data, data2, pdata_)
    for g, w in zip(got, (data, data2, pdata_)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


# -- mx.image ---------------------------------------------------------------
def _img(h=20, w=24, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype("uint8")


def _close_uint8(got, want):
    """At most one level off on under 1% of the values (a pixel whose
    float value sits within rounding of an integer truncates either way);
    float results to 1e-5."""
    assert got.shape == want.shape
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_imresize_matches_reference(dtype):
    src = _img(37, 29).astype(dtype)
    for w, h, interp in ((13, 11, 1), (50, 61, 2), (16, 16, 0)):
        with CPU:
            got = pimg.imresize(mx.nd.array(src, dtype=dtype), w, h,
                                interp).asnumpy()
        want = rimg.imresize(src, w, h, interp).asnumpy()
        assert got.dtype == want.dtype
        _close_uint8(got, want)
    with CPU:
        short = pimg.resize_short(mx.nd.array(src, dtype=dtype), 20)
    assert short.shape == rimg.resize_short(src, 20).shape


AUGS = [
    ("HorizontalFlipAug", (0.5,)), ("BrightnessJitterAug", (0.3,)),
    ("ContrastJitterAug", (0.3,)), ("SaturationJitterAug", (0.3,)),
    ("HueJitterAug", (0.2,)), ("ColorJitterAug", (0.2, 0.3, 0.4)),
    ("LightingAug", (0.1, [55.46, 4.794, 1.148],
                     [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.814],
                      [-0.5836, -0.6948, 0.4203]])),
    ("ColorNormalizeAug", ([123.0, 117.0, 104.0], [58.0, 57.0, 57.0])),
    ("RandomGrayAug", (0.5,)), ("CastAug", ()),
    ("RandomCropAug", ((12, 10),)), ("CenterCropAug", ((12, 10),)),
    ("RandomSizedCropAug", ((12, 10), (0.3, 1.0), (0.75, 1.33))),
]


@pytest.mark.parametrize("name,args", AUGS, ids=[a[0] for a in AUGS])
def test_augmenters_match_reference_under_one_seed(name, args):
    src = _img()
    for seed in range(4):
        np.random.seed(seed)
        with CPU:
            got = getattr(pimg, name)(*args)(mx.nd.array(src)).asnumpy()
        np.random.seed(seed)
        want = getattr(rimg, name)(*args)(src)
        want = want.asnumpy() if hasattr(want, "asnumpy") else want
        assert got.dtype == want.dtype and got.shape == want.shape
        if name == "RandomSizedCropAug":     # the crop is resized
            _close_uint8(got, want)
        else:
            np.testing.assert_array_equal(got, want)
    assert getattr(pimg, name)(*args).dumps() == \
        getattr(rimg, name)(*args).dumps()


def test_create_augmenter_pipelines_match_reference():
    src = _img(40, 44)
    kw = dict(resize=0, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.2, contrast=0.2, saturation=0.2,
              hue=0.1, pca_noise=0.1, rand_gray=0.2)
    for seed in range(3):
        np.random.seed(seed)
        with CPU:
            x = mx.nd.array(src)
            for aug in pimg.CreateAugmenter((3, 24, 28), **kw):
                x = aug(x)
        np.random.seed(seed)
        y = src
        for aug in rimg.CreateAugmenter((3, 24, 28), **kw):
            y = aug(y)
        np.testing.assert_allclose(x.asnumpy(), y.asnumpy(), rtol=1e-6,
                                   atol=1e-5)
    label = np.array([[1, 0.1, 0.2, 0.6, 0.7], [0, 0.3, 0.3, 0.9, 0.8],
                      [-1, -1, -1, -1, -1]], "f")
    dkw = dict(rand_crop=0.7, rand_pad=0.5, rand_mirror=True, mean=True)
    for seed in range(4):
        np.random.seed(seed)
        with CPU:
            x, lx = mx.nd.array(src), label
            for aug in pimg.CreateDetAugmenter((3, 24, 24), **dkw):
                x, lx = aug(x, lx)
        np.random.seed(seed)
        y, ly = src, label
        for aug in rimg.CreateDetAugmenter((3, 24, 24), **dkw):
            y, ly = aug(y, ly)
        np.testing.assert_array_equal(lx, ly)
        # the force-resize to 24 x 24 is imresize: within a level before
        # the normalization (std 1 here)
        np.testing.assert_allclose(x.asnumpy(), y.asnumpy(), atol=1.0 + 1e-4)


def _det_rec(tmp_path, n=6):
    rec, idx = str(tmp_path / "det.rec"), str(tmp_path / "det.idx")
    w = rio.MXIndexedRecordIO(idx, rec, "w")
    rs = np.random.RandomState(0)
    for i in range(n):
        im = rs.uniform(0, 255, (48, 48, 3)).astype("uint8")
        label = np.concatenate([[2, 5], [i % 3, 0.2, 0.2, 0.8, 0.8],
                                [1, 0.1, 0.5, 0.4, 0.9]][:2 + (i % 2 + 1)]
                               ).astype("f")
        w.write_idx(i, rio.pack_img(rio.IRHeader(0, label, i, 0), im))
    w.close()
    return rec


def test_image_iter_and_det_iter_match_reference(tmp_path):
    rec, _ = _rec(tmp_path, n=6, hw=(20, 20))
    for aug in (None, "list"):
        batches = []
        for pkg in (pimg, rimg):
            np.random.seed(2)
            aug_list = None if aug is None else [
                pkg.RandomCropAug((16, 16)), pkg.HorizontalFlipAug(0.5),
                pkg.CastAug()]
            with CPU:
                it = pkg.ImageIter(batch_size=2, data_shape=(3, 16, 16),
                                   path_imgrec=rec, shuffle=True,
                                   aug_list=aug_list)
                batches.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                                for b in it])
        for (d, l), (rd, rl) in zip(*batches):
            np.testing.assert_array_equal(l, rl)
            if aug is None:     # imresize of uint8: a level at most
                assert np.abs(d - rd).max() <= 1.0
            else:
                np.testing.assert_array_equal(d, rd)
    det = _det_rec(tmp_path)
    out = []
    for pkg in (pimg, rimg):
        np.random.seed(7)
        with CPU:
            it = pkg.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                                  path_imgrec=det,
                                  aug_list=pkg.CreateDetAugmenter(
                                      (3, 32, 32), rand_mirror=True,
                                      rand_crop=0.5))
            out.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                        for b in it])
    assert len(out[0]) == len(out[1]) == 3
    for (d, l), (rd, rl) in zip(*out):
        assert d.shape == rd.shape == (2, 3, 32, 32) and l.shape == rl.shape
        np.testing.assert_array_equal(l, rl)
        assert np.abs(d - rd).max() <= 1.0


def test_ref_file_feeds_the_port(tmp_path):
    """A record file the reference wrote feeds the port's iterator."""
    rec = str(tmp_path / "r.rec")
    w = ref_rio.MXRecordIO(rec, "w")
    rng = np.random.RandomState(5)
    for i in range(5):
        w.write(ref_rio.pack_img(ref_rio.IRHeader(0, float(i), i, 0),
                                 rng.randint(0, 255, (9, 9, 3))
                                 .astype("uint8")))
    w.close()
    with CPU:
        got = _batches(pio.ImageRecordIter(path_imgrec=rec,
                                           data_shape=(3, 8, 8),
                                           batch_size=5))
    _same(got, _batches(rio_.ImageRecordIter(path_imgrec=rec,
                                             data_shape=(3, 8, 8),
                                             batch_size=5)))
