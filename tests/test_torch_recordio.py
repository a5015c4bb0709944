"""RecordIO files and the native reader of the port against the reference.

- a ``.rec``/``.idx`` pair written by either package reads back in the
  other byte for byte (``MXIndexedRecordIO``, ``pack``/``unpack``,
  ``pack_img``/``unpack_img`` in ``.npy`` and, through PIL, PNG), and
  both writers write the same bytes;
- the port's native reader (``csrc/recordio_reader.cc``, built under
  ``mxnet_tpu_torch/_build/``) gives the reference's records in the
  reference's order for the same seed and epoch: sequential, shuffled over
  three epochs, and sharded by ``num_parts``/``part_index``;
- the reader's library builds from the port's own source into ``_build/``
  (a bad path raises; a source the compiler rejects raises, with no
  Python reader standing in).
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import recordio as ref_rio
from mxnet_tpu.native import NativeRecordReader as RefReader
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch import recordio as rio
from mxnet_tpu_torch.native import NativeRecordReader


def _write(pkg_rio, prefix, n=37, fmt=".npy"):
    rec, idx = f"{prefix}.rec", f"{prefix}.idx"
    w = pkg_rio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = rng.randint(0, 255, (10, 12, 3)).astype("uint8")
        label = float(i % 5) if i % 3 else [float(i), 0.5, 2.0]
        w.write_idx(i, pkg_rio.pack_img(pkg_rio.IRHeader(0, label, i, 7),
                                        img, img_fmt=fmt))
    w.close()
    return rec, idx


@pytest.mark.parametrize("fmt", [".npy", ".png"])
def test_files_cross_both_ways_byte_for_byte(tmp_path, fmt):
    ref_rec, ref_idx = _write(ref_rio, str(tmp_path / "ref"), fmt=fmt)
    port_rec, port_idx = _write(rio, str(tmp_path / "port"), fmt=fmt)
    for a, b in ((ref_rec, port_rec), (ref_idx, port_idx)):
        assert open(a, "rb").read() == open(b, "rb").read()
    for reader_rio, rec, idx in ((rio, ref_rec, ref_idx),
                                 (ref_rio, port_rec, port_idx)):
        r = reader_rio.MXIndexedRecordIO(idx, rec, "r")
        other = ref_rio if reader_rio is rio else rio
        o = other.MXIndexedRecordIO(idx, rec, "r")
        assert r.keys == o.keys == list(range(37))
        for k in (0, 5, 36):
            raw = r.read_idx(k)
            assert raw == o.read_idx(k)
            (h, img), (ho, imgo) = reader_rio.unpack_img(raw), \
                other.unpack_img(raw)
            np.testing.assert_array_equal(img, imgo)
            assert (h.flag, h.id, h.id2) == (ho.flag, ho.id, ho.id2) == \
                (h.flag, k, 7)
            np.testing.assert_array_equal(h.label, ho.label)
        r.close()
        o.close()


def test_sequential_reader_and_pack(tmp_path):
    path = str(tmp_path / "seq.rec")
    w = rio.MXRecordIO(path, "w")
    payloads = [b"", b"a", b"abcd", b"x" * 13]
    for p in payloads:
        w.write(p)
    w.close()
    r = ref_rio.MXRecordIO(path, "r")
    assert [r.read() for _ in payloads] == payloads and r.read() is None
    with pytest.raises(mx.MXNetError):
        rio.MXRecordIO(path, "x")
    s = rio.pack(rio.IRHeader(0, [1.0, 2.0], 3, 4), b"payload")
    assert s == ref_rio.pack(ref_rio.IRHeader(0, [1.0, 2.0], 3, 4),
                             b"payload")
    h, body = rio.unpack(s)
    assert body == b"payload" and h.flag == 2 and list(h.label) == [1, 2]


def _ids(reader, unpack):
    out = []
    while True:
        batch = reader.next_batch()
        if batch is None:
            return out
        out.append([unpack(p)[0].id for p in batch])


@pytest.mark.parametrize("kw", [
    dict(batch_size=8),
    dict(batch_size=6, shuffle=True, seed=7),
    dict(batch_size=5, shuffle=True, seed=3, num_parts=3, part_index=1),
    dict(batch_size=64, num_parts=3, part_index=2),
], ids=["sequential", "shuffled", "shuffled-shard", "last-shard"])
def test_native_reader_order_matches_reference(tmp_path, kw):
    rec, _ = _write(rio, str(tmp_path / "d"))
    port, ref = NativeRecordReader(rec, **kw), RefReader(rec, **kw)
    assert port.num_records == ref.num_records
    for epoch in range(3):
        got = _ids(port, rio.unpack)
        assert got == _ids(ref, ref_rio.unpack), epoch
        if kw.get("shuffle") and epoch == 0:
            first = got
        port.reset()
        ref.reset()
    if kw.get("shuffle"):
        assert got != first   # a new epoch, a new order
    port.close()


def test_native_reader_shards_cover_the_file(tmp_path):
    rec, _ = _write(rio, str(tmp_path / "d"))
    seen = []
    for part in range(3):
        r = NativeRecordReader(rec, batch_size=64, num_parts=3,
                               part_index=part)
        seen.extend(rio.unpack(p)[0].id for p in r.next_batch() or [])
    assert sorted(seen) == list(range(37))
    with pytest.raises(mx.MXNetError):
        NativeRecordReader(str(tmp_path / "never.rec"), batch_size=4)


def test_native_reader_is_built_under_the_port(tmp_path):
    """The library comes from csrc/recordio_reader.cc into _build/ with its
    build log, and no kernel list mistakes it for a .cu kernel."""
    rec, _ = _write(rio, str(tmp_path / "d"), n=3)
    NativeRecordReader(rec, batch_size=2).close()
    so = _kernels._target("recordio_reader")
    assert so.exists() and so.parent == _kernels._BUILD
    assert so.with_suffix(".log").exists()
    assert "recordio_reader" not in _kernels.sources()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A reader source the compiler rejects raises MXNetError with the
    compiler's message; no Python reader stands in."""
    import mxnet_tpu_torch.native as native

    (tmp_path / "recordio_reader.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_kernels, "_CSRC", tmp_path)
    monkeypatch.setattr(_kernels, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(_kernels, "_loaded", {})
    with pytest.raises(mx.MXNetError, match="failed to build"):
        native.NativeRecordReader(str(tmp_path / "x.rec"), batch_size=2)
    assert not list((tmp_path / "_build").glob("*.so"))
