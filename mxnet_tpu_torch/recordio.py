"""RecordIO: the packed binary record format and image record pack/unpack
(counterpart of ``mxnet_tpu/recordio.py``; MXNet's
``python/mxnet/recordio.py`` over dmlc-core's ``recordio.h``).  A file
either package writes, the other reads byte for byte.

Format (compatible with dmlc recordio): each record is
    uint32 kMagic = 0xced7230a
    uint32 lrecord  (upper 3 bits: continue-flag, lower 29: length)
    data   (padded to 4-byte boundary)
The magic is escaped inside payloads by the continue-flag chunking; this
writer uses single-chunk records (cflag=0), which the reference reader
accepts.
"""
from __future__ import annotations

import ast
import os
import struct
from collections import namedtuple

import numpy as _np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xCED7230A

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference: dmlc::RecordIOWriter)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag}")

    def close(self):
        if self.record is not None:
            self.record.close()
            self.record = None

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def write(self, buf):
        if not self.writable:
            raise MXNetError("not opened for writing")
        self.record.write(struct.pack("<II", _kMagic, len(buf)))
        self.record.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self):
        if self.writable:
            raise MXNetError("not opened for reading")
        head = self.record.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _kMagic:
            raise MXNetError("invalid record magic")
        length = lrec & ((1 << 29) - 1)
        data = self.record.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.record.read(pad)
        return data

    def tell(self):
        return self.record.tell()


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with an index file for random access (reference:
    MXIndexedRecordIO over .idx tsv)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.isfile(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    key = key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        elif flag == "w":
            self.fidx = open(idx_path, "w")

    def close(self):
        super().close()
        if getattr(self, "fidx", None) is not None:
            self.fidx.close()
            self.fidx = None

    def seek(self, idx):
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """Pack an IRHeader + payload into a record payload."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
        return hdr + s
    label = _np.asarray(header.label, dtype=_np.float32)
    hdr = struct.pack(_IR_FORMAT, len(label), 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        arr = _np.frombuffer(s[:flag * 4], dtype=_np.float32)
        s = s[flag * 4:]
        header = IRHeader(flag, arr, id_, id2)
    else:
        header = IRHeader(flag, label, id_, id2)
    return header, s


def pack_img(header, img, quality=95, img_fmt=".npy"):
    """Pack an image. Offline environment: no OpenCV/JPEG codec is baked in,
    so the default encoding is raw .npy (shape+dtype preserved); .jpg/.png
    are attempted via PIL if available."""
    if img_fmt in (".jpg", ".jpeg", ".png"):
        import io as _io

        try:
            from PIL import Image
        except ImportError as e:
            raise MXNetError("JPEG/PNG encoding needs PIL; use img_fmt='.npy'") from e
        buf = _io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG" if "j" in img_fmt else "PNG",
                                  quality=quality)
        payload = b"IMG0" + buf.getvalue()
    else:
        import io as _io

        buf = _io.BytesIO()
        _np.save(buf, _np.asarray(img), allow_pickle=False)
        payload = b"NPY0" + buf.getvalue()
    return pack(header, payload)


_NPY_HEADERS = {}


def _npy_view(buf):
    """``np.load`` of a .npy payload as a read-only view of ``buf`` (no
    copy), the header parsed once for each distinct header (the images of
    a record file share one)."""
    mv = memoryview(buf)
    if bytes(mv[:6]) != b"\x93NUMPY":
        raise MXNetError("record payload is not a .npy array")
    start = 10 if mv[6] == 1 else 12
    hlen = struct.unpack("<H" if start == 10 else "<I", mv[8:start])[0]
    key = bytes(mv[:start + hlen])
    info = _NPY_HEADERS.get(key)
    if info is None:
        d = ast.literal_eval(key[start:].decode("latin1"))
        info = (_np.lib.format.descr_to_dtype(d["descr"]), tuple(d["shape"]),
                "F" if d["fortran_order"] else "C", start + hlen)
        if len(_NPY_HEADERS) > 64:
            _NPY_HEADERS.clear()
        _NPY_HEADERS[key] = info
    dtype, shape, order, offset = info
    count = 1
    for n in shape:
        count *= n
    return _np.frombuffer(mv, dtype=dtype, count=count,
                          offset=offset).reshape(shape, order=order)


def _unpack_img_view(s):
    """:func:`unpack_img` for the decode pipeline: a .npy image comes back
    as a read-only view of the record, with no copy."""
    header, payload = unpack(s)
    if bytes(payload[:4]) == b"NPY0":
        return header, _npy_view(memoryview(payload)[4:])
    return unpack_img(s)


def unpack_img(s, iscolor=-1, flag=1):
    header, payload = unpack(s)
    tag, body = bytes(payload[:4]), payload[4:]
    import io as _io

    if tag == b"NPY0":
        img = _npy_view(body).copy(order="K")
    elif tag == b"IMG0":
        try:
            from PIL import Image
        except ImportError as e:
            raise MXNetError("JPEG/PNG decoding needs PIL") from e
        img = _np.asarray(Image.open(_io.BytesIO(bytes(body))))
    else:
        # raw jpeg bytes from a reference-written .rec
        try:
            from PIL import Image
        except ImportError as e:
            raise MXNetError("decoding reference .rec needs PIL") from e
        img = _np.asarray(Image.open(_io.BytesIO(bytes(payload))))
    return header, img
