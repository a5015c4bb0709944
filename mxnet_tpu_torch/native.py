"""Native (C++) host components of the data path, bound with ``ctypes``
(counterpart of ``mxnet_tpu/native/__init__.py``).

``csrc/recordio_reader.cc`` is built by the host compiler at first use into
the git-ignored ``_build/`` (``_kernels.load_host``: the stale-source check
and the build log of the kernels); a failed build raises, and nothing falls
back to a Python reader.  ``NativeRecordReader`` gives the reference's
record order for the same ``(seed, epoch)``, shuffled and sharded alike.
"""
from __future__ import annotations

import ctypes

from .base import MXNetError

__all__ = ["NativeRecordReader", "get_lib"]


def get_lib():
    """The reader's ctypes library, built first if needed."""
    from . import _kernels

    return _kernels.load_host("recordio_reader")


class NativeRecordReader:
    """Threaded, sharded, shuffling RecordIO batch reader (C++ backend):
    ``num_parts``/``part_index`` take a contiguous shard of the file's
    records, ``shuffle`` permutes the shard every epoch from ``seed +
    epoch``, and a background thread keeps up to ``queue_depth`` batches
    of payloads read ahead."""

    def __init__(self, path, batch_size, num_parts=1, part_index=0,
                 shuffle=False, seed=0, queue_depth=4):
        self._lib = get_lib()
        self._handle = self._lib.mxtpu_reader_create(
            str(path).encode(), int(batch_size), int(num_parts),
            int(part_index), 1 if shuffle else 0, int(seed),
            int(queue_depth))
        if not self._handle:
            raise MXNetError(f"cannot open record file {path}")
        self._epoch = 0

    @property
    def num_records(self):
        return self._lib.mxtpu_reader_num_records(self._handle)

    @property
    def read_errors(self):
        """Records dropped because the file was truncated or unreadable."""
        return self._lib.mxtpu_reader_read_errors(self._handle)

    def reset(self):
        """Start the next epoch (its own shuffle); raises if the last one
        lost records to read errors."""
        self._epoch += 1
        if self.read_errors:
            raise MXNetError(
                f"{self.read_errors} record(s) could not be read (truncated "
                "or corrupt record file)")
        self._lib.mxtpu_reader_reset(self._handle, self._epoch)

    def next_views(self):
        """The next batch's payloads as memoryviews of one bytes copy of
        the batch (no copy per record), or None at the end of the
        epoch."""
        data = ctypes.POINTER(ctypes.c_uint8)()
        lengths = ctypes.POINTER(ctypes.c_uint64)()
        n = ctypes.c_uint64()
        total = ctypes.c_uint64()
        rc = self._lib.mxtpu_reader_next_batch(
            self._handle, ctypes.byref(data), ctypes.byref(lengths),
            ctypes.byref(n), ctypes.byref(total))
        if rc != 0:
            return None
        raw = memoryview(ctypes.string_at(data, total.value)
                         if total.value else b"")
        out, off = [], 0
        for i in range(n.value):
            ln = lengths[i]
            out.append(raw[off:off + ln])
            off += ln
        return out

    def next_batch(self):
        """A list of the next batch's payloads (bytes), or None at the end
        of the epoch."""
        views = self.next_views()
        return None if views is None else [bytes(v) for v in views]

    def close(self):
        """Stop the reader's thread and free it.  Idempotent."""
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.mxtpu_reader_free(handle)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
