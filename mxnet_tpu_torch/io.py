"""Data iterators, ``mx.io`` (counterpart of ``mxnet_tpu/io.py``; MXNet's
``python/mxnet/io/io.py`` over the C++ iterators of ``src/io/``):
DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter, PrefetchingIter,
ImageRecordIter (the native reader, a decode pool, per-record seeded
augmentation), CSVIter, LibSVMIter (CSR batches) and MNISTIter.

An iterator's batches land on the context that was current when it was
made (``current_context()``, the first card unless a ``with mx.cpu():``
scope said otherwise), whichever thread calls ``next()``: a prefetching
consumer's thread too.
"""
from __future__ import annotations

import threading
from collections import namedtuple

import numpy as _np

import torch

from .base import MXNetError
from .context import current_context
from .ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "ImageRecordIter", "CSVIter", "LibSVMIter",
           "MNISTIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    if data is None:
        return []
    if isinstance(data, (NDArray, _np.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}{'_' + str(i) if i else ''}": d
                for i, d in enumerate(data)} if len(data) > 1 else \
            ({default_name: data[0]} if data else {})
    out = []
    for k, v in data.items():
        if not isinstance(v, NDArray):
            v = array(_np.asarray(v))
        out.append((k, v))
    return out


def _wrap_batch(arr, ctx):
    """A freshly made numpy batch as an NDArray on ``ctx``, without the
    host copy ``nd.array`` makes (nothing else holds ``arr``)."""
    return NDArray._wrap(torch.from_numpy(arr).to(ctx.device))


class NDArrayIter(DataIter):
    """In-memory iterator (reference: mx.io.NDArrayIter)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = _np.arange(self.num_data)
        if shuffle:
            _np.random.shuffle(self.idx)
        self._ctx = current_context()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            _np.random.shuffle(self.idx)

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "roll_over":
            return self.cursor < self.num_data
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        out = []
        for _, v in arrays:
            end = self.cursor + self.batch_size
            ids = self.idx[self.cursor:min(end, self.num_data)]
            batch = v.asnumpy()[ids]
            if len(ids) < self.batch_size:  # pad
                pad = self.batch_size - len(ids)
                batch = _np.concatenate([batch, batch[:pad]])
            out.append(array(batch, ctx=self._ctx))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if end > self.num_data:
            return end - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize (truncate/loop) another iterator to size batches per epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Thread-prefetch wrapper (reference: mx.io.PrefetchingIter over
    dmlc::ThreadedIter); the base iterator runs on the thread under the
    context current when this wrapper was made."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        import queue

        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter here supports one base iter")
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self._ctx = current_context()
        self._queue = queue.Queue(maxsize=2)
        self._thread = None
        self._start()

    def _start(self):
        import threading

        def worker():
            while True:
                try:
                    with self._ctx:
                        batch = self.iter.next()
                except StopIteration:
                    self._queue.put(None)
                    return
                self._queue.put(batch)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        while self._thread.is_alive():
            try:
                if self._queue.get(timeout=0.1) is None:
                    break
            except Exception:
                break
        self.iter.reset()
        self._start()

    def next(self):
        batch = self._queue.get()
        if batch is None:
            raise StopIteration
        return batch

    def iter_next(self):
        raise NotImplementedError


class _DecodePipeline:
    """Decode/augment pool between the C++ byte reader and batching.

    Reference shape: ``src/io/iter_image_recordio_2.cc`` ParseChunk runs the
    decode stage on an OMP pool so a single Python thread never bounds
    throughput.  Here: a feeder thread pulls payload batches from the
    native reader and fans the per-image decode out to a ThreadPoolExecutor
    (numpy and PIL release the GIL for the heavy parts), each image written
    by its thread into its row of the batch's array (``shape`` a row, float32),
    and queues (array, labels) for ``next()``."""

    def __init__(self, reader, decode_method, n_threads, depth, shape):
        import queue
        import threading
        import weakref
        from concurrent.futures import ThreadPoolExecutor

        self._reader = reader
        # weak binding: the running feeder thread must not keep an abandoned
        # iterator (and its reader/pool/buffers) alive forever
        self._decode = weakref.WeakMethod(decode_method)
        self._shape = tuple(shape)
        self._pool = ThreadPoolExecutor(max_workers=n_threads)
        self._q = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        # two batches in the pool at once: the next batch's images are
        # queued before the feeder waits on this one's, so the threads do
        # not idle at a batch's boundary
        idx, pending = 0, None
        while not self._stop.is_set():
            decode = self._decode()  # WeakMethod: None once the owner died
            if decode is None:
                return
            try:
                payloads = self._reader.next_views()
                submitted = None
                if payloads is not None:
                    submitted = self._submit(decode, payloads, idx)
                    idx += len(payloads)
                del decode
                if pending is not None:
                    for f in pending[2]:
                        f.result()
                    if not self._put(pending[:2]):
                        return
                pending = submitted
            except Exception as e:  # surface read/decode errors at next()
                self._put(e)
                return
            if pending is None:
                self._put(None)
                return

    def _submit(self, decode, payloads, start):
        """Queue one batch's decodes: (its array, its labels, the
        futures)."""
        data = _np.empty((len(payloads),) + self._shape, _np.float32)
        labels = [None] * len(payloads)

        def work(i, payload):
            labels[i] = decode(payload, start + i, out=data[i])[1]

        return data, labels, [self._pool.submit(work, i, p)
                              for i, p in enumerate(payloads)]

    def _put(self, item):
        import queue

        # also abort when the owning iterator has been garbage-collected
        # (nobody will ever drain the queue)
        while not self._stop.is_set() and self._decode() is not None:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def get(self):
        # once terminal (exhausted or errored) the feeder is gone: replay
        # the terminal state instead of blocking on an empty queue forever
        done = getattr(self, "_done", None)
        if done is not None:
            if isinstance(done, Exception):
                raise MXNetError(
                    f"decode pipeline failed: {done!r}") from done
            return None
        item = self._q.get()
        if isinstance(item, Exception):
            self._done = item
            raise MXNetError(f"decode pipeline failed: {item!r}") from item
        if item is None:
            self._done = True
        return item

    def shutdown(self):
        import queue

        self._stop.set()
        while self._thread.is_alive():
            try:  # drain so a blocked _put can observe the stop flag
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        while True:  # discard whatever is left
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._pool.shutdown(wait=False)


class ImageRecordIter(DataIter):
    """Threaded image-record iterator (reference: src/io/iter_image_recordio_2.cc
    "ImageRecordIter" — shard reader → decode pool → batcher → prefetcher).

    The C++ reader (``native.NativeRecordReader``) owns file IO, record
    framing, num_parts/part_index sharding, epoch shuffling and read-ahead;
    decode and augmentation run on a thread pool here
    (``preprocess_threads``, default ``env.cpu_worker_nthreads()``; the
    reference's OMP decode stage).  Each record's crop and mirror draw from
    ``RandomState((seed * 1000003 + epoch * 7919 + index) mod 2^31)``, so a
    batch is the same bit for bit at any thread count, and the reference's
    batch.  Record payloads: .npy-encoded arrays (``recordio.pack_img``'s
    default) and, through PIL, JPEG/PNG; ``resize`` and a resize to an
    image smaller than ``data_shape`` need PIL too.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, resize=-1, num_parts=1, part_index=0, seed=0,
                 round_batch=True, prefetch_buffer=4, preprocess_threads=None,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        from . import recordio as _rio
        from .native import NativeRecordReader

        self._rio = _rio
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.mean = _np.array([mean_r, mean_g, mean_b], dtype="float32")
        self.std = _np.array([std_r, std_g, std_b], dtype="float32")
        self.round_batch = round_batch
        self._seed = seed
        self._epoch = 0
        if preprocess_threads is None:
            from . import env as _env

            preprocess_threads = _env.cpu_worker_nthreads()
        self._n_threads = max(int(preprocess_threads), 1)
        self._depth = prefetch_buffer
        self._reader = NativeRecordReader(
            path_imgrec, batch_size, num_parts=num_parts,
            part_index=part_index, shuffle=shuffle, seed=seed,
            queue_depth=prefetch_buffer)
        self._data_name = data_name
        self._label_name = label_name
        self._ctx = current_context()
        self._tls = threading.local()
        self._pipeline = _DecodePipeline(self._reader, self._decode,
                                         self._n_threads, self._depth,
                                         self.data_shape)

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        if self._pipeline is not None:  # may be closed / previously failed
            self._pipeline.shutdown()
        self._pipeline = None  # a failed reader.reset() must not leave a
        #                        dead pipeline that blocks next() forever
        self._reader.reset()
        self._epoch += 1
        self._exhausted = False
        self._pipeline = _DecodePipeline(self._reader, self._decode,
                                         self._n_threads, self._depth,
                                         self.data_shape)

    def close(self):
        """Stop the decode pool and the reader's thread (the pool also stops
        when the iterator is garbage-collected, through the pipeline's weak
        binding)."""
        if getattr(self, "_pipeline", None) is not None:
            self._pipeline.shutdown()
            self._pipeline = None
        self._reader.close()

    def _decode(self, payload, index, out=None):
        """(the augmented CHW float32 image, written into ``out`` when
        given, its label).  The RNG is keyed by (seed, epoch, index), so
        augmentation does not depend on the decode threads' schedule; each
        thread reseeds a RandomState of its own (the same stream as a new
        RandomState of that seed, without building one per record)."""
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            rng = self._tls.rng = _np.random.RandomState()
        rng.seed((self._seed * 1000003 + self._epoch * 7919 + index)
                 % (2 ** 31))
        header, img = self._rio._unpack_img_view(payload)
        return self._augment(img, rng, out), header.label

    def _augment(self, img, rng, out=None):
        # img HWC uint8/float -> data_shape CHW float32
        c, h, w = self.data_shape
        if img.ndim == 2:
            img = img[:, :, None]
        # reconcile channel count with data_shape: gray->RGB replicate,
        # RGBA->drop alpha, RGB->gray luminance
        ic = img.shape[2]
        if ic != c:
            if ic == 1:
                img = _np.repeat(img, c, axis=2)
            elif ic == 4 and c == 3:
                img = img[:, :, :3]
            elif c == 1:
                img = img[:, :, :3].mean(axis=2, keepdims=True)
            else:
                raise MXNetError(
                    f"record has {ic} channels but data_shape wants {c}")
        if self.resize > 0:
            img = self._resize_short(img, self.resize)
        ih, iw = img.shape[:2]
        if self.rand_crop and ih >= h and iw >= w:
            y0 = rng.randint(0, ih - h + 1)
            x0 = rng.randint(0, iw - w + 1)
        else:
            y0 = max((ih - h) // 2, 0)
            x0 = max((iw - w) // 2, 0)
        img = img[y0:y0 + h, x0:x0 + w]
        if img.shape[0] != h or img.shape[1] != w:
            img = self._resize_exact(img, h, w)
        if self.rand_mirror and rng.rand() < 0.5:
            img = img[:, ::-1]
        # the reference's float32 (x - mean) / std element by element (the
        # same bits), written channel-major in two passes
        nch = img.shape[2]
        if out is None:
            out = _np.empty((nch, h, w), _np.float32)
        _np.subtract(img.transpose(2, 0, 1), self.mean[:nch, None, None],
                     out=out, dtype=_np.float32)
        _np.divide(out, self.std[:nch, None, None], out=out)
        return out

    @staticmethod
    def _pil():
        try:
            from PIL import Image
        except ImportError as e:
            raise MXNetError("ImageRecordIter's resize needs PIL; store "
                             "records at data_shape or larger") from e
        return Image

    @classmethod
    def _resize_short(cls, img, size):
        Image = cls._pil()

        ih, iw = img.shape[:2]
        scale = size / min(ih, iw)
        nh, nw = int(round(ih * scale)), int(round(iw * scale))
        return _np.asarray(Image.fromarray(img.astype("uint8")).resize(
            (nw, nh), Image.BILINEAR))

    @classmethod
    def _resize_exact(cls, img, h, w):
        Image = cls._pil()

        return _np.asarray(Image.fromarray(img.astype("uint8")).resize(
            (w, h), Image.BILINEAR))

    def next(self):
        if getattr(self, "_exhausted", False):
            raise StopIteration
        if self._pipeline is None:
            raise MXNetError(
                "iterator is closed or a previous reset() failed; "
                "create a new ImageRecordIter")
        results = self._pipeline.get()
        if results is None:
            self._exhausted = True
            raise StopIteration
        data, labels = results
        pad = self.batch_size - len(labels)
        if pad > 0 and self.round_batch:
            # pad the tail batch with copies of the last record (reference
            # round_batch semantics); pad count lets callers mask them
            data = _np.concatenate([data, _np.repeat(data[-1:], pad, 0)])
            labels = labels + [labels[-1]] * pad
        else:
            pad = 0
        data = _wrap_batch(data, self._ctx)
        label = _wrap_batch(_np.asarray(labels, dtype="float32"), self._ctx)
        return DataBatch(data=[data], label=[label], pad=pad)


class CSVIter(DataIter):
    """CSV file iterator (reference: ``src/io/iter_csv.cc`` CSVIter).

    Loads ``data_csv`` (and optional ``label_csv``) into host memory once
    (the reference streams chunk-wise; at the dataset sizes CSV is used for
    this is a simplification, not a constraint) and yields batch-size
    slices, each row reshaped to ``data_shape``.  ``round_batch`` pads the
    tail batch by wrapping to the head like the reference."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32",
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_shape = tuple(label_shape)
        self.round_batch = round_batch
        self._dtype = dtype
        self._data = _np.loadtxt(data_csv, delimiter=",",
                                 dtype=dtype, ndmin=2)
        n = self._data.shape[0]
        if self._data.shape[1] != int(_np.prod(self.data_shape)):
            raise MXNetError(
                f"csv row width {self._data.shape[1]} != data_shape "
                f"{self.data_shape}")
        self._data = self._data.reshape((n,) + self.data_shape)
        if label_csv is not None:
            self._label = _np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                                      ndmin=2).reshape((n,) + self.label_shape)
        else:
            self._label = _np.zeros((n,) + self.label_shape, dtype=dtype)
        self._data_name = data_name
        self._label_name = label_name
        self._ctx = current_context()
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        # a (1,)-wide label squeezes to a vector (matching next())
        shape = (self.batch_size,) if self.label_shape == (1,) else \
            (self.batch_size,) + self.label_shape
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        self._cursor = 0

    def next(self):
        n = self._data.shape[0]
        if self._cursor >= n:
            raise StopIteration
        end = self._cursor + self.batch_size
        if end > n and not self.round_batch:
            raise StopIteration
        # modular take wraps however many times the pad requires
        ids = _np.arange(self._cursor, end) % n
        data = self._data[ids]
        label = self._label[ids]
        pad = end - n if end > n else 0
        self._cursor = end
        lbl = label[:, 0] if self.label_shape == (1,) else label
        return DataBatch(data=[array(data, ctx=self._ctx)],
                         label=[array(lbl, ctx=self._ctx)], pad=pad)


class LibSVMIter(DataIter):
    """LibSVM-format iterator producing CSR batches (reference:
    ``src/io/iter_libsvm.cc`` LibSVMIter), the sparse input path of the
    factorization machine and the linear models: ``label index:value ...``
    lines, each batch a ``CSRNDArray`` (a short tail batch wraps to the
    head, ``pad`` counting the wrapped rows)."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 batch_size=1, round_batch=True, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        if len(self.data_shape) != 1:
            raise MXNetError("LibSVMIter data_shape must be (num_features,)")
        self.round_batch = round_batch
        labels, indptr, indices, values = [], [0], [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    i, _, v = tok.partition(":")
                    indices.append(int(i))
                    values.append(float(v))
                indptr.append(len(indices))
        self._labels = _np.asarray(labels, dtype="float32")
        self._indptr = _np.asarray(indptr, dtype="int64")
        self._indices = _np.asarray(indices, dtype="int64")
        self._values = _np.asarray(values, dtype="float32")
        if label_libsvm is not None:
            ext = _np.loadtxt(label_libsvm, dtype="float32", ndmin=1)
            ext = ext.reshape(-1)
            if ext.shape[0] != len(labels):
                raise MXNetError(
                    f"label file has {ext.shape[0]} rows but data file has "
                    f"{len(labels)}")
            self._labels = ext
        self._data_name = data_name
        self._label_name = label_name
        self._ctx = current_context()
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name, (self.batch_size,))]

    def reset(self):
        self._cursor = 0

    def _rows_csr(self, row_ids):
        """Build a CSR batch from arbitrary row ids — stays sparse, so the
        tail-batch wrap never densifies a huge feature dim."""
        from .ndarray.sparse import CSRNDArray

        vals, inds, indptr = [], [], [0]
        for r in row_ids:
            lo, hi = self._indptr[r], self._indptr[r + 1]
            vals.append(self._values[lo:hi])
            inds.append(self._indices[lo:hi])
            indptr.append(indptr[-1] + (hi - lo))
        return CSRNDArray.create(
            _np.concatenate(vals) if vals else _np.zeros(0, "f"),
            _np.concatenate(inds) if inds else _np.zeros(0, "i8"),
            _np.asarray(indptr, dtype="int64"),
            (len(row_ids), self.data_shape[0]), self._ctx)

    def next(self):
        n = len(self._labels)
        if self._cursor >= n:
            raise StopIteration
        end = self._cursor + self.batch_size
        if end > n and not self.round_batch:
            raise StopIteration
        ids = _np.arange(self._cursor, end) % n  # wraps any pad size
        csr = self._rows_csr(ids)
        label = self._labels[ids]
        pad = end - n if end > n else 0
        self._cursor = end
        return DataBatch(data=[csr], label=[array(label, ctx=self._ctx)],
                         pad=pad)


class MNISTIter(DataIter):
    """IDX-format MNIST reader (reference: ``src/io/iter_mnist.cc``).

    ``image``/``label`` point at the idx3/idx1 files (optionally .gz)."""

    def __init__(self, image, label, batch_size=1, shuffle=False, flat=False,
                 seed=0, silent=True, input_shape=None, **kwargs):
        super().__init__(batch_size)
        self._images = self._read_idx(image, expect_dims=3)
        self._labels = self._read_idx(label, expect_dims=1)
        if self._images.shape[0] != self._labels.shape[0]:
            raise MXNetError("MNIST image/label count mismatch")
        self.flat = flat
        self.shuffle = shuffle
        self._rng = _np.random.RandomState(seed)
        self._order = _np.arange(self._images.shape[0])
        self._ctx = current_context()
        self.reset()

    @staticmethod
    def _read_idx(path, expect_dims):
        import gzip
        import struct

        op = gzip.open if str(path).endswith(".gz") else open
        with op(path, "rb") as f:
            raw = f.read()
        zero, dtype_code, ndim = raw[0] | raw[1], raw[2], raw[3]
        if zero != 0 or dtype_code != 0x08:
            raise MXNetError(
                f"{path} is not a uint8 idx file (magic "
                f"{raw[:4].hex()}; expected 0000 08 xx)")
        if ndim != expect_dims:
            raise MXNetError(f"idx file {path}: expected {expect_dims} dims, "
                             f"got {ndim}")
        dims = struct.unpack(">" + "I" * ndim, raw[4:4 + 4 * ndim])
        data = _np.frombuffer(raw, dtype=_np.uint8, offset=4 + 4 * ndim)
        return data.reshape(dims)

    def reset(self):
        self._cursor = 0
        if self.shuffle:
            self._rng.shuffle(self._order)

    @property
    def provide_data(self):
        h, w = self._images.shape[1:]
        shape = (self.batch_size, h * w) if self.flat else \
            (self.batch_size, 1, h, w)
        return [DataDesc("data", shape)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def next(self):
        n = self._images.shape[0]
        if self._cursor + self.batch_size > n:
            raise StopIteration
        ids = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        imgs = self._images[ids].astype("float32") / 255.0
        if self.flat:
            imgs = imgs.reshape(self.batch_size, -1)
        else:
            imgs = imgs[:, None, :, :]
        return DataBatch(
            data=[array(imgs, ctx=self._ctx)],
            label=[array(self._labels[ids].astype("float32"), ctx=self._ctx)],
            pad=0)
