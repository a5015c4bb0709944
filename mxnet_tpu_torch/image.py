"""Image utilities, ``mx.image`` (counterpart of ``mxnet_tpu/image.py``;
MXNet's ``python/mxnet/image/image.py`` and ``image/detection.py``):
imread, imresize, the crops and colour ops, the Augmenter family and
CreateAugmenter, ImageIter, the detection augmenters, CreateDetAugmenter
and ImageDetIter.

Augmentation runs on the host in numpy, drawing from the global numpy
RNG, as the reference's does: under one ``np.random.seed`` both packages
give the same images wherever they compute in numpy.  ``imresize`` is the
reference's ``jax.image.resize`` (bilinear for any nonzero ``interp``,
nearest for 0), computed by ``ops.image_ops.resize_axes``; a uint8 result
is cast back as the reference casts it, so a pixel whose float value lands
within rounding of an integer may sit one level off the reference's.
Encoded images (JPEG, PNG) need PIL, imported where they are read."""
from __future__ import annotations

import numpy as _np

from .base import MXNetError
from .context import current_context
from .ndarray.ndarray import NDArray, array

__all__ = ["imread", "imresize", "resize_short", "fixed_crop", "center_crop",
           "random_crop", "random_size_crop", "color_normalize", "ImageIter",
           "Augmenter", "SequentialAug", "RandomOrderAug", "ResizeAug",
           "ForceResizeAug", "CastAug", "RandomCropAug", "CenterCropAug",
           "RandomSizedCropAug", "HorizontalFlipAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
           "RandomGrayAug", "CreateAugmenter",
           "DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


def imread(filename, flag=1, to_rgb=True):
    """An image file as an HWC NDArray: .npy through numpy, anything else
    through PIL (raises without it); ``flag=0`` averages to one
    channel."""
    if filename.endswith(".npy"):
        return array(_np.load(filename))
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("imread of encoded images needs PIL; .npy works "
                         "without it") from e
    img = _np.asarray(Image.open(filename))
    if flag == 0 and img.ndim == 3:
        img = img.mean(axis=-1, keepdims=True).astype(img.dtype)
    return array(img)


def imresize(src, w, h, interp=1):
    """``src`` (HWC) resized to (h, w) in float32 and cast back to its
    dtype, on its context (a numpy source: the current context)."""
    import torch

    from .ops.image_ops import resize_axes

    if isinstance(src, NDArray):
        v = src._data.detach()
    else:
        v = torch.from_numpy(_np.ascontiguousarray(src)).to(
            current_context().device)
    out = resize_axes(v.to(torch.float32), {0: h, 1: w},
                      "bilinear" if interp else "nearest")
    return NDArray._wrap(out.to(v.dtype))


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, size * h // w
    else:
        new_w, new_h = size * w // h, size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    return fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp), \
        (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _np.random.randint(0, w - new_w + 1)
    y0 = _np.random.randint(0, h - new_h + 1)
    return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src if isinstance(src, NDArray) else array(src)
    out = src - (mean if isinstance(mean, NDArray) else array(_np.asarray(mean)))
    if std is not None:
        out = out / (std if isinstance(std, NDArray) else array(_np.asarray(std)))
    return out


class ImageIter:
    """Python-side image iterator over .rec or image list (reference:
    mx.image.ImageIter).  ``aug_list`` (e.g. from :func:`CreateAugmenter`)
    runs per decoded image; without one, images are resized to
    ``data_shape``."""

    def __init__(self, batch_size, data_shape, path_imgrec=None, shuffle=False,
                 aug_list=None, **kwargs):
        from .recordio import MXIndexedRecordIO, unpack_img

        if path_imgrec is None:
            raise MXNetError("ImageIter requires path_imgrec here")
        idx = path_imgrec[:path_imgrec.rfind(".")] + ".idx"
        self._rec = MXIndexedRecordIO(idx, path_imgrec, "r")
        self.batch_size = batch_size
        self.data_shape = data_shape
        self.shuffle = shuffle
        self.auglist = aug_list
        self._unpack_img = unpack_img
        self._order = list(self._rec.keys)
        self._pos = 0
        self.reset()

    def reset(self):
        self._pos = 0
        if self.shuffle:
            _np.random.shuffle(self._order)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        from .io import DataBatch

        if self._pos + self.batch_size > len(self._order):
            raise StopIteration
        c, h, w = self.data_shape
        data = _np.zeros((self.batch_size, c, h, w), dtype=_np.float32)
        label = _np.zeros((self.batch_size,), dtype=_np.float32)
        for i in range(self.batch_size):
            rec = self._rec.read_idx(self._order[self._pos + i])
            hdr, img = self._unpack_img(rec)
            if self.auglist:
                img_nd = array(_np.asarray(img))
                for aug in self.auglist:
                    img_nd = aug(img_nd)
                img = _as_np(img_nd)
            else:
                img = _np.asarray(imresize(array(img), w, h).asnumpy())
            if img.ndim == 2:
                img = img[:, :, None]
            data[i] = img.transpose(2, 0, 1)[:c]
            label[i] = hdr.label if _np.isscalar(hdr.label) else hdr.label[0]
        self._pos += self.batch_size
        return DataBatch(data=[array(data)], label=[array(label)])


def random_size_crop(src, size, area, ratio, interp=2):
    """Random crop with area/aspect constraints (reference:
    image.random_size_crop — the inception-style crop)."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _np.random.uniform(*area) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        aspect = _np.exp(_np.random.uniform(*log_ratio))
        new_w = int(round(_np.sqrt(target_area * aspect)))
        new_h = int(round(_np.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            x0 = _np.random.randint(0, w - new_w + 1)
            y0 = _np.random.randint(0, h - new_h + 1)
            return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def _as_np(src):
    return src.asnumpy() if isinstance(src, NDArray) else _np.asarray(src)


# ==========================================================================
# Augmenter architecture (reference: image.py Augmenter and subclasses)
# ==========================================================================
class Augmenter:
    """Image augmentation base (reference: mx.image.Augmenter).  Call with
    an HWC image NDArray, get the augmented NDArray back."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, _np.ndarray):
                kwargs[k] = v.tolist()

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src

    def dumps(self):
        return [self.__class__.__name__, [t.dumps() for t in self.ts]]


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        order = _np.random.permutation(len(self.ts))
        for i in order:
            src = self.ts[i](src)
        return src

    def dumps(self):
        return [self.__class__.__name__, [t.dumps() for t in self.ts]]


class ResizeAug(Augmenter):
    """Resize shorter edge to size (reference: ResizeAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Resize to exact (w, h) ignoring aspect (reference: ForceResizeAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return array(_as_np(src).astype(self.typ))


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _np.random.rand() < self.p:
            return array(_as_np(src)[:, ::-1].copy())
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _np.random.uniform(-self.brightness, self.brightness)
        return array(_as_np(src) * alpha)


class ContrastJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], "f")

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _np.random.uniform(-self.contrast, self.contrast)
        s = _as_np(src).astype("f")
        gray = (s * self._coef).sum() * (3.0 / s.size)
        return array(s * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], "f")

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _np.random.uniform(-self.saturation, self.saturation)
        s = _as_np(src).astype("f")
        gray = (s * self._coef).sum(axis=2, keepdims=True)
        return array(s * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    """Hue rotation in YIQ space (reference: HueJitterAug's tyiq route)."""
    _tyiq = _np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], "f")
    _ityiq = _np.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], "f")

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = _np.random.uniform(-self.hue, self.hue)
        u, w = _np.cos(alpha * _np.pi), _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]], "f")
        t = self._ityiq @ bt @ self._tyiq
        s = _as_np(src).astype("f")
        return array(s @ t.T)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA-noise lighting (reference: LightingAug, AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, "f")
        self.eigvec = _np.asarray(eigvec, "f")

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha) @ self.eigval
        return array(_as_np(src).astype("f") + rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = None if mean is None else _np.asarray(mean, "f")
        self.std = None if std is None else _np.asarray(std, "f")

    def __call__(self, src):
        s = _as_np(src).astype("f")
        if self.mean is not None:
            s = s - self.mean
        if self.std is not None:
            s = s / self.std
        return array(s)


class RandomGrayAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _np.random.rand() < self.p:
            s = _as_np(src).astype("f")
            gray = (s @ _np.array([0.299, 0.587, 0.114], "f"))[..., None]
            return array(_np.repeat(gray, 3, axis=2))
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """Standard augmenter pipeline factory (reference:
    mx.image.CreateAugmenter — same knob set, same order)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ==========================================================================
# Detection augmenters (reference: python/mxnet/image/detection.py)
# Label format: (N, 5+) float rows [cls_id, xmin, ymin, xmax, ymax, ...] with
# coordinates normalized to [0, 1] (the reference's internal format after
# its header parse).
# ==========================================================================
class DetAugmenter:
    """Detection augmentation base: __call__(src, label) -> (src, label)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap a plain image Augmenter for detection (reference: DetBorrowAug
    — geometry-preserving augmenters only)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly select one of several augmenters (or skip)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _np.random.rand() < self.skip_prob or not self.aug_list:
            return src, label
        i = _np.random.randint(len(self.aug_list))
        return self.aug_list[i](src, label)


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _np.random.rand() < self.p:
            src = array(_as_np(src)[:, ::-1].copy())
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
        return src, label


def _bbox_overlap(boxes, crop):
    """Fraction of each box's area covered by crop (both normalized)."""
    x1 = _np.maximum(boxes[:, 0], crop[0])
    y1 = _np.maximum(boxes[:, 1], crop[1])
    x2 = _np.minimum(boxes[:, 2], crop[2])
    y2 = _np.minimum(boxes[:, 3], crop[3])
    inter = _np.maximum(x2 - x1, 0) * _np.maximum(y2 - y1, 0)
    area = _np.maximum((boxes[:, 2] - boxes[:, 0])
                       * (boxes[:, 3] - boxes[:, 1]), 1e-12)
    return inter / area


class DetRandomCropAug(DetAugmenter):
    """Random crop with object-coverage constraints (reference:
    DetRandomCropAug — SSD-style constrained sampling)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _sample_crop(self, label):
        valid = label[label[:, 0] >= 0]
        for _ in range(self.max_attempts):
            area = _np.random.uniform(*self.area_range)
            ar = _np.random.uniform(*self.aspect_ratio_range)
            cw = min(_np.sqrt(area * ar), 1.0)
            ch = min(_np.sqrt(area / ar), 1.0)
            cx = _np.random.uniform(0, 1.0 - cw)
            cy = _np.random.uniform(0, 1.0 - ch)
            crop = (cx, cy, cx + cw, cy + ch)
            if len(valid) == 0:
                return crop
            cov = _bbox_overlap(valid[:, 1:5], crop)
            if cov.max() >= self.min_object_covered:
                return crop
        return None

    def __call__(self, src, label):
        crop = self._sample_crop(label)
        if crop is None:
            return src, label
        h, w = src.shape[:2]
        x0, y0 = int(crop[0] * w), int(crop[1] * h)
        cw, ch = max(int((crop[2] - crop[0]) * w), 1), \
            max(int((crop[3] - crop[1]) * h), 1)
        out = fixed_crop(src, x0, y0, cw, ch)
        new_label = []
        for row in label:
            if row[0] < 0:
                continue
            cov = _bbox_overlap(row[None, 1:5], crop)[0]
            if cov < self.min_eject_coverage:
                continue
            b = row.copy()
            b[1] = (max(row[1], crop[0]) - crop[0]) / (crop[2] - crop[0])
            b[2] = (max(row[2], crop[1]) - crop[1]) / (crop[3] - crop[1])
            b[3] = (min(row[3], crop[2]) - crop[0]) / (crop[2] - crop[0])
            b[4] = (min(row[4], crop[3]) - crop[1]) / (crop[3] - crop[1])
            new_label.append(b)
        if not new_label:
            return src, label  # keep original rather than emit empty
        out_label = _np.full_like(label, -1.0)
        out_label[:len(new_label)] = _np.stack(new_label)
        return out, out_label


class DetRandomPadAug(DetAugmenter):
    """Random expansion pad (reference: DetRandomPadAug — zoom-out)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        s = _as_np(src)
        h, w = s.shape[:2]
        for _ in range(self.max_attempts):
            area = _np.random.uniform(*self.area_range)
            ar = _np.random.uniform(*self.aspect_ratio_range)
            nw, nh = int(w * _np.sqrt(area * ar)), int(h * _np.sqrt(area / ar))
            if nw >= w and nh >= h:
                x0 = _np.random.randint(0, nw - w + 1)
                y0 = _np.random.randint(0, nh - h + 1)
                canvas = _np.empty((nh, nw) + s.shape[2:], dtype=s.dtype)
                canvas[...] = _np.asarray(self.pad_val, dtype=s.dtype)
                canvas[y0:y0 + h, x0:x0 + w] = s
                label = label.copy()
                valid = label[:, 0] >= 0
                label[valid, 1] = (label[valid, 1] * w + x0) / nw
                label[valid, 2] = (label[valid, 2] * h + y0) / nh
                label[valid, 3] = (label[valid, 3] * w + x0) / nw
                label[valid, 4] = (label[valid, 4] * h + y0) / nh
                return array(canvas), label
        return src, label


class _DetForceResizeAug(DetAugmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src, label):
        return imresize(src, self.size[0], self.size[1], self.interp), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, hue=0,
                       pca_noise=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Detection pipeline factory (reference: mx.image.CreateDetAugmenter —
    same knobs; crop/pad probabilities select constrained samplers)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])), max_attempts,
                              pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # force to network input size
    auglist.append(_DetForceResizeAug((data_shape[2], data_shape[1]),
                                      inter_method))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator over a .rec file (reference: mx.image.ImageDetIter).

    Record labels use the reference's detection header:
    ``[header_width, object_width, (extras...), obj0..., obj1...]`` where
    each object is ``[cls_id, xmin, ymin, xmax, ymax, ...]`` normalized.
    Batch label shape is (batch, max_objects, object_width), padded with -1
    rows.
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None, shuffle=False,
                 aug_list=None, **kwargs):
        super().__init__(batch_size, data_shape, path_imgrec=path_imgrec,
                         shuffle=shuffle, **kwargs)
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape)
        self.auglist = aug_list
        from .recordio import unpack as _unpack_header

        # first pass over headers to size the padded label tensor — headers
        # only (recordio.unpack leaves the image payload undecoded)
        self._obj_width, self._max_objs = 5, 1
        for k in self._rec.keys:
            hdr, _ = _unpack_header(self._rec.read_idx(k))
            objs = self._split_objects(_np.asarray(hdr.label, "f").ravel())
            self._obj_width = max(self._obj_width, objs.shape[1])
            self._max_objs = max(self._max_objs, len(objs))

    @staticmethod
    def _split_objects(lab):
        """Split a raw label vector into object rows.  Detection headers are
        ``[header_width>=2, object_width>=5, extras..., objs...]`` with
        integral leading fields (reference im2rec layout); anything else is
        plain ``[cls x1 y1 x2 y2]`` rows."""
        if (lab.size >= 2 and lab[0] >= 2 and lab[1] >= 5
                and float(lab[0]).is_integer() and float(lab[1]).is_integer()
                and (lab.size - int(lab[0])) % int(lab[1]) == 0):
            hw, ow = int(lab[0]), int(lab[1])
            return lab[hw:].reshape(-1, ow)
        return lab.reshape(-1, 5)

    def _parse_label(self, hdr):
        objs = self._split_objects(_np.asarray(hdr.label, "f").ravel())
        out = _np.full((self._max_objs, self._obj_width), -1.0, "f")
        out[:len(objs), :objs.shape[1]] = objs
        return out

    def next(self):
        from .io import DataBatch

        if self._pos + self.batch_size > len(self._order):
            raise StopIteration
        c, h, w = self.data_shape
        data = _np.zeros((self.batch_size, c, h, w), dtype=_np.float32)
        labels = _np.full((self.batch_size, self._max_objs, self._obj_width),
                          -1.0, dtype=_np.float32)
        for i in range(self.batch_size):
            rec = self._rec.read_idx(self._order[self._pos + i])
            hdr, img = self._unpack_img(rec)
            img_nd = array(_np.asarray(img))
            label = self._parse_label(hdr)
            for aug in self.auglist:
                img_nd, label = aug(img_nd, label)
            s = _as_np(img_nd)
            if s.ndim == 2:
                s = s[:, :, None]
            if s.shape[:2] != (h, w):
                # aug list without a sizing step (boxes are normalized, so
                # a plain resize keeps the labels valid)
                s = _as_np(imresize(array(s.astype("float32")), w, h))
            data[i] = s.transpose(2, 0, 1)[:c]
            labels[i] = label
        self._pos += self.batch_size
        return DataBatch(data=[array(data)], label=[array(labels)])
