"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; MXNet's
``python/mxnet/gluon/data/vision/transforms.py``).  They take HWC uint8 or
float images (numpy or NDArray), compute in numpy on the host, as the
reference does, and return NDArrays on the current context; ToTensor gives
CHW float32.  Resizing is the reference's ``jax.image.resize`` (bilinear,
half-pixel centred, antialiased when shrinking), computed by
``ops.image_ops.resize_axes``."""
from __future__ import annotations

import numpy as _np

from ...block import Block, HybridBlock
from ...nn import Sequential
from ....ndarray.ndarray import NDArray, array

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomLighting", "RandomColorJitter"]


def _to_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return array(_to_np(x).astype(self._dtype))


class ToTensor(Block):
    """HWC uint8 [0,255] -> CHW float32 [0,1]."""

    def forward(self, x):
        a = _to_np(x).astype(_np.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return array(a)


class Normalize(Block):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, dtype=_np.float32)
        self._std = _np.asarray(std, dtype=_np.float32)

    def forward(self, x):
        a = _to_np(x).astype(_np.float32)
        mean = self._mean.reshape(-1, 1, 1) if a.ndim == 3 else self._mean
        std = self._std.reshape(-1, 1, 1) if a.ndim == 3 else self._std
        return array((a - mean) / std)


def _resize_np(img, size):
    """Bilinear resize of an HWC numpy image to ``size`` = (w, h), in
    float32."""
    import torch

    from ....ops.image_ops import resize_axes

    out = resize_axes(torch.from_numpy(_np.ascontiguousarray(
        img, dtype=_np.float32)), {0: size[1], 1: size[0]}, "bilinear")
    return out.numpy()


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._keep = keep_ratio

    def forward(self, x):
        img = _to_np(x)
        w, h = self._size
        if self._keep:
            ih, iw = img.shape[:2]
            scale = min(w / iw, h / ih)
            w, h = int(iw * scale), int(ih * scale)
        return array(_resize_np(img, (w, h)).astype(img.dtype if
                     img.dtype == _np.float32 else _np.uint8))


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        img = _to_np(x)
        w, h = self._size
        ih, iw = img.shape[:2]
        x0 = max((iw - w) // 2, 0)
        y0 = max((ih - h) // 2, 0)
        crop = img[y0:y0 + h, x0:x0 + w]
        if crop.shape[:2] != (h, w):
            crop = _resize_np(crop, (w, h)).astype(img.dtype)
        return array(crop)


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        img = _to_np(x)
        ih, iw = img.shape[:2]
        area = ih * iw
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            aspect = _np.random.uniform(*self._ratio)
            w = int(round(_np.sqrt(target_area * aspect)))
            h = int(round(_np.sqrt(target_area / aspect)))
            if w <= iw and h <= ih:
                x0 = _np.random.randint(0, iw - w + 1)
                y0 = _np.random.randint(0, ih - h + 1)
                crop = img[y0:y0 + h, x0:x0 + w]
                out = _resize_np(crop, self._size)
                return array(out.astype(_np.uint8) if img.dtype == _np.uint8
                             else out)
        # fallback: center crop
        return CenterCrop(self._size).forward(x)


class RandomHorizontalFlip(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        img = _to_np(x)
        if _np.random.rand() < self._p:
            img = img[:, ::-1]
        return array(_np.ascontiguousarray(img))


class RandomVerticalFlip(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        img = _to_np(x)
        if _np.random.rand() < self._p:
            img = img[::-1]
        return array(_np.ascontiguousarray(img))


class _RandomJitter(Block):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _factor(self):
        return 1.0 + _np.random.uniform(-self._amount, self._amount)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        img = _to_np(x).astype(_np.float32)
        return array(_np.clip(img * self._factor(), 0, 255))


class RandomContrast(_RandomJitter):
    def forward(self, x):
        img = _to_np(x).astype(_np.float32)
        gray = img.mean()
        return array(_np.clip((img - gray) * self._factor() + gray, 0, 255))


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        img = _to_np(x).astype(_np.float32)
        gray = img.mean(axis=-1, keepdims=True)
        return array(_np.clip((img - gray) * self._factor() + gray, 0, 255))


class RandomLighting(Block):
    """AlexNet-style PCA lighting jitter."""

    _eigval = _np.array([55.46, 4.794, 1.148])
    _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]])

    def __init__(self, alpha=0.1):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        img = _to_np(x).astype(_np.float32)
        alpha = _np.random.normal(0, self._alpha, 3)
        rgb = (self._eigvec @ (alpha * self._eigval)).astype(_np.float32)
        return array(_np.clip(img + rgb, 0, 255))


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def forward(self, x):
        ts = list(self._ts)
        _np.random.shuffle(ts)
        for t in ts:
            x = t.forward(x)
        return x
