"""Image transforms (numpy-only copy of the CIFAR, FEMNIST and ImageNet
stacks of ``commefficient_tpu/data/transforms.py``). All operate on HWC arrays
and draw from the same numpy RNG (``np.random`` unless one is given)
in the same order as the JAX package's, so a seeded run transforms a
batch bit for bit as the JAX loader does.

``RandomResizedCrop`` and ``Resize`` resize as PIL's ``Image.resize(BILINEAR)`` does,
without PIL: ``pil_bilinear_resize`` is PIL's separable resample
(Resample.c) in numpy -- a triangle filter whose support widens by the
downscale factor, coefficients normalized in float64 and rounded to
22-bit fixed point, the horizontal pass first (over the rows the
vertical pass reads), each pass rounding and clipping to uint8.
"""

from __future__ import annotations

import functools

import numpy as np

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)
FEMNIST_MEAN = np.array([0.9637], np.float32)
FEMNIST_STD = np.array([0.1597], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToFloat:
    """uint8 HWC -> float32 in [0, 1]."""

    def __call__(self, x):
        if x.dtype == np.uint8:
            return x.astype(np.float32) / 255.0
        return x.astype(np.float32)


class Normalize:
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def __call__(self, x):
        return (x - self.mean) / self.std


class RandomCrop:
    """Pad by ``padding`` (reflect, or constant ``fill``), then a random
    crop back to ``size``."""

    def __init__(self, size, padding=4, rng=None, fill=None):
        self.size, self.padding, self.fill = size, padding, fill
        self.rng = rng or np.random

    def __call__(self, x):
        p = self.padding
        if self.fill is None:
            x = np.pad(x, ((p, p), (p, p), (0, 0)), mode="reflect")
        else:
            x = np.pad(x, ((p, p), (p, p), (0, 0)), mode="constant",
                       constant_values=self.fill)
        i = self.rng.randint(0, x.shape[0] - self.size + 1)
        j = self.rng.randint(0, x.shape[1] - self.size + 1)
        return x[i:i + self.size, j:j + self.size]


class RandomHorizontalFlip:
    def __init__(self, rng=None):
        self.rng = rng or np.random

    def __call__(self, x):
        if self.rng.rand() < 0.5:
            return x[:, ::-1].copy()
        return x


class RandomRotation:
    """Small-angle rotation, nearest neighbour, constant fill."""

    def __init__(self, degrees, fill=1.0, rng=None):
        self.degrees, self.fill = degrees, fill
        self.rng = rng or np.random

    def __call__(self, x):
        ang = np.deg2rad(self.rng.uniform(-self.degrees, self.degrees))
        h, w = x.shape[:2]
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        c, s = np.cos(ang), np.sin(ang)
        sy = cy + (yy - cy) * c - (xx - cx) * s
        sx = cx + (yy - cy) * s + (xx - cx) * c
        syi = np.round(sy).astype(int)
        sxi = np.round(sx).astype(int)
        valid = (syi >= 0) & (syi < h) & (sxi >= 0) & (sxi < w)
        out = np.full_like(x, self.fill, dtype=np.float32)
        out[valid] = x[syi[valid], sxi[valid]]
        return out


# PIL's fixed point: 32 bits - 8 of the pixel - 2 of headroom
_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=None)
def _bilinear_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear filter over the whole input: (out_size,) first input
    index, (out_size, ksize) int64 fixed-point weights (zero past each
    output's window); cached, read only."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        # C casts truncate toward zero
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ww = 0.0
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            w = 1.0 - t if t < 1.0 else 0.0
            kk[xx, x] = w
            ww += w
        if ww != 0.0:
            kk[xx, :xmax] /= ww
        xmins[xx] = xmin
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * one),
                     np.trunc(0.5 + kk * one)).astype(np.int64)
    return xmins, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass over ``axis`` (0: rows, 1: columns) of an (H, W, C)
    uint8 image: the fixed-point sum from a half-unit rounding offset,
    shifted back and clipped to uint8."""
    in_size = img.shape[axis]
    xmins, k = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(img.astype(np.int64), axis, 0)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmins + j, in_size - 1)
        acc += src[idx] * k[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear_resize(arr: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``Image.fromarray(arr).resize((nw, nh), Image.BILINEAR)`` of an
    (H, W, C) uint8 array, in numpy. PIL runs a pass only along an axis
    whose size changes, the horizontal one first."""
    out = arr
    if nw != arr.shape[1]:
        out = _resample_axis(out, nw, 1)
    if nh != arr.shape[0]:
        out = _resample_axis(out, nh, 0)
    return out


def resize(x, nh, nw):
    """Bilinear resize of an HWC array to (nh, nw), preserving the
    input's dtype convention as the JAX package's ``_pil_resize`` does:
    uint8 stays uint8; float in [0, 1] is clipped, truncated to uint8,
    resized and returned as float32 / 255."""
    if x.dtype == np.uint8:
        arr = np.asarray(x)
    else:
        arr = np.asarray(np.clip(x, 0, 1) * 255, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    out = pil_bilinear_resize(arr, nh, nw)
    if x.dtype != np.uint8:
        out = out.astype(np.float32) / 255.0
    return out


class Resize:
    """Shorter side -> ``size`` (PIL bilinear), HWC uint8/float."""

    def __init__(self, size):
        self.size = size

    def __call__(self, x):
        h, w = x.shape[:2]
        if h < w:
            nh, nw = self.size, max(1, round(w * self.size / h))
        else:
            nh, nw = max(1, round(h * self.size / w)), self.size
        return resize(x, nh, nw)


class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, x):
        h, w = x.shape[:2]
        i = max(0, (h - self.size) // 2)
        j = max(0, (w - self.size) // 2)
        return x[i:i + self.size, j:j + self.size]


class RandomResizedCrop:
    """Random area/aspect crop resized to ``size`` (reference
    transforms.py:49, 67)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.),
                 rng=None):
        self.size, self.scale, self.ratio = size, scale, ratio
        self.rng = rng or np.random

    def __call__(self, x):
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * self.rng.uniform(*self.scale)
            ar = np.exp(self.rng.uniform(np.log(self.ratio[0]),
                                         np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = self.rng.randint(0, h - ch + 1)
                j = self.rng.randint(0, w - cw + 1)
                x = x[i:i + ch, j:j + cw]
                break
        else:
            s = min(h, w)
            x = CenterCrop(s)(x)
        return resize(x, self.size, self.size)


def cifar_train_transform(mean=CIFAR10_MEAN, std=CIFAR10_STD):
    return Compose([ToFloat(), RandomCrop(32, 4),
                    RandomHorizontalFlip(), Normalize(mean, std)])


def cifar_val_transform(mean=CIFAR10_MEAN, std=CIFAR10_STD):
    return Compose([ToFloat(), Normalize(mean, std)])


def femnist_train_transform(rng=None):
    """reference transforms.py:47-53 (crop, resize and rotate with white
    fill: LEAF femnist is white-background floats in [0, 1])."""
    return Compose([ToFloat(),
                    RandomCrop(28, 2, rng=rng, fill=1.0),
                    RandomResizedCrop(28, scale=(0.8, 1.2),
                                      ratio=(4. / 5., 5. / 4.), rng=rng),
                    RandomRotation(5, fill=1.0, rng=rng),
                    Normalize(FEMNIST_MEAN, FEMNIST_STD)])


def femnist_val_transform():
    return Compose([ToFloat(), Normalize(FEMNIST_MEAN, FEMNIST_STD)])


def imagenet_train_transform(rng=None):
    return Compose([RandomResizedCrop(224, rng=rng),
                    RandomHorizontalFlip(rng=rng), ToFloat(),
                    Normalize(IMAGENET_MEAN, IMAGENET_STD)])


def imagenet_val_transform():
    return Compose([Resize(256), CenterCrop(224), ToFloat(),
                    Normalize(IMAGENET_MEAN, IMAGENET_STD)])
