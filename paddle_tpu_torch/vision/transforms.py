"""Vision transforms (``paddle_tpu/vision/transforms.py``).

Host-side numpy preprocessing, as in the JAX package: the DataLoader
applies them before a batch reaches the device. HWC uint8 numpy in; the
random transforms draw from numpy's global generator, so one
``np.random.seed`` gives both packages the same crops and flips.
``ToTensor`` / ``to_tensor`` return the port's ``Tensor`` (CHW float32
by default, on the current device), and ``Normalize`` takes a ``Tensor``
or an array. ``rotate`` goes through PIL, imported when called.
"""
from __future__ import annotations

import numbers

import numpy as np

from ..framework.core import Tensor

__all__ = [
    "Compose", "ToTensor", "Resize", "Normalize", "CenterCrop", "RandomCrop",
    "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose", "Pad",
    "RandomResizedCrop", "BrightnessTransform", "ContrastTransform",
    "SaturationTransform", "HueTransform", "ColorJitter", "Grayscale",
    "to_tensor", "normalize", "resize", "hflip", "vflip", "center_crop", "crop",
    "RandomRotation", "adjust_brightness", "adjust_contrast", "adjust_hue",
    "pad", "rotate", "to_grayscale",
]


def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def resize(img, size, interpolation="bilinear"):
    img = _as_hwc(img)
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h < w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
    else:
        nh, nw = size
    if (nh, nw) == (h, w):
        return img
    # bilinear resize in numpy, on the host
    ys = np.linspace(0, h - 1, nh)
    xs = np.linspace(0, w - 1, nw)
    if interpolation == "nearest":
        out = img[np.round(ys).astype(int)[:, None], np.round(xs).astype(int)[None, :]]
        return out
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    f = img.astype(np.float32)
    out = (f[y0][:, x0] * (1 - wy) * (1 - wx) + f[y1][:, x0] * wy * (1 - wx)
           + f[y0][:, x1] * (1 - wy) * wx + f[y1][:, x1] * wy * wx)
    if img.dtype == np.uint8:
        out = np.clip(out, 0, 255).astype(np.uint8)
    return out


def crop(img, top, left, height, width):
    return _as_hwc(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    img = _as_hwc(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = img.shape[:2]
    th, tw = output_size
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return crop(img, i, j, th, tw)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


def to_tensor(pic, data_format="CHW"):
    img = _as_hwc(pic).astype(np.float32)
    if img.dtype == np.float32 and np.asarray(pic).dtype == np.uint8:
        img = img / 255.0
    elif np.asarray(pic).dtype == np.uint8:
        img = img / 255.0
    if data_format == "CHW":
        img = img.transpose(2, 0, 1)
    return Tensor(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    if isinstance(img, Tensor):
        arr = img._data.detach().cpu().float().numpy()
    else:
        arr = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format == "CHW":
        arr = (arr - mean[:, None, None]) / std[:, None, None]
    else:
        arr = (arr - mean) / std
    return Tensor(arr) if isinstance(img, Tensor) else arr


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean, self.std = mean, std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding = padding

    def _apply_image(self, img):
        img = _as_hwc(img)
        if self.padding:
            p = self.padding if not isinstance(self.padding, numbers.Number) else [self.padding] * 4
            img = np.pad(img, ((p[1], p[3]), (p[0], p[2]), (0, 0)))
        h, w = img.shape[:2]
        th, tw = self.size
        if h == th and w == tw:
            return img
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return crop(img, i, j, th, tw)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4, 4.0 / 3),
                 interpolation="bilinear", keys=None):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self.scale) * area
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            nw = int(round(np.sqrt(target_area * ar)))
            nh = int(round(np.sqrt(target_area / ar)))
            if 0 < nw <= w and 0 < nh <= h:
                i = np.random.randint(0, h - nh + 1)
                j = np.random.randint(0, w - nw + 1)
                return resize(crop(img, i, j, nh, nw), self.size, self.interpolation)
        return resize(center_crop(img, min(h, w)), self.size, self.interpolation)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return hflip(img)
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return vflip(img)
        return img


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        return _as_hwc(img).transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        if isinstance(padding, numbers.Number):
            padding = [padding] * 4
        elif len(padding) == 2:
            padding = [padding[0], padding[1], padding[0], padding[1]]
        self.padding = padding
        self.fill = fill

    def _apply_image(self, img):
        img = _as_hwc(img)
        p = self.padding
        return np.pad(img, ((p[1], p[3]), (p[0], p[2]), (0, 0)), constant_values=self.fill)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        alpha = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        img = _as_hwc(img).astype(np.float32) * alpha
        return np.clip(img, 0, 255).astype(np.uint8)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        alpha = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        img = _as_hwc(img).astype(np.float32)
        mean = img.mean()
        out = img * alpha + mean * (1 - alpha)
        return np.clip(out, 0, 255).astype(np.uint8)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        alpha = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        img = _as_hwc(img).astype(np.float32)
        gray = img.mean(axis=2, keepdims=True)
        out = img * alpha + gray * (1 - alpha)
        return np.clip(out, 0, 255).astype(np.uint8)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if isinstance(value, numbers.Number):
            if not 0 <= value <= 0.5:
                raise ValueError("hue value must be in [0, 0.5]")
            self.value = (-float(value), float(value))
        else:
            lo, hi = float(value[0]), float(value[1])
            if not -0.5 <= lo <= hi <= 0.5:
                raise ValueError("hue range must lie within [-0.5, 0.5]")
            self.value = (lo, hi)

    def _apply_image(self, img):
        if self.value == (0.0, 0.0):
            return img
        factor = np.random.uniform(self.value[0], self.value[1])
        return adjust_hue(img, factor)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        self.transforms = [
            BrightnessTransform(brightness), ContrastTransform(contrast),
            SaturationTransform(saturation), HueTransform(hue),
        ]

    def _apply_image(self, img):
        order = np.random.permutation(len(self.transforms))
        for i in order:
            img = self.transforms[i](img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        img = _as_hwc(img).astype(np.float32)
        gray = (img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114)
        gray = gray[..., None]
        if self.num_output_channels == 3:
            gray = np.repeat(gray, 3, axis=2)
        return gray.astype(np.uint8)


# --- functional color/geometry ops (reference vision/transforms/functional.py)

def adjust_brightness(img, brightness_factor):
    """img * factor, clipped (reference functional.adjust_brightness)."""
    arr = _as_hwc(img).astype(np.float32) * float(brightness_factor)
    return np.clip(arr, 0, 255).astype(np.uint8)


def adjust_contrast(img, contrast_factor):
    """Blend with the mean gray level (reference functional.adjust_contrast)."""
    arr = _as_hwc(img).astype(np.float32)
    gray = (arr[..., 0] * 0.299 + arr[..., 1] * 0.587
            + arr[..., 2] * 0.114) if arr.shape[-1] == 3 else arr[..., 0]
    mean = gray.mean()
    out = mean + float(contrast_factor) * (arr - mean)
    return np.clip(out, 0, 255).astype(np.uint8)


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc, gc, bc = (maxc - r) / dz, (maxc - g) / dz, (maxc - b) / dz
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.choose(i[..., None], [
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return out


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor ∈ [-0.5, 0.5] via HSV
    (reference functional.adjust_hue)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr = _as_hwc(img).astype(np.float32) / 255.0
    if arr.shape[-1] == 1:
        return _as_hwc(img)
    hsv = _rgb_to_hsv(arr)
    hsv[..., 0] = (hsv[..., 0] + hue_factor) % 1.0
    out = _hsv_to_rgb(hsv)
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def to_grayscale(img, num_output_channels=1):
    return Grayscale(num_output_channels)._apply_image(img)


def pad(img, padding, fill=0, padding_mode="constant"):
    """Pad H/W (reference functional.pad): padding int | (lr, tb) |
    (l, t, r, b)."""
    arr = _as_hwc(img)
    if isinstance(padding, numbers.Number):
        l = t = r = b = int(padding)
    elif len(padding) == 2:
        l = r = int(padding[0])
        t = b = int(padding[1])
    else:
        l, t, r, b = (int(v) for v in padding)
    width = [(t, b), (l, r), (0, 0)]
    if padding_mode == "constant":
        return np.pad(arr, width, mode="constant", constant_values=fill)
    mode = {"reflect": "reflect", "edge": "edge",
            "symmetric": "symmetric"}.get(padding_mode)
    if mode is None:
        raise ValueError("unknown padding_mode %r" % (padding_mode,))
    return np.pad(arr, width, mode=mode)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate counter-clockwise by ``angle`` degrees via PIL
    (reference functional.rotate)."""
    from PIL import Image

    arr = _as_hwc(img)
    squeeze = arr.shape[-1] == 1
    pil = Image.fromarray(arr[..., 0] if squeeze else arr)
    resample = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
                "bicubic": Image.BICUBIC}[interpolation]
    out = np.asarray(pil.rotate(angle, resample=resample, expand=expand,
                                center=center, fillcolor=fill))
    return out[..., None] if squeeze else out


class RandomRotation(BaseTransform):
    """Rotate by a random angle from [-degrees, degrees] (reference
    transforms.RandomRotation)."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            self.degrees = (-float(degrees), float(degrees))
        else:
            self.degrees = (float(degrees[0]), float(degrees[1]))
        self.args = (interpolation, expand, center, fill)

    def _apply_image(self, img):
        angle = np.random.uniform(self.degrees[0], self.degrees[1])
        interpolation, expand, center, fill = self.args
        return rotate(img, angle, interpolation, expand, center, fill)
