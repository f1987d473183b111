"""Vision transforms — port of ``paddle_tpu/vision/transforms``: numpy
preprocessing on the host (HWC uint8 in, CHW float out by ``ToTensor``, a
CPU ``torch.Tensor``), run in the DataLoader's workers.

The random transforms draw from Python's ``random`` (``RandomErasing``'s
noise from a numpy generator seeded by it), as in the JAX package, so a
program that seeds ``random`` gets the same flips, crops and jitter from
both packages. ``Resize`` is ``jax.image.resize(..., "linear")`` as the JAX
package calls it (antialiased when it shrinks, through the port's
``nn.functional`` resize rule) and casts back with numpy's ``astype``,
which truncates a uint8 result; its channels-first test is the JAX
package's guess (3 axes, the first 1 or 3 and the last not).
"""
from __future__ import annotations

import numbers
import random
from typing import List, Sequence

import numpy as np

import torch

# the tensor type the transforms take and return
Tensor = torch.Tensor


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


def _to_np(img):
    if isinstance(img, Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def _tensor(arr) -> torch.Tensor:
    """A CPU tensor of the numpy array ``arr``."""
    return torch.from_numpy(np.ascontiguousarray(arr))


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = _to_np(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = arr.astype(np.float32)
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return _tensor(arr)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = _to_np(img).astype(np.float32)
        if self.data_format == "CHW":
            mean = self.mean.reshape(-1, 1, 1)
            std = self.std.reshape(-1, 1, 1)
        else:
            mean = self.mean
            std = self.std
        out = (arr - mean) / std
        return _tensor(out) if isinstance(img, Tensor) else out


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def _apply_image(self, img):
        arr = _to_np(img)
        h, w = self.size
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3)
        if chw:
            out_shape = (arr.shape[0], h, w)
        elif arr.ndim == 3:
            out_shape = (h, w, arr.shape[2])
        else:
            out_shape = (h, w)
        return _resize_linear(arr, out_shape).astype(arr.dtype)


def _resize_linear(arr, out_shape) -> np.ndarray:
    """``jax.image.resize(arr in fp32, out_shape, "linear")``: each axis
    whose size changes resized in turn under the JAX rule (half-pixel
    centres, a triangle kernel widened when it shrinks); fp32 numpy out."""
    from ...nn.functional.common import _aa_axis

    x = torch.from_numpy(np.array(arr, dtype=np.float32))
    for d, n_out in enumerate(out_shape):
        if x.shape[d] != n_out:
            x = _aa_axis(x, d, n_out, "bilinear")
    return x.numpy()


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            arr = _to_np(img)
            return np.ascontiguousarray(arr[..., ::-1]) if arr.ndim == 3 and \
                arr.shape[0] in (1, 3) else np.ascontiguousarray(np.fliplr(arr))
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.ascontiguousarray(np.flipud(_to_np(img)))
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.padding = padding

    def _apply_image(self, img):
        arr = _to_np(img)
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) else \
                [self.padding] * 4
            arr = np.pad(arr, [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (arr.ndim - 2))
        h, w = arr.shape[0], arr.shape[1]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return arr[i:i + th, j:j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def _apply_image(self, img):
        arr = _to_np(img)
        h, w = arr.shape[0], arr.shape[1]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = _to_np(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.ascontiguousarray(np.fliplr(_to_np(img)))


def vflip(img):
    return np.ascontiguousarray(np.flipud(_to_np(img)))


class Pad(BaseTransform):
    """ref transforms.Pad — pad HWC images on each border."""

    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(padding, numbers.Number):
            padding = [padding] * 4
        elif len(padding) == 2:
            padding = [padding[0], padding[1], padding[0], padding[1]]
        self.padding = padding  # left, top, right, bottom
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        arr = _to_np(img)
        l, t, r, b = self.padding
        pads = [(t, b), (l, r)] + [(0, 0)] * (arr.ndim - 2)
        if self.padding_mode == "constant":
            return np.pad(arr, pads, constant_values=self.fill)
        return np.pad(arr, pads, mode=self.padding_mode)


class Grayscale(BaseTransform):
    """ref transforms.Grayscale — ITU-R 601-2 luma transform."""

    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        raw = _to_np(img)
        arr = raw.astype(np.float32)
        if arr.ndim == 2:
            g = arr
        else:
            g = _rgb_to_gray(arr)
        g = g[..., None]
        if self.num_output_channels == 3:
            g = np.repeat(g, 3, axis=-1)
        return g.astype(raw.dtype)


def _rgb_to_gray(arr):
    """ITU-R 601-2 luma; arr float HWC-3."""
    return arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114


def _clip_to_dtype(out, dtype):
    return np.clip(out, 0, 255 if dtype == np.uint8 else np.inf).astype(dtype)


def _inverse_warp(arr, sy, sx, fill, out_shape=None):
    """Nearest-neighbor gather at source coords (sy, sx); out-of-bounds
    pixels get ``fill``. Shared by rotation/affine/perspective."""
    h, w = arr.shape[0], arr.shape[1]
    syi = np.round(sy).astype(np.int64)
    sxi = np.round(sx).astype(np.int64)
    valid = (syi >= 0) & (syi < h) & (sxi >= 0) & (sxi < w)
    shape = (out_shape or sy.shape) + arr.shape[2:]
    out = np.full(shape, fill, dtype=arr.dtype)
    out[valid] = arr[np.clip(syi, 0, h - 1), np.clip(sxi, 0, w - 1)][valid]
    return out


def _jitter_range(value, center=1.0):
    """Accept the reference's scalar-or-(min,max) forms: scalar v means
    U(center-v, center+v) clamped at 0; a sequence is used as-is."""
    if isinstance(value, (list, tuple)):
        lo, hi = float(value[0]), float(value[1])
    else:
        v = float(value)
        lo, hi = max(0.0, center - v), center + v
    return lo, hi


class BrightnessTransform(BaseTransform):
    """ref transforms.BrightnessTransform — scale by U(1-v, 1+v)."""

    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.range = _jitter_range(value)

    def _apply_image(self, img):
        if self.range == (1.0, 1.0):
            return img
        arr = _to_np(img)
        f = random.uniform(*self.range)
        return _clip_to_dtype(arr.astype(np.float32) * f, arr.dtype)


class ContrastTransform(BaseTransform):
    """ref transforms.ContrastTransform — blend with the mean GRAY level
    (luma mean, matching adjust_contrast)."""

    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.range = _jitter_range(value)

    def _apply_image(self, img):
        if self.range == (1.0, 1.0):
            return img
        raw = _to_np(img)
        arr = raw.astype(np.float32)
        f = random.uniform(*self.range)
        if arr.ndim == 3 and arr.shape[-1] == 3:
            pivot = _rgb_to_gray(arr).mean()
        else:
            pivot = arr.mean()
        out = pivot + f * (arr - pivot)
        return _clip_to_dtype(out, raw.dtype)


class SaturationTransform(BaseTransform):
    """ref transforms.SaturationTransform — blend with the grayscale image."""

    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.range = _jitter_range(value)

    def _apply_image(self, img):
        if self.range == (1.0, 1.0):
            return img
        raw = _to_np(img)
        if raw.ndim != 3 or raw.shape[-1] != 3:
            return img  # saturation undefined off 3-channel RGB
        arr = raw.astype(np.float32)
        f = random.uniform(*self.range)
        gray = _rgb_to_gray(arr)[..., None]
        out = gray + f * (arr - gray)
        return _clip_to_dtype(out, raw.dtype)


class HueTransform(BaseTransform):
    """ref transforms.HueTransform — shift hue in HSV space by U(-v, v),
    v in [0, 0.5]."""

    def __init__(self, value, keys=None):
        super().__init__(keys)
        if isinstance(value, (list, tuple)):
            self.range = (float(value[0]), float(value[1]))
        else:
            v = float(value)
            self.range = (-v, v)

    def _apply_image(self, img):
        if self.range == (0.0, 0.0):
            return img
        arr = _to_np(img)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            return img  # hue rotation is only defined on 3-channel RGB
        f = random.uniform(*self.range)
        x = arr.astype(np.float32) / (255.0 if arr.dtype == np.uint8 else 1.0)
        # RGB->HSV hue rotation (vectorized)
        mx, mn = x.max(-1), x.min(-1)
        diff = mx - mn + 1e-12
        h = np.zeros_like(mx)
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        h = np.where(mx == r, ((g - b) / diff) % 6, h)
        h = np.where(mx == g, (b - r) / diff + 2, h)
        h = np.where(mx == b, (r - g) / diff + 4, h)
        h = (h / 6.0 + f) % 1.0
        s = np.where(mx > 0, diff / (mx + 1e-12), 0)
        v = mx
        # HSV->RGB
        i = np.floor(h * 6.0)
        ff = h * 6.0 - i
        p = v * (1 - s)
        q = v * (1 - s * ff)
        t = v * (1 - s * (1 - ff))
        i = (i.astype(np.int32) % 6)[..., None]
        out = np.select(
            [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
            [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
             np.stack([p, v, t], -1), np.stack([p, q, v], -1),
             np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
        if arr.dtype == np.uint8:
            out = np.clip(out * 255.0, 0, 255)
        return out.astype(arr.dtype)


class ColorJitter(BaseTransform):
    """ref transforms.ColorJitter — random brightness/contrast/saturation/hue
    in random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        super().__init__(keys)
        self._ts = [BrightnessTransform(brightness), ContrastTransform(contrast),
                    SaturationTransform(saturation), HueTransform(hue)]

    def _apply_image(self, img):
        ts = list(self._ts)
        random.shuffle(ts)
        for t in ts:
            img = t(img)
        return img


class RandomResizedCrop(BaseTransform):
    """ref transforms.RandomResizedCrop — random area/aspect crop, resized."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        arr = _to_np(img)
        h, w = arr.shape[0], arr.shape[1]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target * ar)))
            th = int(round(np.sqrt(target / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = random.randint(0, h - th)
                j = random.randint(0, w - tw)
                return self._resize(arr[i:i + th, j:j + tw])
        # fallback (ref behavior): clamp aspect ratio, center crop
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            tw, th = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            th, tw = h, int(round(h * self.ratio[1]))
        else:
            th, tw = h, w
        i = (h - th) // 2
        j = (w - tw) // 2
        return self._resize(arr[i:i + th, j:j + tw])


class RandomRotation(BaseTransform):
    """ref transforms.RandomRotation — rotate by U(-degrees, degrees) about
    the center (nearest-neighbor resample, constant fill)."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        arr = _to_np(img)
        angle = np.deg2rad(random.uniform(*self.degrees))
        h, w = arr.shape[0], arr.shape[1]
        ca, sa = np.cos(angle), np.sin(angle)
        if self.expand:
            oh = int(np.ceil(abs(h * ca) + abs(w * sa)))
            ow = int(np.ceil(abs(w * ca) + abs(h * sa)))
        else:
            oh, ow = h, w
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        ocy, ocx = (oh - 1) / 2.0, (ow - 1) / 2.0
        if self.center is not None and not self.expand:
            cx, cy = self.center
            ocy, ocx = cy, cx
        yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
        # inverse map: source = R(-angle) · (dst - oc) + c
        sy = ca * (yy - ocy) - sa * (xx - ocx) + cy
        sx = sa * (yy - ocy) + ca * (xx - ocx) + cx
        return _inverse_warp(arr, sy, sx, self.fill, out_shape=(oh, ow))


class RandomErasing(BaseTransform):
    """ref transforms.RandomErasing — erase a random rectangle (value or
    per-pixel noise)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        was_tensor = isinstance(img, Tensor)
        arr = np.array(_to_np(img))
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3) and \
            arr.shape[-1] not in (1, 3)
        h, w = (arr.shape[1], arr.shape[2]) if chw else (arr.shape[0], arr.shape[1])
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = random.randint(0, h - eh)
                j = random.randint(0, w - ew)
                if isinstance(self.value, str) and self.value == "random":
                    # seed from the random module so random.seed() makes the
                    # whole pipeline reproducible
                    rng = np.random.RandomState(random.getrandbits(32))
                    patch = rng.rand(
                        *(arr[..., i:i + eh, j:j + ew].shape if chw else
                          arr[i:i + eh, j:j + ew].shape)) * (
                        255 if arr.dtype == np.uint8 else 1)
                    patch = patch.astype(arr.dtype)
                else:
                    patch = np.asarray(self.value, dtype=arr.dtype)
                    if patch.ndim == 1:  # per-channel fill
                        patch = patch.reshape((-1, 1, 1) if chw else (1, 1, -1))
                if chw:
                    arr[..., i:i + eh, j:j + ew] = patch
                else:
                    arr[i:i + eh, j:j + ew] = patch
                return _tensor(arr) if was_tensor else arr
        return _tensor(arr) if was_tensor else arr


class RandomAffine(BaseTransform):
    """ref transforms.RandomAffine — rotation/translate/scale/shear sampled
    per call, nearest-neighbor inverse warp."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.translate = translate
        self.scale_rng = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        arr = _to_np(img)
        h, w = arr.shape[0], arr.shape[1]
        angle = np.deg2rad(random.uniform(*self.degrees))
        tx = ty = 0.0
        if self.translate:
            tx = random.uniform(-self.translate[0], self.translate[0]) * w
            ty = random.uniform(-self.translate[1], self.translate[1]) * h
        sc = random.uniform(*self.scale_rng) if self.scale_rng else 1.0
        if isinstance(self.shear, numbers.Number):
            sh = np.deg2rad(random.uniform(-self.shear, self.shear))
        elif isinstance(self.shear, (list, tuple)) and len(self.shear) >= 2:
            sh = np.deg2rad(random.uniform(self.shear[0], self.shear[1]))
        else:
            sh = 0.0
        if self.center is not None:
            cx, cy = self.center
        else:
            cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        ca, sa = np.cos(angle), np.sin(angle)
        # forward affine A = R·Shear·Scale; inverse-map each dst pixel
        a11, a12 = ca * sc, (-sa + ca * np.tan(sh)) * sc
        a21, a22 = sa * sc, (ca + sa * np.tan(sh)) * sc
        det = a11 * a22 - a12 * a21
        i11, i12, i21, i22 = a22 / det, -a12 / det, -a21 / det, a11 / det
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        dy, dx = yy - cy - ty, xx - cx - tx
        sy = i11 * dy + i12 * dx + cy
        sx = i21 * dy + i22 * dx + cx
        return _inverse_warp(arr, sy, sx, self.fill)


AffineTransform = RandomAffine  # legacy alias used by some reference code


class RandomPerspective(BaseTransform):
    """ref transforms.RandomPerspective — random corner displacement warp."""

    def __init__(self, prob=0.5, distortion_scale=0.5, interpolation="nearest",
                 fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        arr = _to_np(img)
        h, w = arr.shape[0], arr.shape[1]
        d = self.distortion_scale
        dh, dw = int(h * d / 2), int(w * d / 2)

        def jit(y, x):
            return (y + random.randint(-dh, dh) if dh else y,
                    x + random.randint(-dw, dw) if dw else x)

        src = np.float64([[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1]])
        dst = np.float64([jit(0, 0), jit(0, w - 1), jit(h - 1, 0),
                          jit(h - 1, w - 1)])
        # solve the 8-dof homography dst->src (inverse map)
        A, b = [], []
        for (ys, xs), (yd, xd) in zip(src, dst):
            A.append([yd, xd, 1, 0, 0, 0, -ys * yd, -ys * xd])
            b.append(ys)
            A.append([0, 0, 0, yd, xd, 1, -xs * yd, -xs * xd])
            b.append(xs)
        try:
            hvec = np.linalg.solve(np.float64(A), np.float64(b))
        except np.linalg.LinAlgError:
            return arr
        m = np.append(hvec, 1.0).reshape(3, 3)
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        den = m[2, 0] * yy + m[2, 1] * xx + 1.0
        sy = (m[0, 0] * yy + m[0, 1] * xx + m[0, 2]) / den
        sx = (m[1, 0] * yy + m[1, 1] * xx + m[1, 2]) / den
        return _inverse_warp(arr, sy, sx, self.fill)


from . import functional  # noqa: E402,F401
from .functional import (adjust_brightness, adjust_contrast,  # noqa: E402,F401
                         adjust_hue, affine, center_crop, crop, erase, pad,
                         perspective, rotate, to_grayscale)
