"""Functional transforms — port of
``paddle_tpu/vision/transforms/functional.py`` (adjust_brightness /
contrast / hue, crop / center_crop, pad, rotate, affine, perspective,
erase, to_grayscale).

Deterministic single-image forms of the random transform classes in
``__init__`` — they share the same numpy warp/color machinery
(_inverse_warp, _rgb_to_gray, the HSV rotation), so class and functional
paths cannot drift."""
from __future__ import annotations

import numbers

import numpy as np

import torch

Tensor = torch.Tensor


def _np(img):
    from . import _to_np

    return _to_np(img)


def _wrap_like(out, img):
    return torch.from_numpy(np.ascontiguousarray(out)) \
        if isinstance(img, Tensor) else out


def adjust_brightness(img, brightness_factor):
    """pixel * factor, clipped (ref functional.adjust_brightness)."""
    from . import _clip_to_dtype

    arr = _np(img)
    out = _clip_to_dtype(arr.astype(np.float32) * float(brightness_factor),
                         arr.dtype)
    return _wrap_like(out, img)


def adjust_contrast(img, contrast_factor):
    """blend with the mean luma level (ref functional.adjust_contrast)."""
    from . import _clip_to_dtype, _rgb_to_gray

    raw = _np(img)
    arr = raw.astype(np.float32)
    pivot = (_rgb_to_gray(arr).mean()
             if arr.ndim == 3 and arr.shape[-1] == 3 else arr.mean())
    out = pivot + float(contrast_factor) * (arr - pivot)
    return _wrap_like(_clip_to_dtype(out, raw.dtype), img)


def adjust_hue(img, hue_factor):
    """rotate hue by ``hue_factor`` in [-0.5, 0.5] turns (ref
    functional.adjust_hue); shares HueTransform's vectorized HSV math."""
    from . import HueTransform

    assert -0.5 <= hue_factor <= 0.5, hue_factor
    t = HueTransform.__new__(HueTransform)
    t.range = (float(hue_factor), float(hue_factor))
    t.keys = None
    out = t._apply_image(_np(img))
    return _wrap_like(out, img)


def to_grayscale(img, num_output_channels=1):
    """ITU-R 601-2 luma (ref functional.to_grayscale)."""
    from . import Grayscale

    out = Grayscale(num_output_channels)._apply_image(_np(img))
    return _wrap_like(out, img)


def crop(img, top, left, height, width):
    """HWC crop (ref functional.crop)."""
    arr = _np(img)
    return _wrap_like(arr[top:top + height, left:left + width], img)


def center_crop(img, output_size):
    """ref functional.center_crop."""
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    arr = _np(img)
    h, w = arr.shape[0], arr.shape[1]
    th, tw = output_size
    top = max(0, (h - th) // 2)
    left = max(0, (w - tw) // 2)
    return crop(img, top, left, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    """ref functional.pad — delegates to the Pad transform."""
    from . import Pad

    out = Pad(padding, fill=fill,
              padding_mode=padding_mode)._apply_image(_np(img))
    return _wrap_like(out, img)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """ref functional.rotate — deterministic RandomRotation."""
    from . import RandomRotation

    t = RandomRotation.__new__(RandomRotation)
    t.degrees = (float(angle), float(angle))
    t.expand = expand
    t.center = center
    t.fill = fill
    t.keys = None
    return _wrap_like(t._apply_image(_np(img)), img)


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """ref functional.affine — rotation/translate/scale/shear composed into
    ONE inverse map (translation inside the matrix: out-of-range pixels get
    ``fill``, never wrap)."""
    from . import _inverse_warp

    arr = _np(img)
    h, w = arr.shape[0], arr.shape[1]
    tx, ty = (translate if translate else (0, 0))
    sc = float(scale) if scale else 1.0
    sh = np.deg2rad(float(shear)) if isinstance(shear, numbers.Number) \
        else (np.deg2rad(float(shear[0])) if shear else 0.0)
    ang = np.deg2rad(float(angle))
    if center is not None:
        cx, cy = center
    else:
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ca, sa = np.cos(ang), np.sin(ang)
    a11, a12 = ca * sc, (-sa + ca * np.tan(sh)) * sc
    a21, a22 = sa * sc, (ca + sa * np.tan(sh)) * sc
    det = a11 * a22 - a12 * a21
    i11, i12, i21, i22 = a22 / det, -a12 / det, -a21 / det, a11 / det
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dy, dx = yy - cy - float(ty), xx - cx - float(tx)
    sy = i11 * dy + i12 * dx + cy
    sx = i21 * dy + i22 * dx + cx
    return _wrap_like(_inverse_warp(arr, sy, sx, fill), img)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """ref functional.perspective — warp mapping ``startpoints`` (corners,
    (x, y)) to ``endpoints``; shares RandomPerspective's homography solve."""
    from . import _inverse_warp

    arr = _np(img)
    h, w = arr.shape[0], arr.shape[1]
    # reference gives (x, y); the solver below works in (y, x)
    src = np.float64([[p[1], p[0]] for p in startpoints])
    dst = np.float64([[p[1], p[0]] for p in endpoints])
    A, b = [], []
    for (ys, xs), (yd, xd) in zip(src, dst):
        A.append([yd, xd, 1, 0, 0, 0, -ys * yd, -ys * xd])
        b.append(ys)
        A.append([0, 0, 0, yd, xd, 1, -xs * yd, -xs * xd])
        b.append(xs)
    hvec = np.linalg.solve(np.float64(A), np.float64(b))
    m = np.append(hvec, 1.0).reshape(3, 3)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    den = m[2, 0] * yy + m[2, 1] * xx + 1.0
    sy = (m[0, 0] * yy + m[0, 1] * xx + m[0, 2]) / den
    sx = (m[1, 0] * yy + m[1, 1] * xx + m[1, 2]) / den
    return _wrap_like(_inverse_warp(arr, sy, sx, fill), img)


def erase(img, i, j, h, w, v, inplace=False):
    """Erase the rectangle [i:i+h, j:j+w] with value ``v`` (ref
    functional.erase); CHW tensors and HWC arrays both supported."""
    was_tensor = isinstance(img, Tensor)
    arr = np.array(_np(img))
    # paddle contract: Tensor input is CHW, ndarray/PIL is HWC — branch on
    # the type, not on shape guesses (a (3, H, 3) strip would misclassify)
    chw = was_tensor and arr.ndim == 3
    val = np.asarray(v, dtype=arr.dtype)
    if chw:
        arr[..., i:i + h, j:j + w] = (
            val.reshape(-1, 1, 1) if val.ndim == 1 else val)
    else:
        arr[i:i + h, j:j + w] = (
            val.reshape(1, 1, -1) if val.ndim == 1 else val)
    return torch.from_numpy(arr) if was_tensor else arr
