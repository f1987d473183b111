"""The vision data side of the PyTorch port
(``paddle_tpu_torch/vision/transforms``, ``transforms/functional.py`` and
``vision/datasets``) against the JAX package on the CPU.

The random transforms draw from Python's ``random`` (``RandomErasing``'s
noise from a numpy generator it seeds), so each case seeds ``random`` and
``np.random`` alike before each package runs. Every transform is numpy on
the host in both packages, so results are held exactly, but for
``Resize`` (and ``RandomResizedCrop``, which resizes): JAX's
``jax.image.resize`` against the port's resize rule in PyTorch, fp32
results within 1e-4 of the largest value, uint8 ones within one level
(the cast truncates, so a value a rounding below a whole number falls a
level lower in one package). A JAX-package tensor result is compared as
numpy with the port's CPU ``torch.Tensor``."""
import random

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.vision.transforms as JT
import paddle_tpu.vision.transforms.functional as JF
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.vision.transforms as TT
import paddle_tpu_torch.vision.transforms.functional as TF
from torch_tensor_parity import host

RNG = np.random.RandomState(0)
U8 = RNG.randint(0, 256, (20, 24, 3)).astype(np.uint8)
GRAY = RNG.randint(0, 256, (20, 24)).astype(np.uint8)
F32 = RNG.rand(20, 24, 3).astype(np.float32)
CHW = RNG.rand(3, 20, 24).astype(np.float32)


def _np(v):
    if isinstance(v, (torch.Tensor, jpaddle.Tensor)):
        return host(v)
    return np.asarray(v)


def _run(make, img, seed):
    """``make(T, F)(img)`` for both packages, the generators seeded alike;
    a tensor input enters each package as its own tensor."""
    out = []
    for T, F, wrap in ((JT, JF, jpaddle.to_tensor),
                       (TT, TF, lambda a: torch.from_numpy(a.copy()))):
        random.seed(seed)
        np.random.seed(seed)
        arg = wrap(img[1]) if isinstance(img, tuple) else img
        out.append(make(T, F)(arg))
    return out


def _exact(j, t, what):
    assert isinstance(t, torch.Tensor) == isinstance(j, jpaddle.Tensor), \
        (what, type(j), type(t))
    a, b = _np(j), _np(t)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(b, a, err_msg=what)


TENSOR = ("tensor", CHW)     # a CHW tensor input in either package

EXACT = {
    "to_tensor": (lambda T, F: T.ToTensor(), U8),
    "to_tensor_hwc": (lambda T, F: T.ToTensor("HWC"), F32),
    "to_tensor_gray": (lambda T, F: T.ToTensor(), GRAY),
    "normalize_chw": (lambda T, F: T.Normalize([0.5, 0.4, 0.3],
                                               [0.2, 0.3, 0.4]), TENSOR),
    "normalize_hwc": (lambda T, F: T.Normalize(0.5, 0.25, "HWC"), F32),
    "compose": (lambda T, F: T.Compose([
        T.RandomHorizontalFlip(), T.ToTensor(),
        T.Normalize([0.49, 0.48, 0.45], [0.25, 0.24, 0.26])]), U8),
    "hflip_random": (lambda T, F: T.RandomHorizontalFlip(), U8),
    "hflip_chw": (lambda T, F: T.RandomHorizontalFlip(1.0), CHW),
    "vflip": (lambda T, F: T.RandomVerticalFlip(1.0), U8),
    "random_crop": (lambda T, F: T.RandomCrop(12), U8),
    "random_crop_padded": (lambda T, F: T.RandomCrop((16, 18), padding=2),
                           U8),
    "center_crop": (lambda T, F: T.CenterCrop((9, 30)), U8),
    "transpose": (lambda T, F: T.Transpose(), U8),
    "transpose_gray": (lambda T, F: T.Transpose((2, 1, 0)), GRAY),
    "fn_to_tensor": (lambda T, F: lambda x: T.to_tensor(x), U8),
    "fn_normalize": (lambda T, F: lambda x: T.normalize(
        x, [0.1, 0.2, 0.3], [1.0, 2.0, 3.0], "HWC"), F32),
    "fn_hflip": (lambda T, F: T.hflip, U8),
    "fn_vflip": (lambda T, F: T.vflip, U8),
    "pad_constant": (lambda T, F: T.Pad(2, fill=9), U8),
    "pad_reflect": (lambda T, F: T.Pad((1, 3), padding_mode="reflect"), U8),
    "pad_edge4": (lambda T, F: T.Pad([1, 2, 3, 4], padding_mode="edge"),
                  GRAY),
    "grayscale": (lambda T, F: T.Grayscale(), U8),
    "grayscale3": (lambda T, F: T.Grayscale(3), F32),
    "brightness": (lambda T, F: T.BrightnessTransform(0.4), U8),
    "brightness_off": (lambda T, F: T.BrightnessTransform(0.0), U8),
    "contrast": (lambda T, F: T.ContrastTransform((0.5, 1.5)), U8),
    "contrast_gray": (lambda T, F: T.ContrastTransform(0.3), GRAY),
    "saturation": (lambda T, F: T.SaturationTransform(0.5), U8),
    "saturation_gray": (lambda T, F: T.SaturationTransform(0.5), GRAY),
    "hue": (lambda T, F: T.HueTransform(0.3), U8),
    "hue_float": (lambda T, F: T.HueTransform((-0.2, 0.1)), F32),
    "color_jitter": (lambda T, F: T.ColorJitter(0.3, 0.3, 0.3, 0.1), U8),
    "rotation": (lambda T, F: T.RandomRotation(30), U8),
    "rotation_expand": (lambda T, F: T.RandomRotation((10, 50), expand=True,
                                                      fill=7), U8),
    "rotation_center": (lambda T, F: T.RandomRotation(20, center=(3, 5)),
                        GRAY),
    "erasing": (lambda T, F: T.RandomErasing(1.0, value=5), U8),
    "erasing_random": (lambda T, F: T.RandomErasing(1.0, value="random"),
                       U8),
    "erasing_channels": (lambda T, F: T.RandomErasing(
        1.0, value=[1, 2, 3]), U8),
    "erasing_chw_tensor": (lambda T, F: T.RandomErasing(
        1.0, value=[0.1, 0.2, 0.3]), TENSOR),
    "erasing_skipped": (lambda T, F: T.RandomErasing(0.0), U8),
    "affine": (lambda T, F: T.RandomAffine(25, translate=(0.1, 0.2),
                                           scale=(0.8, 1.2), shear=10), U8),
    "affine_shear_range": (lambda T, F: T.RandomAffine(
        0, shear=(-5, 15), center=(4, 6), fill=3), GRAY),
    "affine_alias": (lambda T, F: T.AffineTransform(15), F32),
    "perspective": (lambda T, F: T.RandomPerspective(1.0, 0.6), U8),
    "perspective_skipped": (lambda T, F: T.RandomPerspective(0.0), U8),
    "fn_brightness": (lambda T, F: lambda x: F.adjust_brightness(x, 1.7), U8),
    "fn_contrast": (lambda T, F: lambda x: F.adjust_contrast(x, 0.4), U8),
    "fn_hue": (lambda T, F: lambda x: F.adjust_hue(x, -0.25), U8),
    "fn_hue_tensor": (lambda T, F: lambda x: F.adjust_hue(x, 0.1),
                      ("tensor", U8)),
    "fn_grayscale": (lambda T, F: lambda x: F.to_grayscale(x, 3), U8),
    "fn_crop": (lambda T, F: lambda x: F.crop(x, 2, 3, 10, 11), U8),
    "fn_crop_tensor": (lambda T, F: lambda x: F.crop(x, 2, 3, 10, 11),
                       ("tensor", F32)),
    "fn_center_crop": (lambda T, F: lambda x: F.center_crop(x, 8), U8),
    "fn_pad": (lambda T, F: lambda x: F.pad(x, [1, 2], fill=4), U8),
    "fn_rotate": (lambda T, F: lambda x: F.rotate(x, 33, expand=True), U8),
    "fn_affine": (lambda T, F: lambda x: F.affine(
        x, 12, (2, -3), 1.1, (5, 0)), U8),
    "fn_affine_center": (lambda T, F: lambda x: F.affine(
        x, -20, None, None, 8, center=(5, 5), fill=1), GRAY),
    "fn_perspective": (lambda T, F: lambda x: F.perspective(
        x, [[0, 0], [23, 0], [23, 19], [0, 19]],
        [[2, 1], [21, 0], [23, 17], [1, 19]]), U8),
    "fn_erase_array": (lambda T, F: lambda x: F.erase(x, 2, 3, 4, 5, 9), U8),
    "fn_erase_tensor": (lambda T, F: lambda x: F.erase(
        x, 1, 2, 5, 6, np.asarray([0.5, 0.6, 0.7], np.float32)), TENSOR),
}


@pytest.mark.parametrize("name", sorted(EXACT))
@pytest.mark.parametrize("seed", [0, 3])
def test_transforms_match_jax_exactly(name, seed):
    make, img = EXACT[name]
    j, t = _run(make, img, seed)
    _exact(j, t, name)


RESIZE = {
    "u8_down": (lambda T, F: T.Resize((11, 13)), U8),
    "u8_up": (lambda T, F: T.Resize(37), U8),
    "f32_down": (lambda T, F: T.Resize((7, 30)), F32),
    "f32_chw_up": (lambda T, F: T.Resize((25, 31)), CHW),
    "gray_down": (lambda T, F: lambda x: T.resize(x, (10, 9)), GRAY),
    "resized_crop": (lambda T, F: T.RandomResizedCrop(
        16, scale=(0.3, 0.9)), U8),
    "resized_crop_fallback": (lambda T, F: T.RandomResizedCrop(
        (8, 12), scale=(5.0, 6.0)), U8),
}


@pytest.mark.parametrize("name", sorted(RESIZE))
@pytest.mark.parametrize("seed", [0, 3])
def test_resize_matches_jax(name, seed):
    make, img = RESIZE[name]
    j, t = _run(make, img, seed)
    a, b = _np(j), _np(t)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == np.uint8:
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
    else:
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale)


def test_resize_truncates_uint8_as_jax_does():
    """Both packages cast the fp32 resize back with ``astype``: values
    a hair below a whole number truncate a level down (the quirk kept)."""
    img = np.full((4, 4), 100, np.uint8)
    img[0, 0] = 101
    for T in (JT, TT):
        out = _np(T.Resize((2, 2))(img))
        assert out.dtype == np.uint8 and out[1, 1] == 100
        # the exact 2x2 average of [[101, 100], [100, 100]] is 100.25
        assert out[0, 0] == 100


# ------------------------------------------------------------- datasets

DATASETS = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
            "VOC2012"]


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_datasets_match_jax(name, mode):
    jd = getattr(jpaddle.vision.datasets, name)(mode=mode)
    td = getattr(tpaddle.vision.datasets, name)(mode=mode)
    assert len(td) == len(jd)
    for idx in (0, 5, len(jd) - 1):
        (ji, jl), (ti, tl) = jd[idx], td[idx]
        _exact(ji, ti, f"{name}[{idx}] image")
        _exact(jl, tl, f"{name}[{idx}] label")


def test_dataset_transform_runs_on_each_sample():
    def make(T, F):
        ds = (jpaddle if T is JT else tpaddle).vision.datasets.Cifar10(
            transform=T.Compose([T.RandomHorizontalFlip(), T.ToTensor()]))
        return lambda _: [ds[i][0] for i in range(4)]

    j, t = _run(make, None, 1)
    for a, b in zip(j, t):
        _exact(a, b, "cifar10 transform")


def test_dataset_folder_matches_jax(tmp_path):
    from PIL import Image

    for ci, cls in enumerate(["cat", "dog"]):
        d = tmp_path / cls
        d.mkdir()
        np.save(d / "a.npy", np.full((4, 5, 3), ci, np.uint8))
        Image.fromarray(U8).save(d / "b.png")
    for name in ("DatasetFolder", "ImageFolder"):
        jd = getattr(jpaddle.vision.datasets, name)(str(tmp_path))
        td = getattr(tpaddle.vision.datasets, name)(
            str(tmp_path), transform=None)
        assert td.classes == jd.classes == ["cat", "dog"]
        assert len(td) == len(jd) == 4
        for i in range(4):
            _exact(jd[i][0], td[i][0], f"{name}[{i}]")
            _exact(jd[i][1], td[i][1], f"{name}[{i}] label")
    assert len(tpaddle.vision.datasets.DatasetFolder(
        str(tmp_path / "none"))) == 0
