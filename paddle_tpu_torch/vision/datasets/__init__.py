"""Vision datasets — port of ``paddle_tpu/vision/datasets``.

As in the JAX package, the named datasets are synthetic: deterministic
images and labels with the real formats and shapes (sample ``idx`` drawn
from ``RandomState(seed + idx)``, the same draws as there), so that the
training recipes run end to end with no download; ``MNIST`` / ``Cifar10``
/ ``Cifar100`` are capped at 2048 samples. ``DatasetFolder`` /
``ImageFolder`` read a directory tree (``.npy`` files, or images through
Pillow, imported only when one is read).
"""
from __future__ import annotations

import os

import numpy as np

from ...io import Dataset


class _SyntheticImageDataset(Dataset):
    """Deterministic fake data with the correct schema."""

    def __init__(self, n, shape, num_classes, transform=None, seed=0):
        self._n = n
        self._shape = shape
        self._num_classes = num_classes
        self.transform = transform
        self._seed = seed

    def __len__(self):
        return self._n

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seed + idx)
        img = rng.randint(0, 256, self._shape, np.uint8)
        label = np.asarray(rng.randint(0, self._num_classes), np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class MNIST(_SyntheticImageDataset):
    def __init__(self, image_path=None, label_path=None, mode="train", transform=None,
                 download=True, backend=None):
        n = 60000 if mode == "train" else 10000
        # keep tests fast: cap synthetic size
        super().__init__(min(n, 2048), (28, 28, 1), 10, transform)


class FashionMNIST(MNIST):
    pass


class Cifar10(_SyntheticImageDataset):
    def __init__(self, data_file=None, mode="train", transform=None, download=True,
                 backend=None):
        n = 50000 if mode == "train" else 10000
        super().__init__(min(n, 2048), (32, 32, 3), 10, transform)


class Cifar100(_SyntheticImageDataset):
    def __init__(self, data_file=None, mode="train", transform=None, download=True,
                 backend=None):
        n = 50000 if mode == "train" else 10000
        super().__init__(min(n, 2048), (32, 32, 3), 100, transform)


class Flowers(_SyntheticImageDataset):
    def __init__(self, data_file=None, label_file=None, setid_file=None, mode="train",
                 transform=None, download=True, backend=None):
        super().__init__(1024, (224, 224, 3), 102, transform)


class VOC2012(Dataset):
    """Segmentation dataset (ref: python/paddle/vision/datasets/voc2012.py).

    Samples: (image HWC uint8, label map HW uint8 with class ids 0..20 and
    255 = ignore). Synthetic fallback when the tarball is absent.
    """

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self._n = 256
        self.transform = transform
        self._seed = {"train": 0, "test": 1, "valid": 2}.get(mode, 0)

    def __len__(self):
        return self._n

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seed * 100003 + idx)
        img = rng.randint(0, 256, (224, 224, 3), np.uint8)
        label = rng.randint(0, 21, (224, 224), np.uint8)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.samples = []
        self.classes = []
        if os.path.isdir(root):
            self.classes = sorted(d for d in os.listdir(root)
                                  if os.path.isdir(os.path.join(root, d)))
            for ci, c in enumerate(self.classes):
                for f in sorted(os.listdir(os.path.join(root, c))):
                    self.samples.append((os.path.join(root, c, f), ci))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = np.load(path) if path.endswith(".npy") else self._load_image(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(label, np.int64)

    @staticmethod
    def _load_image(path):
        try:
            from PIL import Image

            return np.asarray(Image.open(path).convert("RGB"))
        except ImportError:
            raise ImportError("PIL is required for image folders")


ImageFolder = DatasetFolder
