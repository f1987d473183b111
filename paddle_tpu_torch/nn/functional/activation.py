"""Activations — port of ``paddle_tpu/nn/functional/activation.py``
(``gelu``, ``relu``, ``tanh``)."""
from __future__ import annotations

import torch
from torch.nn import functional as F


def gelu(x, approximate=False):
    """GELU; exact (erf) unless ``approximate`` (the tanh form), as
    ``jax.nn.gelu(v, approximate=approximate)`` with the JAX package's
    default ``approximate=False``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)
