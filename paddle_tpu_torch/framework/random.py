"""The framework's random state — port of ``paddle_tpu/framework/random.py``.

The JAX package keeps one splitting ``jax.random`` key; the port keeps
one ``torch.Generator`` a device, all seeded by :func:`seed`. A layer or a
creation function draws from the generator it is given, else from
:func:`default_generator` of the device it builds on (the CPU's, or the
card's). The draws never equal ``jax.random``'s: a test that holds the
port against the JAX package carries the JAX weights across instead.

:func:`get_rng_state` / :func:`set_rng_state` save and restore every
device's generator state (a list of byte tensors, the CPU's first); the
JAX package's state is its key data, which the port cannot read.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["default_generator", "get_rng_state", "seed", "set_rng_state"]


def default_generator(device="cpu") -> torch.Generator:
    """The generator draws on ``device`` take by default: PyTorch's own
    default generator of that device (the CUDA device's is registered
    with every CUDA graph by PyTorch itself)."""
    device = torch.device(device)
    if device.type == "cuda":
        idx = torch.cuda.current_device() if device.index is None \
            else device.index
        return torch.cuda.default_generators[idx]
    if device.type != "cpu":
        raise ValueError(f"no generator for device {device}")
    return torch.default_generator


def seed(s: int) -> torch.Generator:
    """``paddle.seed``: seeds the CPU generator and every CUDA device's
    (without initialising CUDA where it is not yet), and the global numpy
    stream, as the JAX package's does; returns the CPU generator."""
    torch.manual_seed(int(s))
    # legacy consumers (user code, datasets) read the global numpy stream;
    # seeding it here is the API's contract, as in the JAX package
    np.random.seed(int(s) % (2 ** 32))
    return torch.default_generator


def get_rng_state():
    """Every generator's state: ``[cpu] + [cuda:i ...]`` (byte tensors)."""
    states = [torch.get_rng_state()]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        states += torch.cuda.get_rng_state_all()
    return states


def set_rng_state(state) -> None:
    """Inverse of :func:`get_rng_state`."""
    torch.set_rng_state(state[0])
    if len(state) > 1:
        torch.cuda.set_rng_state_all(state[1:])
