"""Random draws — port of ``paddle_tpu/tensor/random.py``.

The JAX package draws from one splitting ``jax.random`` key; the port
draws from each device's ``torch.Generator``
(``framework/random.default_generator``: PyTorch's own default
generators, which ``paddle.seed`` seeds, so a seed repeats a draw). The
port keeps JAX's distributions, not its streams: no draw equals
``jax.random``'s. A ``seed=`` argument (``uniform``, ``gaussian``) draws
from a generator of its own seeded with it, a repeatable draw of its own,
as in JAX. ``multinomial`` draws with replacement whatever
``replacement`` says, as the JAX package's categorical draw does.

A function that makes a tensor from nothing takes ``device`` (``place``
its alias; None: the card, raising without one); one of a tensor draws on
that tensor's device.
"""
from __future__ import annotations

import torch

from .. import resolve_place
from ..framework.dtype import convert_dtype, get_default_dtype
from ..framework.random import default_generator

__all__ = ["bernoulli", "bernoulli_", "binomial", "exponential_",
           "gaussian", "log_normal", "multinomial", "normal", "normal_",
           "poisson", "rand", "rand_like", "randint", "randint_like", "randn",
           "randn_like", "randperm", "standard_gamma", "standard_normal",
           "uniform", "uniform_"]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _gen(device, seed=0):
    """The device's default generator, or a new one seeded with a nonzero
    ``seed``."""
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return default_generator(device)


def _float(dtype):
    return convert_dtype(dtype) or get_default_dtype()


def rand(shape, dtype=None, name=None, *, device=None, place=None):
    dev = resolve_place(device, place)
    return torch.rand(_shape(shape), dtype=_float(dtype), device=dev,
                      generator=_gen(dev))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None, *,
            device=None, place=None):
    dev = resolve_place(device, place)
    out = torch.empty(_shape(shape), dtype=_float(dtype), device=dev)
    return out.uniform_(min, max, generator=_gen(dev, seed))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with torch.no_grad():
        return x.uniform_(min, max, generator=_gen(x.device, seed))


def randn(shape, dtype=None, name=None, *, device=None, place=None):
    dev = resolve_place(device, place)
    return torch.randn(_shape(shape), dtype=_float(dtype), device=dev,
                       generator=_gen(dev))


def normal(mean=0.0, std=1.0, shape=None, name=None, *, device=None,
           place=None):
    """``mean + std · N(0, 1)`` of the broadcast shape of tensor ``mean``
    / ``std`` (on their device), else of ``shape``."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        shp = torch.broadcast_shapes(
            tuple(getattr(mean, "shape", ())), tuple(getattr(std, "shape",
                                                             ())))
        z = torch.randn(shp, dtype=get_default_dtype(), device=ref.device,
                        generator=_gen(ref.device))
        return z * std + mean
    dev = resolve_place(device, place)
    shp = _shape(shape) if shape is not None else ()
    return torch.randn(shp, dtype=get_default_dtype(), device=dev,
                       generator=_gen(dev)) * std + mean


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(x.device))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None, *,
             device=None, place=None):
    dev = resolve_place(device, place)
    return torch.randn(_shape(shape), dtype=_float(dtype), device=dev,
                       generator=_gen(dev, seed)) * std + mean


def standard_normal(shape, dtype=None, name=None, *, device=None,
                    place=None):
    return randn(shape, dtype, device=device, place=place)


def standard_gamma(alpha, name=None):
    """Gamma(``alpha``, 1) draws (PyTorch's sampler draws from the
    device's default generator)."""
    return torch._standard_gamma(alpha)


def poisson(x, name=None):
    return torch.poisson(x, generator=_gen(x.device))


def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=_gen(x.device))


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        return x.bernoulli_(p, generator=_gen(x.device))


def binomial(count, prob, name=None):
    """int64 Binomial(``count``, ``prob``) draws."""
    p = prob.float()
    n = torch.broadcast_to(count.to(p.dtype), p.shape)
    return torch.binomial(n, p, generator=_gen(p.device)).long()


def multinomial(x, num_samples=1, replacement=False, name=None):
    """int64 category draws from the (unnormalised) probabilities ``x``:
    ``[num_samples]`` for 1-D, ``[rows, num_samples]`` for 2-D."""
    return torch.multinomial(x.float(), num_samples, replacement=True,
                             generator=_gen(x.device))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None, *,
            device=None, place=None):
    if high is None:
        low, high = 0, low
    dev = resolve_place(device, place)
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=convert_dtype(dtype), device=dev,
                         generator=_gen(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), tuple(x.shape),
                         dtype=convert_dtype(dtype) or x.dtype,
                         device=x.device, generator=_gen(x.device))


def randperm(n, dtype="int64", name=None, *, device=None, place=None):
    dev = resolve_place(device, place)
    return torch.randperm(int(n), dtype=convert_dtype(dtype), device=dev,
                          generator=_gen(dev))


def rand_like(x, dtype=None, name=None):
    return torch.rand(tuple(x.shape), dtype=convert_dtype(dtype) or x.dtype,
                      device=x.device, generator=_gen(x.device))


def randn_like(x, dtype=None, name=None):
    return torch.randn(tuple(x.shape), dtype=convert_dtype(dtype) or x.dtype,
                       device=x.device, generator=_gen(x.device))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(x.device))


def log_normal(mean=1.0, std=2.0, shape=None, name=None, *, device=None,
               place=None):
    dev = resolve_place(device, place)
    shp = _shape(shape) if shape is not None else ()
    return torch.exp(torch.randn(shp, dtype=get_default_dtype(), device=dev,
                                 generator=_gen(dev)) * std + mean)
