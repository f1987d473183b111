"""What the vision models share: the layers' keywords, resolved once."""
from __future__ import annotations

from ... import resolve_place
from ...nn import BatchNorm2D


def layer_kw(device=None, place=None, dtype=None, generator=None):
    """The keywords every layer of a model is built with: ``device``
    (``place`` its alias; None: the CUDA card, raising without one),
    ``dtype`` (None: the default dtype) and ``generator`` (the
    ``torch.Generator`` the weights draw from; None: the device's default
    one)."""
    return dict(device=resolve_place(device, place), dtype=dtype,
                generator=generator)


def bn(channels, kw):
    """``BatchNorm2D(channels)`` on the model's device and dtype."""
    return BatchNorm2D(channels, device=kw["device"], dtype=kw["dtype"])


def no_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported (no "
                                  "download); load a state dict")
