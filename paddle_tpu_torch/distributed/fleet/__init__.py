"""Counterpart of ``paddle_tpu.distributed.fleet``; so far only
:mod:`.recompute`."""
from .recompute import recompute

__all__ = ["recompute"]
