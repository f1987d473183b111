"""The high-level API — port of ``paddle_tpu/hapi``: ``Model`` (``fit`` /
``evaluate`` / ``predict``, ``save`` / ``load``), the callbacks and
``summary``."""
from .model import Model
from . import callbacks  # noqa: F401
from .summary import summary

__all__ = ["Model", "callbacks", "summary"]
