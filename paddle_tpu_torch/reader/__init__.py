"""``paddle.reader`` — port of ``paddle_tpu/reader`` (host only)."""
from .decorator import (  # noqa: F401
    ComposeNotAligned, buffered, cache, chain, compose, firstn, map_readers,
    multiprocess_reader, shuffle, xmap_readers,
)

__all__ = []
