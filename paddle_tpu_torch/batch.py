"""``paddle.batch`` — port of ``paddle_tpu/batch.py``: the batched reader
decorator (host only)."""
from __future__ import annotations

__all__ = []


def batch(reader, batch_size, drop_last=False):
    """Create a batched reader combining items from ``reader`` into lists.

    Args:
        reader: a no-arg callable returning a generator of samples.
        batch_size (int): number of samples per emitted batch.
        drop_last (bool): drop the trailing partial batch when True.
    """
    if batch_size <= 0 or int(batch_size) != batch_size:
        raise ValueError(
            f"batch_size should be a positive integer, but got {batch_size}")
    batch_size = int(batch_size)

    def batch_reader():
        buf = []
        for instance in reader():
            buf.append(instance)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
