"""Auxiliary tensor containers — port of
``paddle_tpu/framework/containers.py``: :class:`TensorArray` (a list of
tensors written, read and stacked) and :class:`SelectedRows` (row slices
of a tall tensor, the gradient type of large embedding tables), which
densifies with one ``index_add_``."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    from .io_state import from_numpy

    return from_numpy(np.asarray(x), resolve_device(device))


class TensorArray:
    """Dynamic array of same-rank tensors (write / read / stack); numbers
    and arrays become tensors on ``device`` (None: the card)."""

    def __init__(self, values: Optional[Sequence] = None, device=None):
        self.device = device
        self._items: List[Optional[torch.Tensor]] = list(values) \
            if values else []

    def append(self, x) -> "TensorArray":
        self._items.append(_tensor(x, self.device))
        return self

    def write(self, index: int, x):
        index = int(index)
        if index >= len(self._items):
            self._items.extend([None] * (index + 1 - len(self._items)))
        self._items[index] = _tensor(x, self.device)

    def read(self, index: int) -> torch.Tensor:
        item = self._items[int(index)]
        if item is None:
            raise IndexError(f"TensorArray slot {index} was never written")
        return item

    def stack(self, axis: int = 0) -> torch.Tensor:
        holes = [i for i, t in enumerate(self._items) if t is None]
        if holes:
            raise IndexError(
                f"TensorArray.stack: slots {holes} were never written "
                "(write() every index, or append() densely)")
        return torch.stack(self._items, axis)

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self.read(i)


class SelectedRows:
    """Row-sparse tensor: ``value[i]`` is the slice for row ``rows[i]`` of
    a ``[height, ...]`` tensor (rows may repeat: their slices add)."""

    def __init__(self, rows, value, height: int):
        self.value = _tensor(value, None if not isinstance(
            rows, torch.Tensor) else rows.device)
        self.rows = _tensor(rows, self.value.device).to(
            self.value.device, torch.int64)
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.value.shape[1:])

    def to_dense(self) -> torch.Tensor:
        dense = torch.zeros(self.shape, dtype=self.value.dtype,
                            device=self.value.device)
        return dense.index_add_(0, self.rows, self.value)

    def merge(self) -> "SelectedRows":
        """Duplicate row ids merged by summing their slices, as the JAX
        package's: as many rows as before, the unique ids first (sorted),
        then row 0 with zero slices."""
        n = self.rows.shape[0]
        uniq, inv = torch.unique(self.rows, sorted=True, return_inverse=True)
        pad = torch.full((n - uniq.shape[0],), self.height,
                         dtype=uniq.dtype, device=uniq.device)
        uniq = torch.cat([uniq, pad])
        merged = torch.zeros((n,) + tuple(self.value.shape[1:]),
                             dtype=self.value.dtype,
                             device=self.value.device).index_add_(
            0, inv, self.value)
        keep = uniq < self.height
        mask = keep.reshape((-1,) + (1,) * (self.value.dim() - 1))
        return SelectedRows(torch.where(keep, uniq, torch.zeros_like(uniq)),
                            merged * mask, self.height)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]})")
