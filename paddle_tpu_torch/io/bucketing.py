"""Sequence-length bucketing — port of ``paddle_tpu/io/bucketing.py``
(numpy only; a ``torch.Tensor`` in gives a CPU ``torch.Tensor`` out).

The graphed train engine captures one CUDA graph per batch shape, as XLA
compiles one program per shape in the JAX package: feeding every length
would capture one graph per distinct length.  The policy here caps the
shape set to a fixed bucket ladder:

- :func:`bucket_boundaries` — geometric ladder of lengths (each ~``growth``
  over the previous, ending at ``max_len``): capture count is
  O(log max_len), padding waste per batch < (growth-1).
- :func:`pad_to_bucket` — right-pad a [B, S] batch (and labels, with
  ``ignore_index`` so padded positions drop out of the loss) up to the
  smallest bucket >= S.
- :class:`LengthBucketBatchSampler` — groups sample indices by bucketed
  length so each batch pads to ITS bucket, minimizing waste while keeping
  the shape set fixed.  Drop-in ``batch_sampler`` for ``DataLoader``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["bucket_boundaries", "pad_to_bucket",
           "LengthBucketBatchSampler"]


def bucket_boundaries(max_len: int, min_len: int = 32,
                      growth: float = 1.3) -> List[int]:
    """Geometric bucket ladder, multiples of 8, capped at ``max_len``."""
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1 (got {growth}); growth <= 1 "
                         f"would never reach max_len")
    if min_len <= 0 or max_len < min_len:
        raise ValueError(f"need 0 < min_len <= max_len, got "
                         f"({min_len}, {max_len})")
    out = []
    cur = float(min_len)
    while cur < max_len:
        b = min(int(math.ceil(cur / 8.0) * 8), max_len)
        if not out or b > out[-1]:
            out.append(b)
        cur *= growth
    if not out or out[-1] != max_len:
        out.append(max_len)
    return out


def _bucket_of(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"sequence length {length} exceeds the largest bucket "
                     f"{buckets[-1]}")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(arr, src):
    """``arr`` as a CPU tensor where ``src`` was a tensor, else as it is."""
    if isinstance(src, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr))
    return arr


def pad_to_bucket(ids, buckets: Sequence[int], pad_value: int = 0,
                  labels=None, ignore_index: int = -100):
    """Right-pad ``ids`` [B, S] up to the smallest bucket >= S.  When
    ``labels`` is given it is padded with ``ignore_index`` so the padded
    positions contribute nothing to the loss.  Returns (padded_ids,
    padded_labels_or_None, true_length)."""
    arr = _np(ids)
    S = arr.shape[-1]
    tgt = _bucket_of(S, buckets)
    if tgt != S:
        pad = [(0, 0)] * (arr.ndim - 1) + [(0, tgt - S)]
        arr = np.pad(arr, pad, constant_values=pad_value)
    out_ids = _like(arr, ids)
    out_labels = None
    if labels is not None:
        lab = _np(labels)
        if lab.shape[-1] != S:
            raise ValueError(
                f"labels last dim {lab.shape[-1]} != ids last dim {S}; "
                f"shift labels before padding so ignore_index lands on the "
                f"padded positions")
        if tgt != S:
            pad = [(0, 0)] * (lab.ndim - 1) + [(0, tgt - S)]
            lab = np.pad(lab, pad, constant_values=ignore_index)
        out_labels = _like(lab, labels)
    return out_ids, out_labels, S


class LengthBucketBatchSampler:
    """Batch sampler grouping indices by length bucket (ref: the role
    Paddle's DistributedBatchSampler plays for the loader, with the
    shape policy above added).

    ``lengths``: per-sample sequence lengths (list/array or a callable
    index -> length).  Batches are homogeneous in bucket, shuffled across
    and within buckets per epoch when ``shuffle``."""

    def __init__(self, lengths, batch_size: int,
                 buckets: Optional[Sequence[int]] = None,
                 shuffle: bool = True, drop_last: bool = False,
                 seed: int = 0, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None):
        if callable(lengths):
            raise TypeError("pass materialized lengths (list/ndarray)")
        self._lengths = np.asarray(lengths, np.int64)
        self.batch_size = int(batch_size)
        self.buckets = list(buckets) if buckets is not None else \
            bucket_boundaries(int(self._lengths.max()))
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._epoch = 0
        # data-parallel sharding, DistributedBatchSampler-style: each rank
        # takes every nranks-th batch of the (deterministically shuffled)
        # global batch list
        if num_replicas is None and rank is None:
            self.nranks, self.local_rank = 1, 0
        else:
            from . import _rank_and_world

            r, w = _rank_and_world()
            self.nranks = num_replicas if num_replicas is not None else w
            self.local_rank = rank if rank is not None else r
        # bucket->indices assignment is immutable: compute once
        self._by_bucket = {}
        for idx, ln in enumerate(self._lengths):
            self._by_bucket.setdefault(
                _bucket_of(int(ln), self.buckets), []).append(idx)

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _global_batches(self):
        rng = np.random.default_rng([self._seed, self._epoch])
        batches = []
        for b, idxs in sorted(self._by_bucket.items()):
            idxs = np.asarray(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                chunk = idxs[i:i + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                batches.append(chunk.tolist())
        if self.shuffle:
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches

    def __iter__(self):
        batches = self._global_batches()
        if self.nranks > 1:
            # pad so every rank sees the same batch count (wrap-around),
            # then stride — identical global order on every rank by seed
            total = math.ceil(len(batches) / self.nranks) * self.nranks
            batches = batches + batches[: total - len(batches)]
            batches = batches[self.local_rank:: self.nranks]
        return iter(batches)

    def __len__(self):
        n = 0
        for idxs in self._by_bucket.values():
            n += (len(idxs) // self.batch_size if self.drop_last
                  else math.ceil(len(idxs) / self.batch_size))
        if self.nranks > 1:
            n = math.ceil(n / self.nranks)
        return n
