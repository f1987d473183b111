"""Data loading — port of ``paddle_tpu/io/__init__.py`` (``paddle.io``).

The loader builds batches on the host and yields CPU ``torch.Tensor``s:
the model moves them to its device (``hapi.Model`` moves each batch to
the device of the network's parameters); ``places`` is accepted and
ignored, as in the JAX package. ``num_workers > 0`` starts worker
processes (``worker_pool.py``: an index queue in, shared-memory arrays
out, collate in the parent, so that no worker touches CUDA); set
``PADDLE_TPU_DATALOADER_THREAD=1`` for the single-thread prefetch
instead. Where the worker processes cannot start (a dataset that does not
pickle), the loader retries with ``fork`` and then falls back to that
thread, warning each time, as the JAX package does.

Every random draw is the JAX package's, from the same global stream:
``random_split``, :class:`RandomSampler` and :class:`WeightedRandomSampler`
draw from numpy's global generator, :class:`DistributedBatchSampler` from
``RandomState(epoch)``; so a program that seeds ``np.random`` gets the
same batches from both packages.
"""
from __future__ import annotations

import itertools
import math
import os
import queue
import threading

import numpy as np
import torch

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "DataLoader", "Dataset",
           "DistributedBatchSampler", "IterableDataset",
           "LengthBucketBatchSampler", "RandomSampler", "Sampler",
           "SequenceSampler", "Subset", "TensorDataset",
           "WeightedRandomSampler", "bucket_boundaries",
           "default_collate_fn", "default_convert_fn", "get_worker_info",
           "pad_to_bucket", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            if isinstance(item, tuple):
                out.extend(item)
            else:
                out.append(item)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumsizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumsizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        d_idx = int(np.searchsorted(self.cumsizes, idx, side="right"))
        prev = 0 if d_idx == 0 else self.cumsizes[d_idx - 1]
        return self.datasets[d_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        lengths = [int(math.floor(total * l)) for l in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    perm = np.random.permutation(total).tolist()
    out = []
    offset = 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l]))
        offset += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return (self._num_samples if self._num_samples is not None
                else len(self.data_source))

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _rank_and_world():
    """This process's data-parallel rank and the number of ranks: the
    initialized ``torch.distributed`` group's, else the launcher's
    ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``, else one process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("PADDLE_TRAINER_ID", 0)),
            int(os.environ.get("PADDLE_TRAINERS_NUM", 1)))


class DistributedBatchSampler(BatchSampler):
    """Shards the index space across data-parallel ranks; shuffles with
    ``RandomState(epoch)``."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            r, w = _rank_and_world()
            num_replicas = num_replicas if num_replicas is not None else w
            rank = rank if rank is not None else r
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - n)]
        indices = indices[self.local_rank: self.total_size: self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def _cpu_tensor(array) -> torch.Tensor:
    """A CPU tensor of ``array`` (numpy, or what numpy makes of it); a
    bf16 array (``ml_dtypes.bfloat16``) as bf16."""
    from ..framework.io_state import from_numpy

    return from_numpy(np.asarray(array), "cpu")


def default_collate_fn(batch):
    """Stacks a batch of samples into CPU tensors, structure by
    structure: arrays and tensors stacked, numbers into one tensor,
    strings kept as a list, dicts and sequences collated field by
    field."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return _cpu_tensor(np.stack(batch))
    if isinstance(sample, torch.Tensor):
        return torch.stack([s.detach().cpu() for s in batch])
    if isinstance(sample, (int, float)):
        return _cpu_tensor(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    try:
        return _cpu_tensor(np.stack([np.asarray(s) for s in batch]))
    except Exception:
        return batch


def default_convert_fn(batch):
    if isinstance(batch, (np.ndarray,)):
        return _cpu_tensor(batch)
    if isinstance(batch, (list, tuple)):
        return [default_convert_fn(b) for b in batch]
    return batch


class _PrefetchIter:
    def __init__(self, gen_fn, num_workers, prefetch_factor):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(2, prefetch_factor))
        self._done = object()
        self._exc = None

        def producer():
            try:
                for item in gen_fn():
                    self._q.put(item)
            except BaseException as e:  # propagate to consumer
                self._exc = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._pool = None  # persistent MapWorkerPool
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def _gen(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            if self.batch_size is None:
                for sample in it:
                    yield default_convert_fn(sample)
                return
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        elif self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield default_convert_fn(self.dataset[i])
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    @staticmethod
    def _use_threads():
        return os.environ.get("PADDLE_TPU_DATALOADER_THREAD") == "1"

    def _mp_iter(self):
        from .worker_pool import IterableWorkerIter, MapWorkerPool

        if self._iterable_mode:
            return IterableWorkerIter(
                self.dataset, self.num_workers, self.batch_size,
                self.drop_last, self.collate_fn, default_convert_fn,
                worker_init_fn=self.worker_init_fn,
                use_shm=self.use_shared_memory, timeout=self.timeout,
                prefetch_factor=self.prefetch_factor)
        if self.batch_sampler is not None:
            batches = list(self.batch_sampler)
        else:
            batches = [[i] for i in range(len(self.dataset))]
            # single-sample mode converts, not collates
        collate = (self.collate_fn if self.batch_sampler is not None
                   else lambda samples: default_convert_fn(samples[0]))
        if self._pool is None:
            self._pool = MapWorkerPool(
                self.dataset, self.num_workers,
                worker_init_fn=self.worker_init_fn,
                use_shm=self.use_shared_memory, timeout=self.timeout)
        pool = self._pool

        def run():
            try:
                yield from pool.run_epoch(batches, collate,
                                          self.prefetch_factor)
            finally:
                if not self.persistent_workers:
                    pool.shutdown()
                    self._pool = None

        return run()

    def __iter__(self):
        if self.num_workers and self.num_workers > 0:
            if self._use_threads():
                return _PrefetchIter(self._gen, self.num_workers,
                                     self.prefetch_factor)
            try:
                return self._mp_iter()
            except Exception as e:  # unpicklable dataset etc.
                import warnings

                if (os.environ.get("PADDLE_TPU_MP_START") is None
                        and isinstance(e, (AttributeError, TypeError))):
                    # forkserver refuses closure-local datasets and
                    # lambdas that fork accepts: retry with fork once
                    # (the user's risk, warned)
                    warnings.warn(
                        f"dataset not picklable for the forkserver workers "
                        f"({e!r}); retrying with fork — set "
                        f"PADDLE_TPU_MP_START to silence", RuntimeWarning)
                    os.environ["PADDLE_TPU_MP_START"] = "fork"
                    try:
                        return self._mp_iter()
                    except Exception as e2:
                        e = e2
                    finally:
                        del os.environ["PADDLE_TPU_MP_START"]
                warnings.warn(
                    f"multiprocess DataLoader workers unavailable ({e!r}); "
                    f"falling back to single-thread prefetch", RuntimeWarning)
                return _PrefetchIter(self._gen, self.num_workers,
                                     self.prefetch_factor)
        return self._gen()

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("DataLoader over IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)


def get_worker_info():
    """Inside a DataLoader worker process: its (id, num_workers, seed,
    dataset); None in the main process."""
    from .worker_pool import get_worker_info as _impl

    return _impl()


from .bucketing import (LengthBucketBatchSampler, bucket_boundaries,  # noqa: E402,F401
                        pad_to_bucket)
