"""Multiprocess DataLoader workers — port of
``paddle_tpu/io/worker_pool.py``: subprocess workers fed an index queue,
returning batches through a result queue, large arrays moved through
shared memory.

Workers do the GIL-bound numpy work (decode, augment); the PARENT does
collate, which builds the batch's tensors, so that no worker touches CUDA
(a forked child of a process with CUDA up cannot). Arrays over a size
threshold cross the process boundary through
``multiprocessing.shared_memory`` instead of being pickled through the
pipe.

Order semantics: batch k of the sampler is yielded k-th (an out-of-order
reorder buffer holds early arrivals); for IterableDataset each worker
iterates its own replica (shard with ``get_worker_info()``) and completed
batches are yielded round-robin by worker for determinism.
"""
from __future__ import annotations

import itertools
import os
import queue
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

_SHM_MIN_BYTES = 1 << 16  # arrays >= 64KB go through shared memory


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    seed: int
    dataset: Any


_worker_info: Optional[WorkerInfo] = None


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a worker process: (id, num_workers, seed, dataset); None in the
    main process. Ref fluid/dataloader/worker.py get_worker_info."""
    return _worker_info


# --------------------------------------------------------------------------
# shared-memory transport
# --------------------------------------------------------------------------


class _ShmRef:
    """Pickled placeholder for a large ndarray living in a SharedMemory
    segment; the parent reconstructs and unlinks."""

    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, shape, str(dtype)


def _rebuild_seq(obj, items):
    """Rebuild a list/tuple preserving namedtuple types (their constructors
    take positional fields, not one iterable)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*items)
    return type(obj)(items)


def _encode(obj, use_shm: bool):
    """Recursively swap big ndarrays for _ShmRefs."""
    if not use_shm:
        return obj
    if isinstance(obj, np.ndarray) and obj.nbytes >= _SHM_MIN_BYTES:
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        dst = np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)
        dst[...] = obj
        ref = _ShmRef(shm.name, obj.shape, obj.dtype)
        shm.close()  # parent unlinks after copy-out
        try:
            # ownership transfers to the parent (it unlinks in _decode);
            # unregister here so this process's resource_tracker doesn't
            # warn about the already-unlinked segment at exit
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        return ref
    if isinstance(obj, dict):
        return {k: _encode(v, use_shm) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return _rebuild_seq(obj, [_encode(v, use_shm) for v in obj])
    return obj


def _decode(obj):
    if isinstance(obj, _ShmRef):
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=obj.name)
        try:
            arr = np.array(
                np.ndarray(obj.shape, obj.dtype, buffer=shm.buf))  # copy out
        finally:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        return arr
    if isinstance(obj, dict):
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return _rebuild_seq(obj, [_decode(v) for v in obj])
    return obj


def _to_plain(sample):
    """Make samples picklable/shm-able: tensors -> numpy before crossing the
    process boundary (a bf16 tensor as an ``ml_dtypes.bfloat16`` array)."""
    import torch

    if isinstance(sample, torch.Tensor):
        from ..framework.io_state import _host

        return _host(sample)
    if isinstance(sample, dict):
        return {k: _to_plain(v) for k, v in sample.items()}
    if isinstance(sample, (list, tuple)):
        return _rebuild_seq(sample, [_to_plain(v) for v in sample])
    return sample


def _safe_exc(e):
    """An exception that is guaranteed to survive pickling through the
    result queue (unpicklable exceptions would be dropped by the queue's
    feeder thread, hanging the parent)."""
    import pickle
    import traceback

    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(
            f"{type(e).__name__}: {e}\n" + "".join(traceback.format_exc()))


def _dumps(payload):
    """Pickle in the worker's main thread so serialization errors are caught
    synchronously and shipped as errors instead of hanging the parent."""
    import pickle

    return pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)


def _loads(buf):
    import pickle

    return pickle.loads(buf)


# --------------------------------------------------------------------------
# worker loops
# --------------------------------------------------------------------------


def _map_worker_loop(dataset, index_q, result_q, worker_id, num_workers,
                     seed, worker_init_fn, use_shm):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, seed + worker_id, dataset)
    np.random.seed((seed + worker_id) % (2 ** 31))
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        job = index_q.get()
        if job is None:
            return
        key, idxs = job  # key = (epoch, batch_id)
        try:
            samples = [_to_plain(dataset[i]) for i in idxs]
            result_q.put((key, _dumps(_encode(samples, use_shm)), None))
        except BaseException as e:  # ship the error to the parent
            result_q.put((key, None, _safe_exc(e)))


def _iterable_worker_loop(dataset, result_q, worker_id, num_workers, seed,
                          worker_init_fn, batch_size, drop_last, use_shm,
                          stop_ev):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, seed + worker_id, dataset)
    np.random.seed((seed + worker_id) % (2 ** 31))
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    def _put(item):
        # bounded queue: block in short slices so stop_ev can interrupt
        while not stop_ev.is_set():
            try:
                result_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        it = iter(dataset)
        while not stop_ev.is_set():
            if batch_size is None:
                try:
                    sample = next(it)
                except StopIteration:
                    break
                if not _put((worker_id,
                             _dumps(_encode([_to_plain(sample)], use_shm)),
                             None)):
                    return
                continue
            batch = list(itertools.islice(it, batch_size))
            if not batch or (len(batch) < batch_size and drop_last):
                break
            if not _put((worker_id,
                         _dumps(_encode([_to_plain(s) for s in batch],
                                        use_shm)), None)):
                return
        _put((worker_id, None, None))  # this worker is done
    except BaseException as e:
        _put((worker_id, None, _safe_exc(e)))


# --------------------------------------------------------------------------
# parent-side iterators
# --------------------------------------------------------------------------


def _mp_context():
    """Start-method policy: ``fork`` is the fast path but is unsafe once the
    parent is multi-threaded (CPython deprecates fork-after-threads: a
    child can deadlock on a lock a thread held) or has CUDA up (a forked
    child cannot use it, and the CUDA driver's threads do not survive the
    fork), so take ``forkserver`` then, its server preloading this package
    so that each worker starts without importing it again.
    ``PADDLE_TPU_MP_START`` overrides either way."""
    import multiprocessing as mp
    import threading

    import torch

    method = os.environ.get("PADDLE_TPU_MP_START")
    if method is None:
        threaded = (threading.active_count() > 1
                    or torch.cuda.is_initialized())
        method = "forkserver" if threaded else "fork"
    ctx = mp.get_context(method)
    if method == "forkserver":
        ctx.set_forkserver_preload([__name__])
    return ctx


class MapWorkerPool:
    """Index-fed worker pool for map-style datasets; supports
    persistent_workers reuse across epochs."""

    def __init__(self, dataset, num_workers, worker_init_fn=None, seed=None,
                 use_shm=True, timeout=0):
        self._alive = False  # before anything that can raise: __del__ safety
        ctx = _mp_context()
        self.num_workers = num_workers
        self.timeout = timeout
        self.index_q = ctx.Queue()
        self.result_q = ctx.Queue()
        # fresh base seed per pool: epochs
        # with non-persistent workers get different augmentation randomness
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31))
        self._epoch = 0
        self.procs = [
            ctx.Process(target=_map_worker_loop,
                        args=(dataset, self.index_q, self.result_q, w,
                              num_workers, seed, worker_init_fn, use_shm),
                        daemon=True)
            for w in range(num_workers)
        ]
        started = []
        try:
            for p in self.procs:
                p.start()
                started.append(p)
        except BaseException:
            for p in started:
                p.terminate()
                p.join(timeout=2)
            raise
        self._alive = True

    def run_epoch(self, batches, collate_fn, prefetch_factor=2):
        """batches: list of index lists. Yields collated batches IN ORDER.
        Jobs/results are epoch-tagged so results abandoned mid-epoch (early
        break with persistent workers) are discarded, not replayed."""
        self._epoch += 1
        epoch = self._epoch
        inflight = 0
        next_submit = 0
        next_yield = 0
        hold = {}
        max_inflight = max(2, prefetch_factor) * self.num_workers
        n = len(batches)
        while next_yield < n:
            while next_submit < n and inflight < max_inflight:
                self.index_q.put(((epoch, next_submit), batches[next_submit]))
                next_submit += 1
                inflight += 1
            while next_yield in hold:
                yield collate_fn(hold.pop(next_yield))
                next_yield += 1
            if next_yield >= n:
                break
            try:
                (r_epoch, batch_id), data, err = self.result_q.get(
                    timeout=self.timeout or None)
            except queue.Empty:
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader worker timed out after {self.timeout}s "
                    f"(batch {next_yield})")
            if r_epoch != epoch:  # stale result from an abandoned epoch
                if data is not None:
                    _decode(_loads(data))  # free its shm segments
                continue
            inflight -= 1
            if err is not None:
                self.shutdown()
                raise err
            hold[batch_id] = _decode(_loads(data))

    def shutdown(self):
        if not self._alive:
            return
        self._alive = False
        for _ in self.procs:
            try:
                self.index_q.put(None)
            except Exception:
                pass
        # drain while joining (frees shm of in-flight results), with a final
        # drain AFTER all workers are dead so late puts can't leak segments
        deadline = 5.0
        for p in self.procs:
            while p.is_alive() and deadline > 0:
                self._drain_results()
                p.join(timeout=0.2)
                deadline -= 0.2
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
        self._drain_results()

    def _drain_results(self):
        try:
            while True:
                _, data, _ = self.result_q.get_nowait()
                if data is not None:
                    _decode(_loads(data))
        except queue.Empty:
            pass

    def __del__(self):
        self.shutdown()


class IterableWorkerIter:
    """One-shot iterator over an IterableDataset with worker replicas."""

    def __init__(self, dataset, num_workers, batch_size, drop_last,
                 collate_fn, convert_fn, worker_init_fn=None, seed=None,
                 use_shm=True, timeout=0, prefetch_factor=2):
        ctx = _mp_context()
        self.collate_fn = collate_fn
        self.convert_fn = convert_fn
        self.batch_size = batch_size
        self.timeout = timeout
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31))
        # bounded: backpressure so workers can't buffer the whole dataset
        self.result_q = ctx.Queue(
            maxsize=max(2, prefetch_factor) * num_workers)
        self.stop_ev = ctx.Event()
        self.procs = [
            ctx.Process(target=_iterable_worker_loop,
                        args=(dataset, self.result_q, w, num_workers, seed,
                              worker_init_fn, batch_size, drop_last, use_shm,
                              self.stop_ev),
                        daemon=True)
            for w in range(num_workers)
        ]
        for p in self.procs:
            p.start()
        self._done = set()
        self._buffers = {w: [] for w in range(num_workers)}
        self._rr = 0  # round-robin pointer for deterministic yield order

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            n_workers = len(self.procs)
            if len(self._done) == n_workers and all(
                    not b for b in self._buffers.values()):
                self.shutdown()
                raise StopIteration
            # yield strictly round-robin over workers still producing
            for _ in range(n_workers):
                w = self._rr
                if self._buffers[w]:
                    self._rr = (w + 1) % n_workers
                    return self._emit(self._buffers[w].pop(0))
                if w in self._done:
                    self._rr = (w + 1) % n_workers
                    continue
                break  # need more data from worker self._rr
            try:
                w, data, err = self.result_q.get(timeout=self.timeout or None)
            except queue.Empty:
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader worker timed out after {self.timeout}s")
            if err is not None:
                self.shutdown()
                raise err
            if data is None:
                self._done.add(w)
            else:
                self._buffers[w].append(_decode(_loads(data)))

    def _emit(self, samples):
        if self.batch_size is None:
            return self.convert_fn(samples[0])
        return self.collate_fn(samples)

    def shutdown(self):
        self.stop_ev.set()
        # drain while joining (workers may be blocked on the bounded queue),
        # and once more after death so late puts can't leak shm segments
        deadline = 5.0
        for p in self.procs:
            while p.is_alive() and deadline > 0:
                self._drain_results()
                p.join(timeout=0.2)
                deadline -= 0.2
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
        self._drain_results()

    def _drain_results(self):
        try:
            while True:
                _, data, _ = self.result_q.get_nowait()
                if data is not None:
                    _decode(_loads(data))
        except queue.Empty:
            pass

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass
