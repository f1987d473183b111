"""The native token reader — port of ``paddle_tpu/io/native.py``
(``csrc/ptio.cpp`` through ctypes).

:class:`TokenDataLoader` is the pretraining input pipeline: an mmapped token
file, C++ prefetch threads, fixed (B, S) int32 blocks (inputs and their
next-token labels). The library is built with ``g++`` from the repository's
``csrc/ptio.cpp`` into this package's ignored ``ops/_build/``, named by a
hash of the source and the flags (rebuilt when either changes); nothing is
written into ``csrc/``. Where it cannot be built, or the reader cannot
open the file, the loader raises: it never falls back to the numpy reader
(the JAX package does, silently). The numpy reader is the plain version,
chosen with ``native=False``.

Each C++ thread draws from its own ``mt19937_64``, so with more than one
thread the batches come in an order that depends on the threads'
timing; ``num_threads=1`` gives one order for a seed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["TokenDataLoader", "get_lib", "write_token_file"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "ptio.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIB = None
_LIB_LOCK = threading.Lock()


def _build_lib() -> str:
    """The path of ``libptio-<hash>.so`` in ``ops/_build/``, compiled now
    when it is not there yet; raises RuntimeError when it cannot be."""
    from ..ops._build import BUILD_DIR

    if not SOURCE.exists():
        raise RuntimeError(f"the token reader's source {SOURCE} is missing")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    out = BUILD_DIR / f"libptio-{h.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        p = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE),
                            "-lpthread"], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"g++ could not build {SOURCE}:\n"
                               f"{p.stderr[-2000:]}")
        os.replace(tmp, out)          # a loader never sees half a library
    except FileNotFoundError as e:
        raise RuntimeError(f"no g++ to build {SOURCE}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(out)


def get_lib():
    """The token reader's library, built and loaded on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_build_lib())
        lib.ptio_create_reader.restype = ctypes.c_void_p
        lib.ptio_create_reader.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int]
        lib.ptio_next_batch.restype = ctypes.c_int
        lib.ptio_next_batch.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int32)]
        lib.ptio_samples_per_shard.restype = ctypes.c_long
        lib.ptio_samples_per_shard.argtypes = [ctypes.c_void_p]
        lib.ptio_destroy_reader.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def write_token_file(tokens: np.ndarray, path: str, dtype=np.int32) -> str:
    """Serialize a 1-D token stream to the binary format the reader mmaps."""
    arr = np.ascontiguousarray(tokens, dtype=dtype)
    with open(path, "wb") as f:
        f.write(arr.tobytes())
    return path


class TokenDataLoader:
    """Pretraining loader: yields (input_ids (B, S) int32, labels (B, S)
    int64) numpy arrays, each row a window of S + 1 tokens of the file
    that starts at a multiple of S + 1 (drawn at random in this shard).

    ``native`` (the default) reads through the C++ prefetch core;
    ``native=False`` through the numpy reader, the plain version, which
    draws from ``RandomState(seed)``. ``shard_id`` / ``num_shards`` give
    DistributedBatchSampler-style dataset sharding."""

    def __init__(self, path: str, seq_len: int, batch_size: int,
                 dtype_size: int = 4, num_threads: int = 2,
                 capacity: int = 8, seed: int = 0, shard_id: int = 0,
                 num_shards: int = 1, *, native: bool = True):
        self.path = path
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.dtype_size = dtype_size
        self._handle = None
        self._lib = None
        self._seed = seed
        self._shard = (shard_id, num_shards)
        if native:
            self._lib = get_lib()
            self._handle = self._lib.ptio_create_reader(
                path.encode(), dtype_size, seq_len, batch_size, num_threads,
                capacity, seed, shard_id, num_shards)
            if not self._handle:
                raise ValueError(
                    f"the token reader cannot read {path!r}: missing, "
                    f"dtype size {dtype_size} not 2/4/8, or fewer than "
                    f"{num_shards} windows of {seq_len + 1} tokens")
        else:
            dt = {2: np.uint16, 4: np.int32, 8: np.int64}[dtype_size]
            self._tokens = np.fromfile(path, dtype=dt)
            self._rng = np.random.RandomState(seed)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def samples_per_shard(self) -> int:
        if self._handle:
            return int(self._lib.ptio_samples_per_shard(self._handle))
        stride = self.seq_len + 1
        return (len(self._tokens) // stride) // self._shard[1]

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        stride = self.seq_len + 1
        buf = np.empty((self.batch_size, stride), np.int32)
        if self._handle:
            ok = self._lib.ptio_next_batch(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if not ok:
                raise StopIteration
        else:
            n = self.samples_per_shard()
            shard_id, _ = self._shard
            for i in range(self.batch_size):
                s = shard_id * n + self._rng.randint(n)
                buf[i] = self._tokens[s * stride:(s + 1) * stride].astype(
                    np.int32)
        return buf[:, :-1].copy(), buf[:, 1:].astype(np.int64)

    def __iter__(self):
        while True:
            yield self.next()

    def close(self):
        if self._handle:
            self._lib.ptio_destroy_reader(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
