"""CUDA weight-only int8 matmul — port of ``paddle_tpu/ops/int8.py``
(``_w8_kernel`` as launched by ``_w8_matmul_pallas``).

:func:`w8_matmul_cuda` launches ``csrc/w8_matmul.cu``, one launch of the
weight-streaming main loop of ``csrc/stream_gemm.cuh``: ``x (M, K) bf16 @
w_q (K, N) int8`` with an fp32 accumulator, times ``scale (N,)`` f32, in
bf16, at any M (more than 128 rows run in several token tiles). Its
plain twin is ``int8._w8_plain``. The launch plan (token
tile, column tile, K splits fixed by K, N and the SM count) is
``csrc/stream_tiles.cuh``'s.
"""
from __future__ import annotations

import ctypes

import torch

# rows of x the largest token tile holds (more rows run in several tiles)
TILE_ROWS = 128
# (token tile, 64-column blocks of W a block): the instantiations of the
# streaming kernels (this one and fused LoRA's second launch)
CONFIGS = tuple((X, wg) for X in (8, 16, 32, 48, 64, 128) for wg in (1, 2))
_CONFIG_KEYS = ("threads", "token_rows", "k_step", "stages", "smem_bytes",
                "registers", "local_bytes", "block_cols")


def _config(entry: str):
    """An instantiation table of a streaming kernel (``kernel_config``)."""
    from . import _build

    lib = _build.library()
    out = {}
    for X, wg in CONFIGS:
        vals = (ctypes.c_int * 8)()
        _build.check(getattr(lib, entry)(X, wg, vals), entry)
        out[f"tok{X}_wg{wg}"] = dict(zip(_CONFIG_KEYS, vals))
    return out


def kernel_config():
    """Each instantiation's launch shape (threads, token rows, K rows a
    stage, ring stages, shared memory, registers and local bytes a thread,
    W columns a block), keyed ``tok{X}_wg{wg}``."""
    return _config("pt_w8_matmul_config")


def plan(M: int, K: int, N: int):
    """The streaming product's launch plan on the current device: token
    tile, 64-column blocks of W a block, K splits (the cluster), K steps a
    split, column tiles, token tiles."""
    from . import _build

    vals = (ctypes.c_int * 6)()
    _build.check(_build.library().pt_stream_plan(M, K, N, vals),
                 "stream_plan")
    return dict(zip(("tok", "wg", "splits", "ks", "col_tiles", "tok_tiles"),
                    vals))


def w8_matmul_cuda(x2, w_q, scale):
    """Launch the int8 matmul kernel: x2 (M, K) bfloat16 with M >= 1,
    w_q (K, N) int8, scale (N,) float32, K and N multiples of 128, all on
    one CUDA device. Returns (M, N) bfloat16. Raises on anything else."""
    from . import _build

    if x2.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"w8_matmul_cuda: want x (M, K), w_q (K, N), scale "
                         f"(N,), got {tuple(x2.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    M, K = x2.shape
    N = w_q.shape[1]
    if w_q.shape[0] != K or scale.shape[0] != N:
        raise ValueError(f"w8_matmul_cuda: x {tuple(x2.shape)}, w_q "
                         f"{tuple(w_q.shape)} and scale {tuple(scale.shape)} "
                         f"do not agree")
    if x2.dtype != torch.bfloat16 or w_q.dtype != torch.int8 or \
            scale.dtype != torch.float32:
        raise TypeError(f"w8_matmul_cuda: the kernel takes bfloat16 x, int8 "
                        f"w_q and float32 scale, got {x2.dtype}, {w_q.dtype}, "
                        f"{scale.dtype}")
    if M < 1 or K % 128 or N % 128:
        raise ValueError(f"w8_matmul_cuda: unsupported M={M}, K={K}, N={N} "
                         f"(M >= 1, K and N multiples of 128)")
    tensors = (x2, w_q, scale)
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("w8_matmul_cuda: all inputs must be on one CUDA "
                         "device")
    x2 = x2.contiguous()
    for name, t in (("w_q", w_q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"w8_matmul_cuda: {name} must be contiguous")
    if x2.data_ptr() % 16 or w_q.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("w8_matmul_cuda: x, w_q and scale must be 16-byte "
                         "aligned")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    lib = _build.library()
    err = lib.pt_w8_matmul(x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                           out.data_ptr(), M, K, N,
                           _build.stream_ptr(x2.device))
    _build.check(err, "w8_matmul")
    w8_matmul_cuda.launches += 1
    return out


w8_matmul_cuda.launches = 0
