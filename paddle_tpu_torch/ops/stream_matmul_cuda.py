"""CUDA batch-invariant bf16 product of the decode and verify paths.

:func:`stream_matmul_cuda` launches ``csrc/stream_matmul.cu``: one launch
of the weight-streaming main loop of ``csrc/stream_gemm.cuh`` over bf16 W,
``out = bf16(x @ W)`` (or ``x @ W^T`` for a tied lm-head's embedding W
(N, K)) with an fp32 sum over K ranges fixed by (K, N, SM count), at any
M (more than 128 rows run in several token tiles). Row r of the output
depends only on row r of x and on W. Its plain twin is
``stream_matmul._stream_plain``. The port's own kernel: the JAX package
leaves these products to XLA.
"""
from __future__ import annotations

import ctypes

import torch

from .int8_cuda import _CONFIG_KEYS, CONFIGS


def kernel_config():
    """Each instantiation's launch shape (threads, token rows, K rows a
    stage, ring stages, shared memory, registers and local bytes a thread,
    W columns a block), keyed ``tok{X}_wg{wg}`` (W (K, N)) and
    ``tok{X}_wg{wg}_kmajor`` (a tied head's W (N, K))."""
    from . import _build

    lib = _build.library()
    out = {}
    for kmajor in (0, 1):
        for X, wg in CONFIGS:
            vals = (ctypes.c_int * 8)()
            _build.check(lib.pt_stream_matmul_config(X, wg, kmajor, vals),
                         "pt_stream_matmul_config")
            key = f"tok{X}_wg{wg}" + ("_kmajor" if kmajor else "")
            out[key] = dict(zip(_CONFIG_KEYS, vals))
    return out


def stream_matmul_cuda(x2, w, transpose_w: bool = False):
    """Launch the kernel: x2 (M, K) bfloat16 with M >= 1; w (K, N)
    bfloat16, or (N, K) with ``transpose_w`` (out = x2 @ w.T); K and N
    multiples of 8; all on one CUDA device. Returns (M, N) bfloat16.
    Raises on anything else."""
    from . import _build

    name = "stream_matmul_cuda"
    if x2.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: want x (M, K) and a 2-D w, got "
                         f"{tuple(x2.shape)} and {tuple(w.shape)}")
    M, K = x2.shape
    N = w.shape[0] if transpose_w else w.shape[1]
    if (w.shape[1] if transpose_w else w.shape[0]) != K:
        raise ValueError(f"{name}: x {tuple(x2.shape)} and w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w}) do "
                         f"not agree")
    if x2.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 x and w, got "
                        f"{x2.dtype} and {w.dtype}")
    if M < 1 or K % 8 or N % 8:
        raise ValueError(f"{name}: unsupported M={M}, K={K}, N={N} (M >= 1, "
                         f"K and N multiples of 8)")
    if not (x2.is_cuda and w.is_cuda) or x2.device != w.device:
        raise ValueError(f"{name}: x and w must be on one CUDA device")
    x2 = x2.contiguous()
    if not w.is_contiguous():
        raise ValueError(f"{name}: w must be contiguous")
    if x2.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    err = _build.library().pt_stream_matmul(
        x2.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N,
        1 if transpose_w else 0, _build.stream_ptr(x2.device))
    _build.check(err, "stream_matmul")
    stream_matmul_cuda.launches += 1
    return out


stream_matmul_cuda.launches = 0
