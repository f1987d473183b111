"""CUDA weight-only int8 matmul — port of ``paddle_tpu/ops/int8.py``
(``_w8_kernel`` as launched by ``_w8_matmul_pallas``).

:func:`w8_matmul_cuda` launches ``csrc/w8_matmul.cu``: ``x (M, K) bf16 @
w_q (K, N) int8`` with an fp32 accumulator, times ``scale (N,)`` f32, in
bf16, for M <= 16. Its plain twin is ``int8._w8_plain``.
"""
from __future__ import annotations

import functools

import torch

from .int8 import STREAM_MAX_ROWS

# columns of one thread block (32 lanes x 8 int8 columns each)
BLOCK_N = 256
# the K range of a block is a multiple of this (4 warps x 32 rows)
K_STEP = 128
# blocks per SM the K split aims for
_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k_splits(K: int, N: int, sms: int):
    """(S, KS): split K into S slices of KS rows (a multiple of
    ``K_STEP``; the last may be shorter) so that the column tiles times S
    give about ``_BLOCKS_PER_SM`` blocks per SM; S = 1 when the column
    tiles alone fill the card (the lm-head)."""
    tiles = -(-N // BLOCK_N)
    steps = K // K_STEP
    S = max(1, min(steps, -(-_BLOCKS_PER_SM * sms // tiles)))
    KS = -(-steps // S) * K_STEP
    return -(-K // KS), KS


def w8_matmul_cuda(x2, w_q, scale):
    """Launch the int8 matmul kernel: x2 (M, K) bfloat16 with M <= 16,
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
    if not 1 <= M <= STREAM_MAX_ROWS or K % 128 or N % 128:
        raise ValueError(f"w8_matmul_cuda: unsupported M={M}, K={K}, N={N} "
                         f"(M in 1..{STREAM_MAX_ROWS}, K and N multiples of "
                         f"128)")
    tensors = (x2, w_q, scale)
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("w8_matmul_cuda: all inputs must be on one CUDA "
                         "device")
    x2 = x2.contiguous()
    for name, t in (("w_q", w_q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"w8_matmul_cuda: {name} must be contiguous")
    if x2.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("w8_matmul_cuda: x and w_q must be 16-byte aligned")
    S, KS = k_splits(K, N, _sm_count(x2.device.index or 0))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    part = None
    if S > 1:
        part = torch.empty((S, M, N), dtype=torch.float32, device=x2.device)
    lib = _build.library()
    err = lib.pt_w8_matmul(x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                           out.data_ptr(),
                           part.data_ptr() if part is not None else None,
                           M, K, N, S, KS, _build.stream_ptr(x2.device))
    _build.check(err, "w8_matmul")
    w8_matmul_cuda.launches += 1
    return out


w8_matmul_cuda.launches = 0
