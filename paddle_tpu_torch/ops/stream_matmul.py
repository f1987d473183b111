"""Batch-invariant products of the decode and verify paths: the port's own
repair, not a port of a TPU kernel (the JAX package leaves these products
to XLA).

A decode tick multiplies B rows by each weight and a speculative verify
window B (k + 1) rows. A library product picks its kernel and its K split
from the row count, so a row's result depended on the rows beside it and
greedy speculative output drifted from the plain server's. Every product
of those paths — the bf16 projections and the lm-head here, the int8
projections (``int8.w8_matmul``) and the fused LoRA product
(``nn.lora.lora_matmul``) — sums each output element over K ranges fixed
by (K, N, the card's SM count) in a fixed order, so that row r depends
only on row r of x and on the weight.

:func:`stream_matmul` runs the CUDA kernel (``stream_matmul_cuda``, the
weight-streaming main loop of ``csrc/stream_gemm.cuh`` over bf16 W) on a
CUDA tensor, and its plain twin :func:`_stream_plain` on a CPU tensor or
under ``set_kernel_mode("reference")``. The twin sums the kernel's K
slices (:func:`k_slices`, ``stream_tiles::plan``) in fp32 in the same
order, each slice's product computed a row at a time
(:func:`rows_product`), so that it is batch-invariant too. Prefill chunks
and training keep ``torch.matmul``.
"""
from __future__ import annotations

import torch

# stream_tiles.cuh: K rows a step, W columns a block, the most blocks of a
# cluster
K_STEP = 64
COL_BLOCK = 64
MAX_CLUSTER = 8
# the SM count of an H100 SXM: the K slices a CPU tensor's twin sums
DEFAULT_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sm_count(device) -> int:
    """SMs of ``device``'s card (the kernel's plan), or :data:`DEFAULT_SMS`
    for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return DEFAULT_SMS


def k_split(K: int, N: int, sms: int) -> int:
    """``stream_tiles::k_split``: the K ranges of an output tile, a
    function of (K, N, sms) alone."""
    steps = _cdiv(K, K_STEP)
    wg = 2 if 4 * _cdiv(N, 2 * COL_BLOCK) >= 3 * sms else 1
    s = 2 * sms // _cdiv(N, wg * COL_BLOCK)
    return max(1, min(s, MAX_CLUSTER, steps))


def k_slices(K: int, N: int, sms: int = DEFAULT_SMS):
    """The K ranges [(k0, k1), ...] of ``stream_tiles::plan``, in the
    order the kernel's cluster sums them: ``ks`` steps each, the last
    possibly short, none empty."""
    steps = _cdiv(K, K_STEP)
    ks = _cdiv(steps, k_split(K, N, sms))
    return [(k0, min(K, k0 + ks * K_STEP))
            for k0 in range(0, steps * K_STEP, ks * K_STEP)]


def rows_product(x, w):
    """fp32 ``x (M, K) @ w (K, N)`` a row at a time (one batched product
    of M single-row products, w broadcast, not copied): every row runs
    the same product, so row r's bits do not depend on M or on the other
    rows. x and w: float32."""
    return torch.bmm(x[:, None, :], w.expand(x.shape[0], *w.shape))[:, 0]


def sliced_sum(x, w, slices):
    """fp32 ``x @ w`` as the sum, in order, of the row-wise products of
    the K ``slices`` (:func:`k_slices`). x (M, K), w (K, N), any float
    dtypes (computed in fp32)."""
    out = None
    for k0, k1 in slices:
        part = rows_product(x[:, k0:k1].float(), w[k0:k1].float())
        out = part if out is None else out + part
    return out


def _stream_plain(x2, w, transpose_w: bool = False):
    """Plain twin of the kernel: x2 (M, K) times w (K, N) (or w.T for an
    (N, K) ``w`` with ``transpose_w``), the kernel's K slices summed in
    fp32 in order, rounded to x2's dtype once."""
    wk = w.t() if transpose_w else w
    K, N = wk.shape
    slices = k_slices(K, N, sm_count(x2.device))
    return sliced_sum(x2, wk, slices).to(x2.dtype)


def stream_matmul(x, w, transpose_w: bool = False):
    """``x [..., K] @ w (K, N) -> [..., N]`` in x's dtype (``x @ w.T`` for
    a ``w`` (N, K) with ``transpose_w``: a tied lm-head's embedding),
    batch-invariant: each row's result depends only on that row and on
    w. On a CUDA tensor the kernel runs (bfloat16, any row count) or
    raises; on a CPU tensor or under ``set_kernel_mode("reference")``,
    its plain twin."""
    from . import use_kernel
    from .stream_matmul_cuda import stream_matmul_cuda

    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w.shape[0] if transpose_w else w.shape[1]
    x2 = x.reshape(-1, K)
    if use_kernel(x2):
        out = stream_matmul_cuda(x2, w, transpose_w)
    else:
        out = _stream_plain(x2, w, transpose_w)
    return out.reshape(*lead, N)
