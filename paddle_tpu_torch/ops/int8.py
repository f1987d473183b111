"""Weight-only int8 matmul — port of ``paddle_tpu/ops/int8.py``
(``quantize_per_channel``, ``w8_matmul`` and the arithmetic of the Pallas
``_w8_kernel``).

Scheme: symmetric per-output-channel absmax, ``w ≈ w_q (int8) · scale (f32)
[N]``. Since the scale is per column, ``x @ (w_q · scale) == (x @ w_q) ·
scale``: the kernel multiplies x by the exact int8 codes with an fp32
accumulator and applies the scale to the accumulator once.

Dispatch, by shape and before any launch: up to ``STREAM_MAX_ROWS`` = 128
rows with ``K`` and ``N`` multiples of 128 stream the int8 weight — decode
ticks, verify windows and prefill chunks alike — through the CUDA kernel
(``int8_cuda.w8_matmul_cuda``) on a CUDA tensor, through its plain twin
:func:`_w8_plain` on a CPU tensor or under ``set_kernel_mode("reference")``.
On the card the kernel read the weight once in a fraction of the time of
the dequantize-once path even at 128 rows (PERF.md, row 9), and it is
batch-invariant: a row's sum runs over K ranges fixed by (K, N, SM count)
(``stream_matmul.k_slices``), so a verify window's rows equal a decode
tick's. More rows take the dequantize-once path, ``x @ (w_q ·
scale).to(x.dtype)``, as JAX computes it outside any Pallas kernel —
except on the decode and verify paths (``any_rows=True``,
``Int8Linear.stream``), which stream at every row count, so that a
server whose ``max_batch · (k + 1)`` passes 128 rows stays
batch-invariant.

Two divergences from the JAX package (``ROADMAP.md`` §C): its rule streams
decode shapes only (M <= 16, from a TPU measurement), so its prefill and
verify products dequantize; and the two paths round differently — the
dequantize path rounds ``w_q · scale`` to x's dtype before the product,
the kernel scales the fp32 sum. A kernel error raises: the JAX package's
warn-and-dequantize fallback is not carried over.
"""
from __future__ import annotations

import torch

_LANE = 128
# the largest row count that streams int8 weights outside the decode and
# verify paths (one token tile of the kernel: prefill chunks of up to 128)
STREAM_MAX_ROWS = 128


def quantize_per_channel(w):
    """``(K, N)`` float → (``(K, N)`` int8, ``(N,)`` f32 scale); symmetric
    absmax per column, the JAX package's arithmetic in fp32."""
    wf = torch.as_tensor(w).float()
    absmax = wf.abs().amax(dim=0)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(wf / scale), -127, 127)
    return w_q.to(torch.int8), scale


def streams_int8(M: int, K: int, N: int, any_rows: bool = False) -> bool:
    """True when ``x (M, K) @ w_q (K, N)`` runs the streaming int8 kernel
    (or its plain twin), False when it takes the dequantize-once path;
    ``any_rows``: the decode and verify paths, which stream at every M."""
    return ((any_rows or M <= STREAM_MAX_ROWS) and K % _LANE == 0
            and N % _LANE == 0)


def _w8_plain(x2, w_q, scale):
    """Plain twin of the kernel (``paddle_tpu.ops.int8._w8_kernel``): the
    products of x and the int8 codes accumulated in fp32 (bf16 × int8 is
    exact in fp32) over the kernel's K slices in order, a row at a time
    (batch-invariant, ``stream_matmul.sliced_sum``), times the fp32
    scale, rounded to x's dtype once. x2: (M, K); w_q: (K, N) int8;
    scale: (N,) f32."""
    from .stream_matmul import k_slices, sliced_sum, sm_count

    K, N = w_q.shape
    acc = sliced_sum(x2, w_q, k_slices(K, N, sm_count(x2.device)))
    return (acc * scale.float()).to(x2.dtype)


def dequantize(w_q, scale, dtype):
    """``(w_q · scale)`` computed in fp32 and rounded to ``dtype`` — in one
    pass: int8 times f32 is computed in f32 and cast as it is stored."""
    out = torch.empty(w_q.shape, dtype=dtype, device=w_q.device)
    return torch.mul(w_q, scale.float()[None, :], out=out)


def _w8_dequant(x2, w_q, scale):
    """The dequantize-once path of ``paddle_tpu.ops.int8.w8_matmul``: the
    weight is rebuilt in x's dtype (:func:`dequantize`), then one matrix
    product."""
    return torch.matmul(x2, dequantize(w_q, scale, x2.dtype))


def w8_matmul(x, w_q, scale, any_rows: bool = False):
    """``x [..., K] @ dequant(w_q [K, N], scale [N]) -> [..., N]`` in x's
    dtype. Up to 128 rows (see :func:`streams_int8`) stream the int8
    weight through the CUDA kernel on a CUDA tensor (its plain twin on the
    CPU); more rows dequantize once, unless ``any_rows`` (the decode and
    verify paths: batch-invariant at every row count)."""
    from . import use_kernel
    from .int8_cuda import w8_matmul_cuda

    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w_q.shape[1]
    x2 = x.reshape(-1, K)
    if streams_int8(x2.shape[0], K, N, any_rows):
        if use_kernel(x2):
            out = w8_matmul_cuda(x2, w_q, scale)
        else:
            out = _w8_plain(x2, w_q, scale)
    else:
        out = _w8_dequant(x2, w_q, scale)
    return out.reshape(*lead, N)
