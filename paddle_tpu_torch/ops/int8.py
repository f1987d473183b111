"""Weight-only int8 matmul — port of ``paddle_tpu/ops/int8.py``
(``quantize_per_channel``, ``w8_matmul`` and the arithmetic of the Pallas
``_w8_kernel``).

Scheme: symmetric per-output-channel absmax, ``w ≈ w_q (int8) · scale (f32)
[N]``. Since the scale is per column, ``x @ (w_q · scale) == (x @ w_q) ·
scale``: the kernel multiplies x by the exact int8 codes with an fp32
accumulator and applies the scale to the accumulator once.

Dispatch, by shape and before any launch (the JAX package's own rule,
``ops/int8.py:113-114``): only decode shapes, ``M <= 16`` rows with ``K``
and ``N`` multiples of 128, stream int8 weights — through the CUDA kernel
(``int8_cuda.w8_matmul_cuda``) on a CUDA tensor, through its plain twin
:func:`_w8_plain` on a CPU tensor or under ``set_kernel_mode("reference")``.
Every other shape (a prefill chunk re-uses each weight 128 times) takes the
dequantize-once path, ``x @ (w_q · scale).to(x.dtype)``, as JAX computes it
outside any Pallas kernel. A kernel error raises: the JAX package's
warn-and-dequantize fallback (``:115-128``) is not carried over.
"""
from __future__ import annotations

import torch

_LANE = 128
# the largest row count that streams int8 weights (a decode batch)
STREAM_MAX_ROWS = 16


def quantize_per_channel(w):
    """``(K, N)`` float → (``(K, N)`` int8, ``(N,)`` f32 scale); symmetric
    absmax per column, the JAX package's arithmetic in fp32."""
    wf = torch.as_tensor(w).float()
    absmax = wf.abs().amax(dim=0)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(wf / scale), -127, 127)
    return w_q.to(torch.int8), scale


def streams_int8(M: int, K: int, N: int) -> bool:
    """The reference's shape rule: True when ``x (M, K) @ w_q (K, N)`` runs
    the streaming int8 kernel (or its plain twin), False when it takes the
    dequantize-once path."""
    return M <= STREAM_MAX_ROWS and K % _LANE == 0 and N % _LANE == 0


def _w8_plain(x2, w_q, scale):
    """Plain twin of the kernel (``paddle_tpu.ops.int8._w8_kernel``): the
    products of x and the int8 codes accumulated in fp32 (bf16 × int8 is
    exact in fp32), times the fp32 scale, rounded to x's dtype once.
    x2: (M, K); w_q: (K, N) int8; scale: (N,) f32."""
    acc = torch.matmul(x2.float(), w_q.float())
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


def w8_matmul(x, w_q, scale):
    """``x [..., K] @ dequant(w_q [K, N], scale [N]) -> [..., N]`` in x's
    dtype. Decode shapes (see :func:`streams_int8`) stream the int8 weight
    through the CUDA kernel on a CUDA tensor (its plain twin on the CPU);
    other shapes dequantize once."""
    from . import use_kernel
    from .int8_cuda import w8_matmul_cuda

    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w_q.shape[1]
    x2 = x.reshape(-1, K)
    if streams_int8(x2.shape[0], K, N):
        if use_kernel(x2):
            out = w8_matmul_cuda(x2, w_q, scale)
        else:
            out = _w8_plain(x2, w_q, scale)
    else:
        out = _w8_dequant(x2, w_q, scale)
    return out.reshape(*lead, N)
