"""Fused RMSNorm — port of ``paddle_tpu/ops/fused_norm.py`` (``_rms_ref``,
``_rms_kernel``/``_rms_pallas``, ``fused_rms_norm``).

``fused_rms_norm(x, w, eps)`` computes ``x * rsqrt(mean(x²) + eps) * w`` over
the last dim with fp32 math and the result cast back to ``x.dtype``. On a
CUDA tensor it launches ``csrc/rms_norm.cu`` (one block per row); on a CPU
tensor, or under ``set_kernel_mode("reference")``, it runs :func:`_rms_ref`.
Serving only: no backward (the training slice adds one).
"""
from __future__ import annotations

import torch


def _rms_ref(x, w, eps):
    """Plain version: the arithmetic of ``paddle_tpu.ops.fused_norm._rms_ref``
    — fp32 mean of squares, ``x * rsqrt(ms + eps) * w``, cast to x's dtype."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def rms_norm_cuda(x, w, eps):
    """Launch the CUDA RMSNorm kernel on ``x`` (..., D) and ``w`` (D,).

    Takes bfloat16 CUDA tensors (the served model's type; the kernel is
    instantiated for no other yet), D a multiple of 8 (16-byte loads);
    raises on anything else."""
    from . import _build

    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("rms_norm_cuda: x and w must be on one CUDA device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"rms_norm_cuda: the kernel takes bfloat16 x and w, "
                        f"got {x.dtype} and {w.dtype}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"rms_norm_cuda: w shape {tuple(w.shape)} != ({D},)")
    if D % 8 or D > 8 * 1024 * 8:
        raise ValueError(f"rms_norm_cuda: last dim {D} must be a multiple "
                         f"of 8 and at most 65536")
    x = x.contiguous()
    w = w.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rms_norm_cuda: x and w must be 16-byte aligned")
    rows = x.numel() // D
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.library()
    err = lib.pt_rms_norm(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, D,
                          float(eps), _build.stream_ptr(x.device))
    _build.check(err, "rms_norm")
    rms_norm_cuda.launches += 1
    return y


rms_norm_cuda.launches = 0


def fused_rms_norm(x, w, eps=1e-6):
    from . import use_kernel

    if use_kernel(x):
        return rms_norm_cuda(x, w, eps)
    return _rms_ref(x, w, eps)
