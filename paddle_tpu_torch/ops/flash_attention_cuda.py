"""CUDA flash attention — port of the Pallas kernels
``_flash_fwd_bhsd_loop`` (``paddle_tpu/ops/flash_attention.py:488``) and
the ``_flash_bwd_bhsd_loop`` pair (dQ ``:628``, dK/dV ``:646``).

Three wrappers over ``csrc/flash_attention.cu``, each with its launch
counter: :func:`flash_fwd_cuda` (O, LSE), :func:`flash_bwd_dq_cuda` and
:func:`flash_bwd_dkv_cuda`. Their plain versions are
``flash_attention._flash_fwd_plain`` / ``_flash_bwd_plain``. The kernels
take bfloat16 (B, H, S, 128) tensors only (Llama-3-8B's head dim); any
other type, head dim or device raises.
"""
from __future__ import annotations

import torch

# the one head dim the kernels are instantiated for (Llama-3-8B's)
HEAD_DIM = 128


def _check(name, q, k, v, *rest):
    tensors = (q, k, v) + rest
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: want q (B, H, Sq, D) and equal k/v "
                         f"(B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (Hkv must divide H)")
    if D != HEAD_DIM:
        raise ValueError(f"{name}: head_dim {D} != {HEAD_DIM}")
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise TypeError(f"{name}: the kernel takes bfloat16 q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if min(B, H, Sq, Sk) == 0 or B > 65535 or H > 65535:
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    return B, H, Hkv, Sq, Sk


def _c(t):
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError("flash attention: inputs must be 16-byte aligned")
    return t


def _rows(name, t, B, H, Sq):
    if t.shape != (B, H, Sq) or t.dtype != torch.float32:
        raise ValueError(f"{name}: lse/delta must be fp32 ({B}, {H}, {Sq}), "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    """Forward kernel: (O (B, H, Sq, D) bf16, LSE fp32 (B, H, Sq))."""
    from . import _build

    B, H, Hkv, Sq, Sk = _check("flash_fwd_cuda", q, k, v)
    q, k, v = _c(q), _c(k), _c(v)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    lib = _build.library()
    err = lib.pt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), B, H, Hkv, Sq, Sk,
                           int(bool(causal)), float(scale),
                           _build.stream_ptr(q.device))
    _build.check(err, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ kernel: dQ (B, H, Sq, D) bf16 from the saved LSE and
    delta = rowsum(dO·O)."""
    from . import _build

    B, H, Hkv, Sq, Sk = _check("flash_bwd_dq_cuda", q, k, v, do, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash_bwd_dq_cuda: dO must match q")
    lse = _rows("flash_bwd_dq_cuda", lse, B, H, Sq)
    delta = _rows("flash_bwd_dq_cuda", delta, B, H, Sq)
    q, k, v, do = _c(q), _c(k), _c(v), _c(do)
    dq = torch.empty_like(q)
    lib = _build.library()
    err = lib.pt_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(), B, H, Hkv, Sq,
                              Sk, int(bool(causal)), float(scale),
                              _build.stream_ptr(q.device))
    _build.check(err, "flash_bwd_dq")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dK/dV kernel: (dK, dV) (B, Hkv, Sk, D) bf16, summed over each KV
    head's group of query heads inside the kernel."""
    from . import _build

    B, H, Hkv, Sq, Sk = _check("flash_bwd_dkv_cuda", q, k, v, do, lse,
                               delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash_bwd_dkv_cuda: dO must match q")
    lse = _rows("flash_bwd_dkv_cuda", lse, B, H, Sq)
    delta = _rows("flash_bwd_dkv_cuda", delta, B, H, Sq)
    q, k, v, do = _c(q), _c(k), _c(v), _c(do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.library()
    err = lib.pt_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               B, H, Hkv, Sq, Sk, int(bool(causal)),
                               float(scale), _build.stream_ptr(q.device))
    _build.check(err, "flash_bwd_dkv")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0
