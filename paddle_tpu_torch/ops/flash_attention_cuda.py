"""CUDA flash attention — port of the Pallas kernels of
``paddle_tpu/ops/flash_attention.py``: the full-K loop forms
``_flash_fwd_bhsd_loop`` (``:488``) and the ``_flash_bwd_bhsd_loop`` pair
(dQ ``:628``, dK/dV ``:646``), and the streaming forms
``_flash_fwd_bhsd_stream`` (``:189``) and the ``_flash_bwd_bhsd_stream``
pair (dQ ``:352``, dK/dV ``:376``), which the JAX package takes past
``_FULL_K_MAX`` keys.

Six wrappers over ``csrc/flash_attention.cu`` (the forward) and
``csrc/flash_attention_bwd.cu`` (the dQ and dK/dV kernels), all three
kernels wgmma fed by a TMA ring, each wrapper with its launch counter:
:func:`flash_fwd_cuda` (O, LSE), :func:`flash_bwd_dq_cuda` and
:func:`flash_bwd_dkv_cuda` for the loop
rows, and :func:`flash_fwd_stream_cuda`, :func:`flash_bwd_dq_stream_cuda`
and :func:`flash_bwd_dkv_stream_cuda` for the streaming rows. The TPU
splits the two forms only because the loop kernels keep all of K/V
resident in VMEM; on Hopper every form streams tiles through shared
memory, so both sets of wrappers launch the same three C entry points,
and the separate wrappers and counters show which rows a run went
through. :func:`forward_config` and :func:`backward_config` read the
kernels' launch shape and registers from the built library. Their
plain versions are ``flash_attention._flash_fwd_plain`` /
``_flash_bwd_plain``. The kernels take bfloat16 (B, H, S, D) tensors at
head dim D = 128 (Llama-3-8B) or 64 (ERNIE-3.0 base) whose every tensor
holds fewer than 2**31 elements; any other type, head dim, extent or
device raises. fp32 q/k/v raise on CUDA (TypeError): the card path runs its
models in bfloat16 — call ``model.bfloat16()`` first; the plain versions
keep fp32 on the CPU.
"""
from __future__ import annotations

import torch

# the head dims the kernels are instantiated for (ERNIE-3.0 base's and
# Llama-3-8B's)
HEAD_DIMS = (64, 128)
# the kernels index a tensor's elements with 32-bit row and batch·head
# products: every tensor must hold fewer elements than this
MAX_ELEMENTS = 2 ** 31


def _check(name, q, k, v, *rest):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: want q (B, H, Sq, D) and equal k/v "
                         f"(B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for t in (q, k):
        if t.numel() >= MAX_ELEMENTS:
            raise ValueError(f"{name}: {tuple(t.shape)} holds {t.numel()} "
                             f"elements, the kernel takes fewer than 2**31")
    tensors = (q, k, v) + rest
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (Hkv must divide H)")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise TypeError(f"{name}: the kernel takes bfloat16 q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype} (run the model in "
                        f"bfloat16 on the card: model.bfloat16())")
    if min(B, H, Sq, Sk) == 0 or B > 65535 or H > 65535:
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    return B, H, Hkv, Sq, Sk, D


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


def _fwd(name, q, k, v, causal, scale):
    """Launch the forward kernel; (O, LSE)."""
    from . import _build

    B, H, Hkv, Sq, Sk, D = _check(name, q, k, v)
    q, k, v = _c(q), _c(k), _c(v)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    err = _build.library().pt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Hkv, Sq, Sk, D, int(bool(causal)),
        float(scale), _build.stream_ptr(q.device))
    _build.check(err, name)
    return out, lse


def _bwd_inputs(name, q, k, v, do, lse, delta):
    B, H, Hkv, Sq, Sk, D = _check(name, q, k, v, do, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: dO must match q")
    lse = _rows(name, lse, B, H, Sq)
    delta = _rows(name, delta, B, H, Sq)
    return (B, H, Hkv, Sq, Sk, D), (_c(q), _c(k), _c(v), _c(do), lse,
                                    delta)


def _bwd_dq(name, q, k, v, do, lse, delta, causal, scale):
    """Launch the dQ kernel; dQ."""
    from . import _build

    dims, (q, k, v, do, lse, delta) = _bwd_inputs(name, q, k, v, do, lse,
                                                  delta)
    dq = torch.empty_like(q)
    err = _build.library().pt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
        int(bool(causal)), float(scale), _build.stream_ptr(q.device))
    _build.check(err, name)
    return dq


def _bwd_dkv(name, q, k, v, do, lse, delta, causal, scale):
    """Launch the dK/dV kernel; (dK, dV)."""
    from . import _build

    dims, (q, k, v, do, lse, delta) = _bwd_inputs(name, q, k, v, do, lse,
                                                  delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _build.library().pt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *dims, int(bool(causal)), float(scale), _build.stream_ptr(q.device))
    _build.check(err, name)
    return dk, dv


def flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    """Forward kernel (loop row 1): (O (B, H, Sq, D) bf16, LSE fp32
    (B, H, Sq))."""
    out = _fwd("flash_fwd", q, k, v, causal, scale)
    flash_fwd_cuda.launches += 1
    return out


flash_fwd_cuda.launches = 0


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ kernel (loop row 3): dQ (B, H, Sq, D) bf16 from the saved LSE and
    delta = rowsum(dO·O)."""
    dq = _bwd_dq("flash_bwd_dq", q, k, v, do, lse, delta, causal, scale)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dK/dV kernel (loop row 4): (dK, dV) (B, Hkv, Sk, D) bf16, summed
    over each KV head's group of query heads in fp32 inside the kernel."""
    out = _bwd_dkv("flash_bwd_dkv", q, k, v, do, lse, delta, causal, scale)
    flash_bwd_dkv_cuda.launches += 1
    return out


flash_bwd_dkv_cuda.launches = 0


def flash_fwd_stream_cuda(q, k, v, causal: bool, scale: float):
    """Streaming forward kernel (row 2): as :func:`flash_fwd_cuda`."""
    out = _fwd("flash_fwd_stream", q, k, v, causal, scale)
    flash_fwd_stream_cuda.launches += 1
    return out


flash_fwd_stream_cuda.launches = 0


def flash_bwd_dq_stream_cuda(q, k, v, do, lse, delta, causal: bool,
                             scale: float):
    """Streaming dQ kernel (row 5): as :func:`flash_bwd_dq_cuda`."""
    dq = _bwd_dq("flash_bwd_dq_stream", q, k, v, do, lse, delta, causal,
                 scale)
    flash_bwd_dq_stream_cuda.launches += 1
    return dq


flash_bwd_dq_stream_cuda.launches = 0


def flash_bwd_dkv_stream_cuda(q, k, v, do, lse, delta, causal: bool,
                              scale: float):
    """Streaming dK/dV kernel (row 6): as :func:`flash_bwd_dkv_cuda`, the
    GQA group summed in fp32 and rounded once, as the JAX stream kernel
    rounds."""
    out = _bwd_dkv("flash_bwd_dkv_stream", q, k, v, do, lse, delta,
                   causal, scale)
    flash_bwd_dkv_stream_cuda.launches += 1
    return out


flash_bwd_dkv_stream_cuda.launches = 0


_CONFIG_KEYS = ("threads", "block_rows", "stage_rows", "stages",
                "smem_bytes", "registers", "local_bytes",
                "consumer_registers")


def _config(fn, *args, what):
    import ctypes

    from . import _build

    vals = (ctypes.c_int * len(_CONFIG_KEYS))()
    _build.check(fn(*args, vals), f"{what} config")
    return dict(zip(_CONFIG_KEYS, vals))


def forward_config(D: int) -> dict:
    """The forward kernel's launch shape at head dim D, read from the built
    library: threads a block, the query rows a block owns, the keys a ring
    stage holds, ring stages, dynamic shared memory bytes, registers a
    thread at launch, local (spill and stack) bytes a thread, and the
    consumer warpgroups' setmaxnreg count."""
    from . import _build

    return _config(_build.library().pt_flash_fwd_config, D,
                   what="flash_fwd")


def backward_config(D: int) -> dict:
    """The two backward kernels' launch shape at head dim D, read from the
    built library: {"flash_bwd_dq": {...}, "flash_bwd_dkv": {...}} with
    threads a block, the rows a block owns (dQ query rows, dK/dV keys),
    the rows a ring stage holds (keys, query rows), ring stages, dynamic
    shared memory bytes, registers a thread at launch, local (spill and
    stack) bytes a thread, and the consumer warpgroups' setmaxnreg count."""
    from . import _build

    return {name: _config(_build.library().pt_flash_bwd_config, which, D,
                          what=name)
            for which, name in enumerate(("flash_bwd_dq", "flash_bwd_dkv"))}
