"""Fused RMSNorm and LayerNorm — port of ``paddle_tpu/ops/fused_norm.py``
(``_rms_ref``, ``_rms_kernel``/``_rms_pallas``, the custom-vjp
``fused_rms_norm``; ``_ln_ref``, ``_ln_kernel``/``_ln_pallas``, the
custom-vjp ``fused_layer_norm``).

``fused_rms_norm(x, w, eps)`` computes ``x * rsqrt(mean(x²) + eps) * w`` over
the last dim with fp32 math and the result cast back to ``x.dtype``. It is
a ``torch.autograd.Function``. Its forward launches ``csrc/rms_norm.cu`` on
a CUDA tensor (one block per row) and runs :func:`_rms_ref` on a CPU
tensor or under ``set_kernel_mode("reference")``. Its backward is the
plain gradient of :func:`_rms_ref`, recomputed from the saved inputs, as
the JAX package's ``_rms_bwd`` takes the vjp of its reference: the JAX
package has no RMSNorm backward kernel, so the port has none either.

``fused_layer_norm(x, w, b, eps)`` is the same for LayerNorm: fp32 mean
and two-pass variance ``mean((x - mu)²)``, ``(x - mu) * rsqrt(var + eps) *
w + b`` cast to ``x.dtype``; its forward launches ``csrc/layer_norm.cu``
(one warp per row, bf16 or fp32) on a CUDA tensor and runs
:func:`_ln_ref` on a CPU tensor or under ``set_kernel_mode("reference")``;
its backward is the plain gradient of :func:`_ln_ref`, as the JAX
package's ``_ln_bwd``. Unlike the JAX package's ``fused_layer_norm`` there
is no ``except``-and-carry-on: a CUDA tensor the kernel does not take
raises, and any row count runs (the TPU kernel's row-tile refusal is not
kept).
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


class _FusedRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        from . import use_kernel

        ctx.save_for_backward(x, w)
        ctx.eps = eps
        if use_kernel(x):
            return rms_norm_cuda(x, w, eps)
        return _rms_ref(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            wd = w.detach().requires_grad_()
            y = _rms_ref(xd, wd, ctx.eps)
        dx, dw = torch.autograd.grad(y, (xd, wd), g)
        return dx, dw, None


def fused_rms_norm(x, w, eps=1e-6):
    return _FusedRMSNorm.apply(x, w, float(eps))


def _ln_ref(x, w, b, eps):
    """Plain version: the arithmetic of ``paddle_tpu.ops.fused_norm._ln_ref``
    — fp32 mean and variance (about the mean), ``(x - mu) * rsqrt(var +
    eps) * w + b``, cast to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


# dtype -> the kernel's dtype code and its 16-byte vector width
_LN_DTYPES = {torch.bfloat16: (0, 8), torch.float32: (1, 4)}


def layer_norm_cuda(x, w, b, eps):
    """Launch the CUDA LayerNorm kernel on ``x`` (..., D) and ``w``, ``b``
    (D,), one dtype (bfloat16 or float32), D a multiple of the 16-byte
    vector (8 bf16, 4 fp32); any row count. Raises on anything else."""
    from . import _build

    if not (x.is_cuda and w.is_cuda and b.is_cuda
            and x.device == w.device == b.device):
        raise ValueError("layer_norm_cuda: x, w and b must be on one CUDA "
                         "device")
    if x.dtype not in _LN_DTYPES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"layer_norm_cuda: the kernel takes bfloat16 or "
                        f"float32 x, w and b of one dtype, got {x.dtype}, "
                        f"{w.dtype} and {b.dtype}")
    code, vec = _LN_DTYPES[x.dtype]
    D = x.shape[-1]
    if w.shape != (D,) or b.shape != (D,):
        raise ValueError(f"layer_norm_cuda: w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} must be ({D},)")
    if D == 0 or D % vec:
        raise ValueError(f"layer_norm_cuda: last dim {D} must be a positive "
                         f"multiple of {vec} for {x.dtype} (16-byte loads)")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("layer_norm_cuda: x, w and b must be 16-byte "
                         "aligned")
    rows = x.numel() // D
    if rows >= 2 ** 31:
        raise ValueError(f"layer_norm_cuda: {rows} rows exceed int32")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.library()
    err = lib.pt_layer_norm(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                            y.data_ptr(), rows, D, code, float(eps),
                            _build.stream_ptr(x.device))
    _build.check(err, "layer_norm")
    layer_norm_cuda.launches += 1
    return y


layer_norm_cuda.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        from . import use_kernel

        ctx.save_for_backward(x, w, b)
        ctx.eps = eps
        if use_kernel(x):
            return layer_norm_cuda(x, w, b, eps)
        return _ln_ref(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            wd = w.detach().requires_grad_()
            bd = b.detach().requires_grad_()
            y = _ln_ref(xd, wd, bd, ctx.eps)
        dx, dw, db = torch.autograd.grad(y, (xd, wd, bd), g)
        return dx, dw, db, None


def fused_layer_norm(x, w, b, eps=1e-5):
    return _FusedLayerNorm.apply(x, w, b, float(eps))
