"""Flash attention — port of ``paddle_tpu/ops/flash_attention.py`` (the
full-K loop forms ``_flash_fwd_bhsd_loop`` / ``_flash_bwd_bhsd_loop``, the
streaming forms ``_flash_fwd_bhsd_stream`` / ``_flash_bwd_bhsd_stream``
and the dispatch between them at ``_FULL_K_MAX``, the reference
``_ref_bhsd``, the custom-vjp ``flash_attention`` and
``flash_attention_bshd``).

Layout (B, H, S, D); GQA with Hkv | H query heads (query head h reads KV
head ``h // (H / Hkv)``, never a repeated copy); ``scale`` defaults to
1/sqrt(D); causal masks align bottom-right when Sq != Sk (query i sees key
j iff ``j <= i + Sk - Sq``).

:func:`flash_attention` is a ``torch.autograd.Function``. Its forward
returns O and saves the fp32 logsumexp (B, H, Sq); its backward takes
``delta = rowsum(dO·O)`` (fp32, plain PyTorch, as XLA computes it in the
JAX package) and recomputes P from the LSE. On CUDA tensors the three
steps launch the kernels of ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (dQ, dK/dV; :mod:`.flash_attention_cuda`)
— the loop kernels' entry points up
to ``_FULL_K_MAX`` keys, the streaming ones past it, where the JAX package
switches; on CPU tensors, or under
``set_kernel_mode("reference")``, they run :func:`_flash_fwd_plain` and
:func:`_flash_bwd_plain`, which repeat the kernels' arithmetic. Unlike the
JAX package there is no fallback to the reference on odd shapes or on a
kernel error: the kernels mask a ragged last tile themselves, and a CUDA
tensor they do not take (not bfloat16, D not 64 or 128) raises.

Masked keys get p = 0 exactly, and the running max starts at -1e30 as in
the TPU kernel, so every row that sees at least one key gets the JAX
package's result; a row that sees none (causal with Sq > Sk) gets O = 0.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
# K/V longer than this take the streaming forms, as in the JAX package
# (whose loop kernels keep the whole of K/V resident in VMEM up to here).
# The JAX block-size tables beside it are TPU tuning and are not ported.
_FULL_K_MAX = 8192
# query rows per step of the plain versions: bounds their fp32 score
# tensors to (B, H, _PLAIN_ROWS, Sk)
_PLAIN_ROWS = 512


def _ref_bhsd(q, k, v, causal: bool, scale: float):
    """Reference composition (the JAX package's ``_ref_bhsd``): repeated
    K/V, logits in the input dtype then fp32, masked logits -1e30, fp32
    softmax cast to q's dtype before PV."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention wants q (B, H, Sq, D) and equal "
                         f"k/v (B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"flash attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (Hkv must divide H)")


def _visible(q0, q1, Sq, Sk, device):
    """(q1 - q0, Sk) bool: which keys the query rows q0..q1-1 see under the
    bottom-right-aligned causal mask."""
    qi = torch.arange(q0, q1, device=device)[:, None] + (Sk - Sq)
    return torch.arange(Sk, device=device)[None, :] <= qi


def _grouped(x, Hkv):
    """(B, H, n, D) -> (B, Hkv, rep, n, D): query heads by KV group."""
    B, H = x.shape[:2]
    return x.reshape(B, Hkv, H // Hkv, *x.shape[2:])


def _flash_fwd_plain(q, k, v, causal: bool, scale: float):
    """Plain version of the forward kernel: (O in q's dtype, LSE fp32
    (B, H, Sq)). QK in fp32, p = exp(s - m) cast to V's dtype before PV,
    fp32 sums, O = acc / max(l, 1e-30), LSE = m + log(max(l, 1e-30))."""
    _check_shapes(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf = k.float()[:, :, None]                       # (B, Hkv, 1, Sk, D)
    vf = v.float()[:, :, None]
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, _PLAIN_ROWS):
        q1 = min(q0 + _PLAIN_ROWS, Sq)
        qf = _grouped(q[:, :, q0:q1].float(), Hkv)  # (B, Hkv, rep, n, D)
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        if causal:
            s = s.masked_fill(~_visible(q0, q1, Sq, Sk, q.device), -math.inf)
        m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
        p = torch.exp(s - m)
        l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
        acc = torch.matmul(p.to(v.dtype).float(), vf)
        out[:, :, q0:q1] = (acc / l_safe).reshape(B, H, q1 - q0, D).to(
            q.dtype)
        lse[:, :, q0:q1] = (m + torch.log(l_safe)).reshape(B, H, q1 - q0)
    return out, lse


def _flash_bwd_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain version of the two backward kernels: (dQ, dK, dV) in the input
    dtypes. P = exp(s - LSE) (0 for masked keys); dS = P∘(dO·Vᵀ − δ) cast to
    the input dtype; dQ = scale·dS·K; dV = Pᵀ·dO and dK = scale·dSᵀ·Q, each
    summed over the GQA group in fp32 and rounded once."""
    _check_shapes(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    dq = torch.empty_like(q)
    dk = torch.zeros(B, Hkv, Sk, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, _PLAIN_ROWS):
        q1 = min(q0 + _PLAIN_ROWS, Sq)
        qf = _grouped(q[:, :, q0:q1].float(), Hkv)
        dof = _grouped(do[:, :, q0:q1].float(), Hkv)
        lse_c = _grouped(lse[:, :, q0:q1], Hkv)[..., None]
        delta_c = _grouped(delta[:, :, q0:q1].float(), Hkv)[..., None]
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        if causal:
            s = s.masked_fill(~_visible(q0, q1, Sq, Sk, q.device), -math.inf)
        p = torch.exp(s - lse_c)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = (p * (dp - delta_c)).to(q.dtype).float()
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                           dof).sum(2)
        dk += torch.matmul(ds.transpose(-1, -2), qf).sum(2) * scale
        dq[:, :, q0:q1] = (torch.matmul(ds, kf) * scale).reshape(
            B, H, q1 - q0, D).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _flash_fwd_bhsd_stream(q, k, v, causal: bool, scale: float):
    """(O, LSE) of the streaming form (rows past ``_FULL_K_MAX`` keys): the
    stream forward kernel on CUDA tensors, else the plain version (which
    takes any length, ``_PLAIN_ROWS`` query rows at a time)."""
    from . import use_kernel
    from .flash_attention_cuda import flash_fwd_stream_cuda

    if use_kernel(q):
        return flash_fwd_stream_cuda(q, k, v, causal, scale)
    return _flash_fwd_plain(q, k, v, causal, scale)


def _flash_bwd_bhsd_stream(q, k, v, do, lse, delta, causal: bool,
                           scale: float):
    """(dQ, dK, dV) of the streaming form: the stream dQ and dK/dV kernels
    on CUDA tensors, else the plain version."""
    from . import use_kernel
    from .flash_attention_cuda import (flash_bwd_dkv_stream_cuda,
                                       flash_bwd_dq_stream_cuda)

    if use_kernel(q):
        dq = flash_bwd_dq_stream_cuda(q, k, v, do, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv_stream_cuda(q, k, v, do, lse, delta, causal,
                                           scale)
        return dq, dk, dv
    return _flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)


def _flash_fwd_bhsd(q, k, v, causal: bool, scale: float):
    """(O, LSE): the loop forward kernel up to ``_FULL_K_MAX`` keys and the
    streaming one past it on CUDA tensors, else the plain version."""
    from . import use_kernel
    from .flash_attention_cuda import flash_fwd_cuda

    if k.shape[2] > _FULL_K_MAX:
        return _flash_fwd_bhsd_stream(q, k, v, causal, scale)
    if use_kernel(q):
        return flash_fwd_cuda(q, k, v, causal, scale)
    return _flash_fwd_plain(q, k, v, causal, scale)


def _flash_bwd_bhsd(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dQ, dK, dV): the loop dQ and dK/dV kernels up to ``_FULL_K_MAX``
    keys and the streaming ones past it on CUDA tensors, else the plain
    version."""
    from . import use_kernel
    from .flash_attention_cuda import flash_bwd_dkv_cuda, flash_bwd_dq_cuda

    if k.shape[2] > _FULL_K_MAX:
        return _flash_bwd_bhsd_stream(q, k, v, do, lse, delta, causal, scale)
    if use_kernel(q):
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        return dq, dk, dv
    return _flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _flash_fwd_bhsd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)    # rowsum(dO·O), fp32
        dq, dk, dv = _flash_bwd_bhsd(q, k, v, do, lse, delta, ctx.causal,
                                     ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """(B, H, S, D) flash attention with a flash backward; ``scale``
    defaults to 1/sqrt(D). Under ``amp.auto_cast`` the inputs take the
    ``flash_attention`` rule (white list)."""
    from ..amp import cast_inputs

    q, k, v = cast_inputs("flash_attention", q, k, v)
    s = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), s)


def flash_attention_bshd(q, k, v, causal: bool = False, scale=None):
    """Paddle head layout (B, S, H, D) wrapper; GQA-aware like
    :func:`flash_attention`."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal, scale)
    return out.transpose(1, 2)
