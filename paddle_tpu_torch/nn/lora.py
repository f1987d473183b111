"""LoRA, the serving half — port of ``paddle_tpu/nn/lora.py`` (``bgmv`` and
``lora_matmul``; the training side, ``attach_lora``/``merge_lora`` and the
adapter export, is not ported yet).

A projection's adapter factors for a batch arrive in one of two forms:

* gathered per batch entry, ``(A (E, in, R), B (E, R, out), s (E,))`` — the
  JAX package's form (``AdapterPool.gather_rows``);
* :class:`PooledFactors` — the adapter pool's stacked tensors at one layer
  plus a per-entry page index, which the CUDA kernel reads in place (no
  per-row copies of the factors).

Null entries (page 0) carry zero factors and s = 0, so their delta is an
exact zero.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PooledFactors:
    """One target's factors for a batch, read from the adapter pool pages:
    ``a`` (pages, L, in, R), ``b`` (pages, L, R, out), ``scale`` (pages,)
    f32 with alpha/r baked in, the pool ``layer`` and ``aidx`` (E,) int32,
    the page of each batch entry."""

    a: torch.Tensor
    b: torch.Tensor
    scale: torch.Tensor
    layer: int
    aidx: torch.Tensor

    def gather(self):
        """The per-entry copies ``(A (E, in, R), B (E, R, out), s (E,))``."""
        idx = self.aidx.long()
        return (self.a[idx, self.layer], self.b[idx, self.layer],
                self.scale[idx])


def _gathered(ab):
    return ab.gather() if isinstance(ab, PooledFactors) else ab


def _rows_delta(x, A, B):
    """fp32 ``(x32 @ A_e) @ B_e`` of every row of x (E, S, in), a row at a
    time (each row's products alike, whatever S and E: batch-invariant).
    Returns (E * S, out)."""
    E, S, K = x.shape
    idx = torch.arange(E, device=x.device).repeat_interleave(S)
    xa = torch.bmm(x.reshape(E * S, 1, K).float(), A.float()[idx])
    return torch.bmm(xa, B.float()[idx])[:, 0]


def bgmv(x, ab):
    """Batched gathered LoRA delta ``((x32 @ A) @ B) · s`` per batch entry,
    in fp32, returned in x's dtype (None when ``ab`` is None). x: (E, S,
    in); ``ab``: gathered factors or :class:`PooledFactors`."""
    if ab is None:
        return None
    A, B, s = _gathered(ab)
    d = torch.bmm(torch.bmm(x.float(), A.float()), B.float())
    return (d * s.float()[:, None, None]).to(x.dtype)


def _lora_plain(x, w, A, B, s):
    """Plain twin of the fused kernel (``paddle_tpu.ops.paged_attention_
    pallas._lora_kernel``): the base product accumulated in fp32 over the
    kernel's K slices (``stream_matmul.sliced_sum``), the delta ``(x32 @
    A) @ B`` in fp32, combined as ``y + d · s`` in fp32 and rounded to x's
    dtype once, every row computed alike (batch-invariant, as the
    kernel). The JAX jnp path instead adds the base product and the delta
    each rounded to x's dtype (``nn/lora.py:259-262``); in fp32 the two
    agree."""
    from ..ops.stream_matmul import k_slices, sliced_sum, sm_count

    E, S, K = x.shape
    N = w.shape[1]
    y = sliced_sum(x.reshape(E * S, K), w, k_slices(K, N, sm_count(x.device)))
    d = _rows_delta(x, A, B)
    sr = s.float().repeat_interleave(S)[:, None]
    return (y + d * sr).to(x.dtype).reshape(E, S, N)


def lora_matmul(x, w, ab):
    """Base projection plus the per-entry LoRA delta in one op: ``x @ w +
    ((x32 @ A) @ B) · s``. x: (E, S, in); w: (in, out); ``ab``: None (the
    plain projection), gathered factors (plain twin only) or
    :class:`PooledFactors`. On a CUDA tensor the fused kernel runs and
    reads the :class:`PooledFactors` pages in place; on a CPU tensor or
    under ``set_kernel_mode("reference")``, its plain twin."""
    from ..ops import use_kernel
    from ..ops.fused_lora_cuda import fused_lora_matmul_cuda

    if ab is None:
        return torch.matmul(x, w)
    if not use_kernel(x):
        return _lora_plain(x, w, *_gathered(ab))
    return fused_lora_matmul_cuda(x, w, ab.a, ab.b, ab.scale, ab.layer,
                                  ab.aidx)
