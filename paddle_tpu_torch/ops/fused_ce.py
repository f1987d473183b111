"""Fused lm-head + cross-entropy, chunked over tokens — port of
``paddle_tpu/ops/fused_ce.py`` (``_chunk``, the custom-vjp ``_flce``,
``capped_chunk_size``, ``fused_linear_cross_entropy``).

The loss is computed token chunk by token chunk: one chunk's logits exist
at a time, the ``[B·S, V]`` logits never do. The forward saves each
chunk's logsumexp; the backward recomputes the chunk's logits, forms
``(softmax - onehot) · g / n_valid``, zeroes ignored rows, and accumulates
dW in fp32. Ignored rows' activations are zeroed before the dW
contraction, so non-finite values there cannot poison dW.

Every product here is a plain ``torch`` matrix product, as the JAX
package leaves them to XLA (no Pallas in this op). Chunk logits are fp32
products of the working-dtype operands: on the card a bf16 ``torch.mm``
with an fp32 output (``out_dtype``), on the CPU an fp32 product.
``PT_CE_CHUNK`` (a positive int) overrides every caller's chunk size, as
in the JAX package; any other value warns and keeps the caller's. Not
ported: the ``CEGeometry`` row sub-tile.
"""
from __future__ import annotations

import os
import warnings

import torch
from torch.nn import functional as F


def _mm_f32(a, b):
    """``a @ b`` with fp32 accumulation and an fp32 result."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _chunk(h2, labels, chunk_size, ignore_index):
    """Pad [N, H] / [N] to a multiple of the chunk and reshape to chunks;
    padded rows carry ``ignore_index``."""
    n = h2.shape[0]
    c = min(chunk_size, n)
    nchunk = -(-n // c)
    pad = nchunk * c - n
    if pad:
        h2 = F.pad(h2, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_index)
    return h2.reshape(nchunk, c, h2.shape[-1]), labels.reshape(nchunk, c)


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, w, labels, ignore_index, chunk_size):
        hc, lc = _chunk(h2, labels, chunk_size, ignore_index)
        V = w.shape[-1]
        loss_sum = torch.zeros((), dtype=torch.float32, device=h2.device)
        cnt = torch.zeros((), dtype=torch.int64, device=h2.device)
        lses = []
        for hk, lk in zip(hc, lc):
            logits = _mm_f32(hk, w)
            lse = torch.logsumexp(logits, -1)
            gold = logits.gather(1, lk.clamp(0, V - 1)[:, None])[:, 0]
            del logits
            valid = lk != ignore_index
            loss_sum += torch.where(valid, lse - gold, 0.0).sum()
            cnt += valid.sum()
            lses.append(lse)
        ctx.save_for_backward(h2, w, labels, torch.stack(lses), cnt)
        ctx.ignore_index, ctx.chunk_size = ignore_index, chunk_size
        return loss_sum / cnt.clamp_min(1).float()

    @staticmethod
    def backward(ctx, g):
        h2, w, labels, lses, cnt = ctx.saved_tensors
        hc, lc = _chunk(h2, labels, ctx.chunk_size, ctx.ignore_index)
        V = w.shape[-1]
        scale = g.float() / cnt.clamp_min(1).float()
        rows = torch.arange(hc.shape[1], device=h2.device)
        dw = None
        dh = []
        for hk, lk, lsek in zip(hc, lc, lses):
            # dlogits = (softmax - onehot) * g / n_valid, 0 on ignored rows,
            # formed in place in the recomputed logits
            p = _mm_f32(hk, w).sub_(lsek[:, None]).exp_()
            p[rows, lk.clamp(0, V - 1)] -= 1.0
            p.mul_(scale)
            invalid = (lk == ctx.ignore_index)[:, None]
            p.masked_fill_(invalid, 0.0)
            dlog = p.to(w.dtype)
            del p
            dh.append(torch.matmul(dlog, w.t()).to(hk.dtype))
            part = _mm_f32(hk.masked_fill(invalid, 0).t(), dlog)
            dw = part if dw is None else dw.add_(part)
        dh2 = torch.cat(dh)[:h2.shape[0]]
        return dh2, dw.to(w.dtype), None, None, None


def capped_chunk_size(chunk_size: int, seq_len: int) -> int:
    """The JAX package's long-sequence cap, shared by every fused-CE
    caller: past 8192 tokens per sequence the chunk is at most 8192."""
    return chunk_size if seq_len <= 8192 else min(chunk_size, 8192)


def fused_linear_cross_entropy(hidden, weight, labels,
                               ignore_index: int = -100,
                               chunk_size: int = 1024,
                               transpose_weight: bool = False):
    """Mean next-token CE of ``softmax(hidden @ weight)`` against integer
    ``labels`` without materialising the full logits.

    hidden: [..., H]; weight: [H, V] ([V, H] with ``transpose_weight``, for
    tied embeddings); labels: integer [...] matching hidden's leading
    dims; rows labelled ``ignore_index`` count neither in the sum nor in
    the mean. ``PT_CE_CHUNK`` overrides ``chunk_size`` (see the module
    docstring)."""
    override = os.environ.get("PT_CE_CHUNK")
    if override is not None:
        try:
            parsed = int(override)
        except ValueError:
            parsed = 0
        if parsed > 0:
            chunk_size = parsed
        else:
            warnings.warn(f"PT_CE_CHUNK={override!r} is not a positive int; "
                          f"keeping chunk_size={chunk_size}")
    if transpose_weight:
        weight = weight.t()
    h2 = hidden.reshape(-1, hidden.shape[-1])
    return _FusedLinearCE.apply(h2, weight, labels.reshape(-1).long(),
                                int(ignore_index), int(chunk_size))
