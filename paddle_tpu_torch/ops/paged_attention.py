"""Paged KV-cache attention — port of ``paddle_tpu/ops/paged_attention.py``:
block-table gather, window/decode/chunk K/V writes, the plain
``_attention_core`` and the decode / verify / prefill attention entry
points, for an fp pool and for the int8 pool (``kv_quant="int8"``).

The serving KV cache is a POOL of fixed-size blocks ``(num_blocks,
block_size, KV, D)`` per layer plus per-request int32 block tables. Block id
0 is the scratch block: idle and prefilling rows of the decode batch write
to it and tail table entries point at it; the position mask keeps it out of
every real query's context.

The int8 pool stores int8 codes ``(N, bs, KV, D)`` plus one f32 scale per
(block, KV head) ``(N, KV)`` — symmetric absmax, value ≈ code · scale. Its
attention never builds a dequantized pool: the k-scale multiplies the fp32
QK accumulator and the v-scale multiplies p before the PV product.

Unlike the JAX package, whose pure functions return rebuilt pools (donated
to XLA), the write functions here update the pools IN PLACE
(``Tensor.index_put_`` / indexed assignment) and return the same tensors.
The writes are plain PyTorch, as they are jnp (not Pallas) in JAX.

The attention entry points launch the CUDA kernels
(``paged_attention_cuda.paged_attention_cuda`` and
``paged_attention_int8_cuda``) for CUDA tensors under the ``"auto"`` kernel
mode and otherwise run the plain gather + :func:`_attention_core`
composition.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _table2d(block_tables):
    return block_tables if block_tables.dim() == 2 else block_tables[None]


def gather_block_kv(pool, block_tables):
    """Gather per-row K (or V) context from the block pool.

    pool: (N, bs, KV, D); block_tables: int32 (B, M) (or (M,) for one row).
    Returns (B, M*bs, KV, D) — the dense-equivalent context window."""
    bt = _table2d(block_tables).long()
    gathered = pool[bt]                       # (B, M, bs, KV, D)
    b, m, bs = gathered.shape[:3]
    return gathered.reshape(b, m * bs, *pool.shape[2:])


def write_window_kv(k_pool, v_pool, k, v, block_tables, pos):
    """Scatter a WINDOW of new tokens' K/V per row through the block table,
    in place.

    k/v: (B, W, KV, D); block_tables: int32 (B, M); pos: int32 (B,) — row
    ``b``'s token ``j`` lands at position ``pos[b] + j``, i.e. at
    ``(table[b, (pos+j)//bs], (pos+j)%bs)``. Rows parked on the scratch block
    (idle/prefilling slots) may write it concurrently; whichever write wins,
    scratch is never attended. Returns ``(k_pool, v_pool)``."""
    bs = k_pool.shape[1]
    W = k.shape[1]
    pj = pos.long()[:, None] + torch.arange(W, device=pos.device)[None, :]
    bid = torch.gather(block_tables.long(), 1, pj // bs)
    off = pj % bs
    k_pool.index_put_((bid, off), k.to(k_pool.dtype))
    v_pool.index_put_((bid, off), v.to(v_pool.dtype))
    return k_pool, v_pool


def write_decode_kv(k_pool, v_pool, k, v, block_tables, pos):
    """Scatter ONE new token's K/V per row — :func:`write_window_kv` at
    W = 1. k/v: (B, KV, D)."""
    return write_window_kv(k_pool, v_pool, k[:, None], v[:, None],
                           block_tables, pos)


def _chunk_blocks(name, block_table, start, bs, C):
    """The block ids (int64) of table entries ``[start//bs, start//bs +
    C//bs)``: a chunk's blocks. ``start`` is a host int, checked here
    (block-aligned, room in the table), or an int32 (1,) / 0-d tensor on
    the table's device, read on the device (so that a CUDA graph can
    capture the call), which the caller has checked on the host."""
    on_device = isinstance(start, torch.Tensor)
    if not on_device:
        start = int(start)
    if C % bs or (not on_device and start % bs):
        where = "on the device" if on_device else start
        raise ValueError(f"{name}: chunk {C} and start {where} must be "
                         f"multiples of block_size {bs}")
    nb = C // bs
    if on_device:
        idx = (start.reshape(()).long() // bs
               + torch.arange(nb, device=block_table.device))
        return block_table[idx].long()
    blocks = block_table[start // bs:start // bs + nb].long()
    if blocks.shape[0] != nb:
        raise ValueError(f"{name}: table of {block_table.shape[0]} entries "
                         f"has no room for {nb} blocks at {start}")
    return blocks


def _start_vector(start, device):
    """``start`` (a host int or an int32 (1,) / 0-d tensor) as the int32
    (1,) device vector the attention reads."""
    if isinstance(start, torch.Tensor):
        return start.reshape(1).to(torch.int32)
    return torch.full((1,), int(start), dtype=torch.int32, device=device)


def write_chunk_kv(k_pool, v_pool, k, v, block_table, start):
    """Scatter a prefill CHUNK's K/V into consecutive table entries, in place.

    k/v: (C, KV, D) with C a multiple of ``bs``; block_table: (M,); start:
    block-aligned chunk origin, a host int or a device int32 scalar (see
    :func:`_chunk_blocks`). The chunk occupies table entries ``[start//bs,
    start//bs + C//bs)``. Returns ``(k_pool, v_pool)``."""
    bs = k_pool.shape[1]
    blocks = _chunk_blocks("write_chunk_kv", block_table, start, bs,
                           k.shape[0])
    nb = blocks.shape[0]
    k_pool.index_put_((blocks,), k.reshape(nb, bs, *k.shape[1:])
                      .to(k_pool.dtype))
    v_pool.index_put_((blocks,), v.reshape(nb, bs, *v.shape[1:])
                      .to(v_pool.dtype))
    return k_pool, v_pool


def _attention_core(q, ck, cv, qpos, ksl=None, vsl=None):
    """Plain attention over a gathered context — the arithmetic of
    ``paddle_tpu.ops.paged_attention._attention_core``: grouped GQA QK
    einsum, scores in fp32 divided by sqrt(D), positional causal mask
    (``key position <= qpos``, fill -1e30), fp32 softmax cast to q's dtype,
    then the PV einsum in q's dtype. ``qpos``: (B, S) absolute position of
    every query row. The QK products accumulate in fp32 from the start, as
    the TPU kernel's do (the JAX jnp composition rounds the scores to the
    input dtype first; in fp32 the two are the same).

    int8 pool: ``ck``/``cv`` hold codes and ``ksl``/``vsl`` (B, L, KV) the
    per-token scale views. The k-scale multiplies the fp32 scores before the
    division by sqrt(D); the v-scale multiplies the fp32 softmax before its
    cast to q's dtype — the Pallas kernel's order (``paged_attention_pallas
    .py:140-156``). The JAX jnp reference applies the v-scale after the
    cast, as a multiply in q's dtype; in fp32 the two agree."""
    B, S, H, D = q.shape
    KV = ck.shape[2]
    rep = H // KV
    L = ck.shape[1]
    quantized = ksl is not None
    qg = q.reshape(B, S, KV, rep, D)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(), ck.float())
    if quantized:
        scores = scores * ksl.float().permute(0, 2, 1)[:, :, None, None, :]
    scores = scores / math.sqrt(D)
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None, None, :, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, -1)
    if quantized:
        p = p * vsl.float().permute(0, 2, 1)[:, :, None, None, :]
        cv = cv.to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", p.to(q.dtype), cv)
    return out.reshape(B, S, H, D)


def paged_verify_attention(q, k_pool, v_pool, block_tables, pos):
    """Window attention through block tables (GQA-native).

    q: (B, W, H, D) rope'd queries at positions ``pos[b] + arange(W)``;
    pools: (N, bs, KV, D) with the window's K/V already written; block_tables:
    int32 (B, M); pos: int32 (B,). Query j of row b attends context
    positions ``<= pos[b] + j``. W = 1 is single-token decode."""
    from . import use_kernel
    from .paged_attention_cuda import paged_attention_cuda

    bt = _table2d(block_tables)
    if use_kernel(q):
        return paged_attention_cuda(q, k_pool, v_pool, bt, pos)
    W = q.shape[1]
    ck = gather_block_kv(k_pool, bt)              # (B, L, KV, D)
    cv = gather_block_kv(v_pool, bt)
    qpos = pos.long()[:, None] + torch.arange(W, device=q.device)[None, :]
    return _attention_core(q, ck, cv, qpos)


def paged_decode_attention(q, k_pool, v_pool, block_tables, pos):
    """Single-token decode attention — :func:`paged_verify_attention` at
    W = 1. q: (B, 1, H, D)."""
    return paged_verify_attention(q, k_pool, v_pool, block_tables, pos)


def paged_prefill_attention(q, k_pool, v_pool, block_table, start):
    """Chunked-prefill attention: one chunk of queries (1, C, H, D) at
    positions ``start + arange(C)`` against all paged context written so far
    (earlier chunks, shared prefix blocks and the chunk itself, whose K/V
    must already be in the pool). block_table: (M,); start: a host int or
    a device int32 scalar. The verify attention at B=1, W=C, pos=[start]."""
    return paged_verify_attention(q, k_pool, v_pool, _table2d(block_table),
                                  _start_vector(start, q.device))


# --------------------------------------------------------------------------- #
# The int8 pool (kv_quant="int8")
# --------------------------------------------------------------------------- #

_QEPS = 1e-8   # scale floor: an all-zero block quantizes to scale ~0 with
               # zero codes instead of dividing by zero


def quantize_block_kv(x):
    """(N, bs, KV, D) float → ((N, bs, KV, D) int8, (N, KV) f32 scale);
    symmetric absmax per block per KV head."""
    xf = x.float()
    absmax = xf.abs().amax(dim=(1, 3))                          # (N, KV)
    scale = torch.clamp(absmax, min=_QEPS) / 127.0
    q = torch.clamp(torch.round(xf / scale[:, None, :, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_block_kv(q, scale):
    """Inverse of :func:`quantize_block_kv` — a test and reference helper;
    the serving path never builds it."""
    return q.float() * scale[:, None, :, None]


def _insert_token_q(qpool, scales, tok, bid, off):
    """Insert one token's K (or V) (B, KV, D) at slot ``off`` of block
    ``bid`` per row, in place, requantizing each touched block in one pass:
    the block is rebuilt (codes · scale), the token dropped in, the per-head
    absmax recomputed and the whole block re-coded. When the token does not
    move a head's absmax the scale is unchanged and the old codes round-trip
    exactly; a scale-raising outlier re-rounds its block. Duplicate ``bid``
    only occur for masked rows parked on scratch block 0 (whichever row wins,
    scratch stays finite and is never attended)."""
    B = tok.shape[0]
    rows = torch.arange(B, device=tok.device)
    bid = bid.long()
    blk = qpool[bid].float() * scales[bid][:, None, :, None]   # (B, bs, KV, D)
    blk[rows, off.long()] = tok.float()
    amax = blk.abs().amax(dim=(1, 3))                          # (B, KV)
    ns = torch.clamp(amax, min=_QEPS) / 127.0
    q = torch.clamp(torch.round(blk / ns[:, None, :, None]), -127, 127)
    qpool.index_put_((bid,), q.to(torch.int8))
    scales.index_put_((bid,), ns)
    return qpool, scales


def write_window_kv_q(kq, ks, vq, vs, k, v, block_tables, pos):
    """Quantizing twin of :func:`write_window_kv`: scatter a WINDOW of new
    tokens' K/V into the int8 pool in place, rescaling each touched block,
    one token at a time. k/v: (B, W, KV, D) float; kq/vq: (N, bs, KV, D)
    int8; ks/vs: (N, KV) f32. Returns ``(kq, ks, vq, vs)``."""
    bs = kq.shape[1]
    tables = block_tables.long()
    for j in range(k.shape[1]):
        pj = pos.long() + j
        bid = torch.gather(tables, 1, (pj // bs)[:, None])[:, 0]
        off = pj % bs
        _insert_token_q(kq, ks, k[:, j], bid, off)
        _insert_token_q(vq, vs, v[:, j], bid, off)
    return kq, ks, vq, vs


def write_decode_kv_q(kq, ks, vq, vs, k, v, block_tables, pos):
    """Quantizing twin of :func:`write_decode_kv` — one token per row.
    k/v: (B, KV, D)."""
    return write_window_kv_q(kq, ks, vq, vs, k[:, None], v[:, None],
                             block_tables, pos)


def write_chunk_kv_q(kq, ks, vq, vs, k, v, block_table, start):
    """Quantizing twin of :func:`write_chunk_kv`: a prefill chunk fully
    overwrites its blocks, so each block is quantized fresh. k/v: (C, KV, D),
    C a multiple of ``bs``; ``start`` as in :func:`write_chunk_kv`. In
    place; returns ``(kq, ks, vq, vs)``."""
    bs = kq.shape[1]
    blocks = _chunk_blocks("write_chunk_kv_q", block_table, start, bs,
                           k.shape[0])
    nb = blocks.shape[0]
    knew, ksn = quantize_block_kv(k.reshape(nb, bs, *k.shape[1:]))
    vnew, vsn = quantize_block_kv(v.reshape(nb, bs, *v.shape[1:]))
    kq.index_put_((blocks,), knew)
    ks.index_put_((blocks,), ksn)
    vq.index_put_((blocks,), vnew)
    vs.index_put_((blocks,), vsn)
    return kq, ks, vq, vs


def gather_block_scales(scales, block_tables, block_size):
    """Per-token view of the per-block scales: (N, KV) gathered through
    (B, M) tables and repeated across the block → (B, M·block_size, KV),
    aligned with :func:`gather_block_kv`'s context."""
    bt = _table2d(block_tables).long()
    return torch.repeat_interleave(scales[bt], block_size, dim=1)


def paged_verify_attention_q(q, kq, ks, vq, vs, block_tables, pos):
    """Window attention over the int8 pool: codes ``kq``/``vq`` (N, bs, KV,
    D) with scales ``ks``/``vs`` (N, KV), the scales applied inside the
    attention (see :func:`_attention_core`). Masking and positions as in
    :func:`paged_verify_attention`."""
    from . import use_kernel
    from .paged_attention_cuda import paged_attention_int8_cuda

    bt = _table2d(block_tables)
    if use_kernel(q):
        return paged_attention_int8_cuda(q, kq, ks, vq, vs, bt, pos)
    W = q.shape[1]
    bs = kq.shape[1]
    ckq = gather_block_kv(kq, bt)                 # (B, L, KV, D) int8
    cvq = gather_block_kv(vq, bt)
    ksl = gather_block_scales(ks, bt, bs)         # (B, L, KV) f32
    vsl = gather_block_scales(vs, bt, bs)
    qpos = pos.long()[:, None] + torch.arange(W, device=q.device)[None, :]
    return _attention_core(q, ckq, cvq, qpos, ksl=ksl, vsl=vsl)


def paged_decode_attention_q(q, kq, ks, vq, vs, block_tables, pos):
    """Single-token decode over the int8 pool —
    :func:`paged_verify_attention_q` at W = 1. q: (B, 1, H, D)."""
    return paged_verify_attention_q(q, kq, ks, vq, vs, block_tables, pos)


def paged_prefill_attention_q(q, kq, ks, vq, vs, block_table, start):
    """Chunked-prefill attention over the int8 pool (the verify attention
    at B=1, W=C, pos=[start]). block_table: (M,); start as in
    :func:`paged_prefill_attention`."""
    return paged_verify_attention_q(q, kq, ks, vq, vs, _table2d(block_table),
                                    _start_vector(start, q.device))
