"""Paged KV-cache attention — port of ``paddle_tpu/ops/paged_attention.py``
(the fp subset: block-table gather, window/decode/chunk K/V writes, the
plain ``_attention_core`` and the decode / verify / prefill attention
entry points).

The serving KV cache is a POOL of fixed-size blocks ``(num_blocks,
block_size, KV, D)`` per layer plus per-request int32 block tables. Block id
0 is the scratch block: idle and prefilling rows of the decode batch write
to it and tail table entries point at it; the position mask keeps it out of
every real query's context.

Unlike the JAX package, whose pure functions return rebuilt pools (donated
to XLA), the write functions here update the pools IN PLACE
(``Tensor.index_put_`` / indexed assignment) and return the same tensors.

The attention entry points launch the CUDA kernel
(``paged_attention_cuda.paged_attention_cuda``) for CUDA tensors under the
``"auto"`` kernel mode and otherwise run the plain gather +
:func:`_attention_core` composition.
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


def write_chunk_kv(k_pool, v_pool, k, v, block_table, start):
    """Scatter a prefill CHUNK's K/V into consecutive table entries, in place.

    k/v: (C, KV, D) with C a multiple of ``bs``; block_table: (M,); start:
    block-aligned chunk origin (int). The chunk occupies table entries
    ``[start//bs, start//bs + C//bs)``. Returns ``(k_pool, v_pool)``."""
    bs = k_pool.shape[1]
    C = k.shape[0]
    start = int(start)
    if C % bs or start % bs:
        raise ValueError(f"write_chunk_kv: chunk {C} and start {start} must "
                         f"be multiples of block_size {bs}")
    nb = C // bs
    blocks = block_table[start // bs:start // bs + nb].long()
    if blocks.shape[0] != nb:
        raise ValueError(f"write_chunk_kv: table of {block_table.shape[0]} "
                         f"entries has no room for {nb} blocks at {start}")
    k_pool.index_put_((blocks,), k.reshape(nb, bs, *k.shape[1:])
                      .to(k_pool.dtype))
    v_pool.index_put_((blocks,), v.reshape(nb, bs, *v.shape[1:])
                      .to(v_pool.dtype))
    return k_pool, v_pool


def _attention_core(q, ck, cv, qpos):
    """Plain attention over a gathered context — the arithmetic of
    ``paddle_tpu.ops.paged_attention._attention_core`` (fp branch): grouped
    GQA QK einsum, scores in fp32 divided by sqrt(D), positional causal mask
    (``key position <= qpos``, fill -1e30), fp32 softmax cast to q's dtype,
    then the PV einsum in q's dtype. ``qpos``: (B, S) absolute position of
    every query row. The QK products accumulate in fp32 from the start, as
    the TPU kernel's do (the JAX jnp composition rounds the scores to the
    input dtype first; in fp32 the two are the same)."""
    B, S, H, D = q.shape
    KV = ck.shape[2]
    rep = H // KV
    L = ck.shape[1]
    qg = q.reshape(B, S, KV, rep, D)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(), ck.float())
    scores = scores / math.sqrt(D)
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None, None, :, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, -1).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", p, cv)
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
    must already be in the pool). block_table: (M,). The verify attention at
    B=1, W=C, pos=[start]."""
    start_v = torch.full((1,), int(start), dtype=torch.int32,
                         device=q.device)
    return paged_verify_attention(q, k_pool, v_pool, _table2d(block_table),
                                  start_v)
