"""CUDA paged attention — port of ``paddle_tpu/ops/paged_attention_pallas.py``
(``_attn_kernel`` / ``_paged_attention_call``, fp pools and the int8-pool
twin ``paged_attention_q``).

:func:`paged_attention_cuda` (fp pools) and :func:`paged_attention_int8_cuda`
(int8 codes with per-(block, KV head) f32 scales) launch
``csrc/paged_attention.cu``: one online-softmax kernel for decode (W=1),
verify windows (W=k+1) and chunked prefill (B=1, W=chunk). The plain
versions they are held against are ``paged_attention._attention_core`` over
the gathered context (``paged_attention.paged_verify_attention`` and
``paged_verify_attention_q`` under ``"reference"`` mode).
"""
from __future__ import annotations

import functools

import torch

# the one head dim the kernel is instantiated for (Llama-3-8B's)
HEAD_DIM = 128
# blocks per SM the context split aims for when (row tiles x KV heads x
# batch) alone would leave SMs idle
_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def context_splits(B: int, Wr: int, KV: int, M: int, sms: int):
    """(S, P): split each row's M table entries into S parts of P entries.

    One part per row when the row tiles alone fill the card; else enough
    parts for about ``_BLOCKS_PER_SM`` blocks per SM (flash-decoding). The
    kernel tiles a KV head's ``Wr`` query rows by 4 (Wr <= 4) or 16."""
    tiles = -(-Wr // (4 if Wr <= 4 else 16))
    base = tiles * KV * B
    if base >= sms:
        return 1, M
    S = min(M, -(-_BLOCKS_PER_SM * sms // base), max(65535 // B, 1))
    P = -(-M // S)
    return -(-M // P), P


def _on_one_card(name, *tensors):
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all inputs must be on one CUDA device")


def _check_common(name, q, pools, block_tables, pos):
    """Shapes and table types both wrappers share; returns
    (B, W, H, D, N, bs, KV, M)."""
    k_pool, v_pool = pools[0], pools[-1]
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: want q (B, W, H, D) and equal pools (N, "
                         f"bs, KV, D), got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, W, H, D = q.shape
    N, bs, KV, Dk = k_pool.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block_tables must be (B={B}, M), got "
                         f"{tuple(block_tables.shape)}")
    M = block_tables.shape[1]
    if pos.shape != (B,):
        raise ValueError(f"{name}: pos must be ({B},), got "
                         f"{tuple(pos.shape)}")
    if Dk != D or D != HEAD_DIM:
        raise ValueError(f"{name}: head_dim {D} (pool {Dk}) != {HEAD_DIM}")
    if H % KV:
        raise ValueError(f"{name}: {H} query heads not a multiple of {KV} "
                         f"KV heads")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and pos must be int32")
    if B > 65535 or KV > 65535 or M == 0:
        raise ValueError(f"{name}: unsupported B={B}, KV={KV}, M={M}")
    for tname, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and "
                             f"16-byte aligned")
    return B, W, H, D, N, bs, KV, M


def _workspace(q, B, W, H, KV, M):
    """(S, P, out, part_acc, part_ml) for one launch."""
    Wr = W * (H // KV)
    S, P = context_splits(B, Wr, KV, M, _sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if S > 1:
        part_acc = torch.empty((B, KV, S, Wr, q.shape[-1]),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, KV, S, Wr, 2), dtype=torch.float32,
                              device=q.device)
    return S, P, out, part_acc, part_ml


def _ptr(t):
    return t.data_ptr() if t is not None else None


def paged_attention_cuda(q, k_pool, v_pool, block_tables, pos):
    """Fused paged attention over an fp block pool, on the card.

    q: (B, W, H, D) bfloat16 with D = 128; k_pool/v_pool: (N, bs, KV, D)
    bfloat16 (the kernel is instantiated for no other type or head dim
    yet); block_tables: int32 (B, M) — every entry a valid block id;
    pos: int32 (B,) absolute position of each row's first query token.
    Returns (B, W, H, D) in q's dtype. Raises on a shape, dtype or device
    the kernel does not take."""
    from . import _build

    _on_one_card("paged_attention_cuda", q, k_pool, v_pool, block_tables,
                 pos)
    B, W, H, D, N, bs, KV, M = _check_common(
        "paged_attention_cuda", q, (k_pool, v_pool), block_tables, pos)
    if {q.dtype, k_pool.dtype, v_pool.dtype} != {torch.bfloat16}:
        raise TypeError(f"paged_attention_cuda: the kernel takes bfloat16 q "
                        f"and pools, got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    block_tables = block_tables.contiguous()
    pos = pos.contiguous()
    S, P, out, part_acc, part_ml = _workspace(q, B, W, H, KV, M)
    lib = _build.library()
    err = lib.pt_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        _ptr(part_acc), _ptr(part_ml),
        B, W, H, KV, D, N, bs, M, S, P, _build.stream_ptr(q.device))
    _build.check(err, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_attention_int8_cuda(q, kq_pool, k_scales, vq_pool, v_scales,
                              block_tables, pos):
    """Fused paged attention over an int8 block pool, on the card: the
    kernel reads the codes and applies the per-(block, KV head) scales on
    the tile (k-scale on the QK accumulator, v-scale on p before PV).

    q: (B, W, H, D) bfloat16 with D = 128; kq_pool/vq_pool: (N, bs, KV, D)
    int8; k_scales/v_scales: (N, KV) float32; block_tables and pos as in
    :func:`paged_attention_cuda`. Returns (B, W, H, D) bfloat16. Raises on
    a shape, dtype or device the kernel does not take."""
    from . import _build

    name = "paged_attention_int8_cuda"
    if q.dtype != torch.bfloat16 or kq_pool.dtype != torch.int8 or \
            vq_pool.dtype != torch.int8:
        raise TypeError(f"{name}: the kernel takes bfloat16 q and int8 "
                        f"pools, got {q.dtype}, {kq_pool.dtype}, "
                        f"{vq_pool.dtype}")
    B, W, H, D, N, bs, KV, M = _check_common(
        name, q, (kq_pool, vq_pool), block_tables, pos)
    for sname, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
        if sc.shape != (N, KV) or sc.dtype != torch.float32 or \
                not sc.is_contiguous():
            raise ValueError(f"{name}: {sname} must be contiguous float32 "
                             f"({N}, {KV}), got {sc.dtype} "
                             f"{tuple(sc.shape)}")
    _on_one_card(name, q, kq_pool, k_scales, vq_pool, v_scales, block_tables,
                 pos)
    block_tables = block_tables.contiguous()
    pos = pos.contiguous()
    S, P, out, part_acc, part_ml = _workspace(q, B, W, H, KV, M)
    lib = _build.library()
    err = lib.pt_paged_attention_int8(
        q.data_ptr(), kq_pool.data_ptr(), k_scales.data_ptr(),
        vq_pool.data_ptr(), v_scales.data_ptr(), block_tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), _ptr(part_acc), _ptr(part_ml),
        B, W, H, KV, D, N, bs, M, S, P, _build.stream_ptr(q.device))
    _build.check(err, "paged_attention_int8")
    paged_attention_int8_cuda.launches += 1
    return out


paged_attention_int8_cuda.launches = 0
