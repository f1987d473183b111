"""CUDA paged attention — port of ``paddle_tpu/ops/paged_attention_pallas.py``
(``_attn_kernel`` / ``_paged_attention_call``, fp pools and the int8-pool
twin ``paged_attention_q``).

:func:`paged_attention_cuda` (fp pools) and :func:`paged_attention_int8_cuda`
(int8 codes with per-(block, KV head) f32 scales) launch
``csrc/paged_attention.cu``: one wgmma kernel fed by a TMA ring over the
pool's pages for decode (W=1), verify windows (W=k+1) and chunked prefill
(B=1, W=chunk), and a combine pass where a tile's keys were split. The
launch plan is ``csrc/paged_tiles.cuh``'s (:func:`plan`): the grid, the
splits and the workspace follow from shapes alone, and the kernel reads
``pos`` on the card, so no wrapper reads a device tensor on the host (a
call can be captured in a CUDA graph). The plain versions they are held
against are ``paged_attention._attention_core`` over the gathered context
(``paged_attention.paged_verify_attention`` and ``paged_verify_attention_q``
under ``"reference"`` mode).
"""
from __future__ import annotations

import ctypes
import functools

import torch

# the one head dim the kernel is instantiated for (Llama-3-8B's)
HEAD_DIM = 128
# block sizes the kernel takes: multiples of 8, the TPU kernel's rule on
# hardware (paddle_tpu/ops/paged_attention_pallas.py:70-79)
BLOCK_MULTIPLE = 8
_PLAN_KEYS = ("rows", "tiles", "split_keys", "splits", "box", "items",
              "units")
_CONFIG_KEYS = ("threads", "block_rows", "stage_keys", "stages",
                "smem_bytes", "registers", "local_bytes", "blocks_per_sm")


@functools.lru_cache(maxsize=None)
def plan(B: int, W: int, H: int, KV: int, bs: int, M: int) -> dict:
    """The kernel's launch plan from shapes alone (``paged_tiles::plan``):
    query rows a (batch row, KV head), 64-row tiles, keys a split, splits
    a tile at most, keys a TMA box, work items and work units (item x KV
    head) at most."""
    from . import _build

    vals = (ctypes.c_int * 7)()
    _build.check(_build.library().pt_paged_plan(B, W, H, KV, bs, M, vals),
                 "paged_plan")
    return dict(zip(_PLAN_KEYS, vals))


def kernel_config() -> dict:
    """The kernel's launch shape per pool type (``bf16``, ``int8``):
    threads, query rows a block, keys a ring stage, ring stages, shared
    memory, registers and local bytes a thread, blocks an SM holds."""
    from . import _build

    lib = _build.library()
    out = {}
    for name, quant in (("bf16", 0), ("int8", 1)):
        vals = (ctypes.c_int * 8)()
        _build.check(lib.pt_paged_attention_config(quant, vals),
                     "paged_attention_config")
        out[name] = dict(zip(_CONFIG_KEYS, vals))
    return out


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
    if bs <= 0 or bs % BLOCK_MULTIPLE:
        raise ValueError(f"{name}: unsupported block_size {bs}: the kernel "
                         f"takes multiples of {BLOCK_MULTIPLE} (the TPU "
                         f"kernel's rule on hardware, paged_attention_pallas"
                         f".py:70-79)")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and pos must be int32")
    if B > 65535 or KV > 65535 or M == 0:
        raise ValueError(f"{name}: unsupported B={B}, KV={KV}, M={M}")
    for tname, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and "
                             f"16-byte aligned")
    return B, W, H, D, N, bs, KV, M


def _workspace(q, B, W, H, KV, bs, M):
    """(out, part_acc, part_ml) for one launch, sized from shapes alone:
    the split workspaces only where the plan may split a tile's keys."""
    p = plan(B, W, H, KV, bs, M)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if p["splits"] > 1:
        part_acc = torch.empty((B, KV, p["splits"], p["rows"], q.shape[-1]),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, KV, p["splits"], p["rows"], 2),
                              dtype=torch.float32, device=q.device)
    return out, part_acc, part_ml


def _ptr(t):
    return t.data_ptr() if t is not None else None


def paged_attention_cuda(q, k_pool, v_pool, block_tables, pos):
    """Fused paged attention over an fp block pool, on the card.

    q: (B, W, H, D) bfloat16 with D = 128; k_pool/v_pool: (N, bs, KV, D)
    bfloat16 (the kernel is instantiated for no other type or head dim
    yet), bs a multiple of 8; block_tables: int32 (B, M) — every entry a
    valid block id; pos: int32 (B,) absolute position of each row's first
    query token.
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
    out, part_acc, part_ml = _workspace(q, B, W, H, KV, bs, M)
    lib = _build.library()
    err = lib.pt_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        _ptr(part_acc), _ptr(part_ml),
        B, W, H, KV, D, N, bs, M, _build.stream_ptr(q.device))
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
    out, part_acc, part_ml = _workspace(q, B, W, H, KV, bs, M)
    lib = _build.library()
    err = lib.pt_paged_attention_int8(
        q.data_ptr(), kq_pool.data_ptr(), k_scales.data_ptr(),
        vq_pool.data_ptr(), v_scales.data_ptr(), block_tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), _ptr(part_acc), _ptr(part_ml),
        B, W, H, KV, D, N, bs, M, _build.stream_ptr(q.device))
    _build.check(err, "paged_attention_int8")
    paged_attention_int8_cuda.launches += 1
    return out


paged_attention_int8_cuda.launches = 0
