"""CUDA whole-tick decode megakernel — port of
``paddle_tpu/ops/decode_megakernel.py`` (``_tick_kernel`` / ``decode_tick``,
fp pools without LoRA).

:func:`decode_tick_cuda` launches ``csrc/decode_megakernel.cu`` once: a
cooperative launch of one block per SM that runs every layer of the tick
and writes the window's K/V into the pools in place. The plain version it
is held against is ``decode_megakernel._tick_plain``.
"""
from __future__ import annotations

import torch

# the kernel's shape rules (csrc/decode_megakernel.cu)
HEAD_DIM = 128
K_STEP = 256
MAX_ROWS = 64

_POOL_TABLES: dict = {}


def _pool_table(pools, device):
    """int64 device table of the pools' addresses, cached by address."""
    key = (device, tuple(p.data_ptr() for p in pools))
    t = _POOL_TABLES.get(key)
    if t is None:
        if len(_POOL_TABLES) > 16:
            _POOL_TABLES.clear()
        t = torch.tensor(key[1], dtype=torch.int64, device=device)
        _POOL_TABLES[key] = t
    return t


def decode_tick_cuda(x, pools, tables, pos, weights, cos_rows, sin_rows, *,
                     eps: float):
    """One decode/verify tick through every layer, on the card.

    ``x``: (B, W, hidden) bfloat16 with hidden = H·128; ``pools``: flat
    [k0, v0, ...] bfloat16 (N, bs, KV, 128) pools, written in place;
    ``tables`` int32 (B, M); ``pos`` int32 (B,); ``weights``: a
    ``decode_megakernel.LayerWeights`` built on this card; ``cos_rows`` /
    ``sin_rows`` float32 (B, W, 64). B·W ≤ 64, hidden and the
    intermediate size multiples of 256, bs a multiple of 8. Returns the
    tick's output rows (B, W, hidden). Raises on a type, shape, layout or
    device the kernel does not take, and when the launch is refused."""
    from . import _build

    name = "decode_tick_cuda"
    tensors = [x, tables, pos, cos_rows, sin_rows, *pools]
    if x.dtype != torch.bfloat16 or any(p.dtype != torch.bfloat16
                                        for p in pools):
        raise TypeError(f"{name}: the kernel takes bfloat16 x and pools, got "
                        f"{x.dtype}, {sorted({str(p.dtype) for p in pools})}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{name}: tables and pos must be int32")
    if cos_rows.dtype != torch.float32 or sin_rows.dtype != torch.float32:
        raise TypeError(f"{name}: cos_rows and sin_rows must be float32")
    if x.dim() != 3 or not pools or pools[0].dim() != 4:
        raise ValueError(f"{name}: want x (B, W, hidden) and pools (N, bs, "
                         f"KV, D)")
    B, W, Hd = x.shape
    N, bs, KV, D = pools[0].shape
    L = weights.num_layers
    wq = weights["wq"][0]
    I = weights["wg"][0].shape[1]
    if D != HEAD_DIM or cos_rows.shape[-1] * 2 != D:
        raise ValueError(f"{name}: head_dim {D} != {HEAD_DIM}")
    H = Hd // D
    if H * D != Hd or wq.shape != (Hd, Hd) or H % KV:
        raise ValueError(f"{name}: hidden {Hd} is not heads x {D} with a "
                         f"multiple of {KV} KV heads")
    if len(pools) != 2 * L or any(p.shape != pools[0].shape for p in pools):
        raise ValueError(f"{name}: want {2 * L} pools of one shape")
    if B * W > MAX_ROWS or Hd % K_STEP or I % K_STEP or bs % 8:
        raise ValueError(f"{name}: unsupported B*W={B * W} (max {MAX_ROWS}), "
                         f"hidden {Hd} / intermediate {I} (multiples of "
                         f"{K_STEP}) or block size {bs} (multiple of 8)")
    if tables.dim() != 2 or tables.shape[0] != B or pos.shape != (B,) or \
            cos_rows.shape != (B, W, D // 2) or \
            sin_rows.shape != cos_rows.shape:
        raise ValueError(f"{name}: want tables ({B}, M), pos ({B},) and "
                         f"rope rows ({B}, {W}, {D // 2})")
    for tname, t in (("x", x), ("tables", tables), ("pos", pos),
                     ("cos_rows", cos_rows), ("sin_rows", sin_rows),
                     *(("pool", p) for p in pools)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte "
                             f"aligned")
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if weights.ptrs is None or weights.ptrs.device != x.device:
        raise ValueError(f"{name}: the weight table is not on {x.device}")
    M = tables.shape[1]
    dev = x.device
    xres = x.clone()                      # the residual, updated in place
    q = torch.empty((B * W, Hd), dtype=x.dtype, device=dev)
    ao = torch.empty((B * W, Hd), dtype=x.dtype, device=dev)
    hbuf = torch.empty((B * W, I), dtype=x.dtype, device=dev)
    ptab = _pool_table(pools, dev)
    lib = _build.library()
    err = lib.pt_decode_tick(
        weights.ptrs.data_ptr(), ptab.data_ptr(), tables.data_ptr(),
        pos.data_ptr(), cos_rows.data_ptr(), sin_rows.data_ptr(),
        xres.data_ptr(), q.data_ptr(), ao.data_ptr(), hbuf.data_ptr(),
        L, B, W, H, KV, D, I, bs, M, float(eps), _build.stream_ptr(dev))
    _build.check(err, "decode_tick")
    decode_tick_cuda.launches += 1
    return xres


decode_tick_cuda.launches = 0
