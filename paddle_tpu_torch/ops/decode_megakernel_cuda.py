"""CUDA whole-tick decode megakernel — port of
``paddle_tpu/ops/decode_megakernel.py`` (``_tick_kernel`` / ``decode_tick``):
fp or int8 KV pools, with or without pooled LoRA deltas.

:func:`decode_tick_cuda` launches ``csrc/decode_megakernel.cu`` once: a
cooperative launch of one block per SM that runs every layer of the tick
and writes the window's K/V into the pools in place. The weights stream
through TMA tensor maps that are encoded once per weight table
(:func:`_weight_maps`); the partial sums and counters of the work plan
(``csrc/tick_plan.cuh``) are scratch tensors of each call. The plain
version it is held against is ``decode_megakernel._tick_plain``.
"""
from __future__ import annotations

import ctypes

import torch

# the kernel's shape rules (csrc/decode_megakernel.cu, csrc/tick_plan.cuh):
# head dim 128, hidden and intermediate sizes multiples of K_STEP (a weight
# tile is K_STEP x 64), B * W <= MAX_ROWS
HEAD_DIM = 128
K_STEP = 64
MAX_ROWS = 64
MAX_LORA_RANK = 16
MAX_INT8_BLOCK = 128
SHRINK_SLICE = 512     # K slice of one LoRA shrink item
LORA_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
# the clock counters (``trace=``): phases of a layer, LoRA shrinks included
# (``TRACE_PHASES``), and the slots of a (layer, phase, block)
TRACE_PHASES = ("shrink_qkv", "qkv", "attention", "shrink_o", "o",
                "shrink_gate_up", "gate_up", "shrink_down", "down")
TRACE_SLOTS = ("entry", "work_end", "barrier_exit", "consumer_wait_ns",
               "producer_wait_ns", "work_a_ns", "work_b_ns", "work_c_ns")
# what the three work slots sum, a product phase and the attention phase
TRACE_WORK = {"product": ("staging", "fragment_ends", "epilogues"),
              "attention": ("key_loops", "split_merges", "int8_inserts")}

_CONFIG_KEYS = ("threads", "block_rows", "stage_rows", "stages", "smem_bytes",
                "registers", "local_bytes", "consumer_registers")

_POOL_TABLES: dict = {}
_PLANS: dict = {}


def kernel_config() -> dict:
    """Each instantiation's launch shape (threads, rows of a full tick, K
    rows a stage, ring stages, shared memory, registers and local bytes a
    thread, the consumers' setmaxnreg count), keyed ``fp``, ``fp_lora``,
    ``int8``, ``int8_lora``."""
    from . import _build

    lib = _build.library()
    out = {}
    for name, quant, lora in (("fp", 0, 0), ("fp_lora", 0, 1),
                              ("int8", 1, 0), ("int8_lora", 1, 1)):
        vals = (ctypes.c_int * 8)()
        _build.check(lib.pt_decode_tick_config(quant, lora, vals),
                     "decode_tick_config")
        out[name] = dict(zip(_CONFIG_KEYS, vals))
    return out


def tick_plan(hid: int, kv: int, inter: int, rows: int, device) -> dict:
    """The work plan's sizes on ``device`` (``csrc/tick_plan.cuh``): fp32
    floats of the partial-sum scratch, group counters, the grid, shared
    memory, whether the plan takes the shapes, and the KV blocks of an
    attention split; cached by shape."""
    from . import _build

    key = (device, hid, kv, inter, rows)
    plan = _PLANS.get(key)
    if plan is None:
        vals = (ctypes.c_int * 7)()
        with torch.cuda.device(device):
            _build.check(_build.library().pt_decode_tick_plan(
                hid, kv, inter, rows, vals), "decode_tick_plan")
        plan = dict(scratch_floats=vals[0] + (vals[1] << 31),
                    groups=vals[2], grid=vals[3], smem_bytes=vals[4],
                    fits=bool(vals[5]), split_blocks=vals[6])
        _PLANS[key] = plan
    return plan


def _weight_maps(weights, device):
    """The TMA maps of the seven projections of every layer, (7, L)
    CUtensorMap of 128 bytes, encoded once per weight table and kept on it
    (the kernel's ``maps``)."""
    from . import _build

    maps = weights.maps
    if maps is None or maps.device != device:
        L = weights.num_layers
        hid = weights["wq"][0].shape[0]
        kvd = weights["wk"][0].shape[1]
        inter = weights["wg"][0].shape[1]
        maps = torch.empty(7 * L * 128, dtype=torch.uint8, device=device)
        addrs = [a for row in weights.addresses() for a in row]
        host = (ctypes.c_longlong * len(addrs))(*addrs)
        with torch.cuda.device(device):
            _build.check(_build.library().pt_decode_tick_maps(
                host, L, hid, kvd, inter, maps.data_ptr()),
                "decode_tick_maps")
        weights.maps = maps
    return maps


def _pool_table(pools, device):
    """int64 device table of the pools' addresses, cached by address for
    the process's life: a CUDA graph that captured a tick reads the table
    by address, so an entry is never dropped (one small tensor a pool
    set)."""
    key = (device, tuple(p.data_ptr() for p in pools))
    t = _POOL_TABLES.get(key)
    if t is None:
        t = torch.tensor(key[1], dtype=torch.int64, device=device)
        _POOL_TABLES[key] = t
    return t


def _check_pools(name, pools, L):
    """(quantized, N, bs, KV, D) of the flat pool list; raises on a type,
    count or shape the kernel does not take."""
    if not pools or pools[0].dim() != 4:
        raise ValueError(f"{name}: want pools (N, bs, KV, D)")
    quant = pools[0].dtype == torch.int8
    N, bs, KV, D = pools[0].shape
    if quant:
        codes, scales = pools[0::2], pools[1::2]
        if any(p.dtype != torch.int8 for p in codes) or \
                any(p.dtype != torch.float32 for p in scales):
            raise TypeError(f"{name}: int8 pools take int8 codes and float32 "
                            f"scales, got {sorted({str(p.dtype) for p in pools})}")
        if len(pools) != 4 * L or any(p.shape != pools[0].shape
                                      for p in codes):
            raise ValueError(f"{name}: want {4 * L} pools (codes, scales, "
                             f"codes, scales a layer), codes of one shape")
        if any(tuple(p.shape) != (N, KV) for p in scales):
            raise ValueError(f"{name}: scales must be ({N}, {KV}) per (block, "
                             f"KV head)")
        if bs > MAX_INT8_BLOCK:
            raise ValueError(f"{name}: unsupported block size {bs} for int8 "
                             f"pools (at most {MAX_INT8_BLOCK})")
    else:
        if any(p.dtype != torch.bfloat16 for p in pools):
            raise TypeError(f"{name}: the kernel takes bfloat16 or int8 pools, "
                            f"got {sorted({str(p.dtype) for p in pools})}")
        if len(pools) != 2 * L or any(p.shape != pools[0].shape
                                      for p in pools):
            raise ValueError(f"{name}: want {2 * L} pools of one shape")
    return quant, N, bs, KV, D


def _lora_args(name, lora, B, L, dims, device):
    """(A pointers, B pointers, scale, aidx, R) of the LoRA tables; raises
    on what the kernel does not take."""
    R = int(lora.max_rank)
    if not 1 <= R <= MAX_LORA_RANK:
        raise ValueError(f"{name}: LoRA rank {R} is over the kernel's limit "
                         f"{MAX_LORA_RANK} (or below 1)")
    aidx, scale = lora.aidx, lora.scale
    if aidx.dtype != torch.int32:
        raise TypeError(f"{name}: aidx must be int32, got {aidx.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"{name}: the LoRA scale must be float32")
    if aidx.device != device or scale.device != device:
        raise ValueError(f"{name}: aidx and the LoRA scale must be on "
                         f"{device}")
    if tuple(aidx.shape) != (B,) or scale.dim() != 1:
        raise ValueError(f"{name}: want aidx ({B},) and scale (pages,)")
    pages = scale.shape[0]
    a_ptr, b_ptr = [0] * 7, [0] * 7
    for t, (A, Bt) in lora.factors.items():
        i, o = dims[t]
        if A.dtype != torch.float32 or Bt.dtype != torch.float32:
            raise TypeError(f"{name}: LoRA factors of {t!r} must be float32")
        if not (A.is_contiguous() and Bt.is_contiguous()):
            raise ValueError(f"{name}: LoRA factors of {t!r} must be "
                             f"contiguous")
        if tuple(A.shape) != (pages, L, i, R) or \
                tuple(Bt.shape) != (pages, L, R, o):
            raise ValueError(f"{name}: LoRA factors of {t!r} must be "
                             f"({pages}, {L}, {i}, {R}) and ({pages}, {L}, "
                             f"{R}, {o})")
        if A.device != device or Bt.device != device:
            raise ValueError(f"{name}: LoRA factors must be on {device}")
        k = LORA_TARGETS.index(t)
        a_ptr[k], b_ptr[k] = A.data_ptr(), Bt.data_ptr()
    for tname, t in (("aidx", aidx), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    return a_ptr, b_ptr, scale, aidx, R


def tick_grid(device) -> int:
    """Blocks of the tick's launch on ``device``: one per SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def trace_buffer(L: int, device):
    """A zeroed int64 (L, phases, grid, slots) buffer for ``trace=``."""
    return torch.zeros((L, len(TRACE_PHASES), tick_grid(device),
                        len(TRACE_SLOTS)), dtype=torch.int64, device=device)


def decode_tick_cuda(x, pools, tables, pos, weights, cos_rows, sin_rows, *,
                     eps: float, dequant: str = "scores", lora=None,
                     trace=None):
    """One decode/verify tick through every layer, on the card.

    ``x``: (B, W, hidden) bfloat16 with hidden = H·128; ``pools``: flat
    [k0, v0, ...] bfloat16 (N, bs, KV, 128) pools, or int8 [kq0, ks0, vq0,
    vs0, ...] with int8 codes (N, bs, KV, 128) and float32 scales (N, KV)
    (bs ≤ 128), written in place; ``tables`` int32 (B, M); ``pos`` int32
    (B,); ``weights``: a ``decode_megakernel.LayerWeights`` built on this
    card; ``cos_rows`` / ``sin_rows`` float32 (B, W, 64); ``dequant``:
    ``"scores"`` or ``"tile"`` (int8 pools); ``lora``: a
    ``decode_megakernel.LoraTables`` (float32 contiguous factors, rank ≤
    16, int32 aidx on the card) or None; ``trace``: None on the served path,
    or a :func:`trace_buffer` that the kernel fills with its clock counters
    (a diagnostic: the output is the same bits). B·W ≤ 64, hidden and the
    intermediate size multiples of 64, bs a multiple of 8. Returns the
    tick's output rows (B, W, hidden). Raises on a type, shape, layout or
    device the kernel does not take, and when the launch is refused.

    A CUDA graph may capture the call once a call outside the capture has
    encoded the weights' TMA maps and built the pools' address table (both
    kept for later calls): under capture the scratch tensors come from the
    graph's pool and the barrier counters' zeroing is a captured memset,
    so every replay starts on clear barriers."""
    from . import _build

    name = "decode_tick_cuda"
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 x, got {x.dtype}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{name}: tables and pos must be int32")
    if cos_rows.dtype != torch.float32 or sin_rows.dtype != torch.float32:
        raise TypeError(f"{name}: cos_rows and sin_rows must be float32")
    if dequant not in ("scores", "tile"):
        raise ValueError(f"{name}: dequant must be 'scores' or 'tile', got "
                         f"{dequant!r}")
    if x.dim() != 3:
        raise ValueError(f"{name}: want x (B, W, hidden)")
    L = weights.num_layers
    quant, N, bs, KV, D = _check_pools(name, pools, L)
    B, W, Hd = x.shape
    wq = weights["wq"][0]
    I = weights["wg"][0].shape[1]
    if D != HEAD_DIM or cos_rows.shape[-1] * 2 != D:
        raise ValueError(f"{name}: head_dim {D} != {HEAD_DIM}")
    H = Hd // D
    if H * D != Hd or wq.shape != (Hd, Hd) or H % KV:
        raise ValueError(f"{name}: hidden {Hd} is not heads x {D} with a "
                         f"multiple of {KV} KV heads")
    if B * W > MAX_ROWS or Hd % K_STEP or I % K_STEP or bs % 8:
        raise ValueError(f"{name}: unsupported B*W={B * W} (max {MAX_ROWS}), "
                         f"hidden {Hd} / intermediate {I} (multiples of "
                         f"{K_STEP}) or block size {bs} (multiple of 8)")
    if tables.dim() != 2 or tables.shape[0] != B or pos.shape != (B,) or \
            cos_rows.shape != (B, W, D // 2) or \
            sin_rows.shape != cos_rows.shape:
        raise ValueError(f"{name}: want tables ({B}, M), pos ({B},) and "
                         f"rope rows ({B}, {W}, {D // 2})")
    dev = x.device
    a_ptr, b_ptr = [0] * 7, [0] * 7
    lscale = laidx = lpart = None
    R = 0
    if lora is not None:
        KVD = KV * D
        dims = {"q": (Hd, Hd), "k": (Hd, KVD), "v": (Hd, KVD), "o": (Hd, Hd),
                "gate": (Hd, I), "up": (Hd, I), "down": (I, Hd)}
        a_ptr, b_ptr, lscale, laidx, R = _lora_args(name, lora, B, L, dims,
                                                    dev)
    tensors = [x, tables, pos, cos_rows, sin_rows, *pools]
    for tname, t in (("x", x), ("tables", tables), ("pos", pos),
                     ("cos_rows", cos_rows), ("sin_rows", sin_rows),
                     *(("pool", p) for p in pools)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte "
                             f"aligned")
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if trace is not None and (
            trace.dtype != torch.int64 or not trace.is_contiguous()
            or trace.device != x.device or tuple(trace.shape) != (
                weights.num_layers, len(TRACE_PHASES), tick_grid(x.device),
                len(TRACE_SLOTS))):
        raise ValueError(f"{name}: trace must be trace_buffer(L, device)")
    if weights.ptrs is None or weights.ptrs.device != x.device:
        raise ValueError(f"{name}: the weight table is not on {x.device}")
    M = tables.shape[1]
    rows = B * W
    plan = tick_plan(Hd, KV, I, rows, dev)
    if not plan["fits"]:
        raise ValueError(f"{name}: the work plan does not take hidden {Hd}, "
                         f"{KV} KV heads, intermediate {I} at {rows} rows")
    maps = _weight_maps(weights, dev)
    NS = -(-max(Hd, I) // SHRINK_SLICE)
    if lora is not None:
        lpart = torch.empty((rows, 7, NS, R), dtype=torch.float32, device=dev)
    xres = x.clone()                      # the residual, updated in place
    q = torch.empty((rows, Hd), dtype=x.dtype, device=dev)
    ao = torch.empty((rows, Hd), dtype=x.dtype, device=dev)
    hbuf = torch.empty((rows, I), dtype=x.dtype, device=dev)
    ktok = vtok = None
    if quant:
        ktok = torch.empty((rows, KV * D), dtype=x.dtype, device=dev)
        vtok = torch.empty((rows, KV * D), dtype=x.dtype, device=dev)
    # the plan's partial sums; the attention splits' (max, sum, output) of
    # every query row; the grid barrier's, the groups' and the splits'
    # counters, zeroed
    part = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                       device=dev)
    splits = -(-M // plan["split_blocks"])
    apart = torch.empty(B * KV * splits * W * (H // KV) * (D + 2),
                        dtype=torch.float32, device=dev)
    gsync = torch.zeros(1 + plan["groups"] + B * KV, dtype=torch.int32,
                        device=dev)
    ptab = _pool_table(pools, dev)
    la = (ctypes.c_longlong * 7)(*a_ptr)
    lb = (ctypes.c_longlong * 7)(*b_ptr)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    err = lib.pt_decode_tick(
        maps.data_ptr(), weights.ptrs.data_ptr(), ptab.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), cos_rows.data_ptr(),
        sin_rows.data_ptr(), xres.data_ptr(), q.data_ptr(), ao.data_ptr(),
        hbuf.data_ptr(), ptr(ktok), ptr(vtok), ctypes.addressof(la),
        ctypes.addressof(lb), ptr(lscale), ptr(laidx), ptr(lpart),
        part.data_ptr(), apart.data_ptr(), gsync.data_ptr(), ptr(trace),
        L, B, W, H, KV, D, I, bs, M, int(quant),
        int(dequant == "tile"), R, NS, float(eps), _build.stream_ptr(dev))
    _build.check(err, "decode_tick")
    decode_tick_cuda.launches += 1
    return xres


decode_tick_cuda.launches = 0
