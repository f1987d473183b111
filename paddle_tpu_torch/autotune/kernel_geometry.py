"""Per-layer kernel geometry: tunable schedules for the per-op kernels,
plus the per-(op, dtype, shape, chip) winner cache — port of
``paddle_tpu/autotune/kernel_geometry.py`` (torch and the standard library
only). The five dataclasses keep the JAX field names, defaults,
``validate`` and ``asdict``, and the cache its key string and
fingerprint, so a profile file round-trips between the two packages byte
for byte.

What is the port's own is the Hopper meaning of each schedule and the
occupancy model that filters the candidates. The JAX package filters and
ranks against a TPU core's VMEM (``vmem_bytes``); here that model holds
for the ``"cpu"`` and TPU device kinds, so candidate lists, proxies and
validity on the CPU equal JAX's, and on an NVIDIA card each class's
``smem_bytes`` (the shared memory of one block of its kernel, read from
the kernel's own layout) is held to the 227 KB a Hopper block may take
(:func:`uses_hopper_model`). The Hopper meanings:

- :class:`PagedAttentionGeometry` (``csrc/paged_attention.cu``):
  ``kv_block_depth`` multiplies the TMA ring's stages (2 fp, 3 int8 at
  1); ``grid_order`` numbers the work units KV head fastest ("bgm") or
  slowest ("gbm"). ``q_rows`` would change the tiles a row's query rows
  fill, and with them the splits and their rounding; ``dequant="early"``
  (int8: the codes widened as each stage lands, by the producer
  warpgroup's spare warps) was built and gave the default's bits, but its
  kernel spilled registers. Both raise for a non-default value (ROADMAP
  A9c) and the Hopper candidates leave them out.
- :class:`NormGeometry` (``csrc/rms_norm.cu``, ``csrc/layer_norm.cu``):
  ``rows`` is the rows a block, clamped to a divisor of the rows; each
  row is still reduced by the default's thread tree.
- :class:`LoRAGeometry`: ``rank_pad`` zero-pads the factors on the host
  before the fused kernel, as JAX does; ``accum`` other than
  ``"base_first"`` raises (ROADMAP A9c).
- :class:`FlashAttentionGeometry`: resolved, and a non-default
  ``block_q`` / ``block_kv`` raises (ROADMAP A9c).
- :class:`CEGeometry`: ``rows`` sub-tiles the plain fused CE's chunks.

The contract, as in JAX: every supported geometry is a schedule change
only — tile or block shapes, the order of independent work, streaming
depth, exact casts moved — never a change to the order of any sum, so
every geometry's output is bit-exact against the default geometry's, and
the default geometry of every class is the kernel as it was before the
schedules: zero values mean "today's choice". Axes that would regroup
floating-point sums exist as declared fields but are left out of the
sweep's candidates, and the sweep hard-rejects any candidate whose output
is not bitwise equal to the default's.

Winners are cached per ``(op, dtype, head_dim_or_row, device_kind)`` in a
:class:`GeometryCache`: schedules are specific to a hardware generation, so
one artifact serves a mixed fleet. The cache persists inside
``TunedProfile`` (schema v3) with its own fingerprint; a hand-edited cache
fails at load. ``install_geometry_cache`` pins a process-wide cache;
``GenerationServer`` installs its profile's in its constructor, resolves
its ops' schedules there once, and records them in its snapshot
fingerprint.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Mapping, Optional, Tuple

#: the most shared memory one block may take on Hopper (sm_90: 227 KB)
HOPPER_SMEM_LIMIT = 232448
#: the fused LoRA kernel's largest rank (csrc/fused_lora.cu)
LORA_MAX_RANK = 64
#: the deepest paged-attention ring asked for (paged_attention.cu)
PA_MAX_DEPTH = 4
#: the queue item that ports the schedules the CUDA kernels do not take
A9C = "ROADMAP A9c"

#: int8 dequant placements for the paged-attention kernel. Both apply
#: the k/v scales in the reference order (bit-exact); they differ only
#: in WHERE the exact int8->fp cast of the streamed KV tile sits:
#: "scores" casts inside the causal-skip branch (today's schedule,
#: skipped blocks never cast), "early" hoists the cast to the top of
#: the grid step (branchless stream — the tile is cast as soon as its
#: DMA lands, trading wasted casts on skipped blocks for a shorter
#: critical path into the QK matmul).
PA_DEQUANT_MODES = ("scores", "early")

#: paged-attention grid iteration orders over the two parallel axes:
#: "bgm" = (batch, kv_head, kv_block) — today's order; "gbm" swaps the
#: batch and kv-head axes (same cells, different walk — changes which
#: pool blocks are DMA-adjacent).
PA_GRID_ORDERS = ("bgm", "gbm")

#: fused-LoRA accumulation layouts: which matmul chain issues first.
#: The final combine is ``y + d * s`` either way (bit-exact);
#: "delta_first" starts the low-rank chain before the base projection
#: so the small matmuls hide under the big one's MXU occupancy.
LORA_ACCUM_LAYOUTS = ("base_first", "delta_first")


def _largest_divisor(n: int, want: int) -> int:
    """Largest divisor of ``n`` that is <= ``want`` (>= 1). Geometry
    values quantize onto real shapes through this — a requested tile
    that doesn't divide the axis degrades deterministically instead of
    erroring, same spirit as flash's ``_pick_block``."""
    want = max(1, min(int(want), int(n)))
    for c in range(want, 0, -1):
        if n % c == 0:
            return c
    return 1


@dataclasses.dataclass(frozen=True)
class PagedAttentionGeometry:
    """Schedule of the paged decode/verify/prefill attention kernel, fp
    and int8: the fields as the JAX package's Pallas kernel
    (``paddle_tpu/ops/paged_attention_pallas.py``) reads them; the CUDA
    kernel's meaning of each is in the module docstring.

    ``kv_block_depth``: KV-pool blocks streamed per grid step. 1 =
    today's one-block-per-step schedule; d > 1 fetches d table-routed
    blocks into VMEM per step (d block specs) and applies the online-
    softmax update to each IN ORDER inside the step — same math, same
    order, fewer grid steps, deeper DMA pipelining. Clamped to a
    divisor of the table width at trace time.

    ``q_rows``: q-row tile. 0 = the whole W*rep GQA row group per
    program (today); > 0 tiles the rows across an extra parallel grid
    axis (rows are independent in attention — bit-exact). Clamped to a
    divisor of W*rep.

    ``grid_order``: iteration order of the parallel axes, one of
    :data:`PA_GRID_ORDERS`.

    ``dequant``: int8 cast placement, one of :data:`PA_DEQUANT_MODES`;
    dead (canonicalized to "scores") for fp pools.
    """

    kv_block_depth: int = 1
    q_rows: int = 0
    grid_order: str = "bgm"
    dequant: str = "scores"

    def validate(self) -> None:
        if not 1 <= self.kv_block_depth <= 8:
            raise ValueError("kv_block_depth must be in [1, 8], got "
                             f"{self.kv_block_depth}")
        if self.q_rows < 0:
            raise ValueError(f"q_rows must be >= 0, got {self.q_rows}")
        if self.grid_order not in PA_GRID_ORDERS:
            raise ValueError(f"grid_order must be one of {PA_GRID_ORDERS}, "
                             f"got {self.grid_order!r}")
        if self.dequant not in PA_DEQUANT_MODES:
            raise ValueError(f"dequant must be one of {PA_DEQUANT_MODES}, "
                             f"got {self.dequant!r}")

    def vmem_bytes(self, *, head_dim: int, block_size: int, window: int,
                   rep: int, dtype_bytes: int = 4,
                   quantized: bool = False) -> int:
        """Worst-case VMEM residency of one grid step: the q tile, the
        streamed KV tiles (+ scales), and the online-softmax scratch."""
        rows = window * rep if self.q_rows == 0 \
            else min(self.q_rows, window * rep)
        d = self.kv_block_depth
        kv_item = 1 if quantized else dtype_bytes
        n = rows * head_dim * dtype_bytes                  # q tile
        n += d * 2 * block_size * head_dim * kv_item       # k/v tiles
        if quantized:
            n += d * 2 * 4                                 # per-block scales
            if self.dequant == "early":
                # hoisted casts keep fp twins of the tiles live
                n += d * 2 * block_size * head_dim * dtype_bytes
        n += rows * (2 * 128 + head_dim) * 4               # m/l/acc scratch
        return n

    def smem_bytes(self, *, quantized: bool = False) -> int:
        """Shared memory of one block of the CUDA kernel under this
        schedule: ``paged_tiles::layout`` (the Q tile; int8: the widened
        bf16 pair; the ring of 64-key stages, ``kv_block_depth`` times the
        default's; the scales; the barriers; the base's alignment)."""
        tile = 64 * 128 * 2
        codes = 64 * 128
        stages = (3 if quantized else 2) * self.kv_block_depth
        conv = 2 * tile if quantized else 0
        stage = 2 * codes if quantized else 2 * tile
        scales = 2 * 64 * 4 if quantized else 0
        return tile + conv + stages * (stage + scales + 16) + 1024

    def hopper_errors(self, *, quantized: bool = False) -> list:
        """Why the CUDA kernel cannot run this schedule; empty when it
        can. ``q_rows`` and ``dequant`` raise apart (:func:`check_served`)."""
        errs = []
        if self.kv_block_depth > PA_MAX_DEPTH:
            errs.append(f"kv_block_depth={self.kv_block_depth} over the "
                        f"kernel's {PA_MAX_DEPTH}")
        elif self.smem_bytes(quantized=quantized) > HOPPER_SMEM_LIMIT:
            errs.append(
                f"kv_block_depth={self.kv_block_depth} needs "
                f"{self.smem_bytes(quantized=quantized)} bytes of shared "
                f"memory a block, over the {HOPPER_SMEM_LIMIT} a Hopper "
                f"block may take")
        return errs

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class LoRAGeometry:
    """Schedule of the fused base+LoRA projection
    (ops/paged_attention_pallas.fused_lora_matmul).

    ``rank_pad``: pad the adapter rank dim up to a multiple of this
    before the kernel (0 = no padding, today's layout). Zero columns
    of A / zero rows of B contribute exact zeros to the low-rank
    chain — bit-exact — while aligning the contraction to the MXU's
    native tiling.

    ``accum``: matmul issue order, one of :data:`LORA_ACCUM_LAYOUTS`.
    """

    rank_pad: int = 0
    accum: str = "base_first"

    def validate(self) -> None:
        if self.rank_pad < 0 or self.rank_pad > 1024:
            raise ValueError("rank_pad must be in [0, 1024], got "
                             f"{self.rank_pad}")
        if self.accum not in LORA_ACCUM_LAYOUTS:
            raise ValueError(f"accum must be one of {LORA_ACCUM_LAYOUTS}, "
                             f"got {self.accum!r}")

    def padded_rank(self, rank: int) -> int:
        if self.rank_pad <= 0 or rank % self.rank_pad == 0:
            return rank
        return -(-rank // self.rank_pad) * self.rank_pad

    def vmem_bytes(self, *, seq: int, in_dim: int, out_dim: int, rank: int,
                   dtype_bytes: int = 4) -> int:
        rp = self.padded_rank(rank)
        n = seq * in_dim * dtype_bytes          # x row
        n += in_dim * out_dim * dtype_bytes     # base weight
        n += (in_dim * rp + rp * out_dim) * 4   # A/B factors (f32)
        n += 2 * seq * out_dim * 4              # y + delta accumulators
        return n

    def hopper_errors(self, *, rank: int) -> list:
        """The Hopper model: the fused kernel's shared memory is static
        (its x and A chunks; the rank is taken 8 columns a grid slice), so
        what bounds a padding is the kernel's largest rank,
        ``LORA_MAX_RANK``."""
        rp = self.padded_rank(rank)
        if rp > LORA_MAX_RANK:
            return [f"rank_pad={self.rank_pad} pads rank {rank} to {rp}, "
                    f"over the fused kernel's {LORA_MAX_RANK}"]
        return []

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FlashAttentionGeometry:
    """Schedule of the flash attention kernels
    (ops/flash_attention.py). 0 = derive from the measured per-regime
    tables (``_block_defaults``) — today's behavior.

    ``block_q``: q-block rows. Rows are independent, so any block_q is
    mathematically identical — but bitwise equality additionally needs
    the backend's matmul to contract each row the same way at every
    tile shape (true of the MXU's fixed systolic order; host BLAS
    microkernels may regroup by tile). The sweep's bitwise gate decides
    empirically per chip: a block_q that regroups on this backend is
    parity-rejected and the default keeps the cell.

    ``block_kv``: kv-block width. CAUTION: this sets the online-softmax
    update granularity, so non-default values regroup the running
    max/sum accumulation — a schedule axis that is NOT parity-exact.
    It is declared here (and honored when set explicitly) but excluded
    from sweep candidates; the sweep's bitwise parity gate would reject
    any such candidate regardless.
    """

    block_q: int = 0
    block_kv: int = 0

    def validate(self) -> None:
        for name, v in (("block_q", self.block_q),
                        ("block_kv", self.block_kv)):
            if v < 0 or v > 4096:
                raise ValueError(f"{name} must be in [0, 4096], got {v}")
            if v and v % 8:
                raise ValueError(f"{name} must be sublane-aligned (8), "
                                 f"got {v}")

    def vmem_bytes(self, *, head_dim: int, seq_k: int,
                   dtype_bytes: int = 4) -> int:
        bq = self.block_q or 512
        bk = self.block_kv or 512
        n = bq * head_dim * dtype_bytes                 # q block
        n += 2 * min(bk, seq_k) * head_dim * dtype_bytes  # k/v blocks
        n += bq * (head_dim + 2) * 4                    # acc + m/l rows
        return n

    def hopper_errors(self) -> list:
        return []

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class NormGeometry:
    """Row tile of the fused RMS/Layer norm kernels
    (ops/fused_norm.py). ``rows`` = 0 derives today's
    ``max(min(512, rows), 8)``; > 0 requests that tile, clamped to a
    divisor of the flattened row count (rows are independent —
    bit-exact)."""

    rows: int = 0

    def validate(self) -> None:
        if self.rows < 0 or self.rows > 4096:
            raise ValueError(f"rows must be in [0, 4096], got {self.rows}")

    def vmem_bytes(self, *, width: int, dtype_bytes: int = 4) -> int:
        r = self.rows or 512
        return r * width * (dtype_bytes + 4) + width * dtype_bytes

    def hopper_errors(self) -> list:
        # the CUDA norms' shared memory (a block's warp sums) does not
        # depend on the rows a block: every value fits
        return []

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CEGeometry:
    """Row sub-tile of the fused linear-cross-entropy forward
    (ops/fused_ce.py). ``rows`` = 0 keeps today's whole-chunk logits
    transient; > 0 computes the row-local quantities (logits row,
    logsumexp, label gather) in ``rows``-row sub-tiles of each scan
    chunk, shrinking the [chunk, V] f32 transient to [rows, V]. The
    loss reduction stays at whole-chunk granularity — per-row values
    are identical and the summation grouping is untouched, so any
    sub-tile is bit-exact vs the default. Clamped to a divisor of the
    effective chunk."""

    rows: int = 0

    def validate(self) -> None:
        if self.rows < 0 or self.rows > 16384:
            raise ValueError(f"rows must be in [0, 16384], got {self.rows}")

    def vmem_bytes(self, *, hidden: int, vocab: int,
                   dtype_bytes: int = 4) -> int:
        r = self.rows or 1024
        return r * vocab * 4 + r * hidden * dtype_bytes

    def hopper_errors(self) -> list:
        # plain PyTorch: the sub-tile's logits live in device memory
        return []

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


#: op family -> geometry class; the op names are the cache/telemetry
#: vocabulary (``serving_kernel_geometry{op=...}``)
OP_GEOMETRY = {
    "paged_attention": PagedAttentionGeometry,
    "fused_lora": LoRAGeometry,
    "flash_attention": FlashAttentionGeometry,
    "fused_norm": NormGeometry,
    "fused_ce": CEGeometry,
}

OP_FAMILIES = tuple(sorted(OP_GEOMETRY))


def default_geometry(op: str):
    return OP_GEOMETRY[op]()


def geometry_from_dict(op: str, d: Mapping[str, Any]):
    cls = OP_GEOMETRY.get(op)
    if cls is None:
        raise ValueError(f"unknown geometry op {op!r} — must be one of "
                         f"{OP_FAMILIES}")
    known = {f.name for f in dataclasses.fields(cls)}
    extra = set(d) - known
    if extra:
        raise ValueError(f"unknown {op} geometry fields {sorted(extra)}")
    geom = cls(**dict(d))
    geom.validate()
    return geom


# ---------------------------------------------------------------- the cache
def local_device_kind() -> str:
    """The chip the process is on: ``torch.cuda.get_device_name()`` on
    the card (e.g. "NVIDIA H100 80GB HBM3"), else "cpu" (as JAX names its
    CPU); cache keys carry it so one artifact serves a mixed fleet."""
    import torch

    if torch.cuda.is_available():
        return str(torch.cuda.get_device_name())
    return "cpu"


def uses_hopper_model(device_kind: str) -> bool:
    """Whether candidates for ``device_kind`` are held to the Hopper
    shared-memory model (an NVIDIA card) rather than JAX's per-core VMEM
    model (``"cpu"`` and TPU kinds)."""
    return "nvidia" in str(device_kind).lower()


def check_served(op: str, geometry, *, quantized: bool = False,
                 rank: Optional[int] = None,
                 hopper: bool = False) -> None:
    """Raise on a schedule the port does not run: NotImplementedError
    naming ROADMAP A9c for the axes its kernels do not take yet (paged
    attention's ``q_rows`` and ``dequant``, flash attention's ``block_q``
    / ``block_kv``, fused LoRA's ``accum``), on any device; with ``hopper``, ValueError for
    a schedule whose kernel layout does not fit a Hopper SM."""
    bad = []
    if op == "paged_attention":
        bad += [f"{n}={getattr(geometry, n)!r}" for n in ("q_rows", "dequant")
                if getattr(geometry, n) != getattr(PagedAttentionGeometry(),
                                                   n)]
    elif op == "flash_attention":
        bad += [f"{n}={getattr(geometry, n)}" for n in ("block_q",
                                                        "block_kv")
                if getattr(geometry, n) != 0]
    elif op == "fused_lora" and geometry.accum != "base_first":
        bad.append(f"accum={geometry.accum!r}")
    if bad:
        raise NotImplementedError(
            f"{type(geometry).__name__} {', '.join(bad)} is not ported: the "
            f"CUDA kernel runs the default of this axis only ({A9C})")
    if not hopper:
        return
    if op == "paged_attention":
        errs = geometry.hopper_errors(quantized=quantized)
    elif op == "fused_lora":
        errs = geometry.hopper_errors(rank=rank) if rank else []
    else:
        errs = geometry.hopper_errors()
    if errs:
        raise ValueError(f"{op}: " + "; ".join(errs))


def _key_str(op: str, dtype: str, key: int, device_kind: str) -> str:
    for part in (op, dtype, device_kind):
        if "|" in part:
            raise ValueError(f"geometry cache key part {part!r} may not "
                             f"contain '|'")
    return f"{op}|{dtype}|{int(key)}|{device_kind}"


class GeometryCache:
    """Winner table keyed by ``(op, dtype, head_dim_or_row,
    device_kind)``. A miss — including an unknown chip — resolves to
    the op's default geometry at the caller, never to a guess from
    another key. Serialization carries a content fingerprint
    (sha256[:12] of the canonical entry JSON); :meth:`from_dict`
    recomputes it, so a tampered cache fails at load exactly like a
    tampered profile config."""

    def __init__(self, entries: Optional[Dict[str, Any]] = None):
        self._entries: Dict[str, Any] = {}
        if entries:
            for kstr, geom in entries.items():
                op = kstr.split("|", 1)[0]
                if not isinstance(geom, OP_GEOMETRY.get(op, ())):
                    raise ValueError(
                        f"entry {kstr!r} holds {type(geom).__name__}, "
                        f"expected {OP_GEOMETRY[op].__name__}")
                self._entries[kstr] = geom

    def __len__(self) -> int:
        return len(self._entries)

    def __eq__(self, other) -> bool:
        return (isinstance(other, GeometryCache)
                and self._entries == other._entries)

    def put(self, op: str, dtype: str, key: int, device_kind: str,
            geometry) -> None:
        if not isinstance(geometry, OP_GEOMETRY[op]):
            raise ValueError(
                f"{op} wants {OP_GEOMETRY[op].__name__}, got "
                f"{type(geometry).__name__}")
        geometry.validate()
        self._entries[_key_str(op, dtype, key, device_kind)] = geometry

    def lookup(self, op: str, dtype: str, key: int,
               device_kind: Optional[str] = None):
        """The cached winner, or None on any miss (op never swept,
        different dtype/shape, unknown chip) — the caller falls back to
        the op's default geometry."""
        if device_kind is None:
            device_kind = local_device_kind()
        return self._entries.get(_key_str(op, dtype, key, device_kind))

    def entries(self) -> Dict[str, Any]:
        return dict(self._entries)

    # ------------------------------------------------------------ (de)ser
    def _canonical_entries(self) -> Dict[str, dict]:
        return {k: self._entries[k].asdict() for k in sorted(self._entries)}

    def fingerprint(self) -> str:
        blob = json.dumps(self._canonical_entries(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def to_dict(self) -> Dict[str, Any]:
        return {"entries": self._canonical_entries(),
                "fingerprint": self.fingerprint()}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any],
                  verify: bool = True) -> "GeometryCache":
        entries = {}
        for kstr, gd in dict(d.get("entries", {})).items():
            parts = kstr.split("|")
            if len(parts) != 4:
                raise ValueError(f"malformed geometry cache key {kstr!r} "
                                 f"(want op|dtype|key|device_kind)")
            entries[kstr] = geometry_from_dict(parts[0], gd)
        cache = cls(entries)
        if verify:
            fp = cache.fingerprint()
            if fp != d.get("fingerprint"):
                raise ValueError(
                    f"geometry cache fingerprint mismatch: recorded "
                    f"{d.get('fingerprint')!r}, recomputed {fp!r} — the "
                    f"cache was edited after the sweep")
        return cache


# ------------------------------------------------------------ resolution
# Mirrors ops.set_kernel_mode: process-wide. A server resolves its ops'
# schedules from it once, in its constructor (after installing its
# profile's cache), and hands them to every pass (ops.kernel_geometry); an
# op called outside a server reads it at the call (ops.geometry_for).
GEOMETRY_SOURCES = ("default", "profile", "swept")

_ACTIVE_CACHE: Optional[GeometryCache] = None
_ACTIVE_SOURCE: str = "default"


def install_geometry_cache(cache: Optional[GeometryCache],
                           source: str = "swept") -> None:
    """Pin the process-wide winner cache (None resets to defaults).
    ``source`` labels telemetry: "profile" when a TunedProfile carried
    it, "swept" for a cache installed directly from a sweep artifact."""
    global _ACTIVE_CACHE, _ACTIVE_SOURCE
    if cache is not None and not isinstance(cache, GeometryCache):
        raise ValueError(f"expected a GeometryCache or None, got "
                         f"{type(cache).__name__}")
    if source not in GEOMETRY_SOURCES:
        raise ValueError(f"source must be one of {GEOMETRY_SOURCES}, "
                         f"got {source!r}")
    _ACTIVE_CACHE = cache
    _ACTIVE_SOURCE = "default" if cache is None else source


def active_geometry_cache() -> Optional[GeometryCache]:
    return _ACTIVE_CACHE


def active_geometry_source() -> str:
    return _ACTIVE_SOURCE


def resolve_geometry(op: str, dtype: str, key: int,
                     device_kind: Optional[str] = None) -> Tuple[Any, str]:
    """(geometry, source) for one op: the active cache's
    winner when present, else the op's default. Never raises on a miss
    — an unknown chip degrades to the default schedule."""
    if _ACTIVE_CACHE is not None:
        hit = _ACTIVE_CACHE.lookup(op, str(dtype), int(key), device_kind)
        if hit is not None:
            return hit, _ACTIVE_SOURCE
    return default_geometry(op), "default"


def resolve_server_geometries(*, head_dim: int, hidden: int, dtype: str,
                              kv_quant: str, lora_rank: Optional[int] = None,
                              device_kind: Optional[str] = None
                              ) -> Dict[str, Tuple[Any, str]]:
    """The per-op resolution a GenerationServer performs at
    construction — the per-layer twin of the megakernel's
    ``mk_geometry`` resolution. Keys follow the cache convention:
    head_dim for the attention ops, the adapter rank for fused LoRA,
    the hidden width for the row-tiled fused ops; the paged-attention
    dtype is "int8" under KV quantization (the int8 kernel is a
    different schedule space than the fp one)."""
    pa_dtype = "int8" if kv_quant == "int8" else dtype
    out = {
        "paged_attention": resolve_geometry(
            "paged_attention", pa_dtype, head_dim, device_kind),
        "flash_attention": resolve_geometry(
            "flash_attention", dtype, head_dim, device_kind),
        "fused_norm": resolve_geometry(
            "fused_norm", dtype, hidden, device_kind),
        "fused_ce": resolve_geometry(
            "fused_ce", dtype, hidden, device_kind),
    }
    if lora_rank is not None:
        out["fused_lora"] = resolve_geometry(
            "fused_lora", dtype, lora_rank, device_kind)
    return out


# ------------------------------------------------------ sweep candidates
def _hopper_candidates(op: str, *, quantized: bool, **shape) -> list:
    """The candidates the card sweeps: the JAX axes less the ones that wait
    for ROADMAP A9c (``q_rows``, ``dequant``, ``block_q`` / ``block_kv``,
    ``accum``), kept where the kernel's layout fits a Hopper SM."""
    cands: list = []
    if op == "paged_attention":
        for depth in (1, 2, 4):
            for order in PA_GRID_ORDERS:
                g = PagedAttentionGeometry(kv_block_depth=depth,
                                           grid_order=order)
                if not g.hopper_errors(quantized=quantized):
                    cands.append(g)
    elif op == "fused_lora":
        for pad in (0, 8, 16, 128):
            g = LoRAGeometry(rank_pad=pad)
            if not g.hopper_errors(rank=int(shape.get("rank", 8))):
                cands.append(g)
    elif op == "flash_attention":
        cands.append(FlashAttentionGeometry())
    elif op == "fused_norm":
        for rows in (0, 8, 64, 256, 512):
            cands.append(NormGeometry(rows=rows))
    elif op == "fused_ce":
        for rows in (0, 64, 128, 256, 512):
            cands.append(CEGeometry(rows=rows))
    else:
        raise ValueError(f"unknown geometry op {op!r}")
    return cands


def geometry_candidates(op: str, *, quantized: bool = False,
                        vmem_limit_bytes: Optional[int] = None,
                        device_kind: Optional[str] = None,
                        **shape) -> list:
    """The deterministic candidate rung for one op family: a canonical
    enumeration of the bit-exact schedule axes, deduped after
    canonicalization (fp pins the dead dequant knob), filtered by the
    occupancy model of ``device_kind`` (the local one when None): JAX's
    VMEM model against the per-core budget for ``"cpu"`` and TPU kinds,
    the kernels' shared memory against a Hopper SM for an NVIDIA kind
    (:func:`_hopper_candidates`). Ordered so index 0 is always the default
    geometry — ties in the sweep resolve toward it."""
    if device_kind is None:
        device_kind = local_device_kind()
    if uses_hopper_model(device_kind):
        cands = _hopper_candidates(op, quantized=quantized, **shape)
        default = default_geometry(op)
        rest = sorted((g for g in cands if g != default),
                      key=lambda g: json.dumps(g.asdict(), sort_keys=True))
        return [default] + rest
    if vmem_limit_bytes is None:
        from .space import MK_VMEM_LIMIT_BYTES

        vmem_limit_bytes = MK_VMEM_LIMIT_BYTES
    cands: list = []
    if op == "paged_attention":
        for depth in (1, 2, 4):
            for q_rows in (0, 8, 16):
                for order in PA_GRID_ORDERS:
                    for deq in (PA_DEQUANT_MODES if quantized
                                else ("scores",)):
                        cands.append(PagedAttentionGeometry(
                            kv_block_depth=depth, q_rows=q_rows,
                            grid_order=order, dequant=deq))
        cands = [g for g in cands if g.vmem_bytes(
            head_dim=shape.get("head_dim", 128),
            block_size=shape.get("block_size", 16),
            window=shape.get("window", 4),
            rep=shape.get("rep", 4),
            quantized=quantized) <= vmem_limit_bytes]
    elif op == "fused_lora":
        for pad in (0, 8, 16, 128):
            for accum in LORA_ACCUM_LAYOUTS:
                cands.append(LoRAGeometry(rank_pad=pad, accum=accum))
        cands = [g for g in cands if g.vmem_bytes(
            seq=shape.get("seq", 1),
            in_dim=shape.get("in_dim", 1024),
            out_dim=shape.get("out_dim", 1024),
            rank=shape.get("rank", 8)) <= vmem_limit_bytes]
    elif op == "flash_attention":
        # block_kv stays at the regime default: it regroups the online
        # softmax (not parity-exact) — see FlashAttentionGeometry
        for bq in (0, 128, 256, 512):
            cands.append(FlashAttentionGeometry(block_q=bq))
        cands = [g for g in cands if g.vmem_bytes(
            head_dim=shape.get("head_dim", 128),
            seq_k=shape.get("seq_k", 2048)) <= vmem_limit_bytes]
    elif op == "fused_norm":
        for rows in (0, 8, 64, 256, 512):
            cands.append(NormGeometry(rows=rows))
    elif op == "fused_ce":
        for rows in (0, 64, 128, 256, 512):
            cands.append(CEGeometry(rows=rows))
    else:
        raise ValueError(f"unknown geometry op {op!r}")
    default = default_geometry(op)
    rest = sorted((g for g in cands if g != default),
                  key=lambda g: json.dumps(g.asdict(), sort_keys=True))
    return [default] + rest
