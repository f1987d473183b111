"""Whole-tick decode megakernel — port of ``paddle_tpu/ops/decode_megakernel.py``.

Every decoder layer of one decode (W = 1) or speculative-verify (W > 1) tick
runs as ONE launch of a persistent CUDA kernel (``csrc/decode_megakernel.cu``,
wrapper :func:`~.decode_megakernel_cuda.decode_tick_cuda`): RMSNorm, the
q/k/v products, RoPE, the window's K/V written through the block table,
paged attention, the o product and residual, RMSNorm, SiLU(g)·u and the
down product and residual, layer after layer, with grid-wide barriers in
place of the JAX kernel's single program and hand-rolled HBM→VMEM streams.
The final norm, the lm-head and sampling stay outside, as in the JAX
executor.

Both variants of the JAX kernel are served: fp or int8 KV pools (the int8
pool's window tokens inserted by in-kernel whole-block requantization, its
scales applied in the ``dequant`` mode's order), each with or without
multi-tenant LoRA deltas read in place from the adapter pool's pages
(:func:`lora_tables`).

:func:`decode_tick` launches the kernel for CUDA tensors and runs its plain
twin :func:`_tick_plain` — the port's plain per-layer functions composed in
the kernel's order, rounding where the kernel rounds — for CPU tensors or
under ``set_kernel_mode("reference")``. It writes the pools in place.

Weights are not copied: :class:`LayerWeights` keeps the model's own
per-layer tensors and, on the card, a device table of their pointers (the
JAX package stacks every projection into new ``(L, in, out)`` arrays, which
doubles the served weights). The geometry knobs are all served:
``prefetch_depth`` sets the producer's ring (6 stages a unit of depth),
``ffn_tile`` the down projection's K slice (fp32 partials over
``ffn_tile``-wide slices of the intermediate dim, as in the JAX kernel),
``dequant`` the int8 scales' placement.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..nn.lora import PooledFactors, bgmv
from .fused_norm import _rms_ref
from .paged_attention import (_attention_core, gather_block_kv,
                              gather_block_scales, write_window_kv,
                              write_window_kv_q)

# the CUDA kernel's shape rules (csrc/decode_megakernel.cu): head dim,
# hidden and intermediate sizes multiples of K_STEP (its weight tiles are
# K_STEP rows by 64 columns), the adapter pool's max_rank <= MAX_LORA_RANK,
# an int8 pool's block size <= MAX_INT8_BLOCK (a block-head is requantized
# in shared memory)
from .decode_megakernel_cuda import (HEAD_DIM, K_STEP, MAX_INT8_BLOCK,
                                     MAX_LORA_RANK, MAX_ROWS)

DEQUANT_MODES = ("scores", "tile")


#: the whole-tick kernel's shared memory (csrc/tick_plan.cuh): weight
#: stages of 8 KB, the x slab's union, the LoRA rows and the misc block,
#: the 1024-byte alignment room, and the most a Hopper block may take
MK_UNIT_BYTES = 64 * 64 * 2
MK_UNION_BYTES = 112 * 1024
MK_LT_BYTES = 2 * MAX_ROWS * MAX_LORA_RANK * 2 * 4
MK_MISC_BYTES = 2048 + 1024
HOPPER_SMEM_LIMIT = 232448
#: ring stages a unit of ``prefetch_depth``: 12 at the default depth 2
MK_STAGES_PER_DEPTH = 6


def _row_tile(rows: int) -> int:
    """tick_plan::row_tile: the wgmma N that holds ``rows`` rows."""
    return 8 if rows <= 8 else 16 if rows <= 16 else 32 if rows <= 32 \
        else 64


@dataclasses.dataclass(frozen=True)
class MegakernelGeometry:
    """The JAX kernel's tunable schedule (``ffn_tile``, ``prefetch_depth``,
    ``dequant``; see ``paddle_tpu.ops.decode_megakernel``), with its Hopper
    meaning in the CUDA kernel:

    ``ffn_tile``: 0 keeps the down projection's K slices of the work plan
    (the fewest that fit the x slab at 64 rows); > 0 cuts its K
    (the intermediate dim) into ``ffn_tile``-wide slices, each summed in
    fp32 and the slices summed in a fixed order, whatever the rows (not
    reference-exact, as in JAX; not combinable with LoRA). A multiple of
    64 that divides the intermediate size.

    ``prefetch_depth``: the producer's ring, ``MK_STAGES_PER_DEPTH`` stages
    of one 8 KB weight tile a unit of depth (12 at the default 2). A
    schedule change only: the tokens are the default's bit for bit.

    ``dequant`` places the int8 KV scales: ``"scores"`` multiplies the
    fp32 QK sums by the k-scale and the probabilities by the v-scale,
    ``"tile"`` dequantizes each K/V tile to the activations' dtype before
    the products; it has no effect on fp pools."""

    ffn_tile: int = 0
    prefetch_depth: int = 2
    dequant: str = "scores"

    def validate(self) -> None:
        if self.ffn_tile < 0:
            raise ValueError(f"ffn_tile must be >= 0, got {self.ffn_tile}")
        if not 1 <= self.prefetch_depth <= 8:
            raise ValueError("prefetch_depth must be in [1, 8], got "
                             f"{self.prefetch_depth}")
        if self.dequant not in DEQUANT_MODES:
            raise ValueError(f"dequant must be one of {DEQUANT_MODES}, "
                             f"got {self.dequant!r}")

    def vmem_bytes(self, *, hidden: int, heads: int, kv_heads: int,
                   head_dim: int, intermediate: int, layers: int,
                   batch: int, window: int, block_size: int,
                   dtype_bytes: int = 4, quantized: bool = False) -> int:
        """The JAX package's worst-case VMEM residency of a TPU core (the
        autotuner's occupancy model for ``"cpu"`` and TPU kinds), term for
        term."""
        BW = batch * window
        Hq = heads * head_dim
        KVD = kv_heads * head_dim
        T = self.ffn_tile or intermediate
        d = self.prefetch_depth
        rep = max(heads // max(kv_heads, 1), 1)
        rows = kv_heads * window * rep
        n = 0
        n += BW * hidden * dtype_bytes + 2 * BW * (head_dim // 2) * 4
        n += 2 * layers * hidden * dtype_bytes
        n += BW * (2 * hidden + 2 * Hq + 2 * KVD) * dtype_bytes
        n += BW * hidden * 4
        n += d * (hidden * Hq + 2 * hidden * KVD + Hq * hidden
                  + 2 * hidden * T + T * hidden) * dtype_bytes
        kv_item = 1 if quantized else dtype_bytes
        n += 2 * 2 * block_size * kv_heads * head_dim * kv_item
        n += 2 * kv_heads * head_dim * dtype_bytes
        if quantized:
            n += 2 * 2 * kv_heads * 4
            n += block_size * kv_heads * head_dim + kv_heads * 4
        n += rows * (2 * 128 + head_dim) * 4
        return n

    def ring_stages(self) -> int:
        return MK_STAGES_PER_DEPTH * self.prefetch_depth

    def smem_bytes(self) -> int:
        """Shared memory of one block of the CUDA kernel at this depth
        (tick_plan.cuh's layout with this ring): the Hopper counterpart of
        :meth:`vmem_bytes`. The kernel allocates the layout of the deepest
        ring that fits (12 stages) and runs ``ring_stages()`` of it."""
        return (self.ring_stages() * MK_UNIT_BYTES + MK_UNION_BYTES
                + MK_LT_BYTES + MK_MISC_BYTES)

    def ffn_steps(self) -> int:
        """K steps (64 rows) of the down projection's slices; 0 = the
        plan's own."""
        return self.ffn_tile // K_STEP

    def hopper_errors(self, *, intermediate: int, rows: int) -> list:
        """Why the CUDA kernel cannot take this geometry at ``rows`` rows a
        tick (the batch times the window) and this intermediate size; empty
        when it can."""
        errs = []
        if self.smem_bytes() > HOPPER_SMEM_LIMIT:
            errs.append(
                f"prefetch_depth={self.prefetch_depth} needs "
                f"{self.ring_stages()} ring stages: {self.smem_bytes()} "
                f"bytes of shared memory a block, over the "
                f"{HOPPER_SMEM_LIMIT} a Hopper block may take")
        if self.ffn_tile:
            if self.ffn_tile % K_STEP:
                errs.append(f"ffn_tile={self.ffn_tile} is not a multiple "
                            f"of the kernel's K step {K_STEP}")
            elif intermediate % self.ffn_tile:
                errs.append(f"ffn_tile={self.ffn_tile} does not divide "
                            f"intermediate_size={intermediate}")
            else:
                nr = _row_tile(max(1, min(int(rows), MAX_ROWS)))
                slab = MK_UNION_BYTES // (nr * 128)
                if self.ffn_steps() > slab:
                    errs.append(
                        f"ffn_tile={self.ffn_tile} is {self.ffn_steps()} K "
                        f"steps a slice, over the {slab} the x slab holds "
                        f"at {rows} rows a tick")
        return errs

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def check_geometry(geometry: MegakernelGeometry, *, intermediate: int,
                   rows: int) -> None:
    """Raise ValueError on a geometry the CUDA kernel cannot take at these
    shapes (:meth:`MegakernelGeometry.hopper_errors`): it is refused where
    it is resolved, never mid-launch."""
    errs = geometry.hopper_errors(intermediate=intermediate, rows=rows)
    if errs:
        raise ValueError("MegakernelGeometry: " + "; ".join(errs))


def cuda_shape_reason(cfg, block_size: int, *, kv_quant: str = "none",
                      lora_rank: int = 0) -> Optional[str]:
    """The CUDA kernel's shape and type rules (the counterpart of the JAX
    kernel's Mosaic alignment guard); None when it takes ``cfg``.
    ``kv_quant``: the pools' format; ``lora_rank``: the adapter pool's
    ``max_rank`` (0 without LoRA)."""
    D = cfg.hidden_size // cfg.num_attention_heads
    if D != HEAD_DIM:
        return f"head_dim {D} != {HEAD_DIM} (the CUDA kernel's only head dim)"
    if cfg.torch_dtype != torch.bfloat16:
        return f"dtype {cfg.dtype}: the CUDA kernel takes bfloat16 weights"
    if block_size % 8:
        return f"block_size {block_size} not a multiple of 8"
    for name, dim in (("hidden", cfg.hidden_size),
                      ("intermediate", cfg.intermediate_size)):
        if dim % K_STEP:
            return f"{name} dim {dim} not a multiple of {K_STEP}"
    if kv_quant == "int8" and block_size > MAX_INT8_BLOCK:
        return f"block_size {block_size} over {MAX_INT8_BLOCK}: the int8 " \
               "variant requantizes a block-head in shared memory"
    if lora_rank > MAX_LORA_RANK:
        return f"LoRA max_rank {lora_rank} over {MAX_LORA_RANK}, the " \
               "largest rank the CUDA kernel stages"
    return None


def megakernel_supported(model, cfg, *, tp: int = 1, cp: int = 1,
                         block_size: int = 16,
                         geometry: Optional[MegakernelGeometry] = None,
                         lora: bool = False, kv_quant: str = "none",
                         lora_rank: int = 0,
                         rows: int = 1) -> Optional[str]:
    """Structural and shape guard of the whole-tick kernel, checked at
    executor construction: None when the megakernel can serve this model,
    else the reason — the JAX package's reasons, word for word, then the
    rows a tick (``rows`` = B·W: the batch times the window, k+1 on a
    speculative server) against the kernel's ``MAX_ROWS``, on any device,
    then the CUDA kernel's rules (:func:`cuda_shape_reason`, given
    ``kv_quant`` and the adapter pool's ``lora_rank``) for a model on the
    card (the CPU twin takes any shape, as the JAX kernel's interpret mode
    does). The port raises on a reason instead of falling back (the JAX
    executor falls back to the per-layer programs where the kernel's
    trace raises)."""
    from ..models.llama import Linear

    geometry = geometry or MegakernelGeometry()
    geometry.validate()
    if tp > 1 or cp > 1:
        return f"multi-chip serving (tp={tp}, cp={cp}) keeps the " \
               "per-layer programs — GSPMD shards those"
    if getattr(cfg, "moe_num_experts", 0) > 0:
        return "MoE FFN layers route per token; the megakernel streams " \
               "dense gate/up/down weights"
    try:
        layers = model.model.layers
    except AttributeError:
        return "model is not LlamaForCausalLM-shaped"
    # (the JAX guard first rejects the fused int8 q/k/v weight, an option
    # the port does not have; an int8 model fails the Linear checks below)
    for i, layer in enumerate(layers):
        attn = layer.self_attn
        mlp = layer.mlp
        for pname in ("gate_proj", "up_proj", "down_proj"):
            if type(getattr(mlp, pname, None)) is not Linear:
                return f"layer {i}: {pname} is not a plain Linear " \
                       "(weight-only int8 or LoRA-wrapped MLP)"
        for pname in ("q_proj", "k_proj", "v_proj", "o_proj"):
            if type(getattr(attn, pname, None)) is not Linear:
                return f"layer {i}: {pname} is not a plain Linear"
    I = cfg.intermediate_size
    if geometry.ffn_tile:
        if I % geometry.ffn_tile != 0:
            return f"ffn_tile {geometry.ffn_tile} does not divide " \
                   f"intermediate_size {I}"
        if lora:
            return "ffn_tile > 0 is incompatible with pooled LoRA (the " \
                   "gate/up/down delta needs the full intermediate dim)"
    D = cfg.hidden_size // cfg.num_attention_heads
    if D * cfg.num_attention_heads != cfg.hidden_size:
        return "hidden_size is not num_attention_heads * head_dim"
    if D % 2:
        return f"head_dim {D} is odd — rope splits it in half"
    if rows > MAX_ROWS:
        return f"{rows} rows a tick (batch x window): the kernel takes " \
               f"B·W <= MAX_ROWS = {MAX_ROWS}"
    if getattr(model, "device", torch.device("cpu")).type == "cuda":
        return cuda_shape_reason(cfg, block_size, kv_quant=kv_quant,
                                 lora_rank=lora_rank if lora else 0)
    return None


# ------------------------------------------------------- the layer weights
class LayerWeights:
    """The per-layer weights the tick reads, without a second copy: for each
    of ``NAMES`` the list of the model's own L tensors and, for a model on
    the card, ``ptrs``: an int64 (9, L) device table of their addresses (the
    kernel's argument). Built once at executor construction;
    :meth:`check` raises when the model's weights were replaced since. The
    CUDA wrapper keeps the kernel's TMA maps of the weights in ``maps``,
    encoded at its first launch."""

    NAMES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "ln1", "ln2")

    def __init__(self, model):
        layers = model.model.layers
        get = {
            "wq": lambda l: l.self_attn.q_proj.weight,
            "wk": lambda l: l.self_attn.k_proj.weight,
            "wv": lambda l: l.self_attn.v_proj.weight,
            "wo": lambda l: l.self_attn.o_proj.weight,
            "wg": lambda l: l.mlp.gate_proj.weight,
            "wu": lambda l: l.mlp.up_proj.weight,
            "wd": lambda l: l.mlp.down_proj.weight,
            "ln1": lambda l: l.input_layernorm.weight,
            "ln2": lambda l: l.post_attention_layernorm.weight,
        }
        self._get = get
        self.tensors = {n: [get[n](layer) for layer in layers]
                        for n in self.NAMES}
        self._addrs = [[t.data_ptr() for t in self.tensors[n]]
                       for n in self.NAMES]
        self.ptrs = None
        self.maps = None
        dev = self.tensors["wq"][0].device
        if dev.type == "cuda":
            for n in self.NAMES:
                for t in self.tensors[n]:
                    if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                            or t.data_ptr() % 16:
                        raise ValueError(
                            f"stack_layer_weights: {n} must be contiguous, "
                            f"16-byte aligned bfloat16, got {t.dtype}")
            self.ptrs = torch.tensor(self._addrs, dtype=torch.int64,
                                     device=dev)

    def addresses(self):
        """The (9, L) addresses of ``NAMES``' tensors, as lists."""
        return self._addrs

    @property
    def num_layers(self) -> int:
        return len(self.tensors["wq"])

    def __getitem__(self, name):
        return self.tensors[name]

    def check(self, model) -> None:
        """Raise when a weight of ``model`` is no longer the tensor (or the
        storage) the table was built from: the kernel would read freed or
        stale memory."""
        layers = model.model.layers
        if len(layers) != self.num_layers:
            raise RuntimeError("the model's layers changed since the "
                               "megakernel's weight table was built")
        for n, addrs in zip(self.NAMES, self._addrs):
            for layer, t, a in zip(layers, self.tensors[n], addrs):
                try:
                    cur = self._get[n](layer)
                except AttributeError:
                    cur = None
                if cur is not t or t.data_ptr() != a:
                    raise RuntimeError(
                        f"the model's {n} weights were replaced after the "
                        f"megakernel's weight table was built: build a new "
                        f"server for the changed model")


def stack_layer_weights(model) -> LayerWeights:
    """The weight tables of :func:`decode_tick` — pointers to the model's
    own tensors, not stacked copies (see :class:`LayerWeights`)."""
    return LayerWeights(model)


def gather_rope_rows(cos, sin, pos, W: int):
    """The (B, W, D/2) rope rows at window positions
    ``clip(pos + arange(W), 0, len - 1)`` — layer-invariant, so gathered
    once a tick outside the kernel (the clamp is a no-op for in-range
    decode positions)."""
    idx = torch.clamp(pos.long()[:, None]
                      + torch.arange(W, device=pos.device)[None, :],
                      0, cos.shape[0] - 1)
    return cos[idx], sin[idx]


# -------------------------------------------------------- HBM accounting
def hbm_bytes_per_trip(cfg, *, batch: int, window: int, block_size: int,
                       avg_ctx_blocks: int, kv_quant: str = "none",
                       megakernel: bool = True,
                       dtype_bytes: int = 4) -> int:
    """Per-trip device-memory byte estimate: weight stream (all layers once)
    + KV block reads/writes + (per-layer path only) the 2L residual-stream
    round trips the megakernel eliminates. The JAX package's arithmetic."""
    L = cfg.num_hidden_layers
    Hd = cfg.hidden_size
    D = Hd // cfg.num_attention_heads
    Hq = cfg.num_attention_heads * D
    KVD = cfg.num_key_value_heads * D
    I = cfg.intermediate_size
    BW = batch * window
    w = L * (Hd * Hq + 2 * Hd * KVD + Hq * Hd + 3 * Hd * I) * dtype_bytes
    kv_item = 1 if kv_quant == "int8" else dtype_bytes
    blk = block_size * cfg.num_key_value_heads * D * kv_item
    if kv_quant == "int8":
        blk += cfg.num_key_value_heads * 4
    kv = L * batch * (2 * avg_ctx_blocks * blk          # context reads
                      + 2 * window * (2 if kv_quant == "int8" else 1) * blk)
    n = w + kv
    if not megakernel:
        n += 2 * L * BW * Hd * dtype_bytes              # residual round trips
    return int(n)


# ------------------------------------------------------------ LoRA tables
@dataclasses.dataclass(frozen=True)
class LoraTables:
    """The adapter pool's pages as the tick reads them, in place — the
    counterpart of the JAX package's ``stack_lora`` (which gathers per-row
    copies): ``factors`` maps each configured target to the pool's ``A``
    (pages, L, in, R) and ``B`` (pages, L, R, out) f32 tensors, ``scale``
    (pages,) f32 holds alpha/r, ``aidx`` int32 (B,) the page of each row
    and ``max_rank`` the pool's R. Page 0 is the null adapter: zero
    factors, scale 0."""

    factors: dict
    scale: torch.Tensor
    aidx: torch.Tensor
    max_rank: int

    def pooled(self, layer: int, target: str) -> Optional[PooledFactors]:
        """``target``'s factors at ``layer`` for the rows (None when the
        pool does not serve the target)."""
        ab = self.factors.get(target)
        if ab is None:
            return None
        return PooledFactors(ab[0], ab[1], self.scale, layer, self.aidx)


def lora_tables(pool, aidx) -> LoraTables:
    """:class:`LoraTables` of an :class:`~..inference.lora.AdapterPool` at
    the rows' pages ``aidx`` (int32 (B,)); nothing is copied."""
    return LoraTables(dict(pool._tensors), pool._scale, aidx, pool.max_rank)


# ------------------------------------------------------------ the tick
def _down_sliced(h, wd, ffn_tile: int):
    """The down product with ``ffn_tile``-wide K slices: each slice's
    product in fp32, the slices summed in order in fp32, rounded once to
    h's dtype (``MegakernelGeometry.ffn_tile``)."""
    acc = None
    for k0 in range(0, h.shape[-1], ffn_tile):
        part = torch.matmul(h[..., k0:k0 + ffn_tile].float(),
                            wd[k0:k0 + ffn_tile].float())
        acc = part if acc is None else acc + part
    return acc.to(h.dtype)


def _tick_plain(x, pools, tables, pos, weights, cos_rows, sin_rows, *,
                eps: float, dequant: str = "scores",
                lora: Optional[LoraTables] = None, ffn_tile: int = 0):
    """Plain twin of the kernel: one layer at a time, the port's plain
    functions in the kernel's order — RMSNorm, q/k/v products, RoPE in fp32,
    K/V written through the table, paged verify attention (scores in fp32
    divided by sqrt(D)), o product + residual, RMSNorm, SiLU(g)·u, down
    product + residual. Each product rounds once to x's dtype and the
    residual stays in x's dtype, as in the kernel.

    int8 pools (four a layer): each window token's roped K and V rows, in
    x's dtype, go in one token at a time by whole-block requantization
    (:func:`~.paged_attention.write_window_kv_q`); attention takes the
    scales as ``dequant`` says (see :class:`MegakernelGeometry`).

    ``lora``: each target's delta ``((x32 @ A[page]) @ B[page]) · s[page]``
    in fp32, rounded to x's dtype and added to the rounded base product in
    x's dtype (``nn.lora.bgmv``), as the JAX kernel does. The q/k/v deltas
    come before RoPE and the K/V write, the o delta reads the attention
    output rows, the down delta ``silu(g)·u``. This differs on purpose from
    the fused LoRA kernel of the per-layer path, which adds base and delta
    in fp32 and rounds once.

    ``ffn_tile`` > 0: the down product is summed in ``ffn_tile``-wide K
    slices in fp32 and rounded once (:func:`_down_sliced`), as the kernel
    slices it under that geometry (not combinable with LoRA)."""
    from torch.nn import functional as F

    from ..models.llama import _rope_rotate

    B, W, Hd = x.shape
    L = weights.num_layers
    D = 2 * cos_rows.shape[-1]
    H = Hd // D
    quantized = pools[0].dtype == torch.int8
    st = 4 if quantized else 2
    KV = pools[0].shape[2]
    bs = pools[0].shape[1]
    c = cos_rows[:, :, None, :]
    s = sin_rows[:, :, None, :]
    qpos = pos.long()[:, None] + torch.arange(W, device=x.device)[None, :]

    def proj(inp, name, target, l):
        y = torch.matmul(inp, weights[name][l])
        ab = None if lora is None else lora.pooled(l, target)
        return y if ab is None else y + bgmv(inp, ab)

    for l in range(L):
        lp = pools[st * l:st * (l + 1)]
        xn = _rms_ref(x, weights["ln1"][l], eps)
        q = proj(xn, "wq", "q", l).reshape(B, W, H, D)
        k = proj(xn, "wk", "k", l).reshape(B, W, KV, D)
        v = proj(xn, "wv", "v", l).reshape(B, W, KV, D)
        qr = _rope_rotate(q, c, s)
        kr = _rope_rotate(k, c, s)
        if quantized:
            kq, ks, vq, vs = lp
            write_window_kv_q(kq, ks, vq, vs, kr, v, tables, pos)
            ck, cv = gather_block_kv(kq, tables), gather_block_kv(vq, tables)
            ksl = gather_block_scales(ks, tables, bs)
            vsl = gather_block_scales(vs, tables, bs)
            if dequant == "tile":
                a = _attention_core(qr, (ck.float() * ksl[..., None]).to(
                    x.dtype), (cv.float() * vsl[..., None]).to(x.dtype), qpos)
            else:
                a = _attention_core(qr, ck, cv, qpos, ksl, vsl)
        else:
            kp, vp = lp
            write_window_kv(kp, vp, kr, v, tables, pos)
            a = _attention_core(qr, gather_block_kv(kp, tables),
                                gather_block_kv(vp, tables), qpos)
        x = x + proj(a.reshape(B, W, Hd), "wo", "o", l)
        xn = _rms_ref(x, weights["ln2"][l], eps)
        g = proj(xn, "wg", "gate", l)
        u = proj(xn, "wu", "up", l)
        h = F.silu(g) * u
        if ffn_tile:
            x = x + _down_sliced(h, weights["wd"][l], ffn_tile)
        else:
            x = x + proj(h, "wd", "down", l)
    return x


def decode_tick(x, pools, tables, pos, weights, cos_rows, sin_rows, *,
                block_size: int,
                geometry: Optional[MegakernelGeometry] = None,
                eps: float = 1e-6, lora: Optional[LoraTables] = None):
    """One whole decode/verify tick through every layer.

    ``x``: (B, W, hidden) embedded window rows; ``pools``: the flat list of
    per-layer pools, written IN PLACE — fp ``[k0, v0, k1, v1, ...]``, each
    (N, block_size, KV, D), or int8 ``[kq0, ks0, vq0, vs0, ...]`` with int8
    codes (N, block_size, KV, D) and f32 scales (N, KV); ``tables``: int32
    (B, M); ``pos``: int32 (B,) position of each row's first window token;
    ``weights`` from :func:`stack_layer_weights`; ``cos_rows``/``sin_rows``:
    fp32 (B, W, D/2) from :func:`gather_rope_rows`; ``geometry``: a
    :class:`MegakernelGeometry` (all three fields; on the card
    :func:`check_geometry` refuses what the kernel cannot take); ``lora``: :func:`lora_tables` of the adapter
    pool at the rows' pages, or None. Returns ``(x_out (B, W, hidden),
    pools)``; the final norm is not applied. CUDA tensors launch the kernel
    (or raise on what it does not take); CPU tensors, or the
    ``"reference"`` mode, run :func:`_tick_plain`."""
    from . import use_kernel
    from .decode_megakernel_cuda import decode_tick_cuda

    geometry = geometry or MegakernelGeometry()
    geometry.validate()
    if geometry.ffn_tile and lora is not None:
        raise ValueError("ffn_tile > 0 is incompatible with pooled LoRA (the "
                         "gate/up/down delta needs the full intermediate "
                         "dim)")
    pools = list(pools)
    st = 4 if pools and pools[0].dtype == torch.int8 else 2
    if len(pools) != st * weights.num_layers:
        raise ValueError(f"decode_tick: {len(pools)} pools for "
                         f"{weights.num_layers} layers (want {st} a layer)")
    if any(p.shape[1] != block_size for p in pools[::st // 2]):
        raise ValueError(f"decode_tick: pools' block size is not "
                         f"{block_size}")
    kw = dict(eps=eps, dequant=geometry.dequant, lora=lora)
    if use_kernel(x):
        check_geometry(geometry, intermediate=weights["wg"][0].shape[1],
                       rows=x.shape[0] * x.shape[1])
        return decode_tick_cuda(x, pools, tables, pos, weights, cos_rows,
                                sin_rows, stages=geometry.ring_stages(),
                                ffn_steps=geometry.ffn_steps(), **kw), pools
    return _tick_plain(x, pools, tables, pos, weights, cos_rows, sin_rows,
                       ffn_tile=geometry.ffn_tile, **kw), pools
