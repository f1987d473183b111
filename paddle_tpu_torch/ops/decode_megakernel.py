"""Whole-tick decode megakernel — port of ``paddle_tpu/ops/decode_megakernel.py``
(fp KV pools, no LoRA).

Every decoder layer of one decode (W = 1) or speculative-verify (W > 1) tick
runs as ONE launch of a persistent CUDA kernel (``csrc/decode_megakernel.cu``,
wrapper :func:`~.decode_megakernel_cuda.decode_tick_cuda`): RMSNorm, the
q/k/v products, RoPE, the window's K/V written through the block table,
paged attention, the o product and residual, RMSNorm, SiLU(g)·u and the
down product and residual, layer after layer, with grid-wide barriers in
place of the JAX kernel's single program and hand-rolled HBM→VMEM streams.
The final norm, the lm-head and sampling stay outside, as in the JAX
executor.

:func:`decode_tick` launches the kernel for CUDA tensors and runs its plain
twin :func:`_tick_plain` — the port's plain per-layer functions composed in
the kernel's order, rounding where the kernel rounds — for CPU tensors or
under ``set_kernel_mode("reference")``. It writes the pools in place.

Weights are not copied: :class:`LayerWeights` keeps the model's own
per-layer tensors and, on the card, a device table of their pointers (the
JAX package stacks every projection into new ``(L, in, out)`` arrays, which
doubles the served weights). The int8-KV variant (in-kernel whole-block
requantization) and the LoRA streams of the JAX kernel are not ported yet;
neither are the geometry knobs: only the default
:class:`MegakernelGeometry` is served.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .fused_norm import _rms_ref
from .paged_attention import _attention_core, gather_block_kv, write_window_kv

DEQUANT_MODES = ("scores", "tile")
# the CUDA kernel's shape rules (csrc/decode_megakernel.cu)
HEAD_DIM = 128
K_STEP = 256          # hidden and intermediate sizes are multiples of this
MAX_ROWS = 64         # B * W


@dataclasses.dataclass(frozen=True)
class MegakernelGeometry:
    """The JAX kernel's tunable schedule (``ffn_tile``, ``prefetch_depth``,
    ``dequant``; see ``paddle_tpu.ops.decode_megakernel``). The CUDA kernel
    takes the defaults only: :func:`check_geometry` raises on another
    ``ffn_tile`` or ``prefetch_depth``. ``dequant`` places the int8 KV
    scales, so it has no effect on the fp pools this kernel serves."""

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

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def check_geometry(geometry: MegakernelGeometry) -> None:
    """Raise ``NotImplementedError`` on a geometry the CUDA kernel does not
    take yet: its tile width and prefetch depth are fixed."""
    default = MegakernelGeometry()
    for name in ("ffn_tile", "prefetch_depth"):
        if getattr(geometry, name) != getattr(default, name):
            raise NotImplementedError(
                f"MegakernelGeometry.{name}={getattr(geometry, name)!r} is "
                f"not ported: the CUDA decode_tick kernel takes the default "
                f"geometry only ({name}={getattr(default, name)!r})")


def cuda_shape_reason(cfg, block_size: int) -> Optional[str]:
    """The CUDA kernel's shape and type rules (the counterpart of the JAX
    kernel's Mosaic alignment guard); None when it takes ``cfg``."""
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
    return None


def megakernel_supported(model, cfg, *, tp: int = 1, cp: int = 1,
                         block_size: int = 16,
                         geometry: Optional[MegakernelGeometry] = None,
                         lora: bool = False) -> Optional[str]:
    """Structural and shape guard of the whole-tick kernel, checked at
    executor construction: None when the megakernel can serve this model,
    else the reason — the JAX package's reasons, word for word, then the
    CUDA kernel's rules (:func:`cuda_shape_reason`) for a model on the card
    (the CPU twin takes any shape, as the JAX kernel's interpret mode
    does). The port raises on a reason instead of falling back."""
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
    if getattr(model, "device", torch.device("cpu")).type == "cuda":
        return cuda_shape_reason(cfg, block_size)
    return None


# ------------------------------------------------------- the layer weights
class LayerWeights:
    """The per-layer weights the tick reads, without a second copy: for each
    of ``NAMES`` the list of the model's own L tensors and, for a model on
    the card, ``ptrs``: an int64 (9, L) device table of their addresses (the
    kernel's argument). Built once at executor construction;
    :meth:`check` raises when the model's weights were replaced since."""

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


# ------------------------------------------------------------ the tick
def _tick_plain(x, pools, tables, pos, weights, cos_rows, sin_rows, *,
                eps: float):
    """Plain twin of the kernel: one layer at a time, the port's plain
    functions in the kernel's order — RMSNorm, q/k/v products, RoPE in fp32,
    K/V written through the table, paged verify attention (scores in fp32
    divided by sqrt(D)), o product + residual, RMSNorm, SiLU(g)·u, down
    product + residual. Each product rounds once to x's dtype and the
    residual stays in x's dtype, as in the kernel."""
    from torch.nn import functional as F

    from ..models.llama import _rope_rotate

    B, W, Hd = x.shape
    L = weights.num_layers
    D = 2 * cos_rows.shape[-1]
    H = Hd // D
    KV = pools[0].shape[2]
    c = cos_rows[:, :, None, :]
    s = sin_rows[:, :, None, :]
    qpos = pos.long()[:, None] + torch.arange(W, device=x.device)[None, :]
    for l in range(L):
        kp, vp = pools[2 * l], pools[2 * l + 1]
        xn = _rms_ref(x, weights["ln1"][l], eps)
        q = torch.matmul(xn, weights["wq"][l]).reshape(B, W, H, D)
        k = torch.matmul(xn, weights["wk"][l]).reshape(B, W, KV, D)
        v = torch.matmul(xn, weights["wv"][l]).reshape(B, W, KV, D)
        qr = _rope_rotate(q, c, s)
        kr = _rope_rotate(k, c, s)
        write_window_kv(kp, vp, kr, v, tables, pos)
        a = _attention_core(qr, gather_block_kv(kp, tables),
                            gather_block_kv(vp, tables), qpos)
        x = x + torch.matmul(a.reshape(B, W, Hd), weights["wo"][l])
        xn = _rms_ref(x, weights["ln2"][l], eps)
        g = torch.matmul(xn, weights["wg"][l])
        u = torch.matmul(xn, weights["wu"][l])
        x = x + torch.matmul(F.silu(g) * u, weights["wd"][l])
    return x


def decode_tick(x, pools, tables, pos, weights, cos_rows, sin_rows, *,
                block_size: int, eps: float = 1e-6):
    """One whole decode/verify tick through every layer.

    ``x``: (B, W, hidden) embedded window rows; ``pools``: the flat list of
    per-layer fp K/V pools ``[k0, v0, k1, v1, ...]``, each (N, block_size,
    KV, D), written IN PLACE; ``tables``: int32 (B, M); ``pos``: int32 (B,)
    position of each row's first window token; ``weights`` from
    :func:`stack_layer_weights`; ``cos_rows``/``sin_rows``: fp32 (B, W,
    D/2) from :func:`gather_rope_rows`. Returns ``(x_out (B, W, hidden),
    pools)``; the final norm is not applied. CUDA tensors launch the kernel
    (or raise on what it does not take); CPU tensors, or the
    ``"reference"`` mode, run :func:`_tick_plain`."""
    from . import use_kernel
    from .decode_megakernel_cuda import decode_tick_cuda

    pools = list(pools)
    if len(pools) != 2 * weights.num_layers:
        raise ValueError(f"decode_tick: {len(pools)} pools for "
                         f"{weights.num_layers} layers (want K and V each)")
    if any(p.shape[1] != block_size for p in pools):
        raise ValueError(f"decode_tick: pools' block size is not "
                         f"{block_size}")
    if use_kernel(x):
        return decode_tick_cuda(x, pools, tables, pos, weights, cos_rows,
                                sin_rows, eps=eps), pools
    return _tick_plain(x, pools, tables, pos, weights, cos_rows, sin_rows,
                       eps=eps), pools
