"""Llama — port of ``paddle_tpu/models/llama.py``: config, RoPE, RMSNorm,
GQA attention, the fp SwiGLU MLP and the causal-LM head, with the dense
causal training forward (``LlamaForCausalLM.forward(input_ids, labels)``:
flash attention, the fused lm-head + CE loss) and the paged serving
forwards (decode, the speculative verify window and chunked prefill) over an fp or an int8 KV pool, with
weight-only int8 projections (:meth:`LlamaForCausalLM.quantize_int8`) or
per-row LoRA adapters read from the adapter pool (``lora=``), and the
fixed-cache forwards of dense generation (``prefill`` over a whole prompt,
``decode`` of one token a row at a scalar or per-row position) behind
:meth:`LlamaForCausalLM.generate` and ``GenerationServer(cache="dense")``.

Parameters keep the JAX package's names and Paddle's ``Linear`` layout:
every projection weight is ``(in, out)`` and a projection computes
``x @ weight``, so a JAX state dict carries over name-for-name and
array-for-array (``models/convert.py``). Training and prefill chunks
multiply with ``torch.matmul``; a decode tick or a verify window
(``paged_verify``) runs every projection and the head through the
batch-invariant products (``ops.stream_matmul``, the int8 and fused LoRA
kernels), so that a row's logits do not depend on the rows beside it.

Training recomputes activations per decoder layer under ``cfg.recompute``
(full recompute, as JAX's ``recompute``) or under the engine's
``remat=True`` and its ``remat_policy``, which sees the checkpoint names
``qkv``, ``attn_out`` and ``mlp_out`` where the JAX model sets them.

Training-side LoRA: ``cfg.lora_rank > 0`` (or :meth:`LlamaForCausalLM.
attach_lora`) wraps the projections named by ``cfg.lora_targets``
(default :data:`LLAMA_LORA_TARGETS`, all seven) in ``nn.lora.LoRALinear``,
whose frozen base keeps the weights a model without LoRA draws from the
same seed; :meth:`LlamaForCausalLM.merge_lora` folds the factors back.

Left out so far: MoE, the fused int8 q/k/v weight (``PT_W8_FUSED_QKV``, a
serving option), ring/Ulysses/context/sequence parallel attention.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..amp import cast_inputs
from ..distributed.fleet.recompute import (checkpoint_name, layer_checkpoint,
                                           recompute)
from ..nn.lora import lora_matmul
from ..nn.quant import Int8Linear
from ..ops.flash_attention import flash_attention
from ..ops.fused_ce import capped_chunk_size, fused_linear_cross_entropy
from ..ops.fused_norm import fused_rms_norm
from ..ops.paged_attention import (paged_prefill_attention,
                                   paged_prefill_attention_q,
                                   paged_verify_attention,
                                   paged_verify_attention_q, write_chunk_kv,
                                   write_chunk_kv_q, write_window_kv,
                                   write_window_kv_q)
from ..ops.stream_matmul import stream_matmul

NEG_INF = -1e30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # the JAX config's parallelism / training / MoE / LoRA knobs, kept so a
    # config carries over field for field; this slice serves only their
    # defaults (LlamaForCausalLM raises otherwise)
    context_parallel: bool = False
    sequence_parallel: bool = False
    ulysses_parallel: bool = False
    use_flash_attention: bool = True
    fused_lm_head_ce: bool = True
    ce_chunk_size: int = 16384
    recompute: bool = False
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 1
    moe_aux_coeff: float = 0.01
    lora_rank: int = 0
    lora_alpha: Optional[float] = None
    lora_targets: Optional[tuple] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {tuple(_DTYPES)}, got "
                             f"{self.dtype!r}")
        return _DTYPES[self.dtype]


# attribute names attach_lora / merge_lora wrap when cfg.lora_targets is None
LLAMA_LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                      "gate_proj", "up_proj", "down_proj")


def llama3_8b_config(**kw) -> LlamaConfig:
    return LlamaConfig(**{**dict(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8), **kw})


def llama_tiny_config(**kw) -> LlamaConfig:
    return LlamaConfig(**{**dict(
        vocab_size=1024, hidden_size=256, intermediate_size=704,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=512, dtype="float32"), **kw})


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #


def _rope_tables(head_dim: int, max_pos: int, theta: float):
    """fp32 (max_pos, head_dim/2) cos/sin tables, computed on the CPU so the
    card and the CPU serve identical tables (the caller moves them)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def _rope_rotate(x, c, s):
    """Rotate pairs (x[..., :D/2], x[..., D/2:]) by pre-gathered c/s rows,
    in fp32, cast back to x's dtype."""
    d2 = x.shape[-1] // 2
    xf1 = x[..., :d2].float()
    xf2 = x[..., d2:].float()
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)


def _apply_rope_window(x, cos, sin, pos):
    """x: (B, W, H, D), row ``b``'s token ``j`` at position ``pos[b] + j``
    (pos int32 (B,)), edge-clamped to the table as the JAX gather is: the
    last ticks of a decode window or the surplus of a verify window may run
    a finished row past it, and their tokens are discarded. W = 1 is one
    decode token a row."""
    W = x.shape[1]
    p = torch.clamp(pos.long()[:, None]
                    + torch.arange(W, device=pos.device)[None, :], 0,
                    cos.shape[0] - 1)                        # (B, W)
    return _rope_rotate(x, cos[p][:, :, None, :], sin[p][:, :, None, :])


def _apply_rope_bhsd(x, cos, sin, pos_offset=0):
    """x: (B, H, S, D), the kernels' head-major layout, at positions
    ``pos_offset + arange(S)``."""
    S = x.shape[2]
    return _rope_rotate(x, cos[pos_offset:pos_offset + S][None, None],
                        sin[pos_offset:pos_offset + S][None, None])


def _apply_rope_chunk(x, cos, sin, start):
    """x: (B, C, H, D) at positions ``start + arange(C)``, edge-clamped to the
    table: a padded final chunk may overrun it, and the clamped rows are
    padding that is never read. ``start``: a host int or a device int32
    scalar ((1,) or 0-d; the add runs on the device)."""
    S = x.shape[1]
    if isinstance(start, torch.Tensor):
        start = start.reshape(()).long()
    else:
        start = int(start)
    idx = torch.clamp(start + torch.arange(S, device=x.device), 0,
                      cos.shape[0] - 1)
    return _rope_rotate(x, cos[idx][None, :, None, :],
                        sin[idx][None, :, None, :])


def rows_pos(pos, B: int, device) -> torch.Tensor:
    """A decode position as int (B,) rows on ``device``: a host int, a
    0-d or (1,) device scalar (one position for every row, expanded
    without a copy) or a per-row (B,) tensor."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((B,), int(pos), dtype=torch.long, device=device)
    return pos.reshape(-1).long().expand(B) if pos.numel() == 1 \
        else pos.reshape(B).long()


def masked_attention(q, k, v, causal: bool = True):
    """The JAX model's einsum attention (``use_flash_attention=False``):
    q (B, S, H, D), k/v (B, T, KV, D) repeated to H heads, logits in the
    input dtype then fp32 over sqrt(D), masked logits -1e30 (causal:
    bottom-right aligned), fp32 softmax cast to q's dtype before PV.
    Returns (B, S, H, D)."""
    q, k, v = cast_inputs("einsum", q, k, v)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if KV != H:
        # query head h reads KV head h // (H / KV), as jnp.repeat lays out
        k = k[:, :, :, None].expand(B, T, KV, H // KV, D).reshape(B, T, H, D)
        v = v[:, :, :, None].expand(B, T, KV, H // KV, D).reshape(B, T, H, D)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() \
        / math.sqrt(q.shape[-1])
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device).tril(T - S)
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", p, v)


def write_rows(cache, new, pos) -> None:
    """Write one token a row into a fixed cache, in place: ``cache`` (B, L,
    KV, D), ``new`` (B, KV, D) at row b's position ``pos[b]`` (int (B,)).
    A position past the cache is clamped to L - 1, a slot no kept token
    reads (the surplus ticks of a decode window past max_len: JAX drops
    those writes)."""
    B, L = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    cache.index_put_((rows, torch.clamp(pos, max=L - 1)),
                     new.to(cache.dtype))


def decode_attention(q, ck, cv, pos):
    """One query a row against a fixed cache — the JAX ``decode`` step's
    GQA einsum (a jnp composition there, plain PyTorch here): q (B, 1, H,
    D); ck/cv (B, L, KV, D); row b attends positions ``<= pos[b]`` (int
    (B,)). Logits in the input dtype then fp32 over sqrt(D), masked -1e30,
    fp32 softmax cast to q's dtype before PV. Returns (B, 1, H, D).

    Each product reads the cache as it lies, (L, KV·D) rows a batch row,
    in one matrix product: the scores multiply it by the queries placed
    block-diagonally (H, KV·D), zero outside each query head's KV group,
    and PV multiplies the probabilities by it and keeps the (query head,
    its group) blocks. The zeros add exact zeros to the sums; the cache
    is never permuted into a copy (a per-group product would copy the
    whole slab every layer)."""
    B, _, H, D = q.shape
    L, KV = ck.shape[1], ck.shape[2]
    eye = torch.eye(KV, dtype=q.dtype, device=q.device)
    # qbd[b, g·rep + r, g2·D + d] = [g == g2] · q[b, g·rep + r, d]
    qg = q.reshape(B, KV, H // KV, 1, D)
    qbd = (qg * eye[None, :, None, :, None]).reshape(B, H, KV * D)
    scores = torch.matmul(qbd, ck.reshape(B, L, KV * D).transpose(1, 2))
    scores = scores.float() / math.sqrt(D)                   # (B, H, L)
    mask = torch.arange(L, device=q.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    full = torch.matmul(p, cv.reshape(B, L, KV * D))         # (B, H, KV·D)
    # keep head h = (g, r)'s own group g: (B, KV, rep, KV, D) diagonal
    out = torch.diagonal(full.reshape(B, KV, H // KV, KV, D), dim1=1,
                         dim2=3)                             # (B, rep, D, KV)
    return out.permute(0, 3, 1, 2).reshape(B, 1, H, D)


# --------------------------------------------------------------------------- #
# Modules
# --------------------------------------------------------------------------- #


def _param(shape, cfg, device):
    return nn.Parameter(torch.empty(shape, dtype=cfg.torch_dtype,
                                    device=device), requires_grad=False)


class Linear(nn.Module):
    """Bias-free projection in Paddle's layout: ``weight`` (in, out),
    ``y = x @ weight``: ``torch.matmul`` (training, prefill), or
    :meth:`stream`, batch-invariant (decode and verify)."""

    def __init__(self, in_features, out_features, cfg, device):
        super().__init__()
        self.weight = _param((in_features, out_features), cfg, device)

    def forward(self, x):
        x, w = cast_inputs("linear", x, self.weight)
        return torch.matmul(x, w)

    def stream(self, x):
        return stream_matmul(x, self.weight)


class Embedding(nn.Module):
    def __init__(self, num, dim, cfg, device):
        super().__init__()
        self.weight = _param((num, dim), cfg, device)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden_size, eps, cfg, device):
        super().__init__()
        self.weight = _param((hidden_size,), cfg, device)
        self._eps = eps

    def forward(self, x):
        return fused_rms_norm(x, self.weight, self._eps)


def _proj(p, x, ab=None, stream: bool = False):
    """Projection ``p`` of x, with this batch's adapter factors ``ab`` of
    its target (or None) as one ``lora_matmul``; ``stream``: the decode
    and verify paths' batch-invariant product (``Linear.stream``, an
    ``Int8Linear``'s streaming kernel, the fused LoRA kernel)."""
    if ab is not None:
        _no_int8_lora(p)
        return lora_matmul(x, p.weight, ab)
    return p.stream(x) if stream else p(x)


def _no_int8_lora(*projections) -> None:
    """The JAX package serves LoRA over fp base weights only
    (``models/llama.py:710-715``): int8 projections with adapter deltas
    raise there, and here."""
    if any(isinstance(p, Int8Linear) for p in projections):
        raise NotImplementedError(
            "pooled LoRA deltas on weight-only int8 projections are not "
            "supported — serve LoRA over fp base weights (int8 KV quant is "
            "fine)")


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.head_dim
        self.use_flash = cfg.use_flash_attention
        h, d = cfg.hidden_size, self.head_dim
        self.q_proj = Linear(h, self.num_heads * d, cfg, device)
        self.k_proj = Linear(h, self.num_kv_heads * d, cfg, device)
        self.v_proj = Linear(h, self.num_kv_heads * d, cfg, device)
        self.o_proj = Linear(self.num_heads * d, h, cfg, device)

    def _qkv(self, x, B, S, lora=None, stream: bool = False):
        """q/k/v projections; ``lora``: this layer's {target: factors} —
        each base projection and its per-row delta run as one
        ``lora_matmul``; ``stream``: the batch-invariant products of the
        decode and verify paths (:func:`_proj`)."""
        if lora is not None:
            _no_int8_lora(self.q_proj, self.k_proj, self.v_proj)
        lora = lora or {}
        q, k, v = (_proj(p, x, lora.get(t), stream) for p, t in (
            (self.q_proj, "q"), (self.k_proj, "k"), (self.v_proj, "v")))
        return (q.reshape(B, S, self.num_heads, self.head_dim),
                k.reshape(B, S, self.num_kv_heads, self.head_dim),
                v.reshape(B, S, self.num_kv_heads, self.head_dim))

    def _o_lora(self, out, lora, stream: bool = False):
        """Output projection plus this layer's "o" delta, fused."""
        if lora is not None:
            _no_int8_lora(self.o_proj)
        return _proj(self.o_proj, out, (lora or {}).get("o"), stream)

    def forward(self, x, cos, sin):
        """Dense causal pass (training): heads go head-major BEFORE RoPE,
        then flash attention, then back. x: (B, S, hidden)."""
        B, S = x.shape[0], x.shape[1]
        q, k, v = (checkpoint_name(t, "qkv") for t in self._qkv(x, B, S))
        if not self.use_flash:
            out = masked_attention(_apply_rope_chunk(q, cos, sin, 0),
                                   _apply_rope_chunk(k, cos, sin, 0), v)
            out = checkpoint_name(out, "attn_out")
            return self.o_proj(out.reshape(B, S, -1))
        qh = _apply_rope_bhsd(q.transpose(1, 2), cos, sin)
        kh = _apply_rope_bhsd(k.transpose(1, 2), cos, sin)
        vh = v.transpose(1, 2)
        out = flash_attention(qh, kh, vh, causal=True)
        # back to (B, S, H, D) for the output projection: the anchor's
        # copy where a policy saves it, the reshape's copy otherwise
        out = checkpoint_name(out.transpose(1, 2), "attn_out")
        return self.o_proj(out.reshape(B, S, -1))

    def prefill(self, x, cos, sin, ck, cv):
        """A whole prompt in one causal pass (JAX ``prefill``): its K/V
        written into the fixed caches ck/cv (B, L, KV, D) at [0, S), in
        place; flash attention over the prompt with ``use_flash_attention``
        (the kernel on the card), the masked einsum otherwise. x: (B, S,
        hidden). Returns (output, ck, cv)."""
        B, S = x.shape[0], x.shape[1]
        q, k, v = self._qkv(x, B, S)
        qr = _apply_rope_chunk(q, cos, sin, 0)
        kr = _apply_rope_chunk(k, cos, sin, 0)
        ck[:, :S] = kr.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)
        if self.use_flash:
            out = flash_attention(qr.transpose(1, 2), kr.transpose(1, 2),
                                  v.transpose(1, 2),
                                  causal=True).transpose(1, 2)
        else:
            out = masked_attention(qr, kr, v)
        return self.o_proj(out.reshape(B, S, -1)), ck, cv

    def decode(self, x, cos, sin, ck, cv, pos):
        """One token a row against the fixed caches (JAX ``decode``): its
        K/V written at the row's position (in place) and attention over
        positions <= it. x: (B, 1, hidden); ck/cv (B, L, KV, D); pos: a
        host int, a device scalar, or int (B,) per-row positions (the
        dense server's slots). The projections are the batch-invariant
        decode products (``stream``), so a row's logits do not depend on
        the rows beside it. Returns (output, ck, cv)."""
        B = x.shape[0]
        q, k, v = self._qkv(x, B, 1, stream=True)
        p = rows_pos(pos, B, x.device)
        qr = _apply_rope_window(q, cos, sin, p)
        kr = _apply_rope_window(k, cos, sin, p)
        write_rows(ck, kr[:, 0], p)
        write_rows(cv, v[:, 0], p)
        out = decode_attention(qr, ck, cv, p)
        return self.o_proj.stream(out.reshape(B, 1, -1)), ck, cv

    def paged_verify(self, x, cos, sin, pool, block_tables, pos,
                     lora=None):
        """A WINDOW of W tokens a row against the paged pool (JAX
        ``paged_verify_attn``): row ``b``'s token ``j`` sits at position
        ``pos[b] + j``; the window's K/V scatter through the block table
        (in place), then query ``j`` attends the context up to its own
        position. x: (B, W, hidden); pool: ``(kp, vp)`` (num_blocks, bs,
        KV, D) fp pools, or ``(kq, ks, vq, vs)`` int8 codes with (num_blocks,
        KV) f32 scales; block_tables: int32 (B, M); pos: int32 (B,);
        ``lora``: this layer's adapter factors (or None). W = 1 is the
        single-token decode. Returns (output, pool)."""
        B, W = x.shape[0], x.shape[1]
        q, k, v = self._qkv(x, B, W, lora, stream=True)
        qr = _apply_rope_window(q, cos, sin, pos)
        kr = _apply_rope_window(k, cos, sin, pos)
        if len(pool) == 4:
            write_window_kv_q(*pool, kr, v, block_tables, pos)
            out = paged_verify_attention_q(qr, *pool, block_tables, pos)
        else:
            write_window_kv(*pool, kr, v, block_tables, pos)
            out = paged_verify_attention(qr, *pool, block_tables, pos)
        return self._o_lora(out.reshape(B, W, -1), lora, stream=True), pool

    # single-token decode: the verify window at W = 1
    paged_decode = paged_verify

    def paged_prefill_chunk(self, x, cos, sin, pool, block_table, start,
                            lora=None):
        """One fixed-size prefill CHUNK: queries at ``start + arange(C)``
        (block-aligned ``start``, a host int or a device int32 scalar that
        the caller checked; C a multiple of the block size); their K/V
        fill consecutive table entries (in place) and attention runs over
        all paged context written so far. x: (1, C, hidden); ``pool`` and
        ``lora`` as in :meth:`paged_verify`; block_table: int32 (M,).
        Returns (output, pool)."""
        B, S = x.shape[0], x.shape[1]
        q, k, v = self._qkv(x, B, S, lora)
        qr = _apply_rope_chunk(q, cos, sin, start)
        kr = _apply_rope_chunk(k, cos, sin, start)
        if len(pool) == 4:
            write_chunk_kv_q(*pool, kr[0], v[0], block_table, start)
            out = paged_prefill_attention_q(qr, *pool, block_table, start)
        else:
            write_chunk_kv(*pool, kr[0], v[0], block_table, start)
            out = paged_prefill_attention(qr, *pool, block_table, start)
        return self._o_lora(out.reshape(B, S, -1), lora), pool


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Linear(h, f, cfg, device)
        self.up_proj = Linear(h, f, cfg, device)
        self.down_proj = Linear(f, h, cfg, device)

    def forward(self, x, lora=None, stream: bool = False):
        """SwiGLU. ``lora``: this layer's adapter factors — each projection
        and its per-row delta run as one ``lora_matmul``. Int8 projections
        (``Int8Linear``) run their own ``w8_matmul``. ``stream``: the
        batch-invariant products of the decode and verify paths."""
        lora = lora or {}
        if any(t in lora for t in ("gate", "up", "down")):
            _no_int8_lora(self.gate_proj, self.up_proj, self.down_proj)
        g = _proj(self.gate_proj, x, lora.get("gate"), stream)
        u = _proj(self.up_proj, x, lora.get("up"), stream)
        return _proj(self.down_proj, F.silu(g) * u, lora.get("down"), stream)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                            cfg, device)
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attention_layernorm = LlamaRMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, cfg, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, cos, sin):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return h + checkpoint_name(self.mlp(self.post_attention_layernorm(h)),
                                   "mlp_out")

    def prefill(self, x, cos, sin, ck, cv):
        a, ck, cv = self.self_attn.prefill(self.input_layernorm(x), cos, sin,
                                           ck, cv)
        h = x + a
        return h + self.mlp(self.post_attention_layernorm(h)), ck, cv

    def decode(self, x, cos, sin, ck, cv, pos):
        a, ck, cv = self.self_attn.decode(self.input_layernorm(x), cos, sin,
                                          ck, cv, pos)
        h = x + a
        return h + self.mlp(self.post_attention_layernorm(h),
                            stream=True), ck, cv

    def paged_verify(self, x, cos, sin, pool, block_tables, pos,
                     lora=None):
        a, pool = self.self_attn.paged_verify(self.input_layernorm(x), cos,
                                              sin, pool, block_tables, pos,
                                              lora)
        h = x + a
        return h + self.mlp(self.post_attention_layernorm(h), lora,
                            stream=True), pool

    paged_decode = paged_verify

    def paged_prefill_chunk(self, x, cos, sin, pool, block_table, start,
                            lora=None):
        a, pool = self.self_attn.paged_prefill_chunk(
            self.input_layernorm(x), cos, sin, pool, block_table, start, lora)
        h = x + a
        return h + self.mlp(self.post_attention_layernorm(h), lora), pool


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, cfg,
                                      device)
        self.layers = nn.ModuleList([LlamaDecoderLayer(cfg, device)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg,
                                 device)
        cos, sin = _rope_tables(cfg.head_dim, cfg.max_position_embeddings,
                                cfg.rope_theta)
        self.register_buffer("_cos", cos.to(device), persistent=False)
        self.register_buffer("_sin", sin.to(device), persistent=False)

    def forward(self, input_ids):
        """Dense causal pass over (B, S) token ids from position 0;
        returns the normed hidden states (B, S, hidden). Inside the
        engine's ``remat=True`` scope each decoder layer is checkpointed
        under its policy; otherwise, with ``cfg.recompute`` while training
        with grad on, each is recomputed in full (as the JAX model)."""
        run = layer_checkpoint()
        if run is None and self.cfg.recompute and self.training and \
                torch.is_grad_enabled():
            run = recompute
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, self._cos, self._sin) if run is None else \
                run(layer, x, self._cos, self._sin)
        return self.norm(x)

    def decode_step(self, token, caches, pos):
        """Fixed-cache decode (JAX ``decode_step``): token int (B, 1);
        caches: per-layer ``(ck, cv)`` (B, L, KV, D), written in place;
        pos: a host int, a device scalar or int (B,) per-row positions.
        Returns (normed hidden (B, 1, hidden), caches)."""
        x = self.embed_tokens(token)
        new = []
        for layer, (ck, cv) in zip(self.layers, caches):
            x, ck, cv = layer.decode(x, self._cos, self._sin, ck, cv, pos)
            new.append((ck, cv))
        return self.norm(x), new

    def prefill(self, input_ids, caches):
        """Fill the fixed caches at [0, S) from a whole prompt in one
        forward (JAX ``prefill``). Returns (normed hidden of every prompt
        position (B, S, hidden), caches)."""
        x = self.embed_tokens(input_ids)
        new = []
        for layer, (ck, cv) in zip(self.layers, caches):
            x, ck, cv = layer.prefill(x, self._cos, self._sin, ck, cv)
            new.append((ck, cv))
        return self.norm(x), new

    def paged_verify_step(self, tokens, pools, block_tables, pos,
                          lora=None):
        """Speculative verify: score a window of W = k+1 tokens a row in one
        pass (JAX ``paged_verify_step``). tokens: int (B, W), the current
        token then the k drafts, at positions ``pos[b] + arange(W)``;
        pools: list of per-layer ``(kp, vp)`` or ``(kq, ks, vq, vs)``
        (updated in place); block_tables: int32 (B, M); pos: int32 (B,);
        ``lora``: None or a per-layer list of {target: factors}
        (``inference.lora.AdapterPool.layer_factors``). Returns (normed
        hidden (B, W, hidden), pools). W = 1 is :meth:`paged_decode_step`."""
        x = self.embed_tokens(tokens)
        new = []
        for i, (layer, pool) in enumerate(zip(self.layers, pools)):
            x, pool = layer.paged_verify(x, self._cos, self._sin, pool,
                                         block_tables, pos,
                                         None if lora is None else lora[i])
            new.append(pool)
        return self.norm(x), new

    def paged_decode_step(self, token, pools, block_tables, pos, lora=None):
        """Paged continuous-batching decode, token int (B, 1): the verify
        window at W = 1 (see :meth:`paged_verify_step`). Returns (normed
        hidden (B, 1, hidden), pools)."""
        return self.paged_verify_step(token, pools, block_tables, pos, lora)

    def paged_prefill_chunk(self, input_ids, pools, block_table, start,
                            lora=None):
        """Stream ONE prompt chunk into the paged pool. input_ids: int
        (1, C); block_table: int32 (M,); start: block-aligned chunk origin,
        a host int or a device int32 scalar (JAX's traced ``start``);
        ``pools``/``lora`` as in :meth:`paged_decode_step`. Returns (normed
        hidden (1, C, hidden), pools)."""
        x = self.embed_tokens(input_ids)
        new = []
        for i, (layer, pool) in enumerate(zip(self.layers, pools)):
            x, pool = layer.paged_prefill_chunk(
                x, self._cos, self._sin, pool, block_table, start,
                None if lora is None else lora[i])
            new.append(pool)
        return self.norm(x), new


def _check_supported(cfg: LlamaConfig) -> None:
    unsupported = {
        "moe_num_experts": (cfg.moe_num_experts, 0),
        "context_parallel": (cfg.context_parallel, False),
        "sequence_parallel": (cfg.sequence_parallel, False),
        "ulysses_parallel": (cfg.ulysses_parallel, False),
    }
    for name, (got, default) in unsupported.items():
        if got != default:
            raise NotImplementedError(
                f"LlamaConfig.{name}={got!r} is not ported yet (the port "
                f"runs dense-MLP, single-device Llama)")
    if cfg.hidden_size % cfg.num_attention_heads or \
            cfg.num_attention_heads % cfg.num_key_value_heads:
        raise ValueError("hidden_size must divide by num_attention_heads and "
                         "num_attention_heads by num_key_value_heads")


class LlamaForCausalLM(nn.Module):
    """Llama causal LM: the dense training forward, paged serving and
    fixed-cache generation (:meth:`generate`).

    ``device=None`` puts the model on the current CUDA device and raises if
    there is none; pass ``device="cpu"`` for the plain PyTorch path. Weights
    are initialised on that device from a ``torch.Generator`` seeded with
    ``seed`` — projections and embeddings N(0, 0.02), norms 1 — so a
    full-width model never has to exist in host memory. Load trained or JAX
    weights with ``load_state_dict`` (see ``models/convert.py``).
    Parameters are built with ``requires_grad=False`` (serving);
    ``parallel.ParallelEngine`` turns gradients on for the ones it trains.
    With ``cfg.lora_rank`` the projections are wrapped in LoRA after the
    base weights are drawn (:meth:`attach_lora`), so the base equals that
    of the same config without LoRA at the same seed."""

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.model = LlamaModel(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, cfg, device)
        if cfg.lora_rank:
            self.attach_lora(cfg.lora_rank, alpha=cfg.lora_alpha,
                             targets=cfg.lora_targets)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Projections and embeddings N(0, 0.02), norms 1, drawn in
        parameter order from a generator seeded with ``seed``; then each
        LoRA ``lora_A`` N(0, 0.02) from the same generator and ``lora_B``
        zeros (the base draws do not depend on whether LoRA is
        attached)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        named = list(self.named_parameters())
        for name, p in named:
            if name.endswith(("lora_A", "lora_B")):
                continue
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)
        for name, p in named:
            if name.endswith("lora_A"):
                p.normal_(0.0, 0.02, generator=g)
            elif name.endswith("lora_B"):
                p.zero_()

    def attach_lora(self, rank, alpha=None, targets=None, generator=None):
        """Wrap the projections with trainable LoRA factors
        (``nn/lora.py``; ``lora_A`` drawn from ``generator``); ``targets``
        defaults to all of :data:`LLAMA_LORA_TARGETS`. Base weights freeze
        (``trainable = False``); only A and B train. Returns self."""
        from ..nn.lora import attach_lora

        self.__dict__.pop("_gen_cache", None)
        return attach_lora(self, rank, alpha=alpha,
                           targets=targets or LLAMA_LORA_TARGETS,
                           generator=generator)

    def merge_lora(self, targets=None):
        """Fold the trained factors into the base weights (in place) and
        restore plain projections — the dense model the served adapter is
        compared with. Returns self."""
        from ..nn.lora import merge_lora

        self.__dict__.pop("_gen_cache", None)
        return merge_lora(self, targets=targets or LLAMA_LORA_TARGETS)

    @property
    def quantized(self) -> bool:
        """True after :meth:`quantize_int8`."""
        return isinstance(self.model.layers[0].self_attn.q_proj, Int8Linear)

    @torch.no_grad()
    def quantize_int8(self):
        """Convert every projection (q/k/v/o, gate/up/down) and an untied
        lm-head to weight-only int8 (:class:`~paddle_tpu_torch.nn.quant.
        Int8Linear`), in place, as ``paddle_tpu``'s ``quantize_int8``; the
        embedding stays in the model dtype. For inference only. The JAX
        package's fused-q/k/v option (``PT_W8_FUSED_QKV``) is not ported.
        Returns self."""
        for layer in self.model.layers:
            att, mlp = layer.self_attn, layer.mlp
            for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
                setattr(att, name, Int8Linear.from_linear(getattr(att, name)))
            for name in ("gate_proj", "up_proj", "down_proj"):
                setattr(mlp, name, Int8Linear.from_linear(getattr(mlp, name)))
        if not self.cfg.tie_word_embeddings:
            self.lm_head = Int8Linear.from_linear(self.lm_head)
        # generation programs read the fp weights by address
        self.__dict__.pop("_gen_cache", None)
        return self

    def head(self, h, stream: bool = False):
        """Logits in the model dtype: ``h @ lm_head.weight``, or
        ``h @ embed.T`` with tied embeddings; ``stream``: the decode and
        verify paths' batch-invariant product (a tied head reads the
        embedding (vocab, hidden) as it lies)."""
        tied = self.cfg.tie_word_embeddings
        if stream:
            if tied:
                return stream_matmul(h, self.model.embed_tokens.weight,
                                     transpose_w=True)
            return self.lm_head.stream(h)
        if tied:
            return torch.matmul(h, self.model.embed_tokens.weight.t())
        return self.lm_head(h)

    def forward(self, input_ids, labels=None):
        """Dense causal pass. Without labels: logits (B, S, vocab) in the
        model dtype. With labels and ``cfg.fused_lm_head_ce``: the fused
        chunked lm-head + CE loss (mean over labels != -100); otherwise
        :meth:`loss_fn` of the logits."""
        h = self.model(input_ids)
        if labels is not None and self.cfg.fused_lm_head_ce:
            tied = self.cfg.tie_word_embeddings
            w = self.model.embed_tokens.weight if tied else \
                self.lm_head.weight
            chunk = capped_chunk_size(self.cfg.ce_chunk_size,
                                      input_ids.shape[1])
            return fused_linear_cross_entropy(h, w, labels, chunk_size=chunk,
                                              transpose_weight=tied)
        logits = self.head(h)
        if labels is None:
            return logits
        return self.loss_fn(logits, labels)

    def loss_fn(self, logits, labels, ignore_index: int = -100):
        """Mean next-token CE with an fp32 softmax over the labels that are
        not ``ignore_index`` (the JAX package's ``F.cross_entropy``)."""
        logp = torch.log_softmax(logits.float(), dim=-1)
        lbl = labels.long()
        valid = lbl != ignore_index
        nll = -logp.gather(-1, lbl.clamp(0, logits.shape[-1] - 1)[..., None])
        nll = torch.where(valid, nll[..., 0], 0.0)
        return nll.sum() / valid.sum().clamp_min(1).float()

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 eos_token_id: Optional[int] = None, num_beams: int = 1,
                 length_penalty: float = 0.0):
        """Autoregressive generation over fixed-size KV caches (PaddleNLP
        ``model.generate``; greedy when temperature == 0): the prompt in
        one prefill (flash attention with ``use_flash_attention``), then
        one decode step a token, as the replay of one CUDA graph a step
        on the card (``models/generation.py``). Sampling draws from a
        generator seeded with ``seed``; ``num_beams > 1`` runs the beam
        search (temperature / top_k / seed ignored). The decode products
        are the batch-invariant ones (``stream_matmul``, or the int8
        kernel after :meth:`quantize_int8`). Returns int32 (B, P +
        max_new_tokens) on the model's device."""
        from .generation import generate_with_caches

        cfg = self.cfg
        kv, d, n_layers = cfg.num_key_value_heads, cfg.head_dim, \
            cfg.num_hidden_layers
        device = self.device
        model = self

        def make_caches(B, L):
            return [torch.zeros(B, L, kv, d, dtype=cfg.torch_dtype,
                                device=device)
                    for _ in range(2 * n_layers)]

        def pairs(flat):
            return [(flat[2 * i], flat[2 * i + 1]) for i in range(n_layers)]

        def run_one(tok, flat, pos):
            h, _ = model.model.decode_step(tok, pairs(flat), pos)
            return model.head(h, stream=True)[:, 0]

        def prefill(prompt, flat):
            h, _ = model.model.prefill(prompt, pairs(flat))
            return model.head(h[:, -1:])[:, 0]

        return generate_with_caches(
            self, input_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            eos_token_id=eos_token_id, num_beams=num_beams,
            length_penalty=length_penalty, make_caches=make_caches,
            run_one=run_one, prefill=prefill,
            max_positions=cfg.max_position_embeddings)
