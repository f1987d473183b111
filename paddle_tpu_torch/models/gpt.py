"""GPT-2-style decoder — port of ``paddle_tpu/models/gpt.py``: pre-norm
blocks with a fused q/k/v projection (``c_attn``), the tanh GELU MLP and a
head tied to the token embedding, with the dense causal forward and the
fixed-cache paths of generation (``prefill``, ``decode_step`` with the
position embedding read at the decode position).

Parameters keep the JAX model's names and Paddle's ``Linear`` layout
(weight (in, out), ``x @ weight + bias``), so ``models/convert.py``'s
``gpt_params_from_jax`` carries a JAX state dict over name for name. The
model is built on ``device`` (None: the CUDA card, raising without one;
``"cpu"`` for the plain path) in ``cfg.dtype``, and its weights are drawn
from a ``torch.Generator`` seeded with ``seed``: every projection and both
embeddings N(0, 0.02) (GPT-2's initializer range; the JAX model draws its
embeddings N(0, 1)), biases 0, LayerNorms 1 and 0.

On the card every LayerNorm launches the hand-written LayerNorm kernel (25
a forward, prefill or decode step at 12 layers), and attention takes the
flash kernels (head dim 64) where the JAX package's rule admits it: the
prompt's S a multiple of 128 (``nn.functional.attention``); the flash
kernels take bfloat16 only, so a GPT on the card is built with
``dtype="bfloat16"``. The decode step's attention over the fixed cache is
the JAX model's einsum, computed in plain PyTorch
(``llama.decode_attention``).

Training-side LoRA: ``cfg.lora_rank > 0`` (or :meth:`GPTForCausalLM.
attach_lora`) wraps the projections named by ``cfg.lora_targets`` (default
:data:`GPT_LORA_TARGETS`, every projection of a block; the fused ``c_attn``
adapts q, k and v through one (h, 3h) residual) in ``nn.lora.LoRALinear``;
:meth:`GPTForCausalLM.merge_lora` folds them back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..nn import functional as F
from ..nn.layer import Dropout, Embedding, LayerNorm, Linear
from .generation import GenerationMixin
from .llama import _DTYPES, decode_attention, rows_pos, write_rows


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"
    # training-side LoRA: rank > 0 wraps the block projections at
    # construction (nn/lora.py)
    lora_rank: int = 0
    lora_alpha: Optional[float] = None
    lora_targets: Optional[tuple] = None

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {tuple(_DTYPES)}, got "
                             f"{self.dtype!r}")
        return _DTYPES[self.dtype]


# fused qkv + attention out + both MLP projections: every projection in a
# GPTBlock
GPT_LORA_TARGETS = ("c_attn", "c_proj", "c_fc", "c_out")


def gpt2_small_config(**kw) -> GPTConfig:
    return GPTConfig(**kw)


def gpt_tiny_config(**kw) -> GPTConfig:
    return GPTConfig(**{**dict(vocab_size=512, hidden_size=128,
                               num_hidden_layers=2, num_attention_heads=4,
                               intermediate_size=512,
                               max_position_embeddings=256,
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0), **kw})


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device, dtype):
        super().__init__()
        h = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.c_attn = Linear(h, 3 * h, **kw)
        self.c_proj = Linear(h, h, **kw)
        self.ln_2 = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.c_fc = Linear(h, cfg.intermediate_size, **kw)
        self.c_out = Linear(cfg.intermediate_size, h, **kw)
        self.drop = Dropout(cfg.hidden_dropout_prob)
        self.n_head = cfg.num_attention_heads

    def _qkv(self, x):
        B, S, H = x.shape
        qkv = self.c_attn(self.ln_1(x)).reshape(B, S, 3, self.n_head,
                                                H // self.n_head)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _mlp(self, x):
        return self.c_out(F.gelu(self.c_fc(self.ln_2(x)), approximate=True))

    def forward(self, x):
        B, S, H = x.shape
        q, k, v = self._qkv(x)
        attn = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              training=self.training)
        x = x + self.drop(self.c_proj(attn.reshape(B, S, H)))
        return x + self.drop(self._mlp(x))

    def prefill(self, x, ck, cv):
        """The whole prompt in one causal pass, its K/V written into the
        fixed caches ck/cv (B, L, heads, head_dim) at [0, S), in place;
        attention through the same ``scaled_dot_product_attention`` as
        :meth:`forward`. Returns (x, ck, cv)."""
        B, S, H = x.shape
        q, k, v = self._qkv(x)
        ck[:, :S] = k.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             training=False)
        x = x + self.c_proj(out.reshape(B, S, H))
        return x + self._mlp(x), ck, cv

    def decode(self, x, ck, cv, pos):
        """One token a row against the fixed caches: its K/V written at the
        row's position (in place), attention over positions <= it. x (B,
        1, hidden); pos a host int, a device scalar or int (B,). Returns
        (x, ck, cv)."""
        B, _, H = x.shape
        q, k, v = self._qkv(x)
        p = rows_pos(pos, B, x.device)
        write_rows(ck, k[:, 0], p)
        write_rows(cv, v[:, 0], p)
        out = decode_attention(q, ck, cv, p).reshape(B, 1, H)
        x = x + self.c_proj(out)
        return x + self._mlp(x), ck, cv


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             **kw)
        self.drop = Dropout(cfg.hidden_dropout_prob)
        self.h = nn.ModuleList([GPTBlock(cfg, **kw)
                                for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                              **kw)

    def _embed(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.wte(input_ids) + self.wpe(pos)

    def forward(self, input_ids):
        x = self.drop(self._embed(input_ids))
        for block in self.h:
            x = block(x)
        return self.ln_f(x)

    def prefill(self, input_ids, caches):
        """Fill the fixed caches at [0, S) from a whole prompt; returns
        (normed hidden of every position, caches)."""
        x = self._embed(input_ids)
        new = []
        for block, (ck, cv) in zip(self.h, caches):
            x, ck, cv = block.prefill(x, ck, cv)
            new.append((ck, cv))
        return self.ln_f(x), new

    def decode_step(self, token, caches, pos):
        """token int (B, 1) at position ``pos`` (a host int, a device
        scalar or int (B,)): the position embedding read at it; returns
        (normed hidden (B, 1, hidden), caches)."""
        p = rows_pos(pos, token.shape[0], token.device)
        x = self.wte(token) + self.wpe.weight.index_select(0, p)[:, None]
        new = []
        for block, (ck, cv) in zip(self.h, caches):
            x, ck, cv = block.decode(x, ck, cv, p)
            new.append((ck, cv))
        return self.ln_f(x), new


class GPTForCausalLM(nn.Module, GenerationMixin):
    """GPT causal LM with the head tied to ``wte``: the causal forward, the
    loss and fixed-cache generation (:meth:`generate`; the cacheless
    :meth:`GenerationMixin.generate` stays reachable through the mixin).
    ``device=None`` builds on the CUDA card and raises without one."""

    def __init__(self, cfg: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.generator = torch.Generator(device=device)
        self.transformer = GPTModel(cfg, device=device,
                                    dtype=cfg.torch_dtype)
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator
        self.reset_parameters(seed)
        if cfg.lora_rank:
            self.attach_lora(cfg.lora_rank, alpha=cfg.lora_alpha,
                             targets=cfg.lora_targets,
                             generator=self.generator)

    @property
    def device(self) -> torch.device:
        return self.transformer.wte.weight.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Projections and embeddings N(0, 0.02), biases 0, LayerNorms 1
        and 0, drawn on the model's device from ``seed`` (which also seeds
        the dropout masks' generator)."""
        self.generator.manual_seed(int(seed))
        for name, p in self.named_parameters():
            if ".ln_" in name or name.startswith("transformer.ln_f"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith(("bias", "lora_B")):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=self.generator)

    def attach_lora(self, rank, alpha=None, targets=None, generator=None):
        """Wrap the block projections with trainable LoRA factors
        (``targets`` defaults to :data:`GPT_LORA_TARGETS`); the fused
        ``c_attn`` wrap adapts q/k/v through one (h, 3h) residual. Returns
        self."""
        from ..nn.lora import attach_lora

        self.__dict__.pop("_gen_cache", None)
        return attach_lora(self, rank, alpha=alpha,
                           targets=targets or GPT_LORA_TARGETS,
                           generator=generator)

    def merge_lora(self, targets=None):
        """Fold the adapter deltas back into the base weights (the dense
        export). Returns self."""
        from ..nn.lora import merge_lora

        self.__dict__.pop("_gen_cache", None)
        return merge_lora(self, targets=targets or GPT_LORA_TARGETS)

    def _logits(self, h):
        return torch.matmul(h, self.transformer.wte.weight.t())

    def forward(self, input_ids):
        return self._logits(self.transformer(input_ids))

    def loss_fn(self, logits, labels):
        return F.cross_entropy(logits, labels, reduction="mean")

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 eos_token_id=None, num_beams: int = 1,
                 length_penalty: float = 0.0):
        """Fixed-cache generation (overrides the cacheless mixin loop):
        one prefill, then one decode step a token, as CUDA graph replays
        on the card; ``num_beams > 1`` runs the beam search. Returns int32
        (B, P + max_new_tokens) on the model's device."""
        from .generation import generate_with_caches

        cfg = self.cfg
        nh = cfg.num_attention_heads
        hd = cfg.hidden_size // nh
        n_layers = cfg.num_hidden_layers
        device = self.device
        model = self

        def make_caches(B, L):
            return [torch.zeros(B, L, nh, hd, dtype=cfg.torch_dtype,
                                device=device)
                    for _ in range(2 * n_layers)]

        def pairs(flat):
            return [(flat[2 * i], flat[2 * i + 1]) for i in range(n_layers)]

        def run_one(tok, flat, pos):
            h, _ = model.transformer.decode_step(tok, pairs(flat), pos)
            return model._logits(h)[:, 0]

        def prefill(prompt, flat):
            h, _ = model.transformer.prefill(prompt, pairs(flat))
            return model._logits(h[:, -1:])[:, 0]

        return generate_with_caches(
            self, input_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            eos_token_id=eos_token_id, num_beams=num_beams,
            length_penalty=length_penalty, make_caches=make_caches,
            run_one=run_one, prefill=prefill,
            max_positions=cfg.max_position_embeddings)
