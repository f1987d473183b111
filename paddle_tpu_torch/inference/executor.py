"""Paged serving executor — port of ``paddle_tpu/inference/executor.py``
(single device): the device half of the engine/executor split.

``GenerationServer`` (serving.py) is the engine — request lifecycle,
scheduling, slot bookkeeping and harvest, all host-side numpy state.
:class:`PagedExecutor` owns what lives on the device: the per-layer K/V
block pools and the two programs of a step, one decode tick
(:meth:`decode_paged`, JAX ``_decode_paged_fn``) and one prefill chunk
(:meth:`chunk_prefill`, JAX ``_chunk_prefill_fn``).

Where the JAX executor jit-compiles each program and donates the pools,
PyTorch runs eagerly and the model's paged methods write the pools in
place.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..models.generation import sample_token_rows

__all__ = ["PagedExecutor"]


class PagedExecutor:
    """Owns the paged device state for one engine. ``engine`` is the owning
    :class:`~.serving.GenerationServer`; only its construction-time
    configuration is read here."""

    def __init__(self, engine, num_blocks: int):
        self.engine = engine
        cfg = engine.cfg
        shape = (int(num_blocks), engine.block_size, cfg.num_key_value_heads,
                 cfg.head_dim)
        kw = dict(dtype=cfg.torch_dtype, device=engine.device)
        self.pools: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (torch.zeros(shape, **kw), torch.zeros(shape, **kw))
            for _ in range(cfg.num_hidden_layers)]

    @torch.no_grad()
    def decode_paged(self, tokens, tables, pos, temps, topks, topps,
                     greedy: bool, generator):
        """One decode tick for every slot: tokens int (B,), tables int32
        (B, table_width) with zeroed rows for idle/prefilling slots, pos
        int32 (B,). ``greedy`` promises every active row has temperature 0
        (sampling reduces to an argmax and ``temps``/``topks``/``topps``/
        ``generator`` go unread). Returns the next tokens, int32 (1, B)."""
        model = self.engine.model
        h, _ = model.model.paged_decode_step(tokens[:, None], self.pools,
                                             tables, pos)
        lg = model.head(h)[:, 0].float()                 # (B, V)
        if greedy:
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        else:
            nxt = sample_token_rows(lg, generator, temps, topks, topps)
        return nxt[None]

    @torch.no_grad()
    def chunk_prefill(self, chunk, table, start: int, last_idx: int):
        """One prefill chunk: chunk int (1, C) right-padded; its K/V fill the
        slot's table from block-aligned ``start``. Returns fp32 logits
        (1, V) at local index ``last_idx`` (the last real prompt token on the
        final chunk; unused on earlier chunks)."""
        model = self.engine.model
        h, _ = model.model.paged_prefill_chunk(chunk, self.pools, table,
                                               start)
        last = h[:, last_idx:last_idx + 1]
        return model.head(last)[:, 0].float()
