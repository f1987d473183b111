"""Paged serving executor — port of ``paddle_tpu/inference/executor.py``
(single device): the device half of the engine/executor split.

``GenerationServer`` (serving.py) is the engine — request lifecycle,
scheduling, slot bookkeeping and harvest, all host-side numpy state.
:class:`PagedExecutor` owns what lives on the device: the per-layer K/V
block pools — ``(K, V)`` in the model dtype, or for ``kv_quant="int8"``
``(K codes, K scales, V codes, V scales)`` with int8 codes and one f32
scale per (block, KV head) — and the two programs of a step, one decode
tick (:meth:`decode_paged`, JAX ``_decode_paged_fn``) and one prefill chunk
(:meth:`chunk_prefill`, JAX ``_chunk_prefill_fn``). With LoRA, each program
takes the slots' adapter page indices and hands every layer the adapter
pool's factors at those pages (``AdapterPool.layer_factors``).

Where the JAX executor jit-compiles each program and donates the pools,
PyTorch runs eagerly and the model's paged methods write the pools in
place.

Under ``set_kernel_mode("megakernel")`` (``GenerationServer(kernels=
"megakernel")``) a decode tick runs every layer as one launch of the
whole-tick kernel (:meth:`_mk_window`, JAX ``_decode_megakernel_fn``), over
fp or int8 pools, with the slots' LoRA adapters read from the adapter
pool's pages; prefill chunks keep the per-layer kernels. The guard runs
once, at construction, and a configuration the kernel does not serve
raises there: unlike the JAX executor, nothing falls back to the per-layer
programs.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

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
        N, KV = int(num_blocks), cfg.num_key_value_heads
        shape = (N, engine.block_size, KV, cfg.head_dim)
        dev = engine.device
        if engine.kv_quant == "int8":
            def layer():
                return tuple(torch.zeros(sh, dtype=dt, device=dev)
                             for sh, dt in ((shape, torch.int8),
                                            ((N, KV), torch.float32)) * 2)
        else:
            def layer():
                return tuple(torch.zeros(shape, dtype=cfg.torch_dtype,
                                         device=dev) for _ in range(2))
        self.pools: List[Tuple[torch.Tensor, ...]] = [
            layer() for _ in range(cfg.num_hidden_layers)]
        self._flat_pools = [t for pool in self.pools for t in pool]

        # kernels="megakernel": the guard runs here, once; a rejection
        # raises (the JAX executor records it and falls back)
        self.megakernel = False
        self.megakernel_reason: Optional[str] = None
        self._mk_geometry = None
        self._mk_weights = None
        from .. import ops

        if ops.use_megakernel():
            from ..ops import decode_megakernel as mk

            geom = engine.mk_geometry or mk.MegakernelGeometry()
            lora = engine._lora
            reason = mk.megakernel_supported(
                engine.model, cfg, block_size=engine.block_size,
                geometry=geom, lora=lora is not None,
                kv_quant=engine.kv_quant,
                lora_rank=0 if lora is None else lora.max_rank)
            if reason is not None:
                self.megakernel_reason = reason
                raise ValueError(f"kernels='megakernel' cannot serve this "
                                 f"model: {reason}")
            mk.check_geometry(geom)
            self.megakernel = True
            self._mk_geometry = geom
            # pointers to the model's own weights: no second copy
            self._mk_weights = mk.stack_layer_weights(engine.model)

    def _lora(self, aidx):
        """Per-layer adapter factors at the page indices ``aidx`` (None
        without LoRA)."""
        pool = self.engine._lora
        return None if pool is None else pool.layer_factors(aidx)

    @torch.no_grad()
    def decode_paged(self, tokens, tables, pos, temps, topks, topps,
                     greedy: bool, generator, aidx=None):
        """One decode tick for every slot: tokens int (B,), tables int32
        (B, table_width) with zeroed rows for idle/prefilling slots, pos
        int32 (B,), ``aidx`` int32 (B,) the slots' adapter pages (LoRA
        only; 0 = no adapter). ``greedy`` promises every active row has
        temperature 0 (sampling reduces to an argmax and ``temps``/
        ``topks``/``topps``/``generator`` go unread). Returns the next
        tokens, int32 (1, B)."""
        model = self.engine.model
        if self.megakernel:
            h = self._mk_window(tokens[:, None], tables, pos, aidx)
        else:
            h, _ = model.model.paged_decode_step(tokens[:, None], self.pools,
                                                 tables, pos,
                                                 self._lora(aidx))
        lg = model.head(h)[:, 0].float()                 # (B, V)
        if greedy:
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        else:
            nxt = sample_token_rows(lg, generator, temps, topks, topps)
        return nxt[None]

    def _mk_window(self, window, tables, pos, aidx=None):
        """One W-token tick through the whole-tick kernel: embed →
        ``decode_tick`` (every layer, the pools written in place, the rows'
        adapters read at their pages ``aidx``) → final norm. window: int
        (B, W). Returns the normed hidden (B, W, hidden); the head stays
        outside, as in the JAX executor."""
        from ..ops import decode_megakernel as mk

        engine = self.engine
        m = engine.model.model
        self._mk_weights.check(engine.model)
        x = m.embed_tokens(window)
        cosr, sinr = mk.gather_rope_rows(m._cos, m._sin, pos,
                                         window.shape[1])
        lora = (None if engine._lora is None
                else mk.lora_tables(engine._lora, aidx))
        xo, _ = mk.decode_tick(x, self._flat_pools, tables, pos,
                               self._mk_weights, cosr, sinr,
                               block_size=engine.block_size,
                               geometry=self._mk_geometry,
                               eps=engine.cfg.rms_norm_eps, lora=lora)
        return m.norm(xo)

    @torch.no_grad()
    def chunk_prefill(self, chunk, table, start: int, last_idx: int,
                      aidx=None):
        """One prefill chunk: chunk int (1, C) right-padded; its K/V fill the
        slot's table from block-aligned ``start``; ``aidx`` int32 (1,) the
        slot's adapter page (LoRA only). Returns fp32 logits (1, V) at local
        index ``last_idx`` (the last real prompt token on the final chunk;
        unused on earlier chunks)."""
        model = self.engine.model
        h, _ = model.model.paged_prefill_chunk(chunk, self.pools, table,
                                               start, self._lora(aidx))
        last = h[:, last_idx:last_idx + 1]
        return model.head(last)[:, 0].float()
