"""Paged serving executor — port of ``paddle_tpu/inference/executor.py``
(single device): the device half of the engine/executor split.

``GenerationServer`` (serving.py) is the engine — request lifecycle,
scheduling, slot bookkeeping and harvest, all host-side numpy state.
:class:`PagedExecutor` owns what lives on the device: the per-layer K/V
block pools — ``(K, V)`` in the model dtype, or for ``kv_quant="int8"``
``(K codes, K scales, V codes, V scales)`` with int8 codes and one f32
scale per (block, KV head) — and the two programs of a step: a decode
window of ``ticks`` ticks (:meth:`decode_paged`, JAX ``_decode_paged_fn``)
and one prefill chunk (:meth:`chunk_prefill`, JAX ``_chunk_prefill_fn``).
With LoRA, each program takes the slots' adapter page indices and hands
every layer the adapter pool's factors at those pages
(``AdapterPool.layer_factors``).

Where the JAX executor jit-compiles each program over donated pools, this
one, on a CUDA device, captures each program in a CUDA graph at its first
use and replays it: one graph per decode key ``(greedy, ticks)`` (JAX's
static arguments) and one for every prefill chunk, whose ``start`` and
``last_idx`` are device scalars (as JAX traces them). A graph reads the
executor's static input buffers, into which each pass copies its inputs,
and writes static outputs, which the pass returns: they hold until the
next pass. The pools, the weights, the rope tables and the adapter pool's
pages never move, so the graphs read them by address; the model's paged
methods write the pools in place. Before a key's capture, one eager
warm-up run on a side stream, with every input zeroed so that its writes
land in scratch block 0, encodes the megakernel's weight maps and
creates the libraries' handles. The graphs share one memory pool (they
never run concurrently). A capture counts no launch; each replay adds
the launches it captured to the kernels' counters
(``ops.captured_launches``), so the counts equal an eager run's. A sampled
window's graph draws from the server's generator, registered with it
(``CUDAGraph.register_generator_state``), so that each replay advances it.

A pass runs eagerly instead only by rule: on the CPU (the same buffer
code, with no graph), under ``set_kernel_mode("reference")`` (the plain
versions: chip_smoke's yardstick, not a serving path), and with
``graphs`` set to False (a measurement switch).

The executor serves the weights the model held when it was built: a graph
reads them by address, and so does the megakernel's weight table.
:meth:`check_weights`, which the server runs once after each submit and
at each ``run()``, raises when one was replaced since (``quantize_int8``,
``.to()``, a new ``Parameter``); an update in place is served.

Under ``set_kernel_mode("megakernel")`` (``GenerationServer(kernels=
"megakernel")``) each decode tick runs every layer as one launch of the
whole-tick kernel (:meth:`_mk_window`, JAX ``_decode_megakernel_fn``), over
fp or int8 pools, with the slots' LoRA adapters read from the adapter
pool's pages; prefill chunks keep the per-layer kernels. The guard runs
once, at construction, and a configuration the kernel does not serve
raises there: unlike the JAX executor, nothing falls back to the per-layer
programs.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
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
        self._weights = _weights_key(engine.model)

        # the programs' static inputs (a pass copies its inputs in), their
        # graphs by key and the graphs' shared memory pool
        B, TW = engine.max_batch, engine._table_width

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._dec = dict(tokens=zeros(B), tables=zeros(B, TW), pos=zeros(B),
                         active=zeros(B), aidx=zeros(B),
                         temps=zeros(B, dtype=torch.float32), topks=zeros(B),
                         topps=zeros(B, dtype=torch.float32))
        self._chk = dict(chunk=zeros(1, engine.prefill_chunk),
                         table=zeros(TW), start=zeros(1), last_idx=zeros(1),
                         aidx=zeros(1))
        self.graphs = dev.type == "cuda"
        self._graphs = {}
        self._graph_pool = None
        self.captures = 0
        self.replays = {"decode": 0, "chunk": 0}

    def check_weights(self) -> None:
        """Raise RuntimeError when a tensor of the model (a parameter or a
        buffer) is no longer the one, at the address, the executor was
        built over: a graph or the megakernel would read stale memory."""
        model = self.engine.model
        if self._mk_weights is not None:
            self._mk_weights.check(model)
        if _weights_key(model) != self._weights:
            raise RuntimeError("the model's weights were replaced after the "
                               "server was built: build a new server for "
                               "the changed model")

    def _lora(self, aidx):
        """Per-layer adapter factors at the page indices ``aidx`` (None
        without LoRA)."""
        pool = self.engine._lora
        return None if pool is None else pool.layer_factors(aidx)

    # ------------------------------------------------------------- programs
    @torch.no_grad()
    def decode_paged(self, tokens, tables, pos, temps, topks, topps, active,
                     generator, aidx=None, greedy: bool = False,
                     ticks: int = 1):
        """A decode window of ``ticks`` ticks for every slot, as one
        program: each tick samples every row's next token (an argmax when
        ``greedy``) and feeds it to the next tick, and advances ``pos`` by
        ``active`` on the device. tokens int32 (B,); tables int32 (B,
        table_width) with zeroed rows for idle/prefilling slots; pos int32
        (B,) (0 on those rows); ``active`` int32 (B,), 1 on decoding rows;
        ``aidx`` int32 (B,) the slots' adapter pages (LoRA only; 0 = no
        adapter). ``greedy`` promises every active row has temperature 0
        (sampling reduces to an argmax and ``temps``/``topks``/``topps``/
        ``generator`` go unread). The inputs may live on the host (pinned)
        or on the device: they are copied into the program's buffers.
        Returns the window's tokens, int32 (ticks, B)."""
        ticks = int(ticks)
        if ticks < 1:
            raise ValueError(f"ticks must be >= 1, got {ticks}")
        buf = self._dec
        body = functools.partial(self._decode_window, bool(greedy), ticks,
                                 None if greedy else generator)
        prog = self._program(("decode", bool(greedy), ticks), body, buf,
                             None if greedy else generator)
        inputs = dict(tokens=tokens, tables=tables, pos=pos, active=active,
                      aidx=aidx)
        if not greedy:
            inputs.update(temps=temps, topks=topks, topps=topps)
        _copy_in(buf, inputs)
        return body() if prog is None else self._replay(prog, "decode")

    def _decode_window(self, greedy: bool, ticks: int, generator):
        """The decode program over the static inputs (JAX
        ``_decode_paged_fn`` and ``_decode_megakernel_fn``): the adapter
        factors are taken once a window; ``ticks`` ticks, each through the
        per-layer forwards or one whole-tick launch, then the head and the
        sampling; returns the (ticks, B) stack."""
        b = self._dec
        model = self.engine.model
        if self.megakernel:
            from ..ops import decode_megakernel as mk

            lora = (None if self.engine._lora is None
                    else mk.lora_tables(self.engine._lora, b["aidx"]))
        else:
            lora = self._lora(b["aidx"])
        toks, p, out = b["tokens"], b["pos"], []
        for _ in range(ticks):
            if self.megakernel:
                h = self._mk_window(toks[:, None], b["tables"], p, lora)
            else:
                h, _ = model.model.paged_decode_step(toks[:, None],
                                                     self.pools, b["tables"],
                                                     p, lora)
            lg = model.head(h)[:, 0].float()             # (B, V)
            if greedy:
                toks = torch.argmax(lg, dim=-1).to(torch.int32)
            else:
                toks = sample_token_rows(lg, generator, b["temps"],
                                         b["topks"], b["topps"])
            out.append(toks)
            p = p + b["active"]
        return torch.stack(out)

    def _mk_window(self, window, tables, pos, lora=None):
        """One W-token tick through the whole-tick kernel: embed →
        ``decode_tick`` (every layer, the pools written in place, the rows'
        adapters read through ``lora``, ``mk.lora_tables``) → final norm.
        window: int (B, W). Returns the normed hidden (B, W, hidden); the
        head stays outside, as in the JAX executor."""
        from ..ops import decode_megakernel as mk

        engine = self.engine
        m = engine.model.model
        x = m.embed_tokens(window)
        cosr, sinr = mk.gather_rope_rows(m._cos, m._sin, pos,
                                         window.shape[1])
        xo, _ = mk.decode_tick(x, self._flat_pools, tables, pos,
                               self._mk_weights, cosr, sinr,
                               block_size=engine.block_size,
                               geometry=self._mk_geometry,
                               eps=engine.cfg.rms_norm_eps, lora=lora)
        return m.norm(xo)

    @torch.no_grad()
    def chunk_prefill(self, chunk, table, start, last_idx, aidx=None):
        """One prefill chunk, one program for every chunk: chunk int (1, C)
        right-padded; its K/V fill the slot's table from ``start``, which
        the caller has checked is block-aligned; ``aidx`` int32 (1,) the
        slot's adapter page (LoRA only). ``start`` and ``last_idx`` are
        int32 (1,) tensors (host or device) or ints, copied into the
        program's device scalars. Returns fp32 logits (1, V) at local index
        ``last_idx`` (the last real prompt token on the final chunk; unused
        on earlier chunks), selected on the device."""
        buf = self._chk
        prog = self._program(("chunk",), self._chunk, buf, None)
        _copy_in(buf, dict(chunk=chunk, table=table, start=start,
                           last_idx=last_idx, aidx=aidx))
        return self._chunk() if prog is None else self._replay(prog, "chunk")

    def _chunk(self):
        """The prefill program over the static inputs (JAX
        ``_chunk_prefill_fn``)."""
        b = self._chk
        model = self.engine.model
        h, _ = model.model.paged_prefill_chunk(b["chunk"], self.pools,
                                               b["table"], b["start"],
                                               self._lora(b["aidx"]))
        last = torch.index_select(h, 1, b["last_idx"])     # (1, 1, hidden)
        return model.head(last)[:, 0].float()

    # --------------------------------------------------------------- graphs
    def _program(self, key, body, inputs, generator):
        """The captured graph of ``key`` (captured now at its first use),
        or None where the pass runs eagerly (see the module docstring)."""
        from .. import ops

        if not self.graphs or ops.kernel_mode() == "reference":
            return None
        prog = self._graphs.get(key)
        if prog is None:
            prog = self._graphs[key] = self._capture(body, inputs, generator)
        elif prog.generator is not generator:
            raise ValueError("a sampled window's graph draws from the "
                             "generator it was captured with")
        return prog

    def _capture(self, body, inputs, generator):
        """Warm ``body`` up eagerly on a side stream over zeroed inputs (its
        writes land in scratch block 0; a generator's state is restored
        after), then capture it into a graph in the executor's pool."""
        from .. import ops

        dev = self.engine.device
        for t in inputs.values():
            t.zero_()
        state = None if generator is None else generator.get_state()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), ops.captured_launches():
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        if generator is not None:
            generator.set_state(state)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with ops.captured_launches() as launches:
            with torch.cuda.graph(graph, pool=self._graph_pool):
                out = body()
        self.captures += 1
        return _Graph(graph, out, launches, generator)

    def _replay(self, prog, kind: str):
        from .. import ops

        prog.graph.replay()
        ops.add_launch_counts(prog.launches)
        self.replays[kind] += 1
        return prog.out


@dataclasses.dataclass
class _Graph:
    """One captured program: the graph, its static output, the launches
    one replay makes ({kernel: launches}) and the generator it draws from
    (None: greedy)."""

    graph: object
    out: torch.Tensor
    launches: dict
    generator: object


def _weights_key(model) -> tuple:
    """Each parameter's and buffer's address, dtype and shape."""
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape))
                 for t in itertools.chain(model.parameters(),
                                          model.buffers()))


def _copy_in(buffers, values) -> None:
    """Copy each given value (a tensor, host or device, or a number) into
    its static buffer; a value of None leaves the buffer as it is."""
    for name, v in values.items():
        if v is None:
            continue
        dst = buffers[name]
        if isinstance(v, torch.Tensor):
            dst.copy_(v.reshape(dst.shape), non_blocking=True)
        else:
            dst.fill_(v)
