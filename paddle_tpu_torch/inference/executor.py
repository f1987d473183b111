"""Serving executors — port of ``paddle_tpu/inference/executor.py``
(single device) and of the JAX dense server's programs: the device half of
the engine/executor split.

``GenerationServer`` (serving.py) is the engine — request lifecycle,
scheduling, slot bookkeeping and harvest, all host-side numpy state.
:class:`PagedExecutor` owns what lives on the device: the per-layer K/V
block pools — ``(K, V)`` in the model dtype, or for ``kv_quant="int8"``
``(K codes, K scales, V codes, V scales)`` with int8 codes and one f32
scale per (block, KV head) — and the programs of a step: a decode window
of ``ticks`` ticks (:meth:`decode_paged`, JAX ``_decode_paged_fn``), one
prefill chunk (:meth:`chunk_prefill`, JAX ``_chunk_prefill_fn``) and, on
a speculative server, one verify window of W = k+1 tokens a row with a
host-side drafter's drafts (:meth:`spec_verify`, JAX ``_spec_verify_fn``)
or S windows of device-side drafting, verify and acceptance
(:meth:`spec_scan`, JAX ``_spec_scan_fn``).
With LoRA, each program takes the slots' adapter page indices and hands
every layer the adapter pool's factors at those pages
(``AdapterPool.layer_factors``).

Where the JAX executor jit-compiles each program over donated pools, this
one, on a CUDA device, captures each program in a CUDA graph at its first
use and replays it: one graph per decode key ``(greedy, ticks)`` (JAX's
static arguments), one for every prefill chunk, whose ``start`` and
``last_idx`` are device scalars (as JAX traces them), and one per
speculative key ``("spec_verify", greedy)`` or ``("spec_scan", greedy,
S)``. A graph reads the
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

:class:`DenseExecutor` is the device half of ``cache="dense"`` (the
JAX server's ``_decode_fn`` and ``_prefill``): a fixed slab of
``2·L`` caches (max_batch, max_len, KV, D), one row a slot; a decode
window as one CUDA graph per ``(greedy, ticks)`` (every slot through
``decode_step`` at its own position, ``pos + active`` a tick so that idle
slots do not drift); and a prefill per prompt bucket as one graph: the
bucket-padded prompt through ``prefill`` into zeroed single-row caches,
the logits read at ``true_len - 1`` (device scalars), and the whole row
copied into the slot's row of the slab (``index_copy_`` at a device
slot), zeros past the bucket, as JAX's ``pool.at[slot].set(row)``. Its
warm-ups run on the pass's own inputs, not zeroed ones: the dense slab has
no scratch block, and a prefill's warm-up writes the very row its replay
then rewrites, a decode window's the values its replay writes again.

The executor serves the weights the model held when it was built: a graph
reads them by address, and so does the megakernel's weight table.
:meth:`check_weights`, which the server runs once after each submit and
at each ``run()``, raises when one was replaced since (``quantize_int8``,
``.to()``, a new ``Parameter``); an update in place is served.

Under ``set_kernel_mode("megakernel")`` (``GenerationServer(kernels=
"megakernel")``) each decode tick runs every layer as one launch of the
whole-tick kernel (:meth:`_mk_window`, JAX ``_decode_megakernel_fn``), over
fp or int8 pools, with the slots' LoRA adapters read from the adapter
pool's pages, and so does each verify window, at W = k+1 (JAX
``_spec_verify_megakernel_fn``, ``_spec_scan_megakernel_fn``); prefill
chunks keep the per-layer kernels. The guard runs
once, at construction, and a configuration the kernel does not serve
raises there: unlike the JAX executor, nothing falls back to the per-layer
programs.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from .. import graphs
from ..models.generation import sample_token_rows

__all__ = ["DenseExecutor", "PagedExecutor", "capture_graph"]


def _scheduled(fn):
    """Run an executor pass under its server's resolved kernel schedules
    (``engine.kernel_geometry``, see ``ops.kernel_geometry``): the eager
    pass, a capture's warm-up and the capture itself all see them, so a
    replay runs what the eager twin ran."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        from .. import ops

        with ops.kernel_geometry(getattr(self.engine, "kernel_geometry",
                                         None)):
            return fn(self, *args, **kwargs)
    return run


class _GraphPrograms:
    """What both executors share: the programs' graphs by key (captured at
    a key's first use), their shared memory pool, the capture and replay
    counters, and the check that the model's weights are those the graphs
    read. A subclass sets ``engine``, ``graphs``, ``_graphs``,
    ``_graph_pool``, ``captures``, ``replays`` and ``_weights``."""

    def check_weights(self) -> None:
        """Raise RuntimeError when a tensor of the model (a parameter or a
        buffer) is no longer the one, at the address, the executor was
        built over: a graph would read stale memory."""
        if _weights_key(self.engine.model) != self._weights:
            raise RuntimeError("the model's weights were replaced after the "
                               "server was built: build a new server for "
                               "the changed model")

    def _program(self, key, body, inputs, generator, zero: bool = True):
        """The captured graph of ``key`` (captured now at its first use,
        warmed up over zeroed ``inputs`` or, with ``zero=False``, over the
        ones copied in), or None where the pass runs eagerly (see the
        module docstring)."""
        from .. import ops

        if not self.graphs or ops.kernel_mode() == "reference":
            return None
        prog = self._graphs.get(key)
        if prog is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            prog = self._graphs[key] = capture_graph(
                body, inputs, generator, self.engine.device,
                self._graph_pool, zero=zero)
            self.captures += 1
        elif prog.generators != (() if generator is None else (generator,)):
            raise ValueError("a sampled window's graph draws from the "
                             "generator it was captured with")
        return prog

    def _replay(self, prog, kind: str):
        self.replays[kind] += 1
        return prog.replay()

    def close(self) -> None:
        """Drop the graphs, their memory pool and the device state the
        passes read (pools, slabs, static buffers): the executor serves
        nothing after this."""
        self._graphs.clear()
        self._graph_pool = None
        for name in ("pools", "_flat_pools", "slab", "caches", "_row",
                     "_dec", "_chk", "_pre", "_mk_weights"):
            if name in self.__dict__:
                setattr(self, name, None)


class PagedExecutor(_GraphPrograms):
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
            # a verify window is a tick of k+1 tokens a row
            window = 1 if engine.spec is None else engine.spec_k + 1
            reason = mk.megakernel_supported(
                engine.model, cfg, block_size=engine.block_size,
                geometry=geom, lora=lora is not None,
                kv_quant=engine.kv_quant,
                lora_rank=0 if lora is None else lora.max_rank,
                rows=engine.max_batch * window)
            if reason is not None:
                self.megakernel_reason = reason
                raise ValueError(f"kernels='megakernel' cannot serve this "
                                 f"model: {reason}")
            if dev.type == "cuda":
                mk.check_geometry(geom, intermediate=cfg.intermediate_size,
                                  rows=engine.max_batch * window)
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
        if engine.spec is not None:
            # the speculative programs read the decode window's buffers and
            # these (every pass copies in what its program reads)
            k = engine.spec_k
            self._dec.update(proposals=zeros(B, k), kcaps=zeros(B),
                             ctx=zeros(B, engine.max_len))
            if not engine.drafter.deterministic:
                self._dec["qprobs"] = zeros(B, k, cfg.vocab_size,
                                            dtype=torch.float32)
        self._chk = dict(chunk=zeros(1, engine.prefill_chunk),
                         table=zeros(TW), start=zeros(1), last_idx=zeros(1),
                         aidx=zeros(1))
        self.graphs = dev.type == "cuda"
        self._graphs = {}
        self._graph_pool = None
        self.captures = 0
        self.replays = {"decode": 0, "chunk": 0, "spec": 0}

    def check_weights(self) -> None:
        """As :meth:`_GraphPrograms.check_weights`, and the megakernel's
        weight table too."""
        if self._mk_weights is not None:
            self._mk_weights.check(self.engine.model)
        super().check_weights()

    def clear_blocks(self, bids) -> None:
        """Zero the int8 codes and scales of blocks ``bids`` in every
        layer's pool, in place. A decode or verify write requantizes its
        whole block, unwritten rows included, so a reused block's stale
        rows would make a request's K/V depend on which request held the
        block before (and a swapped request's resume on the allocation
        history); a cleared block gives the same codes whatever its past.
        fp pools need no clearing (their writes do not rescale)."""
        if not bids or self.engine.kv_quant != "int8":
            return
        idx = torch.tensor(list(bids), dtype=torch.long,
                           device=self._flat_pools[0].device)
        for t in self._flat_pools:
            t.index_fill_(0, idx, 0)

    def _lora(self, aidx):
        """Per-layer adapter factors at the page indices ``aidx`` (None
        without LoRA)."""
        pool = self.engine._lora
        return None if pool is None else pool.layer_factors(aidx)

    # ------------------------------------------------------------- programs
    @_scheduled
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
        lora = self._window_lora(b["aidx"])
        toks, p, out = b["tokens"], b["pos"], []
        for _ in range(ticks):
            lg = self._window_logits(toks[:, None], b["tables"], p,
                                     lora)[:, 0]          # (B, V)
            if greedy:
                toks = torch.argmax(lg, dim=-1).to(torch.int32)
            else:
                toks = sample_token_rows(lg, generator, b["temps"],
                                         b["topks"], b["topps"])
            out.append(toks)
            p = p + b["active"]
        return torch.stack(out)

    def _window_lora(self, aidx):
        """The rows' adapters in the form the window's forward takes: the
        whole-tick kernel's ``mk.lora_tables``, or the per-layer factors
        (None without LoRA); taken once a program."""
        if self.engine._lora is None:
            return None
        if self.megakernel:
            from ..ops import decode_megakernel as mk

            return mk.lora_tables(self.engine._lora, aidx)
        return self._lora(aidx)

    def _window_logits(self, window, tables, pos, lora):
        """fp32 logits (B, W, V) of a window of W tokens a row at positions
        ``pos + arange(W)``, its K/V written into the pools: one whole-tick
        launch, or the per-layer forwards (``paged_verify_step``), then
        the head, batch-invariant (``stream=True``): a row's logits do not
        depend on the window's width or on the other rows."""
        model = self.engine.model
        if self.megakernel:
            h = self._mk_window(window, tables, pos, lora)
        else:
            h, _ = model.model.paged_verify_step(window, self.pools, tables,
                                                 pos, lora)
        return model.head(h, stream=True).float()

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

    @_scheduled
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

    @_scheduled
    @torch.no_grad()
    def spec_verify(self, tokens, proposals, tables, pos, temps, topks,
                    topps, kcaps, generator, qprobs=None, aidx=None,
                    greedy: bool = False):
        """One speculative window with a host-side drafter's drafts (JAX
        ``_spec_verify_fn``): the window [current token, k drafts] through
        the verify forward, the head, then :func:`~.speculative.
        speculative_accept`. tokens int32 (B,); proposals int32 (B, k);
        tables, pos, temps, topks, topps, aidx as in :meth:`decode_paged`;
        kcaps int32 (B,) the rows' draft budgets (0 on idle and
        prefilling rows); qprobs fp32 (B, k, V) from a sampling drafter
        (None: one-hot). Returns (out int32 (B, k+1), acc int32 (B,)),
        the program's static outputs."""
        buf = self._dec
        with_q = qprobs is not None
        gen = None if greedy else generator
        body = functools.partial(self._spec_window, bool(greedy), gen,
                                 with_q)
        prog = self._program(("spec_verify", bool(greedy)), body, buf, gen)
        inputs = dict(tokens=tokens, proposals=proposals, tables=tables,
                      pos=pos, kcaps=kcaps, aidx=aidx,
                      qprobs=qprobs if with_q else None)
        if not greedy:
            inputs.update(temps=temps, topks=topks, topps=topps)
        _copy_in(buf, inputs)
        return body() if prog is None else self._replay(prog, "spec")

    def _spec_window(self, greedy: bool, generator, with_q: bool):
        """The verify program over the static inputs."""
        from .speculative import speculative_accept

        b = self._dec
        window = torch.cat([b["tokens"][:, None], b["proposals"]], dim=1)
        lg = self._window_logits(window, b["tables"], b["pos"],
                                 self._window_lora(b["aidx"]))
        return speculative_accept(lg, b["proposals"], b["temps"], b["topks"],
                                  b["topps"], b["kcaps"], generator,
                                  b["qprobs"] if with_q else None,
                                  greedy=greedy)

    @_scheduled
    @torch.no_grad()
    def spec_scan(self, ctx, tables, pos, temps, topks, topps, kcaps, active,
                  generator, aidx=None, greedy: bool = False,
                  windows: int = 1):
        """``windows`` speculative windows as one program, the drafter on
        the device (JAX ``_spec_scan_fn``; ``drafter.propose_device``):
        draft, verify, accept, then the emitted tokens appended to the
        context and the positions advanced, window after window. ctx int32
        (B, max_len): row b's prompt and generated tokens through index
        ``pos[b]``; ``active`` int32 (B,), 1 on decoding rows; the rest as
        in :meth:`spec_verify`. Tokens past a request's end are discarded
        by the host. Returns (outs int32 (windows, B, k+1), accs int32
        (windows, B))."""
        windows = int(windows)
        if windows < 1:
            raise ValueError(f"windows must be >= 1, got {windows}")
        buf = self._dec
        gen = None if greedy else generator
        body = functools.partial(self._spec_scan, bool(greedy), gen, windows)
        prog = self._program(("spec_scan", bool(greedy), windows), body, buf,
                             gen)
        inputs = dict(ctx=ctx, tables=tables, pos=pos, kcaps=kcaps,
                      active=active, aidx=aidx)
        if not greedy:
            inputs.update(temps=temps, topks=topks, topps=topps)
        _copy_in(buf, inputs)
        return body() if prog is None else self._replay(prog, "spec")

    def _spec_scan(self, greedy: bool, generator, windows: int):
        """The fused speculative program over the static inputs; the
        context buffer is updated in place (each pass copies it in
        anew)."""
        from .speculative import speculative_accept

        engine = self.engine
        b = self._dec
        k = engine.spec_k
        W = k + 1
        c = b["ctx"]
        L = c.shape[1]
        dev = c.device
        wpos = torch.arange(W, device=dev)[None, :]
        live = (b["active"] > 0)[:, None]
        lora = self._window_lora(b["aidx"])
        p = b["pos"]
        outs, accs = [], []
        for _ in range(windows):
            cur = torch.gather(c, 1, p.long()[:, None])            # (B, 1)
            proposals = engine.drafter.propose_device(c, p, k)
            window = torch.cat([cur, proposals], dim=1)
            lg = self._window_logits(window, b["tables"], p, lora)
            out, acc = speculative_accept(lg, proposals, b["temps"],
                                          b["topks"], b["topps"], b["kcaps"],
                                          generator, None, greedy=greedy)
            # the emitted tokens appended to the context for the next
            # window's drafts; writes clamped at L - 1 touch only rows the
            # harvest releases
            widx = torch.clamp(p.long()[:, None] + 1 + wpos, max=L - 1)
            keep = (wpos <= acc[:, None]) & live
            c.scatter_(1, widx, torch.where(keep, out,
                                            torch.gather(c, 1, widx)))
            # clamped: only surplus windows past max_len (discarded by the
            # harvest) reach L - 1; without it the ``cur`` gather reads out
            # of bounds and a garbage token's K/V written to scratch block
            # 0 poisons every row whose table padding points there
            p = torch.clamp(p + (acc + 1) * b["active"], max=L - 1)
            outs.append(out)
            accs.append(acc)
        return torch.stack(outs), torch.stack(accs)

class DenseExecutor(_GraphPrograms):
    """Owns the dense slab and the programs of a ``cache="dense"`` engine
    (see the module docstring)."""

    def __init__(self, engine):
        self.engine = engine
        cfg = engine.cfg
        dev = engine.device
        B, L = engine.max_batch, engine.max_len
        shape = (cfg.num_key_value_heads, cfg.head_dim)
        n = 2 * cfg.num_hidden_layers

        def zeros(*sh, dtype=cfg.torch_dtype):
            return torch.zeros(sh, dtype=dtype, device=dev)

        self.slab = [zeros(B, L, *shape) for _ in range(n)]
        self.caches = [(self.slab[2 * i], self.slab[2 * i + 1])
                       for i in range(cfg.num_hidden_layers)]
        # the prefill's single-row caches, copied whole into a slot's row
        self._row = [zeros(1, L, *shape) for _ in range(n)]
        self._weights = _weights_key(engine.model)
        i32 = torch.int32
        self._dec = dict(tokens=zeros(B, dtype=i32), pos=zeros(B, dtype=i32),
                         active=zeros(B, dtype=i32),
                         temps=zeros(B, dtype=torch.float32),
                         topks=zeros(B, dtype=i32),
                         topps=zeros(B, dtype=torch.float32))
        self._pre = {
            b: dict(prompt=zeros(1, b, dtype=i32),
                    true_len=zeros(1, dtype=torch.long),
                    slot=zeros(1, dtype=torch.long))
            for b in engine.buckets}
        self.graphs = dev.type == "cuda"
        self._graphs = {}
        self._graph_pool = None
        self.captures = 0
        self.replays = {"decode": 0, "prefill": 0}

    @_scheduled
    @torch.no_grad()
    def decode_dense(self, tokens, pos, temps, topks, topps, active,
                     generator, greedy: bool = False, ticks: int = 1):
        """A decode window of ``ticks`` ticks for every slot as one program
        (JAX ``_decode_fn``): each tick writes every row's K/V at its
        position, samples its next token (an argmax when ``greedy``) and
        advances ``pos`` by ``active``. tokens / pos / active int32 (B,);
        temps / topps float32, topks int32 (B,), read unless ``greedy``.
        Returns the window's tokens, int32 (ticks, B)."""
        ticks = int(ticks)
        if ticks < 1:
            raise ValueError(f"ticks must be >= 1, got {ticks}")
        buf = self._dec
        inputs = dict(tokens=tokens, pos=pos, active=active)
        if not greedy:
            inputs.update(temps=temps, topks=topks, topps=topps)
        _copy_in(buf, inputs)
        gen = None if greedy else generator
        body = functools.partial(self._decode_window, bool(greedy), ticks,
                                 gen)
        prog = self._program(("decode", bool(greedy), ticks), body, buf, gen,
                             zero=False)
        return body() if prog is None else self._replay(prog, "decode")

    def _decode_window(self, greedy: bool, ticks: int, generator):
        b = self._dec
        model = self.engine.model
        toks, p, out = b["tokens"], b["pos"], []
        for _ in range(ticks):
            h, _ = model.model.decode_step(toks[:, None], self.caches, p)
            lg = model.head(h, stream=True)[:, 0].float()     # (B, V)
            if greedy:
                toks = torch.argmax(lg, dim=-1).to(torch.int32)
            else:
                toks = sample_token_rows(lg, generator, b["temps"],
                                         b["topks"], b["topps"])
            out.append(toks)
            p = p + b["active"]
        return torch.stack(out)

    @_scheduled
    @torch.no_grad()
    def prefill_dense(self, bucket: int, prompt, true_len, slot):
        """One prompt's prefill and slot scatter as one program a bucket
        (JAX ``_prefill``): prompt int32 (1, bucket) right-padded;
        ``true_len`` and ``slot`` int tensors (1,) (host or device) or
        ints. Returns fp32 logits (1, V) at ``true_len - 1``."""
        buf = self._pre[int(bucket)]
        _copy_in(buf, dict(prompt=prompt, true_len=true_len, slot=slot))
        body = functools.partial(self._prefill, int(bucket))
        prog = self._program(("prefill", int(bucket)), body, buf, None,
                             zero=False)
        return body() if prog is None else self._replay(prog, "prefill")

    def _prefill(self, bucket: int):
        b = self._pre[bucket]
        model = self.engine.model
        for r in self._row:
            r.zero_()
        rows = [(self._row[2 * i], self._row[2 * i + 1])
                for i in range(len(self._row) // 2)]
        h, _ = model.model.prefill(b["prompt"], rows)
        last = torch.index_select(h, 1, b["true_len"] - 1)  # (1, 1, hidden)
        lg = model.head(last)[:, 0].float()
        for slab, row in zip(self.slab, self._row):
            slab.index_copy_(0, b["slot"], row)
        return lg


def capture_graph(body, inputs, generator, device, pool=None,
                  zero: bool = True):
    """Warm ``body`` up eagerly on a side stream over zeroed ``inputs`` (a
    dict of its static input tensors: a pool write lands in scratch block
    0; ``zero=False`` keeps the values copied in; a generator's state is
    restored after), then capture it into a CUDA graph (``graphs.capture``,
    in ``pool`` when given) that draws from ``generator`` (None: none). The
    warm-up counts no launch; the capture's are taken back and added at
    each replay."""
    from .. import ops

    if zero:
        for t in inputs.values():
            t.zero_()
    state = None if generator is None else generator.get_state()
    with ops.captured_launches():
        graphs.warm_up(body, device)
    if generator is not None:
        generator.set_state(state)
    return graphs.capture(body, () if generator is None else (generator,),
                          pool)


def _weights_key(model) -> tuple:
    """Each parameter's and buffer's address, dtype and shape."""
    return graphs.weights_key(model.parameters(), model.buffers())


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
