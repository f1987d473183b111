"""Continuous-batching generation server — port of
``paddle_tpu/inference/serving.py`` for ``cache="paged"``.

A FIXED set of ``max_batch`` slots shares one pool of fixed-size KV blocks
(inference/paged_cache.py) through per-slot block tables. Each
:meth:`GenerationServer.step` admits waiting requests in FIFO order (gated
on block headroom), advances ONE prefill chunk per prefilling slot (chunked
prefill: a long prompt never stalls the slots that are decoding), then runs
one decode tick for every decoding slot; finished slots are released and
refilled mid-flight. Full prompt blocks are content-hashed and
refcount-shared, so a repeated prefix prefills once (prefix caching).
Greedy outputs are token-identical to the JAX server's on the same weights
(up to floating-point ties).

``kv_quant="int8"`` stores the KV pool as int8 codes with one f32 scale per
(block, KV head): half the bytes of bf16, so a ``pool_bytes=`` budget holds
about twice the blocks. ``lora=LoRAConfig(...)`` serves many LoRA adapters
over one base model: a request names its adapter at ``submit(...,
adapter=)``, its slot holds a page of the adapter pool (inference/lora.py)
while it runs, and every projection adds the slot's adapter delta. Unlike
the JAX server, the prefix cache keys a request's blocks by its adapter
too: with adapters on the K/V projections a block's contents depend on the
adapter, and the JAX server, which hashes tokens only, shares blocks
across adapters (a fault of the reference).

``kernels="megakernel"`` runs each decode tick as ONE launch of the
whole-tick CUDA kernel (ops/decode_megakernel.py), over fp or
``kv_quant="int8"`` pools, with or without ``lora=``; prefill chunks keep
the per-layer kernels. A configuration it does not serve (an int8-weight
model, a LoRA ``max_rank`` over the kernel's 16, a geometry it does not
take) raises at construction (no fallback).

``tick_window=W`` runs W decode ticks as one program before the host sees
their tokens (executor.py): eos and max-new completion are found up to
W - 1 tokens late and the surplus is discarded, so greedy outputs equal
W = 1's, for one host round trip every W ticks. On a CUDA device every
decode window and prefill chunk is a replay of a CUDA graph over the
executor's static buffers, into which each pass copies its inputs from
pinned host memory.

``spec=SpecConfig(...)`` serves speculative decoding (inference/
speculative.py): a drafter proposes ``k`` tokens a row, one verify window
scores the k+1 positions and the exact accept/reject emits 1 to k+1 tokens
a row. With the n-gram drafter (in-program) a trip runs ``tick_window``
windows as one program; a host-side drafter (``DraftModelDrafter``) runs
one window a trip. The speculation gate switches to plain decode trips of
``gate_ticks`` ticks while acceptance is low. Greedy outputs equal the
plain server's; on a CUDA device every verify window or trip is a CUDA
graph replay, per layer or through the whole-tick kernel at W = k+1.

Not ported yet (their constructor arguments raise ``NotImplementedError``
when given a non-default value): the dense cache, KV tiers and swap preemption, priority/WFQ scheduling, telemetry, fault
injection, tensor/context parallelism, snapshots, replica roles and
``kernels="pallas"`` (the port has no interpret mode).
With the default ``num_blocks`` the pool never runs dry; a smaller pool
that does raises instead of preempting.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models.generation import next_token
from .executor import PagedExecutor
from .lora import AdapterPool
from .paged_cache import BlockAllocator
from .scheduler import Scheduler

# the JAX server's constructor arguments that the port does not serve yet,
# each at the one value it takes (the JAX default); any other value raises
# NotImplementedError. The constructor keeps the JAX server's parameter
# order, so that a positional call means the same in both packages
_UNPORTED_DEFAULTS = {
    "prompt_buckets": (32, 64, 128),
    "host_pool_bytes": None, "warm_pool_bytes": None,
    "tier_demote_low": None, "tier_demote_high": None,
    "telemetry": None, "faults": None, "fault_retries": 3,
    "mesh": None, "role": "any", "profile": None, "clock": None,
}
# the JAX server's ``submit`` arguments that the port does not serve yet,
# at the one value each takes (``priority`` the JAX PRIORITY_NORMAL)
_UNPORTED_SUBMIT = {"priority": 1, "tenant": "default", "ttl_s": None}


def kv_block_bytes(cfg, block_size: int, kv_quant: str = "none") -> int:
    """Device bytes one KV block costs across ALL layers (K + V pools, plus
    the f32 scale rows of the int8 pool) — the unit of ``pool_bytes=``
    sizing."""
    kv = cfg.num_key_value_heads
    d = cfg.hidden_size // cfg.num_attention_heads
    if kv_quant == "int8":
        # int8 codes + one f32 scale per (block, KV head)
        per_pool = block_size * kv * d * 1 + kv * 4
    else:
        itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
        per_pool = block_size * kv * d * itemsize
    return 2 * cfg.num_hidden_layers * per_pool


@dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    draft_k: Optional[int] = None                    # per-request spec budget
    adapter: Optional[str] = None                    # LoRA adapter name
    generated: List[int] = field(default_factory=list)
    sched: Any = None                                # its SchedEntry
    salt: tuple = ()                                 # prefix-chain seed
    table: List[int] = field(default_factory=list)   # block ids, in order
    hashes: List[int] = field(default_factory=list)  # chain hash per full blk
    pf_next: int = 0                                 # next prefill position


class GenerationServer:
    """Paged continuous-batching decode server for a ``LlamaForCausalLM`` —
    greedy by default, per-request sampling via ``submit(...,
    temperature=, top_k=, top_p=)``.

    Usage::

        srv = GenerationServer(model, cache="paged", max_batch=8)
        rid = srv.submit([1, 5, 9], max_new_tokens=16)
        out = srv.run()          # drain all pending requests
        tokens = out[rid]        # prompt + generated ids

    The parameters keep the JAX server's order, so a positional call means
    the same in both packages; the ones the port does not serve yet
    (``_UNPORTED_DEFAULTS``) take only the JAX default and raise
    NotImplementedError on any other value. ``device`` comes after them:
    where the server runs — ``None`` means the current CUDA device (raises
    when there is none); it must be the model's device.
    ``block_size`` tokens per KV block; ``num_blocks`` bounds KV memory
    (default: every slot can hold ``max_len`` tokens, plus scratch), or
    ``pool_bytes`` sizes the pool by a byte budget (``num_blocks =
    pool_bytes // kv_block_bytes(...)``); ``kv_quant``: ``"none"`` or
    ``"int8"`` (int8 codes + per-(block, KV head) scales); ``lora``: a
    :class:`~.lora.LoRAConfig` for multi-adapter serving (fp base weights
    only, as in the JAX package). Prompts prefill in ``prefill_chunk``-token
    chunks (rounded up to a block multiple). ``seed`` seeds the
    ``torch.Generator`` of sampled requests.

    ``tick_window``: decode ticks per host round trip (>= 1; see the
    module docstring); with ``spec``, verify windows per trip (a host-side
    drafter takes 1 only). ``spec``: a :class:`~.speculative.SpecConfig`
    (paged cache only).

    ``kernels``: ``"auto"`` (default) leaves the process-wide
    :func:`paddle_tpu_torch.ops.set_kernel_mode` as it is; ``"megakernel"``
    (requires ``cache="paged"``) sets it so that every decode tick runs all
    layers as one launch of the whole-tick kernel — fp weights, fp or int8
    KV pools, with or without LoRA; anything else raises at construction,
    naming the reason (``_exec.megakernel_reason``); ``"reference"`` pins
    the plain versions. ``mk_geometry``: a
    :class:`~..ops.decode_megakernel.MegakernelGeometry`, accepted only with
    ``kernels="megakernel"``; the kernel takes the default ``ffn_tile`` and
    ``prefetch_depth`` and either ``dequant`` (int8 pools)."""

    def __init__(self, model, max_batch: int = 4, max_len: int = 256,
                 prompt_buckets: Sequence[int] = (32, 64, 128),
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 tick_window: int = 1, cache: str = "paged",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 32, spec=None,
                 kv_quant: str = "none", pool_bytes: Optional[int] = None,
                 policy=None, host_pool_bytes: Optional[int] = None,
                 warm_pool_bytes: Optional[int] = None,
                 tier_demote_low: Optional[float] = None,
                 tier_demote_high: Optional[float] = None,
                 lora=None, telemetry=None, faults=None,
                 fault_retries: int = 3, kernels: str = "auto",
                 mk_geometry=None, mesh=None, role: str = "any",
                 profile=None, clock=None, device=None):
        from ..ops import KERNEL_MODES, kernel_mode, set_kernel_mode

        given = locals()
        for name, default in _UNPORTED_DEFAULTS.items():
            if given[name] != default:
                raise NotImplementedError(
                    f"GenerationServer({name}={given[name]!r}) is not "
                    f"ported yet")
        if kernels == "pallas":
            raise NotImplementedError(
                "kernels='pallas' forces the Pallas kernels in interpret "
                "mode; the port has no interpret mode — use 'auto', "
                "'megakernel' or 'reference'")
        if kernels not in KERNEL_MODES:
            raise ValueError(
                f"kernels must be one of {KERNEL_MODES}, got {kernels!r}")
        if kernels == "megakernel" and cache != "paged":
            raise ValueError("kernels='megakernel' requires cache='paged' "
                             "(the whole-tick kernel serves the paged "
                             "decode path)")
        if mk_geometry is not None:
            if kernels != "megakernel":
                raise ValueError("mk_geometry= requires "
                                 "kernels='megakernel' (the geometry only "
                                 "parameterizes the whole-tick kernel)")
            mk_geometry.validate()
        if spec is not None:
            if cache != "paged":
                raise ValueError(
                    "spec= (speculative decoding) requires cache='paged'")
            spec.validate()
        if cache != "paged":
            raise NotImplementedError(
                f"cache={cache!r}: only cache='paged' is ported")
        if tick_window < 1:
            raise ValueError(f"tick_window must be >= 1, got {tick_window}")
        if policy not in (None, "fifo"):
            raise NotImplementedError(
                f"policy={policy!r}: only FIFO scheduling is ported")
        if kv_quant not in ("none", "int8"):
            raise ValueError(
                f"kv_quant must be 'none' or 'int8', got {kv_quant!r}")
        if pool_bytes is not None and num_blocks is not None:
            raise ValueError(
                "pass either num_blocks= or pool_bytes=, not both")
        if lora is not None and model.quantized:
            raise NotImplementedError(
                "lora= over weight-only int8 projections is not supported "
                "(as in the JAX package) — serve LoRA over fp base weights "
                "(kv_quant='int8' is fine)")
        cfg = model.cfg
        if max_len > cfg.max_position_embeddings:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the server "
                             f"on {self.device}: move one of them")
        self.model = model
        self.cfg = cfg
        self.kv_quant = kv_quant
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos = eos_token_id
        self.tick_window = int(tick_window)
        self.spec = spec
        # per-slot scalars live host-side (numpy)
        self.pos = np.zeros((max_batch,), np.int32)
        self.tokens = np.zeros((max_batch,), np.int32)
        self.temps = np.zeros((max_batch,), np.float32)
        self.topks = np.zeros((max_batch,), np.int32)
        self.topps = np.zeros((max_batch,), np.float32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._slots: List[Optional[_Request]] = [None] * max_batch
        self._sched = Scheduler()
        self._results: Dict[int, List[int]] = {}
        self._idle_streak = 0
        self._next_rid = 0

        bs = int(block_size)
        if bs < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = bs
        chunk = int(prefill_chunk)
        if chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = -(-chunk // bs) * bs  # round up to blocks
        entries = -(-max_len // bs)  # ceil: real table entries per slot
        self._max_entries = entries
        # slack entries (always 0 = scratch) so that neither a final chunk's
        # table slice nor a finished row's last ticks of a window run off
        # the row
        slack = -(-max(self.prefill_chunk, self.tick_window) // bs)
        if spec is not None:
            # a speculative trip writes up to tick_window (or turbo)
            # windows of k+1 positions past a row's last live position, a
            # gated plain trip gate_ticks positions
            wmax = max(self.tick_window, int(spec.turbo_windows))
            slack = max(slack, -(-(wmax * (int(spec.k) + 1)) // bs),
                        -(-int(spec.gate_ticks) // bs))
        self._table_width = entries + slack
        per_block = kv_block_bytes(cfg, bs, kv_quant)
        if num_blocks is None:
            if pool_bytes is not None:
                # byte-budget sizing: the int8 pool's half-size blocks give
                # about twice the blocks of the same budget
                num_blocks = max(2, int(pool_bytes) // per_block)
            else:
                num_blocks = max_batch * entries + 1  # every slot at max_len
        self.alloc = BlockAllocator(int(num_blocks), bs, kv_quant=kv_quant,
                                    bytes_per_block=per_block)
        self._bt = np.zeros((max_batch, self._table_width), np.int32)
        # per-slot adapter page in the LoRA pool; 0 = the all-zero NULL
        # page, so adapterless slots need no branching
        self.aidx = np.zeros((max_batch,), np.int32)
        self._lora = (AdapterPool(cfg, lora, device=self.device)
                      if lora is not None else None)
        # True while the slot streams prompt chunks; None once it decodes
        # (or is empty)
        self._prefilling: List[Optional[bool]] = [None] * max_batch
        # throughput ledger: real prompt tokens / decoded tokens and the
        # host wall time of the work, each span ending on a host copy of
        # its result (so the device work is complete)
        self._prefill_tokens = 0
        self._prefill_chunks = 0
        self._prefill_wall_s = 0.0
        self._decode_trips = 0
        self._weights_checked = False
        self._decode_ticks = 0
        self._decode_tokens = 0
        self._decode_wall_s = 0.0
        # the executor's inputs, staged in pinned host memory (on a CUDA
        # device): a pass fills these and the executor copies them into its
        # device buffers; every pass ends in a host copy of its result
        # before the next one refills them
        pin = self.device.type == "cuda"
        i32 = torch.int32
        TW = self._table_width
        self._stage = {
            name: torch.zeros(shape, dtype=dt, pin_memory=pin)
            for name, shape, dt in (
                ("tokens", (max_batch,), i32), ("tables", (max_batch, TW), i32),
                ("pos", (max_batch,), i32), ("active", (max_batch,), i32),
                ("aidx", (max_batch,), i32),
                ("temps", (max_batch,), torch.float32),
                ("topks", (max_batch,), i32),
                ("topps", (max_batch,), torch.float32),
                ("chunk", (1, self.prefill_chunk), i32), ("table", (TW,), i32),
                ("start", (1,), i32), ("last_idx", (1,), i32),
                ("chunk_aidx", (1,), i32))}
        if spec is not None:
            self.spec_k = int(spec.k)
            self.drafter = spec.build_drafter(max_len)
            dm = getattr(self.drafter, "model", None)
            if dm is not None and dm.device != self.device:
                raise ValueError(f"the draft model lives on {dm.device}, the "
                                 f"server on {self.device}: move one of them")
            # fusible drafters (in-program drafting: the n-gram matcher)
            # run tick_window draft, verify, accept windows in one program;
            # a host-side drafter needs a round trip a window
            self._spec_fused = bool(getattr(self.drafter, "fusible", False))
            if not self._spec_fused and self.tick_window != 1:
                raise ValueError(
                    f"tick_window={tick_window} with spec= needs an "
                    f"in-program (fusible) drafter such as 'ngram'; drafter "
                    f"{type(self.drafter).__name__} proposes host-side and "
                    f"supports tick_window=1 only")
            self._spec_windows = self.tick_window if self._spec_fused else 1
            # per-slot draft budget: kcap 0 (idle and prefilling slots) runs
            # a plain decode tick inside the verify window
            self.kcaps = np.zeros((max_batch,), np.int32)
            self._spec_proposed = 0
            self._spec_accepted = 0
            # the gate: > 0 = plain trips left before the next probe;
            # turbo = long trips while the batch accepts near k
            self._spec_gate_off = 0
            self._spec_plain_windows = 0
            self._spec_turbo = False
            self._stage.update({
                name: torch.zeros(shape, dtype=i32, pin_memory=pin)
                for name, shape in (("proposals", (max_batch, self.spec_k)),
                                    ("kcaps", (max_batch,)),
                                    ("ctx", (max_batch, max_len)))})
        self._verify_trips = 0
        self._verify_windows = 0
        self._verify_tokens = 0
        self._verify_wall_s = 0.0
        self._stage_np = {k: t.numpy() for k, t in self._stage.items()}
        self.kernels = kernels
        self.mk_geometry = mk_geometry
        # the mode is process-wide (as in the JAX package); a server that
        # fails to build leaves it as it found it
        prev_mode = kernel_mode()
        if kernels != "auto":
            set_kernel_mode(kernels)
        try:
            self._exec = PagedExecutor(self, num_blocks=int(num_blocks))
        except BaseException:
            set_kernel_mode(prev_mode)
            raise

    # --------------------------------------------------------------- requests
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, draft_k: Optional[int] = None,
               priority: int = 1, tenant: str = "default",
               ttl_s: Optional[float] = None,
               adapter: Optional[str] = None) -> int:
        """Queue one request; returns its rid. ``draft_k`` lowers the
        request's drafts a window below ``spec.k`` (requires ``spec=``; 0
        decodes it plainly inside the verify windows). ``adapter`` names a
        registered LoRA adapter (requires ``lora=``); an unknown name, a
        rank past the pool's ``max_rank`` or mis-shaped factors are
        rejected here, not at admission. ``priority``, ``tenant`` and
        ``ttl_s`` keep the JAX order; the port's FIFO scheduler takes only
        their defaults and raises NotImplementedError on any other
        value."""
        given = locals()
        for name, default in _UNPORTED_SUBMIT.items():
            if given[name] != default:
                raise NotImplementedError(
                    f"submit({name}={given[name]!r}) is not ported yet")
        prompt = list(prompt)
        if not prompt:
            raise ValueError("prompt must contain at least one token id")
        for t in prompt:
            if isinstance(t, bool) or not isinstance(t, (int, np.integer)):
                raise ValueError(
                    f"prompt must be a sequence of int token ids, got "
                    f"{type(t).__name__}: {t!r}")
        prompt = [int(t) for t in prompt]
        if isinstance(max_new_tokens, bool) or \
                not isinstance(max_new_tokens, (int, np.integer)) or \
                max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be a positive int, got "
                             f"{max_new_tokens!r}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len={self.max_len}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if draft_k is not None:
            if self.spec is None:
                raise ValueError(
                    "draft_k= requires a server built with "
                    "spec=SpecConfig(...)")
            if isinstance(draft_k, bool) or \
                    not isinstance(draft_k, (int, np.integer)) or draft_k < 0:
                raise ValueError(
                    f"draft_k must be an int >= 0, got {draft_k!r}")
            if draft_k > self.spec_k:
                raise ValueError(
                    f"draft_k ({draft_k}) exceeds spec.k ({self.spec_k}) — "
                    f"the compiled verify-window width; raise SpecConfig.k")
            draft_k = int(draft_k)
        if adapter is not None:
            if self._lora is None:
                raise ValueError(
                    "adapter= requires a server built with "
                    "lora=LoRAConfig(...)")
            self._lora.validate(adapter)
        # feasibility gate: a request whose worst-case block need exceeds
        # the pool could never finish
        worst = len(prompt) + max_new_tokens
        need = min(self._max_entries, -(-worst // self.block_size))
        if need > self.alloc.num_blocks - 1:
            raise ValueError(
                f"request needs up to {need} KV blocks but the pool has "
                f"{self.alloc.num_blocks - 1} usable — raise num_blocks or "
                f"shorten the request")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, prompt, int(max_new_tokens),
                       temperature=float(temperature), top_k=int(top_k),
                       top_p=float(top_p), draft_k=draft_k, adapter=adapter)
        req.sched = self._sched.submit(req, rid, adapter=adapter)
        self._weights_checked = False
        return rid

    def _salt(self, adapter: Optional[str]) -> tuple:
        """Prefix-chain seed of a request: its adapter's name and
        registration uid (a re-registered name gets new blocks), or nothing
        for an adapterless request, whose chains equal the JAX server's."""
        if adapter is None:
            return ()
        return ("adapter", adapter, self._lora.registry.get(adapter).uid)

    def _first_token(self, req: _Request, lg) -> int:
        """First generated token from the final chunk's logits (1, V): a host
        argmax for greedy requests, ``next_token`` otherwise."""
        if req.temperature == 0.0:
            return int(np.argmax(lg.cpu().numpy()[0]))
        nxt = next_token(lg, self._gen, req.temperature, req.top_k,
                         req.top_p)
        return int(nxt[0])

    def _activate_slot(self, slot: int, req: _Request, first: int) -> None:
        """Move a freshly-prefilled request into the decode phase."""
        self.pos[slot] = len(req.prompt)
        self.tokens[slot] = first
        self.temps[slot] = req.temperature
        self.topks[slot] = req.top_k
        self.topps[slot] = req.top_p
        if self.spec is not None:
            self.kcaps[slot] = (self.spec_k if req.draft_k is None
                                else req.draft_k)
        req.generated.append(first)

    def _fill_free_slots(self) -> None:
        """Admit waiting requests into free slots in FIFO order, gated on
        block headroom, with no head-of-line bypass (a draining pool always
        reopens headroom)."""
        if self._lora is not None:
            # replay the queue's adapter demand through the pool's LRU: the
            # adapters of the next requests become most recently used and
            # evict last
            self._lora.warm(self._sched.adapter_demand())
        for s in range(self.max_batch):
            if self._slots[s] is not None:
                continue
            ent = self._sched.peek()
            if ent is None or not self._admissible(ent):
                break
            self._sched.pop()
            self._admit_paged(s, ent.req)

    def _admit_paged(self, slot: int, req: _Request) -> None:
        """Claim a slot: take the request's adapter page (an upload on a
        miss), reuse cached prefix blocks (the matched span skips prefill)
        and start chunked prefill at the first uncached block."""
        if self._lora is not None:
            self.aidx[slot] = (self._lora.acquire(req.adapter)
                               if req.adapter is not None else 0)
        req.salt = self._salt(req.adapter)
        req.table = self.alloc.match_prefix(req.prompt, req.salt)
        req.hashes = self.alloc.chain_hashes(req.prompt, req.salt)
        req.pf_next = len(req.table) * self.block_size
        self._bt[slot, :] = 0
        self._bt[slot, :len(req.table)] = req.table
        self._prefilling[slot] = True
        self._slots[slot] = req

    def _admissible(self, ent) -> bool:
        """Headroom gate: the request's whole prompt (less its resident
        prefix blocks) plus one spare block must be reclaimable now."""
        adapter = ent.req.adapter
        if adapter is not None and not self._lora.can_acquire(adapter):
            # every adapter page is held by a running slot: wait for one
            # to finish
            return False
        prompt = ent.req.prompt
        need = min(self._max_entries, -(-len(prompt) // self.block_size))
        need = max(need - self.alloc.probe_prefix(prompt,
                                                  self._salt(adapter)), 1)
        headroom = min(need + 1, self.alloc.num_blocks - 1)
        return (self.alloc.blocks_free
                + self.alloc.evictable_cached) >= headroom

    def _ensure_blocks(self, slot: int, entries: int) -> None:
        """Grow the slot's block table to >= ``entries`` real entries
        (capped at ceil(max_len/block_size); writes past that land in
        scratch by construction)."""
        req = self._slots[slot]
        entries = min(entries, self._max_entries)
        while len(req.table) < entries:
            try:
                bid = self.alloc.alloc()
            except RuntimeError as e:
                raise RuntimeError(
                    f"{e}; swap preemption is not ported yet, so the pool "
                    f"must hold every admitted request (the default "
                    f"num_blocks does)") from e
            req.table.append(bid)
            self._bt[slot, len(req.table) - 1] = bid

    def _prefill_chunk_step(self, slot: int) -> None:
        """Advance one prompt chunk for a prefilling slot; on the final
        chunk, take the first token and flip the slot to decoding."""
        req = self._slots[slot]
        seq = req.prompt
        n = len(seq)
        bs = self.block_size
        C = self.prefill_chunk
        start = req.pf_next
        end = min(start + C, n)
        self._ensure_blocks(slot, -(-end // bs))
        if start % bs:
            raise RuntimeError(f"prefill chunk at {start}: not a multiple of "
                               f"block_size {bs}")
        st, sn = self._stage, self._stage_np
        sn["chunk"][:] = 0
        sn["chunk"][0, :end - start] = seq[start:end]
        sn["table"][:] = self._bt[slot]
        sn["start"][0] = start
        sn["last_idx"][0] = (n - 1 - start) if end == n else 0
        sn["chunk_aidx"][0] = self.aidx[slot]
        w0 = time.perf_counter()
        lg = self._exec.chunk_prefill(
            st["chunk"], st["table"], st["start"], st["last_idx"],
            st["chunk_aidx"] if self._lora is not None else None)
        first = self._first_token(req, lg) if end == n else None
        if first is None:
            lg.cpu()    # the host copy closes the timed span on the device
        self._prefill_tokens += end - start
        self._prefill_chunks += 1
        self._prefill_wall_s += time.perf_counter() - w0
        # publish the prompt blocks this chunk completed for prefix reuse
        for i in range(start // bs, end // bs):
            self.alloc.register(req.table[i], req.hashes[i])
        req.pf_next = start + C
        if end == n:
            self._activate_slot(slot, req, first)
            self._prefilling[slot] = None

    def _plain_decode_trip(self, active, ticks: Optional[int] = None) -> None:
        """One decode trip: ``ticks`` (default ``tick_window``) ticks across
        the listed slots in one program. Idle and prefilling rows run
        masked — zeroed table and pos 0 route their discarded K/V writes to
        scratch block 0, which keeps the batch shape fixed."""
        k = self.tick_window if ticks is None else ticks
        for s in active:
            self._ensure_blocks(s, -(-(int(self.pos[s]) + k)
                                     // self.block_size))
        greedy, active_mask = self._stage_rows(active)
        st = self._stage
        w0 = time.perf_counter()
        stack = self._exec.decode_paged(
            st["tokens"], st["tables"], st["pos"], st["temps"], st["topks"],
            st["topps"], st["active"], self._gen,
            aidx=st["aidx"] if self._lora is not None else None,
            greedy=greedy, ticks=k)
        nxt = stack.cpu().numpy()
        self._decode_wall_s += time.perf_counter() - w0
        self._decode_trips += 1
        self._decode_ticks += k
        self._decode_tokens += self._harvest_window(nxt, active, active_mask)

    def _stage_rows(self, active):
        """Stage the per-row inputs of a decode or verify trip over the
        listed slots (the rest masked: zeroed table, pos 0); returns
        (greedy, the active mask)."""
        greedy = all(float(self.temps[s]) == 0.0 for s in active)
        active_mask = np.zeros((self.max_batch,), np.int32)
        active_mask[active] = 1
        sn = self._stage_np
        sn["tokens"][:] = self.tokens
        sn["tables"][:] = np.where(active_mask[:, None] > 0, self._bt, 0)
        sn["pos"][:] = self.pos * active_mask
        sn["active"][:] = active_mask
        sn["aidx"][:] = self.aidx
        if self.spec is not None:
            # nonzero only on activated, unreleased slots: the active set
            sn["kcaps"][:] = self.kcaps * active_mask
        if not greedy:
            sn["temps"][:] = self.temps
            sn["topks"][:] = self.topks
            sn["topps"][:] = self.topps
        return greedy, active_mask

    def _harvest_window(self, nxt_host, active, active_mask) -> int:
        """Fold one decode window's (k, B) token stack into the per-request
        state: append tokens, detect eos / max-new / max-len completion
        (the window's surplus past completion is discarded) and free
        finished slots for the next step's refill. Returns the tokens
        kept."""
        k = nxt_host.shape[0]
        self.pos = self.pos + active_mask * k
        self.tokens = np.where(active_mask > 0, nxt_host[-1],
                               self.tokens).astype(np.int32)
        kept = 0
        for s in active:
            req = self._slots[s]
            done = False
            had = len(req.generated)
            for t in range(k):
                finished_last = (self.eos is not None
                                 and req.generated[-1] == self.eos)
                if not finished_last:
                    req.generated.append(int(nxt_host[t, s]))
                pos_t = int(self.pos[s]) - k + t + 1
                if (finished_last
                        or len(req.generated) >= req.max_new_tokens
                        or pos_t >= self.max_len - 1):
                    done = True
                    break
            kept += len(req.generated) - had
            if done:
                self._results[req.rid] = (req.prompt
                                          + req.generated[:req.max_new_tokens])
                self._release_slot(s)
        return kept

    def _release_slot(self, slot: int) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        for bid in req.table:
            self.alloc.free(bid)
        req.table = []
        if self._lora is not None:
            # the page stays cached (LRU) for the adapter's next request
            self._lora.release(int(self.aidx[slot]))
            self.aidx[slot] = 0
        self._bt[slot, :] = 0
        self._prefilling[slot] = None
        self.pos[slot] = 0
        self.tokens[slot] = 0
        self.temps[slot] = 0.0
        self.topks[slot] = 0
        self.topps[slot] = 0.0
        if self.spec is not None:
            self.kcaps[slot] = 0

    # ----------------------------------------------------------- speculative
    def _dispatch_trips(self, active) -> None:
        """The step's decode work for ``active`` slots. With ``spec``: the
        gate runs ``spec.gate_cooldown`` plain trips of ``spec.gate_ticks``
        ticks after a trip of low acceptance, then probes speculation
        again; a :class:`~.speculative.DrafterFault` runs the trip through
        the plain program and holds the gate off."""
        if self.spec is None:
            self._plain_decode_trip(active)
            return
        if self._spec_gate_off > 0:
            self._spec_gate_off -= 1
            self._spec_plain_windows += self.spec.gate_ticks
            self._plain_decode_trip(active, self.spec.gate_ticks)
            return
        from .speculative import DrafterFault

        try:
            self._spec_tick(active)
        except DrafterFault:
            # the drafter is an accelerator, not a correctness dependency
            self._spec_gate_off = max(int(self.spec.gate_cooldown) or 0, 4)
            self._spec_turbo = False
            self._spec_plain_windows += self.spec.gate_ticks
            self._plain_decode_trip(active, self.spec.gate_ticks)

    def _spec_tick(self, active) -> None:
        """One speculative trip: every decoding slot drafts k tokens, one
        verify window scores the k+1 positions, exact accept/reject emits 1
        to k+1 tokens a row — a fusible drafter's ``S`` windows as one
        program (``tick_window``, or ``turbo_windows`` in the turbo tier),
        a host-side drafter's one. Blocks for all ``S·(k+1)`` positions
        are reserved up front; the harvest truncates back."""
        k = self.spec_k
        S = self._spec_windows
        if self._spec_turbo and self.spec.turbo_windows > S:
            S = self.spec.turbo_windows
        for s in active:
            self._ensure_blocks(s, -(-(int(self.pos[s]) + S * (k + 1))
                                     // self.block_size))
        greedy, active_mask = self._stage_rows(active)
        st, sn = self._stage, self._stage_np
        lora = st["aidx"] if self._lora is not None else None
        ex = self._exec
        w0 = time.perf_counter()
        if self._spec_fused:
            ctx = sn["ctx"]
            ctx[:] = 0
            for s in active:
                req = self._slots[s]
                toks = req.prompt + req.generated
                ctx[s, :len(toks)] = toks
            outs, accs = ex.spec_scan(
                st["ctx"], st["tables"], st["pos"], st["temps"],
                st["topks"], st["topps"], st["kcaps"], st["active"],
                self._gen, aidx=lora, greedy=greedy, windows=S)
        else:
            contexts: List[Optional[List[int]]] = [None] * self.max_batch
            for s in active:
                req = self._slots[s]
                contexts[s] = req.prompt + req.generated
            proposals, qprobs = self.drafter.propose(
                contexts, k, temps=self.temps, generator=self._gen)
            if isinstance(proposals, np.ndarray):
                sn["proposals"][:] = proposals
                proposals = st["proposals"]
            outs, accs = ex.spec_verify(
                st["tokens"], proposals, st["tables"], st["pos"],
                st["temps"], st["topks"], st["topps"], st["kcaps"],
                self._gen, qprobs=qprobs, aidx=lora, greedy=greedy)
            outs, accs = outs[None], accs[None]
        outs = outs.cpu().numpy()
        accs = accs.cpu().numpy()
        self._verify_wall_s += time.perf_counter() - w0
        self._verify_trips += 1
        self._verify_windows += S
        self._verify_tokens += self._harvest_spec(outs, accs, active)
        if self.spec.gate_cooldown:
            m = float(accs[:, active].mean())
            # below gate_low mean accepted drafts a window, drafting is a
            # net loss: plain trips for a cooldown, then probe again
            if m < self.spec.gate_low:
                self._spec_gate_off = self.spec.gate_cooldown
                self._spec_turbo = False
            else:
                self._spec_turbo = (self._spec_fused
                                    and self.spec.turbo_windows > 0
                                    and m >= self.spec_k - 1)

    def _harvest_spec(self, outs, accs, active) -> int:
        """Fold a trip's verify windows into the requests: window w of row
        ``s`` emits ``outs[w, s, :accs[w, s] + 1]``, appended under the
        eos / max-new / max-len walk of :meth:`_harvest_window` (an eos
        inside a window drops the rest of the trip), so greedy outputs
        equal the plain server's token for token. A slot that goes on
        advances ``pos`` by the emitted count and gives back the blocks
        reserved for rejected drafts (``BlockAllocator.truncate``; their
        stale K/V is overwritten by the next window before a query reads
        it). Returns the tokens kept."""
        S = outs.shape[0]
        kept = 0
        for s in active:
            req = self._slots[s]
            kcap = int(self.kcaps[s])
            new_pos = int(self.pos[s])
            had = len(req.generated)
            done = False
            for w in range(S):
                a = int(accs[w, s])
                self._spec_proposed += kcap
                self._spec_accepted += a
                for j in range(a + 1):
                    finished_last = (self.eos is not None
                                     and req.generated[-1] == self.eos)
                    if not finished_last:
                        req.generated.append(int(outs[w, s, j]))
                    if (finished_last
                            or len(req.generated) >= req.max_new_tokens
                            or new_pos + j + 1 >= self.max_len - 1):
                        done = True
                        break
                if done:
                    break
                new_pos += a + 1
            kept += len(req.generated) - had
            if done:
                self._results[req.rid] = (req.prompt
                                          + req.generated[:req.max_new_tokens])
                self._release_slot(s)
            else:
                self.pos[s] = new_pos
                self.tokens[s] = req.generated[-1]
                req.table = self.alloc.truncate(req.table, new_pos)
                self._bt[s, len(req.table):] = 0
        return kept

    def spec_metrics(self) -> Dict[str, float]:
        """Draft and accept counters of the speculative path (empty
        without ``spec``); ``acceptance_rate`` = accepted / proposed
        drafts, ``gated_plain_windows`` the ticks of the gate's plain
        trips."""
        if self.spec is None:
            return {}
        prop = self._spec_proposed
        return {"draft_tokens_proposed": prop,
                "draft_tokens_accepted": self._spec_accepted,
                "acceptance_rate":
                    (self._spec_accepted / prop) if prop else 0.0,
                "gated_plain_windows": self._spec_plain_windows}

    # ------------------------------------------------------------- stepping
    def step(self) -> int:
        """One server step: admit queued requests, advance one prefill chunk
        per prefilling slot, then one decode trip across decoding slots;
        returns #remaining (occupied slots + queued). The first step after a
        submit or a ``run()`` checks that the model's weights are those the
        server was built over (``PagedExecutor.check_weights``)."""
        if not self._weights_checked:
            self._exec.check_weights()
            self._weights_checked = True
        self._fill_free_slots()
        for s in range(self.max_batch):
            if self._slots[s] is not None and self._prefilling[s]:
                self._prefill_chunk_step(s)
        active = [s for s in range(self.max_batch)
                  if self._slots[s] is not None and not self._prefilling[s]]
        if active:
            self._dispatch_trips(active)
        occupied = sum(sl is not None for sl in self._slots)
        if occupied == 0 and len(self._sched) > 0:
            # every slot empty yet entries wait: admission against an idle
            # pool must succeed, so a streak means corrupted state
            self._idle_streak += 1
            if self._idle_streak > 64:
                raise RuntimeError("scheduler wedged: 64 steps with empty "
                                   "slots and a non-empty queue")
        else:
            self._idle_streak = 0
        return occupied + len(self._sched)

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns {rid: prompt+generated token ids}."""
        self._weights_checked = False
        while self.step():
            pass
        out, self._results = self._results, {}
        return out

    # -------------------------------------------------------------- metrics
    def kv_stats(self) -> Dict[str, int]:
        """Paged-pool occupancy and prefix-cache counters."""
        return self.alloc.stats()

    def adapter_stats(self) -> Dict[str, Any]:
        """Adapter-pool residency counters (empty without ``lora=``)."""
        return self._lora.stats() if self._lora is not None else {}

    def throughput_stats(self) -> Dict[str, float]:
        """Prompt tokens and decode ticks served so far with their host wall
        time (each span ends on a host copy of its result, so the device
        work is included): ``decode_trips`` plain host round trips of
        ``decode_ticks`` ticks in all (``tick_window`` each, ``gate_ticks``
        a gated trip), ``decode_tokens`` the tokens they kept (a window's
        surplus past a request's end is not counted); ``verify_trips``
        speculative round trips of ``verify_windows`` windows in all and
        ``verify_tokens`` the tokens they kept, in ``verify_s``."""
        return {"prefill_tokens": self._prefill_tokens,
                "prefill_chunks": self._prefill_chunks,
                "prefill_s": self._prefill_wall_s,
                "decode_trips": self._decode_trips,
                "decode_ticks": self._decode_ticks,
                "decode_tokens": self._decode_tokens,
                "decode_s": self._decode_wall_s,
                "verify_trips": self._verify_trips,
                "verify_windows": self._verify_windows,
                "verify_tokens": self._verify_tokens,
                "verify_s": self._verify_wall_s}
