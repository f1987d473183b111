"""Continuous-batching generation server — port of
``paddle_tpu/inference/serving.py`` for ``cache="paged"``.

A FIXED set of ``max_batch`` slots shares one pool of fixed-size KV blocks
(inference/paged_cache.py) through per-slot block tables. Each
:meth:`GenerationServer.step` services the queue (inference/scheduler.py:
expires TTL'd waiters, admits waiting requests in policy order, gated on
block headroom, and preempts one less urgent running request a step for
a strictly more urgent waiter), advances ONE prefill chunk per prefilling
slot (chunked prefill: a long prompt never stalls the slots that are
decoding), then runs one decode tick for every decoding slot; finished
slots are released and refilled mid-flight. When the block pool runs dry,
a less urgent request is preempted: a prefilling one is aborted (its
prompt blocks stay cached), a decoding one swaps its KV blocks to pinned
host memory (inference/kv_offload.py, ``host_pool_bytes=``) and later
resumes where it stopped, with the same greedy tokens as a run that was
never preempted. Full prompt blocks are content-hashed and
refcount-shared, so a repeated prefix prefills once (prefix caching).
Greedy outputs are token-identical to the JAX server's on the same weights
(up to floating-point ties). Every product of a decode tick and of a
verify window is batch-invariant (``ops/stream_matmul.py``): a row's
logits depend only on that row, not on the batch or the window width, at
any ``max_batch · (k + 1)`` (past 128 rows the streaming products run
several token tiles with the same K slices).

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
plain server's token for token (the verify window's products are the
decode tick's, bit for bit, on the card as on the CPU; over int8 KV
pools while no window rescales a block it reads); on a CUDA device
every verify window or trip is a CUDA graph replay, per layer or through
the whole-tick kernel at W = k+1.

The per-request API: ``submit(priority=, tenant=, ttl_s=)``,
:meth:`~GenerationServer.cancel`, :meth:`~GenerationServer.status`,
:meth:`~GenerationServer.sched_metrics`,
:meth:`~GenerationServer.request_metrics`,
:meth:`~GenerationServer.assert_conserved`,
:meth:`~GenerationServer.take_results`, ``steps``,
:meth:`~GenerationServer.load_metrics` and
:meth:`~GenerationServer.probe_prefix`. Preemption and resume run on the
host between passes: they add no CUDA graph, and a resumed request
replays the graphs already captured.

Not ported yet (their constructor arguments raise ``NotImplementedError``
when given a non-default value): the dense cache, the warm KV tier,
telemetry, fault injection, tensor/context parallelism, snapshots and
migration, replica roles and ``kernels="pallas"`` (the port has no
interpret mode).
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
from .kv_offload import KVOffloadEngine
from .paged_cache import BlockAllocator
from .scheduler import PRIORITY_NORMAL, SchedEntry, Scheduler

# the JAX server's constructor arguments that the port does not serve yet,
# each at the one value it takes (the JAX default); any other value raises
# NotImplementedError. The constructor keeps the JAX server's parameter
# order, so that a positional call means the same in both packages
_UNPORTED_DEFAULTS = {
    "prompt_buckets": (32, 64, 128),
    "warm_pool_bytes": None,
    "tier_demote_low": None, "tier_demote_high": None,
    "telemetry": None, "faults": None, "fault_retries": 3,
    "mesh": None, "role": "any", "profile": None,
}


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

    ``policy``: None (FIFO), a policy name (``"fifo"``, ``"priority"``,
    ``"wfq"``) or a configured :class:`~.scheduler.Scheduler` (for
    ``max_queue``, TTLs, tenant weights); ``clock``: the scheduler's
    injectable clock (default ``time.monotonic``), also the clock of
    :meth:`request_metrics`. ``host_pool_bytes``: byte cap of the pinned
    host pool that swap preemption parks victims' KV blocks in — None
    unbounded, 0 no swapping (victims then stall instead of parking).

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
        if policy is None:
            self._sched = Scheduler() if clock is None \
                else Scheduler(clock=clock)
        elif isinstance(policy, Scheduler):
            self._sched = policy
        elif isinstance(policy, str):
            self._sched = Scheduler(policy=policy) if clock is None \
                else Scheduler(policy=policy, clock=clock)
        else:
            raise ValueError(
                f"policy must be None, a policy name ('fifo'/'priority'/"
                f"'wfq'), or a Scheduler instance, got {policy!r}")
        self._wall = clock if clock is not None else time.monotonic
        self._results: Dict[int, List[int]] = {}
        self._dropped: Dict[int, str] = {}   # rid -> cancelled | expired
        # per-rid clock marks (submit / first token / done)
        self._req_metrics: Dict[int, Dict[str, Any]] = {}
        self._idle_streak = 0
        self._stall_streak = 0
        self._next_rid = 0
        self._step_no = 0
        # preemption counters (sched_metrics)
        self._preemptions = 0
        self._prefill_aborts = 0
        self._resumes = 0
        self._stalls = 0
        self._cancelled = 0

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
        self._offload = KVOffloadEngine(self.alloc,
                                        capacity_bytes=host_pool_bytes)
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
               priority: int = PRIORITY_NORMAL, tenant: str = "default",
               ttl_s: Optional[float] = None,
               adapter: Optional[str] = None) -> int:
        """Queue one request; returns its rid. ``draft_k`` lowers the
        request's drafts a window below ``spec.k`` (requires ``spec=``; 0
        decodes it plainly inside the verify windows). ``priority`` (lower
        = more urgent), ``tenant`` (the WFQ fairness bucket) and ``ttl_s``
        (the longest queue wait before the request expires unstarted) feed
        the scheduler; raises :class:`~.scheduler.AdmissionError` when a
        bounded queue is full. ``adapter`` names a registered LoRA adapter
        (requires ``lora=``); an unknown name, a rank past the pool's
        ``max_rank`` or mis-shaped factors are rejected here, not at
        admission."""
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
        if not isinstance(tenant, str) or not tenant:
            raise ValueError(
                f"tenant must be a non-empty string, got {tenant!r}")
        if adapter is not None:
            if self._lora is None:
                raise ValueError(
                    "adapter= requires a server built with "
                    "lora=LoRAConfig(...)")
            self._lora.validate(adapter)
        # feasibility gate: a request whose worst-case block need — its
        # final position plus the transient decode-window (or speculative-
        # window) reservation — exceeds the pool could never finish
        if self.spec is not None:
            wmax = max(self.tick_window, int(self.spec.turbo_windows))
            trans = max(wmax * (self.spec_k + 1), int(self.spec.gate_ticks))
        else:
            trans = self.tick_window
        worst = len(prompt) + max_new_tokens - 1 + trans
        need = min(self._max_entries, -(-worst // self.block_size))
        if need > self.alloc.num_blocks - 1:
            raise ValueError(
                f"request needs up to {need} KV blocks but the pool has "
                f"{self.alloc.num_blocks - 1} usable — it could never be "
                f"scheduled; raise num_blocks/pool_bytes or shorten the "
                f"request")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, prompt, int(max_new_tokens),
                       temperature=float(temperature), top_k=int(top_k),
                       top_p=float(top_p), draft_k=draft_k, adapter=adapter)
        # cost = the estimated total tokens: the WFQ charge a tenant pays
        req.sched = self._sched.submit(
            req, rid, priority=priority, tenant=tenant, ttl_s=ttl_s,
            cost=float(len(prompt) + max_new_tokens), adapter=adapter)
        self._req_metrics[rid] = {"submit_t": self._wall(), "tenant": tenant}
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
        m = self._req_metrics.get(req.rid)
        if m is not None:
            m.setdefault("first_token_t", self._wall())

    def _fill_free_slots(self) -> None:
        """Admit waiting requests into free slots in scheduler-policy
        order, gated on block headroom, with no head-of-line bypass
        (skipping an inadmissible head for a later entry could starve it;
        a draining pool always reopens headroom). A swapped entry resumes
        where it stopped."""
        for s in range(self.max_batch):
            if self._slots[s] is not None:
                continue
            ent = self._sched.peek()
            if ent is None or not self._admissible(ent):
                break
            self._sched.pop()
            ent.started = True
            if ent.swap is not None:
                if not self._resume_swapped(s, ent):
                    # headroom moved between the check and the restore
                    # (hash matches changed): requeue, retry next step
                    self._sched.requeue(ent)
                    break
            else:
                self._admit_paged(s, ent.req)

    def _service_queue(self) -> None:
        """Queue maintenance at the top of every step: expire TTL'd
        waiters, replay the queue's adapter demand through the adapter
        pool's LRU, fill free slots in policy order, then — if a strictly
        more urgent entry waits behind a full batch — preempt the least
        urgent running request for it (one victim a step bounds the
        churn)."""
        for ent in self._sched.expire():
            self._drop_entry(ent, "expired")
        if self._lora is not None:
            # the adapters of the next requests (pop-priority order)
            # become most recently used and evict last
            self._lora.warm(self._sched.adapter_demand())
        self._fill_free_slots()
        ent = self._sched.peek()
        if ent is not None and all(sl is not None for sl in self._slots):
            v = self._pick_victim(ent.priority)
            if v is not None and self._preempt_slot(v):
                self._fill_free_slots()

    def _drop_entry(self, ent: SchedEntry, reason: str) -> None:
        """A queued entry leaves without finishing: record why, close its
        metrics, release any parked host KV."""
        self._dropped[ent.rid] = reason
        if reason == "cancelled":
            self._cancelled += 1
        m = self._req_metrics.get(ent.rid)
        if m is not None:
            m["done_t"] = self._wall()
        if ent.swap is not None:
            self._offload.discard(ent.swap)
            ent.swap = None

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

    def _admissible(self, ent: SchedEntry) -> bool:
        """Block-headroom gate: the entry's first allocation burst (the
        whole prompt less its resident prefix blocks for a fresh request;
        the parked blocks not still resident for a swapped one) plus one
        spare block must be reclaimable now."""
        adapter = ent.req.adapter
        if adapter is not None and not self._lora.can_acquire(adapter):
            # every adapter page is held by a running slot: wait for one
            # to finish or be preempted
            return False
        if ent.swap is not None:
            need = self._offload.restore_cost(ent.swap)
        else:
            prompt = ent.req.prompt
            need = min(self._max_entries, -(-len(prompt) // self.block_size))
            need = max(need - self.alloc.probe_prefix(
                prompt, self._salt(adapter)), 1)
        ent.kv_need = need          # the scheduler's queued-demand sum
        headroom = min(need + 1, self.alloc.num_blocks - 1)
        return (self.alloc.blocks_free
                + self.alloc.evictable_cached) >= headroom

    def _ensure_blocks(self, slot: int, entries: int) -> None:
        """Grow the slot's block table to >= ``entries`` real entries
        (capped at ceil(max_len/block_size); writes past that land in
        scratch by construction). Raises RuntimeError when the pool is
        dry (:meth:`_reserve_or_preempt` preempts then)."""
        req = self._slots[slot]
        entries = min(entries, self._max_entries)
        fresh = []
        try:
            while len(req.table) < entries:
                bid = self.alloc.alloc()
                req.table.append(bid)
                self._bt[slot, len(req.table) - 1] = bid
                fresh.append(bid)
        finally:
            # int8 pools: cleared before any later pass or restore writes
            # them (``PagedExecutor.clear_blocks``), in stream order
            self._exec.clear_blocks(fresh)

    # ------------------------------------------------- preemption / offload
    def _resume_swapped(self, slot: int, ent: SchedEntry) -> bool:
        """Restore a swapped-out request into ``slot`` where it stopped:
        KV blocks back from host (prefix-hash hits skip the upload), its
        position, next token and sampling scalars from the request. The
        greedy continuation equals the un-preempted run's: the round trip
        is bit-exact and the decode products are batch-invariant. Returns
        False (entry untouched) when device headroom vanished."""
        req = ent.req
        res = self._offload.swap_in(ent.swap, self._exec._flat_pools)
        if res is None:
            return False
        if res == "corrupt":
            raise RuntimeError(
                f"request {req.rid}: its parked KV payload failed its "
                f"checksum (re-prefilling it from its tokens is not ported)")
        if self._lora is not None:
            # re-acquired after the KV restore committed: _admissible
            # vouched for can_acquire
            self.aidx[slot] = (self._lora.acquire(req.adapter)
                               if req.adapter is not None else 0)
        handle, ent.swap = ent.swap, None
        req.table = res[0]
        self._bt[slot, :] = 0
        self._bt[slot, :len(req.table)] = req.table
        self._prefilling[slot] = None
        self._slots[slot] = req
        self.pos[slot] = handle.n_tokens
        self.tokens[slot] = handle.last_token
        self.temps[slot] = req.temperature
        self.topks[slot] = req.top_k
        self.topps[slot] = req.top_p
        if self.spec is not None:
            self.kcaps[slot] = (self.spec_k if req.draft_k is None
                                else req.draft_k)
        self._resumes += 1
        return True

    def _pick_victim(self, than_priority: int,
                     exclude=()) -> Optional[int]:
        """Least urgent occupied slot STRICTLY less urgent than
        ``than_priority`` (equal-priority peers never preempt each other:
        no ping-pong). Prefers prefilling victims (aborting them loses
        recomputable work only), then the largest block holder."""
        best, best_key = None, None
        for s in range(self.max_batch):
            if s in exclude:
                continue
            req = self._slots[s]
            if req is None:
                continue
            pr = req.sched.priority
            if pr <= than_priority:
                continue
            key = (pr, 1 if self._prefilling[s] else 0, len(req.table))
            if best_key is None or key > best_key:
                best, best_key = s, key
        return best

    def _preempt_slot(self, s: int) -> bool:
        """Evict the request in slot ``s`` and requeue it. A slot still
        prefilling is ABORTED (its KV is recomputable; its registered
        prompt blocks stay on the LRU, so the re-run's prefix match skips
        them). A decoding slot SWAPS: its table, truncated of speculative
        reservations, parks in pinned host memory. Returns False — slot
        untouched — when the host pool is full."""
        req = self._slots[s]
        ent = req.sched
        if self._prefilling[s]:
            for bid in req.table:
                self.alloc.free(bid)
            req.table = []
            req.pf_next = 0
            self._prefill_aborts += 1
        else:
            n = int(self.pos[s])
            req.table = self.alloc.truncate(req.table, n)
            handle = self._offload.swap_out(
                req.rid, req.table,
                req.hashes[:min(len(req.hashes), len(req.table))],
                self._exec._flat_pools, n_tokens=n,
                last_token=int(self.tokens[s]))
            if handle is None:
                return False
            req.table = []
            ent.swap = handle
            self._preemptions += 1
        self._slots[s] = None
        self._bt[s, :] = 0
        self._prefilling[s] = None
        self.pos[s] = 0
        self.tokens[s] = 0
        self.temps[s] = 0.0
        self.topks[s] = 0
        self.topps[s] = 0.0
        if self.spec is not None:
            self.kcaps[s] = 0
        if self._lora is not None:
            # the page goes cached (LRU): a quick resume revives it
            # without an upload
            self._lora.release(int(self.aidx[s]))
            self.aidx[s] = 0
        self._sched.requeue(ent)
        return True

    def _reserve_or_preempt(self, s: int, entries: int) -> str:
        """Grow slot ``s``'s table to ``entries``, preempting less urgent
        slots while the pool is dry. Returns ``"ok"`` (reserved),
        ``"gone"`` (no victim outranked ``s``, so it released its own
        blocks and requeued) or ``"stall"`` (nothing preemptable and the
        host pool refused the swap: ``s`` keeps its state and sits out
        this trip)."""
        tried = {s}
        while True:
            try:
                self._ensure_blocks(s, entries)
                return "ok"
            except RuntimeError:
                v = self._pick_victim(self._slots[s].sched.priority,
                                      exclude=tried)
                if v is not None:
                    tried.add(v)
                    self._preempt_slot(v)
                    continue
                if self._preempt_slot(s):
                    return "gone"
                self._stalls += 1
                return "stall"

    def _reserve_active(self, active, need_fn) -> List[int]:
        """Reserve each decoding slot's blocks for the coming trip, most
        urgent first (under pool pressure this is where swap preemption
        fires). Returns the surviving slots (victims drop out; stalled
        slots skip the trip but keep their state)."""
        out = []
        for s in sorted(active, key=lambda i: (self._slots[i].sched.priority,
                                               i)):
            if self._slots[s] is None:
                continue        # preempted as a victim earlier in the loop
            if self._reserve_or_preempt(s, need_fn(s)) == "ok":
                out.append(s)
        out.sort()
        if not out and active:
            self._stall_streak += 1
            if self._stall_streak > 256:
                raise RuntimeError(
                    "paged pool wedged: 256 consecutive trips made no "
                    "progress (every slot stalled on block reservation) — "
                    "raise num_blocks/pool_bytes or host_pool_bytes")
        else:
            self._stall_streak = 0
        return out

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
        if self._reserve_or_preempt(slot, -(-end // bs)) != "ok":
            return      # aborted as its own victim, or stalled: no chunk
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
        active = self._reserve_active(
            active, lambda s: -(-(int(self.pos[s]) + k) // self.block_size))
        if not active:
            return
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
                self._emit_result(req)
                self._release_slot(s)
        return kept

    def _emit_result(self, req: _Request) -> None:
        """A request finished: publish its tokens, close its metrics."""
        self._results[req.rid] = req.prompt + req.generated[
            :req.max_new_tokens]
        m = self._req_metrics.get(req.rid)
        if m is not None:
            m["done_t"] = self._wall()
            m["n_generated"] = min(len(req.generated), req.max_new_tokens)

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
        # blocks for every window of the trip, reserved up front (the
        # harvest truncates the rejected drafts' back)
        active = self._reserve_active(
            active, lambda s: -(-(int(self.pos[s]) + S * (k + 1))
                                // self.block_size))
        if not active:
            return
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
                self._emit_result(req)
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
        """One server step: service the queue (expiry, admission in policy
        order, one preemption for a more urgent waiter), advance one
        prefill chunk per prefilling slot, then one decode trip across
        decoding slots; returns #remaining (occupied slots + queued). The
        first step after a submit or a ``run()`` checks that the model's
        weights are those the server was built over
        (``PagedExecutor.check_weights``)."""
        if not self._weights_checked:
            self._exec.check_weights()
            self._weights_checked = True
        self._service_queue()
        for s in range(self.max_batch):
            if self._slots[s] is not None and self._prefilling[s]:
                self._prefill_chunk_step(s)
        active = [s for s in range(self.max_batch)
                  if self._slots[s] is not None and not self._prefilling[s]]
        if active:
            self._step_no += 1
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

    def take_results(self) -> Dict[int, List[int]]:
        """Pop and return every result finished so far (the incremental
        form of :meth:`run`'s return value)."""
        out, self._results = self._results, {}
        return out

    @property
    def steps(self) -> int:
        """Steps that ran a decode trip (the JAX server's tick-progress
        count)."""
        return self._step_no

    # ---------------------------------------------------- request lifecycle
    def cancel(self, rid: int) -> bool:
        """Cooperative cancel, effective at once on the host: a waiting (or
        swapped-out) request leaves the queue and any parked host KV is
        discarded; a running request's blocks — the speculative window's
        reservation included — roll back through the refcount-safe
        ``BlockAllocator.truncate``. Returns False for unknown or finished
        rids; a cancelled request never appears in the results
        (``status(rid)`` says ``"cancelled"``)."""
        ent = self._sched.cancel(rid)
        if ent is not None:
            self._drop_entry(ent, "cancelled")
            return True
        for s in range(self.max_batch):
            req = self._slots[s]
            if req is not None and req.rid == rid:
                req.table = self.alloc.truncate(req.table, 0)
                self._dropped[rid] = "cancelled"
                self._cancelled += 1
                m = self._req_metrics.get(rid)
                if m is not None:
                    m["done_t"] = self._wall()
                self._release_slot(s)
                return True
        return False

    def status(self, rid: int) -> str:
        """One of ``done / cancelled / expired / running / prefilling /
        swapped / preempted / queued / unknown`` (the JAX server's
        ``failed``, a request quarantined by fault handling, comes with
        the fault handling)."""
        if rid in self._results:
            return "done"
        if rid in self._dropped:
            return self._dropped[rid]
        for s in range(self.max_batch):
            req = self._slots[s]
            if req is not None and req.rid == rid:
                return "prefilling" if self._prefilling[s] else "running"
        for ent in self._sched.waiting():
            if ent.rid == rid:
                if ent.swap is not None:
                    return "swapped"
                return "preempted" if ent.preempted else "queued"
        return "unknown"

    def sched_metrics(self) -> Dict[str, Any]:
        """Scheduler and preemption counters, the JAX server's keys: the
        policy, queue depth, submitted / expired / cancelled requests,
        preemptions (swaps), prefill aborts, resumes, stalled
        reservations, the host pool's bytes in use and at peak, the
        swapped requests waiting, and the adapter pool's counters with
        ``lora=``. Left out: ``tenants``, the per-tenant TTFT / TPOT
        percentiles, which come from the telemetry registry (not ported;
        :meth:`request_metrics` has the marks)."""
        m = {"policy": self._sched.policy,
             "queue_depth": len(self._sched),
             "submitted": self._sched.submitted,
             "expired": self._sched.expired,
             "cancelled": self._cancelled,
             "preemptions": self._preemptions,
             "prefill_aborts": self._prefill_aborts,
             "resumes": self._resumes,
             "stalled_reservations": self._stalls,
             "host_bytes_in_use": self._offload.host.bytes_in_use,
             "host_bytes_peak": self._offload.host.bytes_peak,
             "swapped_waiting": sum(1 for e in self._sched.waiting()
                                    if e.swap is not None)}
        if self._lora is not None:
            m.update(self._lora.stats())
        return m

    def request_metrics(self) -> Dict[int, Dict[str, Any]]:
        """Per-rid clock marks — ``submit_t``, ``first_token_t``,
        ``done_t``, ``n_generated`` — and the request's ``tenant``, from
        which TTFT and the time per token follow (the server's ``clock``,
        default ``time.monotonic``)."""
        return self._req_metrics

    def assert_conserved(self) -> Dict[str, int]:
        """Pool conservation invariants; raises AssertionError on a leak.
        Checked between steps:

        - block identity: ``in_use + cached + free == num_blocks - 1``
          (block 0 is scratch) and no block is left pinned;
        - refcount audit: the allocator's live refcounts equal the
          multiset of block-table entries across occupied slots;
        - host-pool audit: parked bytes equal the sum over waiting swapped
          entries, in both ledgers (the host pool's and the allocator's);
        - adapter-pool audit (with ``lora=``): the same identity over
          pages, and page refs equal the occupied slots holding each page.

        Returns the audited numbers (the JAX server's keys less the warm
        tier's and the tensor-parallel shards')."""
        from collections import Counter

        a = self.alloc
        errs: List[str] = []
        usable = a.num_blocks - 1
        if a.blocks_in_use + a.blocks_cached + a.blocks_free != usable:
            errs.append(
                f"block identity broken: in_use={a.blocks_in_use} + "
                f"cached={a.blocks_cached} + free={a.blocks_free} != "
                f"usable={usable}")
        if a.pinned_blocks != 0:
            errs.append(f"{a.pinned_blocks} blocks left pinned between "
                        f"steps (pins must be copy-scoped)")
        expect: Counter = Counter()
        for s in range(self.max_batch):
            req = self._slots[s]
            if req is not None:
                expect.update(req.table)
        refs = a.ref_counts()
        if dict(expect) != refs:
            extra = {b: n for b, n in refs.items() if expect.get(b) != n}
            missing = {b: n for b, n in expect.items() if refs.get(b) != n}
            errs.append(f"refcount audit failed: allocator-only={extra} "
                        f"tables-only={missing}")
        swapped = [e for e in self._sched.waiting() if e.swap is not None]
        parked = sum(e.swap.nbytes for e in swapped)
        host = self._offload.host
        if host.bytes_in_use != parked:
            errs.append(f"host pool ledger {host.bytes_in_use} != sum of "
                        f"waiting swap handles {parked}")
        if a.host_bytes_in_use != parked:
            errs.append(f"allocator host ledger {a.host_bytes_in_use} != "
                        f"sum of waiting swap handles {parked}")
        if len(host) != len(swapped):
            errs.append(f"host pool parks {len(host)} payloads but "
                        f"{len(swapped)} entries are swapped")
        if self._lora is not None:
            la = self._lora.alloc
            lu = la.num_blocks - 1
            if la.blocks_in_use + la.blocks_cached + la.blocks_free != lu:
                errs.append(
                    f"adapter page identity broken: in_use="
                    f"{la.blocks_in_use} + cached={la.blocks_cached} + "
                    f"free={la.blocks_free} != usable={lu}")
            pexp: Counter = Counter()
            for s in range(self.max_batch):
                if self._slots[s] is not None and int(self.aidx[s]) > 0:
                    pexp[int(self.aidx[s])] += 1
            if dict(pexp) != la.ref_counts():
                errs.append(f"adapter page refs {la.ref_counts()} != "
                            f"slot aidx multiset {dict(pexp)}")
        if errs:
            raise AssertionError("; ".join(errs))
        return {"blocks_in_use": a.blocks_in_use,
                "blocks_cached": a.blocks_cached,
                "blocks_free": a.blocks_free,
                "host_bytes_in_use": parked,
                "swapped_waiting": len(swapped)}

    def load_metrics(self) -> Dict[str, int]:
        """O(1) load signals for routing: queue depth, occupied and total
        slots, the allocator's admission headroom and the queue's
        annotated block demand."""
        return {"queue_depth": len(self._sched),
                "slots_occupied": sum(sl is not None for sl in self._slots),
                "slots_total": self.max_batch,
                "blocks_headroom": (self.alloc.blocks_free
                                    + self.alloc.evictable_cached),
                "queued_kv_demand": self._sched.kv_demand()}

    def probe_prefix(self, prompt: Sequence[int]) -> int:
        """Cached prefix blocks this server could reuse for ``prompt`` (an
        adapterless request's chain). Read-only: takes no references."""
        return self.alloc.probe_prefix(list(prompt))

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
