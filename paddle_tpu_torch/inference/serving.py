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

Observability and recovery (as in the JAX server):

- ``telemetry=`` (None, a bool or a
  :class:`~paddle_tpu_torch.telemetry.ServingTelemetry`): the metrics
  registry is always live — ``sched_metrics()`` is a view of its counters,
  TTFT / TPOT are observed at completion — and an enabled facade records
  per-request spans (a decode or verify window's span closes after the
  host holds its tokens; a prefill chunk's is the host's dispatch time, as
  JAX's, with no synchronise added) and one flight record a step, whose
  ``recompiles`` is the executor's CUDA graph captures in the step. Every
  32 records the watchdog runs; a preemption storm or a stall run puts the
  server in a degraded mode for 64 steps (speculation off, admission
  asking for more spare blocks). With ``telemetry=None`` the server adds
  no clock read and no synchronise.
- ``faults=`` (a :class:`~paddle_tpu_torch.faults.FaultInjector`) and
  ``fault_retries=``: the degradation ladder. A ``tick`` fault fires before
  the step's graph replay (which writes the pools in place and advances a
  sampled window's generator), so the retried trip is the same replay;
  the participants take strikes and back off, and a request past
  ``fault_retries`` strikes is quarantined (``status`` ``"failed"``);
  ``kind="fatal"`` leaves the server failed (``submit`` raises
  ``EngineFailedError``). ``alloc`` and ``host_put`` faults take the
  dry-pool and stall paths, a ``drafter`` fault a plain decode trip, and a
  swap payload that fails its CRC (``swap_corrupt``) rebuilds the
  request's KV from its tokens and resumes it — the re-prefill rung. The
  JAX server prefills ``prompt + generated[:-1]``; the port prefills the
  prompt and then feeds ``generated`` back through the decode program,
  one known token a tick (``_Request.force``): on the card a prefill
  chunk's products are not a decode tick's bit for bit, and at a near
  tie of the logits a prefilled KV row flips the request's later greedy
  tokens, where the decode program rebuilds the rows the request wrote.
  Each rung is counted and traced.
- ``warm_pool_bytes=`` and ``tier_demote_low=`` / ``tier_demote_high=``:
  the warm KV tier (``kv_offload.WarmTier``): below the low watermark of
  free blocks the coldest cached prefix blocks move to host memory until
  the high one is reached; a later prefix match promotes them.
- :meth:`~GenerationServer.snapshot` / :meth:`~GenerationServer.restore`,
  :meth:`~GenerationServer.evacuate`,
  :meth:`~GenerationServer.admit_migrated`,
  :meth:`~GenerationServer.adopt_warm` and :meth:`~GenerationServer.fail`:
  a snapshot carries every request's host state and, for decoding slots,
  their KV blocks (gathered into host memory without disturbing the
  server) behind CRCs; a restore re-enters each through the swap-in path
  into the restoring server's own pools. Where the JAX snapshot carries
  its sampling key, the port's carries the server generator's state
  (``torch.Generator.get_state()``); greedy continuation is
  token-identical, a sampled request keeps its distribution.
- :meth:`~GenerationServer.watchdog_findings`,
  :meth:`~GenerationServer.slo_observations`,
  :meth:`~GenerationServer.telemetry_snapshot` and
  :meth:`~GenerationServer.export_chrome_trace`.

Not ported yet (their constructor arguments raise ``NotImplementedError``
when given a non-default value): the dense cache and ``prompt_buckets``,
tensor/context parallelism (``mesh``), replica roles (``role``, with
``handoff_ready``: the handoff set is filled only by a prefill-class
replica of the disaggregated fleet), tuned profiles (``profile``) and
``kernels="pallas"`` (the port has no interpret mode). The fleet's fault
sites come with the fleet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..faults import (NULL_INJECTOR, EngineFailedError, FaultInjector,
                      TickFault)
from ..models.generation import next_token
from ..telemetry import ServingTelemetry, watchdog
from .executor import PagedExecutor
from .kv_offload import KVOffloadEngine, SwapHandle, payload_checksum
from .lora import AdapterPool
from .paged_cache import BlockAllocator
from .scheduler import PRIORITY_NORMAL, SchedEntry, Scheduler

# the JAX server's constructor arguments that the port does not serve yet,
# each at the one value it takes (the JAX default); any other value raises
# NotImplementedError. The constructor keeps the JAX server's parameter
# order, so that a positional call means the same in both packages
_UNPORTED_DEFAULTS = {
    "prompt_buckets": (32, 64, 128),
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
    # the re-prefill rung: when a swap payload fails its CRC, the KV of
    # this sequence (prompt + generated[:-1]) is rebuilt instead of
    # restored: the prompt by chunked prefill, the generated tokens by
    # decode ticks fed from `force`
    replay: Optional[List[int]] = None
    # while a replay's decode rebuild runs: the known inputs of its next
    # ticks (their outputs are known already)
    force: Optional[List[int]] = None


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
    :meth:`request_metrics` and of a telemetry facade the server builds.
    ``host_pool_bytes``: byte cap of the pinned host pool that swap
    preemption parks victims' KV blocks in — None unbounded, 0 no swapping
    (victims then stall instead of parking). ``warm_pool_bytes``: byte cap
    of the warm tier (None unbounded); ``tier_demote_low`` /
    ``tier_demote_high``: the free-block watermarks of demotion, as a pair
    with ``0 < low < high <= 1`` (None: no demotion).

    ``telemetry``: None / False (the registry only), True (spans and the
    flight recorder too) or a :class:`~paddle_tpu_torch.telemetry.
    ServingTelemetry`; ``faults``: None or a :class:`~paddle_tpu_torch.
    faults.FaultInjector`; ``fault_retries``: tick-fault strikes a request
    survives before it is quarantined (see the module docstring).

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
        if (tier_demote_low is None) != (tier_demote_high is None):
            raise ValueError(
                "tier_demote_low/tier_demote_high come as a pair — set "
                "both watermarks (or neither to keep demotion off)")
        if tier_demote_low is not None:
            low, high = float(tier_demote_low), float(tier_demote_high)
            if not (0.0 < low < high <= 1.0):
                raise ValueError(
                    f"tier watermarks must satisfy 0 < low < high <= 1, "
                    f"got low={tier_demote_low} high={tier_demote_high}")
            tier_demote_low, tier_demote_high = low, high
        self.tier_demote_low = tier_demote_low
        self.tier_demote_high = tier_demote_high
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
        # rid -> cancelled | expired | failed
        self._dropped: Dict[int, str] = {}
        # per-rid clock marks (submit / first token / done)
        self._req_metrics: Dict[int, Dict[str, Any]] = {}
        self._idle_streak = 0
        self._stall_streak = 0
        self._next_rid = 0
        self._step_no = 0
        # preemption counters; their registry twins below are what
        # sched_metrics() reads
        self._preemptions = 0
        self._prefill_aborts = 0
        self._resumes = 0
        self._stalls = 0

        if faults is None:
            self._faults = NULL_INJECTOR
        elif isinstance(faults, FaultInjector):
            self._faults = faults
        else:
            raise ValueError(
                f"faults must be None or a FaultInjector, got {faults!r}")
        self.faults = self._faults
        if not isinstance(fault_retries, int) or fault_retries < 0:
            raise ValueError(
                f"fault_retries must be an int >= 0, got {fault_retries!r}")
        self.fault_retries = fault_retries
        # degradation-ladder state (host ints; see step)
        self._failed: Optional[str] = None      # terminal-failure reason
        self._strikes: Dict[int, int] = {}      # rid -> tick-fault strikes
        self._backoff_ticks = 0                 # ticks left to sit out
        self._degraded_ticks = 0                # pressure-response cooldown
        self._tick_faults = 0
        self._quarantined = 0

        if telemetry is None or telemetry is False or telemetry is True:
            on = telemetry is True
            self._tel = (ServingTelemetry(enabled=on) if clock is None
                         else ServingTelemetry(enabled=on, clock=clock))
        elif isinstance(telemetry, ServingTelemetry):
            self._tel = telemetry
        else:
            raise ValueError(
                f"telemetry must be None, a bool, or a ServingTelemetry "
                f"instance, got {telemetry!r}")
        self.telemetry = self._tel
        reg = self._tel.registry
        self._sched.attach_metrics(reg)
        self._c_preempt = reg.counter(
            "serving_preemptions", "decoding slots swapped out to host")
        self._c_aborts = reg.counter(
            "serving_prefill_aborts",
            "prefilling slots aborted under pool pressure (recomputable)")
        self._c_resumes = reg.counter(
            "serving_resumes", "swapped requests restored into a slot")
        self._c_stalls = reg.counter(
            "serving_stalled_reservations",
            "block reservations that found no victim and no headroom")
        self._c_completed = reg.counter(
            "serving_requests_completed", "requests finished with results")
        self._c_dropped = reg.counter(
            "serving_requests_dropped",
            "requests dropped before finishing (reason label)")
        self._h_ttft = reg.histogram(
            "serving_ttft_s",
            "submit -> first token, completed requests (seconds)")
        self._h_tpot = reg.histogram(
            "serving_tpot_ms",
            "per-token latency after the first, completed requests (ms)",
            buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                     250.0, 500.0, 1000.0, 2500.0))
        self._h_e2e = reg.histogram(
            "serving_e2e_s", "submit -> done, completed requests (seconds)")
        self._c_faults = reg.counter(
            "serving_faults_injected",
            "fault-injector firings observed by the server (site label)")
        self._c_retries = reg.counter(
            "serving_tick_retries",
            "decode trips retried after a recoverable tick fault")
        self._c_failed = reg.counter(
            "serving_requests_failed",
            "requests quarantined to terminal failed status (reason label)")
        self._c_corrupt = reg.counter(
            "serving_swap_reprefills",
            "corrupted swap payloads recovered by re-prefill")
        self._c_degrade = reg.counter(
            "serving_degrade_events",
            "watchdog-driven degradation responses (kind label)")
        # program key of the last trip, recorded per step by the flight
        # recorder; the watchdog keys its recompile excusal on it
        self._last_prog = "idle"

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
                                        capacity_bytes=host_pool_bytes,
                                        warm_capacity_bytes=warm_pool_bytes)
        self._offload.telemetry = self._tel
        # prefix chains that ran out of cached ancestry while a warm tier
        # held blocks and paid a fresh chunked prefill (the cold tier)
        self._cold_refills = 0
        if self._faults is not NULL_INJECTOR:
            # the injector is threaded through even while disabled (a
            # harness arms its plan later); the null injector never is, so
            # each hook stays an `is None` check
            self.alloc.faults = self._faults
            self._offload.faults = self._faults
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
            if self._faults is not NULL_INJECTOR \
                    and hasattr(self.drafter, "faults"):
                self.drafter.faults = self._faults
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
        admission.

        Raises :class:`~paddle_tpu_torch.faults.EngineFailedError` once the
        server is in a terminal failed state."""
        if self._failed is not None:
            raise EngineFailedError(
                f"server is in a terminal failed state ({self._failed}) — "
                f"restore a snapshot into a fresh server or rebuild")
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
        if self._tel.enabled:
            tr = self._tel.tracer
            tr.set_meta(rid, tenant=tenant, priority=priority,
                        prompt_len=len(prompt), adapter=adapter or "")
            tr.begin(rid, "queued", priority=priority, tenant=tenant)
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
        if self._tel.enabled:
            self._tel.tracer.end(req.rid, "prefill")
            self._tel.tracer.instant(req.rid, "first_token")

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
        self._c_dropped.inc(reason=reason)
        m = self._req_metrics.get(ent.rid)
        if m is not None:
            m["done_t"] = self._wall()
        if ent.swap is not None:
            self._offload.discard(ent.swap)
            ent.swap = None
        self._tel.tracer.close(ent.rid, reason)

    def _admit_paged(self, slot: int, req: _Request) -> None:
        """Claim a slot: take the request's adapter page (an upload on a
        miss), reuse cached prefix blocks — hot ones by reference, warm
        ones promoted (``kv_offload.match_prefix_tiered``); the matched
        span skips prefill — and start chunked prefill at the first
        uncached block. A re-prefill replay prefills its prompt the same
        way; its generated tokens follow through decode
        (:meth:`_activate_replayed`)."""
        if self._lora is not None:
            self.aidx[slot] = (self._lora.acquire(req.adapter)
                               if req.adapter is not None else 0)
        seq = req.prompt
        req.salt = self._salt(req.adapter)
        req.table, _, tiers = self._offload.match_prefix_tiered(
            seq, self._exec._flat_pools, req.salt)
        req.hashes = self.alloc.chain_hashes(seq, req.salt)
        req.pf_next = len(req.table) * self.block_size
        if req.pf_next < len(seq) and self._offload.warm.demoted_blocks:
            # the chain ran out of cached ancestry while a warm tier is
            # live: the rest re-prefills cold
            self._cold_refills += 1
        self._bt[slot, :] = 0
        self._bt[slot, :len(req.table)] = req.table
        self._prefilling[slot] = True
        self._slots[slot] = req
        if self._tel.enabled:
            tr = self._tel.tracer
            tr.end(req.rid, "queued")
            tr.begin(req.rid, "prefill", cached_blocks=len(req.table),
                     warm_blocks=tiers["warm"], prompt_len=len(seq),
                     replay=req.replay is not None)

    def _admissible(self, ent: SchedEntry) -> bool:
        """Block-headroom gate: the entry's first allocation burst (the
        whole prompt less its device-resident prefix blocks for a fresh or
        replayed request; the parked blocks not still resident for a
        swapped one) plus one spare block (three while the server is
        degraded) must be reclaimable now."""
        adapter = ent.req.adapter
        if adapter is not None and not self._lora.can_acquire(adapter):
            # every adapter page is held by a running slot: wait for one
            # to finish or be preempted
            return False
        if ent.swap is not None:
            need = self._offload.restore_cost(ent.swap)
        else:
            seq = ent.req.prompt
            need = min(self._max_entries, -(-len(seq) // self.block_size))
            # hot hits only: a warm hit still promotes into a fresh block
            need = max(need - self.alloc.probe_prefix(
                seq, self._salt(adapter), hot_only=True), 1)
        ent.kv_need = need          # the scheduler's queued-demand sum
        # while degraded (a watchdog pressure finding), admission asks for
        # more spare blocks so that it stops feeding the pressure
        spare = 3 if self._degraded_ticks > 0 else 1
        headroom = min(need + spare, self.alloc.num_blocks - 1)
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

    def _maybe_demote(self) -> None:
        """Watermark-driven demotion (the tier ladder's pressure rung):
        when the free share of usable blocks drops below
        ``tier_demote_low``, move the coldest cached prefix blocks to the
        warm tier until it reaches ``tier_demote_high``, so that admission
        finds free blocks instead of evicting the prefix cache (eviction
        loses the bytes; demotion keeps them promotable). Runs before
        admission each step; a no-op without watermarks or cached
        blocks."""
        low = self.tier_demote_low
        if low is None:
            return
        a = self.alloc
        usable = a.num_blocks - 1
        if usable <= 0 or a.blocks_free / usable >= low:
            return
        want = int(self.tier_demote_high * usable) - a.blocks_free
        if want <= 0:
            return
        victims = a.coldest_cached(want)
        if victims:
            self._offload.demote(victims, self._exec._flat_pools)

    # ------------------------------------------------- preemption / offload
    def _resume_swapped(self, slot: int, ent: SchedEntry) -> bool:
        """Restore a swapped-out request into ``slot`` where it stopped:
        KV blocks back from host (prefix-hash hits skip the upload), its
        position, next token and sampling scalars from the request. The
        greedy continuation equals the un-preempted run's: the round trip
        is bit-exact and the decode products are batch-invariant. Returns
        False (entry untouched) when device headroom vanished.

        A payload that fails its CRC takes the re-prefill rung: the
        request's tokens are host state, so the KV of ``prompt +
        generated[:-1]`` (``handle.n_tokens`` tokens, the coverage at
        swap-out) is rebuilt — the prompt by chunked prefill, the
        generated tokens by decode — and it then decodes on as if nothing
        happened."""
        req = ent.req
        res = self._offload.swap_in(ent.swap, self._exec._flat_pools)
        if res is None:
            return False
        if res == "corrupt":
            handle, ent.swap = ent.swap, None
            self._c_corrupt.inc()
            req.replay = (req.prompt + req.generated)[:handle.n_tokens]
            req.force = None
            if self._tel.enabled:
                tr = self._tel.tracer
                tr.end(req.rid, "preempted", corrupt=True)
                tr.begin(req.rid, "queued", reason="swap_corrupt")
            self._admit_paged(slot, req)
            return True
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
        self._c_resumes.inc()
        if self._tel.enabled:
            self._tel.tracer.end(req.rid, "preempted", resumed=True)
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
            self._c_aborts.inc()
            if self._tel.enabled:
                tr = self._tel.tracer
                tr.end(req.rid, "prefill", aborted=True)
                tr.begin(req.rid, "queued", reason="prefill_abort")
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
            self._c_preempt.inc()
            if self._tel.enabled:
                # the time parked on host; the swap_out / swap_in spans
                # come from the offload engine
                self._tel.tracer.begin(req.rid, "preempted",
                                       blocks=handle.n_blocks)
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
                self._c_stalls.inc()
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
        chunk, take the first token and flip the slot to decoding (a
        re-prefill replay instead starts its decode rebuild: nothing is
        sampled). The chunk's ``prefill_chunk`` span is the host's dispatch
        time, as in JAX: a non-final chunk is not synchronised for it."""
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
        tel = self._tel
        t0 = tel.clock() if tel.enabled else 0.0
        w0 = time.perf_counter()
        lg = self._exec.chunk_prefill(
            st["chunk"], st["table"], st["start"], st["last_idx"],
            st["chunk_aidx"] if self._lora is not None else None)
        if tel.enabled:
            tel.tracer.complete(req.rid, "prefill_chunk", t0, tel.clock(),
                                start=start, tokens=end - start)
        final = end == n
        first = (self._first_token(req, lg)
                 if final and req.replay is None else None)
        if first is None:
            lg.cpu()    # the host copy closes the timed span on the device
        self._prefill_tokens += end - start
        self._prefill_chunks += 1
        self._prefill_wall_s += time.perf_counter() - w0
        # publish the prompt blocks this chunk completed for prefix reuse
        # (a freshly prefilled hash supersedes any stale warm copy)
        for i in range(start // bs, end // bs):
            self.alloc.register(req.table[i], req.hashes[i])
            self._offload.forget_warm(req.hashes[i])
        req.pf_next = start + C
        if final:
            if req.replay is not None:
                self._activate_replayed(slot, req)
            else:
                self._activate_slot(slot, req, first)
            self._prefilling[slot] = None

    def _activate_replayed(self, slot: int, req: _Request) -> None:
        """Start a re-prefill replay's decode rebuild: the chunked prefill
        rebuilt the prompt's KV; decode ticks now take the generated
        tokens as their inputs, one a tick (``req.force``), each writing
        its token's KV as the request's own decode did, their outputs
        discarded. Past the last, the request decodes on from the state a
        swap-in restore lands on. Nothing is sampled here."""
        req.replay = None
        self.pos[slot] = len(req.prompt)
        self.tokens[slot] = req.generated[0]
        req.force = req.generated[1:] or None
        self.temps[slot] = req.temperature
        self.topks[slot] = req.top_k
        self.topps[slot] = req.top_p
        if self.spec is not None:
            self.kcaps[slot] = (self.spec_k if req.draft_k is None
                                else req.draft_k)
        if self._tel.enabled:
            self._tel.tracer.end(req.rid, "prefill", replayed=True)

    def _plain_decode_trip(self, active, ticks: Optional[int] = None) -> None:
        """One decode trip: ``ticks`` (default ``tick_window``) ticks across
        the listed slots in one program. Idle and prefilling rows run
        masked — zeroed table and pos 0 route their discarded K/V writes to
        scratch block 0, which keeps the batch shape fixed."""
        k = self.tick_window if ticks is None else ticks
        tel = self._tel
        active = self._reserve_active(
            active, lambda s: -(-(int(self.pos[s]) + k) // self.block_size))
        if not active:
            if tel.enabled:
                self._last_prog = "stalled"
            return
        greedy, active_mask = self._stage_rows(active)
        if tel.enabled:
            # the program key: the tick count and the greedy
            # specialization are the decode graphs' keys
            self._last_prog = (f"plain:t{'w' if ticks is None else ticks}"
                               f":g{int(greedy)}")
            t0 = tel.clock()
            rids = [self._slots[s].rid for s in active]
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
        if tel.enabled:
            # retroactive: one replay advanced every listed row, each
            # request gets the same span, closed after the host holds the
            # window's tokens (the copy above)
            t1 = tel.clock()
            for rid in rids:
                tel.tracer.complete(rid, "decode_window", t0, t1, ticks=k)

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
            if req.force is not None:
                # a replay's rebuild tick (trips of 1 tick while one runs):
                # it wrote a known token's KV; the next input is known too
                self.tokens[s] = req.force.pop(0)
                if not req.force:
                    req.force = None
                continue
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
        """A request finished: publish its tokens, close its metrics. TTFT
        and TPOT are observed HERE, at completion, into the registry's
        histograms: the tenant breakdown and a benchmark's percentiles
        are two views of the same samples."""
        self._results[req.rid] = req.prompt + req.generated[
            :req.max_new_tokens]
        m = self._req_metrics.get(req.rid)
        if m is not None:
            m["done_t"] = self._wall()
            m["n_generated"] = min(len(req.generated), req.max_new_tokens)
            tenant = m.get("tenant", "default")
            pr = (req.sched.priority if req.sched is not None
                  else PRIORITY_NORMAL)
            self._c_completed.inc(tenant=tenant)
            if "first_token_t" in m:
                self._h_ttft.observe(m["first_token_t"] - m["submit_t"],
                                     tenant=tenant, priority=pr)
                self._h_e2e.observe(m["done_t"] - m["submit_t"],
                                    tenant=tenant)
                n = int(m["n_generated"])
                if n > 1:
                    self._h_tpot.observe(
                        (m["done_t"] - m["first_token_t"]) / (n - 1) * 1e3,
                        tenant=tenant)
        self._tel.tracer.close(req.rid, "complete")

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
        """The step's decode work for ``active`` slots — the one place a
        tick fault fires, and it fires before anything that changes device
        state a retry would not rewrite: before the graph replay, which
        writes the pools in place and advances a sampled window's
        generator (a reservation it may follow is host state the retry
        finds made). With ``spec``: the gate runs ``spec.gate_cooldown``
        plain trips of ``spec.gate_ticks`` ticks after a trip of low
        acceptance, then probes speculation again; a degraded server runs
        plain trips too; a :class:`~.speculative.DrafterFault` runs the
        trip through the plain program and holds the gate off."""
        if self._faults.enabled:
            spec = self._faults.fire("tick")
            if spec is not None:
                self._c_faults.inc(site="tick")
                if spec.kind == "fatal":
                    raise RuntimeError("injected fatal engine fault")
                raise TickFault(rid=spec.rid)
        if any(self._slots[s].force is not None for s in active):
            # a replay's decode rebuild feeds its known tokens from the
            # host, one a tick
            self._plain_decode_trip(active, 1)
            return
        if self.spec is None:
            self._plain_decode_trip(active)
            return
        if self._spec_gate_off > 0 or self._degraded_ticks > 0:
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
            self._c_faults.inc(site="drafter")
            self._spec_gate_off = max(int(self.spec.gate_cooldown) or 0, 4)
            self._spec_turbo = False
            self._spec_plain_windows += self.spec.gate_ticks
            self._plain_decode_trip(active, self.spec.gate_ticks)

    def _on_tick_fault(self, rids, fault) -> None:
        """Degradation ladder, strike rung: attribute the fault (to its
        named rid when the plan says so, else to every participant), back
        off exponentially, and quarantine any request past its retries —
        one poison request must never take the engine down."""
        self._tick_faults += 1
        self._c_retries.inc()
        targets = rids
        rid = getattr(fault, "rid", None)
        if rid is not None and rid in rids:
            targets = [rid]
        worst = 0
        for r in targets:
            self._strikes[r] = self._strikes.get(r, 0) + 1
            worst = max(worst, self._strikes[r])
        # 1, 2, 4, 8 ticks — capped so a noisy plan cannot idle the engine
        self._backoff_ticks = min(1 << max(worst - 1, 0), 8)
        for r in list(targets):
            if self._strikes.get(r, 0) > self.fault_retries:
                self._quarantine_rid(r, "tick_fault_retries_exhausted")

    def _quarantine_rid(self, rid: int, reason: str) -> None:
        """Terminal ``failed`` status for one request: release its slot,
        blocks and adapter page, or its queue entry and parked KV; record
        why. The engine keeps serving."""
        self._strikes.pop(rid, None)
        self._quarantined += 1
        self._dropped[rid] = "failed"
        self._c_failed.inc(reason=reason)
        self._c_dropped.inc(reason="failed")
        m = self._req_metrics.get(rid)
        if m is not None:
            m["done_t"] = self._wall()
        for s in range(self.max_batch):
            req = self._slots[s]
            if req is not None and req.rid == rid:
                req.table = self.alloc.truncate(req.table, 0)
                self._tel.tracer.close(rid, "failed")
                self._release_slot(s)
                return
        ent = self._sched.remove(rid)
        if ent is not None:
            if ent.swap is not None:
                self._offload.discard(ent.swap)
                ent.swap = None
            self._tel.tracer.close(rid, "failed")

    def _spec_tick(self, active) -> None:
        """One speculative trip: every decoding slot drafts k tokens, one
        verify window scores the k+1 positions, exact accept/reject emits 1
        to k+1 tokens a row — a fusible drafter's ``S`` windows as one
        program (``tick_window``, or ``turbo_windows`` in the turbo tier),
        a host-side drafter's one. Blocks for all ``S·(k+1)`` positions
        are reserved up front; the harvest truncates back."""
        if self._spec_fused and self._faults.enabled \
                and self._faults.fire("drafter") is not None:
            # a fused drafter proposes in the program, so its host propose
            # hook never runs: the site is consulted here, before any
            # reservation or replay
            from .speculative import DrafterFault

            raise DrafterFault("injected drafter failure (fused path)")
        k = self.spec_k
        S = self._spec_windows
        if self._spec_turbo and self.spec.turbo_windows > S:
            S = self.spec.turbo_windows
        # blocks for every window of the trip, reserved up front (the
        # harvest truncates the rejected drafts' back)
        tel = self._tel
        active = self._reserve_active(
            active, lambda s: -(-(int(self.pos[s]) + S * (k + 1))
                                // self.block_size))
        if not active:
            if tel.enabled:
                self._last_prog = "stalled"
            return
        greedy, active_mask = self._stage_rows(active)
        if tel.enabled:
            self._last_prog = f"spec:w{S}:g{int(greedy)}"
            t0 = tel.clock()
            rids = [(s, self._slots[s].rid) for s in active]
            kcaps = {s: int(self.kcaps[s]) for s in active}
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
        if tel.enabled:
            t1 = tel.clock()
            for s, rid in rids:
                tel.tracer.complete(
                    rid, "spec_window", t0, t1, windows=int(accs.shape[0]),
                    accepted=int(accs[:, s].sum()),
                    proposed=int(accs.shape[0]) * kcaps[s])
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
        """One server step: demote under pool pressure (with watermarks),
        service the queue (expiry, admission in policy order, one
        preemption for a more urgent waiter), advance one prefill chunk per
        prefilling slot, then one decode trip across decoding slots (or sit
        it out while a tick fault's backoff lasts); returns #remaining
        (occupied slots + queued). The first step after a submit or a
        ``run()`` checks that the model's weights are those the server was
        built over (``PagedExecutor.check_weights``). With telemetry
        enabled, each step leaves a flight record, and every 32 records the
        watchdog may put the server in its degraded mode."""
        if not self._weights_checked:
            self._exec.check_weights()
            self._weights_checked = True
        tel = self._tel
        if not tel.enabled:
            return self._step_inner()
        a = self.alloc
        t0 = tel.clock()
        c0 = self._exec.captures
        pre = (self._preemptions, self._prefill_aborts, self._resumes,
               self._stalls, a.fresh_allocs, a.evictions,
               a.swap_out_blocks, a.swap_in_blocks,
               a.demoted_blocks, a.promoted_blocks)
        sp0, sa0 = ((self._spec_proposed, self._spec_accepted)
                    if self.spec is not None else (0, 0))
        remaining = self._step_inner()
        rec = {
            "t_wall_s": tel.clock() - t0,
            "prog": self._last_prog,
            "decoding": sum(1 for s in range(self.max_batch)
                            if self._slots[s] is not None
                            and not self._prefilling[s]),
            "prefilling": sum(1 for s in range(self.max_batch)
                              if self._prefilling[s]),
            "queue_depth": len(self._sched),
            "blocks_in_use": a.blocks_in_use,
            "blocks_allocated": a.fresh_allocs - pre[4],
            "evictions": a.evictions - pre[5],
            "preemptions": self._preemptions - pre[0],
            "prefill_aborts": self._prefill_aborts - pre[1],
            "resumes": self._resumes - pre[2],
            "stalls": self._stalls - pre[3],
            "swap_out_blocks": a.swap_out_blocks - pre[6],
            "swap_in_blocks": a.swap_in_blocks - pre[7],
            "swap_bytes": (a.swap_out_blocks - pre[6]
                           + a.swap_in_blocks - pre[7]) * a.bytes_per_block,
            "host_bytes": self._offload.host.bytes_in_use,
            "demotions": a.demoted_blocks - pre[8],
            "promotions": a.promoted_blocks - pre[9],
            "warm_bytes": self._offload.warm.bytes_in_use,
            # the port's program builds: CUDA graphs captured in the step
            "recompiles": self._exec.captures - c0,
        }
        if self.spec is not None:
            rec["spec_proposed"] = self._spec_proposed - sp0
            rec["spec_accepted"] = self._spec_accepted - sa0
        tel.flight.record(**rec)
        # pressure response: every 32 records, the watchdog over the recent
        # window; a preemption storm or a stall run makes the server
        # degraded for a cooldown (speculation off, admission tightened)
        if tel.flight.total % 32 == 0:
            finds = [f for f in watchdog(tel.flight.dump()[-64:])
                     if f["kind"] in ("preemption_storm",
                                      "pool_pressure_stall")]
            if finds:
                if self._degraded_ticks == 0:
                    for f in finds:
                        self._c_degrade.inc(kind=f["kind"])
                self._degraded_ticks = 64
        return remaining

    def _step_inner(self) -> int:
        tel_on = self._tel.enabled
        if tel_on:
            self._last_prog = "idle"
        # demote BEFORE admission: freed blocks feed this step's headroom
        self._maybe_demote()
        self._service_queue()
        did_prefill = False
        for s in range(self.max_batch):
            if self._slots[s] is not None and self._prefilling[s]:
                self._prefill_chunk_step(s)
                did_prefill = True
        active = [s for s in range(self.max_batch)
                  if self._slots[s] is not None and not self._prefilling[s]]
        if self._degraded_ticks > 0:
            self._degraded_ticks -= 1
        if active:
            self._step_no += 1
            if self._backoff_ticks > 0:
                # backoff rung: a tick fault left the state untouched (it
                # fires before the replay), so sitting out a few steps lets
                # a transient fault clear before the same trip is retried
                self._backoff_ticks -= 1
                if tel_on:
                    self._last_prog = "backoff"
            else:
                rids = [self._slots[s].rid for s in active]
                try:
                    self._dispatch_trips(active)
                except TickFault as e:
                    self._on_tick_fault(rids, e)
                except Exception as e:
                    # an exception after a replay may have left the pools
                    # half written: no further trip is safe; the server is
                    # failed (submit refuses) and the error propagates
                    self._failed = f"{type(e).__name__}: {e}"
                    raise
                else:
                    # a clean trip clears its participants' strikes
                    for r in rids:
                        self._strikes.pop(r, None)
        if tel_on and did_prefill:
            # prefill-bearing steps get their own program key: the chunk
            # graph's one capture must not read as a recapture of an
            # already-warm decode program
            self._last_prog += "+pf"
        occupied = sum(sl is not None for sl in self._slots)
        if occupied == 0 and len(self._sched) > 0:
            # every slot empty yet entries wait: admission against an idle
            # pool must succeed, so a streak means corrupted state
            self._idle_streak += 1
            if self._idle_streak > 64:
                self._failed = ("scheduler wedged: 64 steps with empty "
                                "slots and a non-empty queue")
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
                self._c_dropped.inc(reason="cancelled")
                m = self._req_metrics.get(rid)
                if m is not None:
                    m["done_t"] = self._wall()
                self._tel.tracer.close(rid, "cancelled")
                self._release_slot(s)
                return True
        return False

    def status(self, rid: int) -> str:
        """One of ``done / cancelled / expired / failed / running /
        prefilling / swapped / preempted / queued / unknown`` (``failed``:
        quarantined after exhausting its fault retries; terminal)."""
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
        swapped requests waiting, ``tenants`` (per-tenant TTFT / TPOT
        percentiles) and the adapter pool's counters with ``lora=``. A
        view over the telemetry registry: these counters are the values
        it exposes."""
        reg = self._tel.registry
        m = {"policy": self._sched.policy,
             "queue_depth": len(self._sched),
             "submitted": int(reg.counter(
                 "sched_requests_submitted").total()),
             "expired": int(reg.counter("sched_requests_expired").total()),
             "cancelled": int(self._c_dropped.total(
                 where={"reason": "cancelled"})),
             "preemptions": int(self._c_preempt.total()),
             "prefill_aborts": int(self._c_aborts.total()),
             "resumes": int(self._c_resumes.total()),
             "stalled_reservations": int(self._c_stalls.total()),
             "host_bytes_in_use": self._offload.host.bytes_in_use,
             "host_bytes_peak": self._offload.host.bytes_peak,
             "swapped_waiting": sum(1 for e in self._sched.waiting()
                                    if e.swap is not None)}
        m["tenants"] = self._tenant_breakdown()
        if self._lora is not None:
            m.update(self._lora.stats())
        return m

    def _tenant_breakdown(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant latency percentiles over COMPLETED requests: TTFT
        (submit → first token) and TPOT (a token after the first) p50 /
        p95, read from the registry's ``serving_ttft_s`` /
        ``serving_tpot_ms`` histograms (observed in :meth:`_emit_result`)."""
        out: Dict[str, Dict[str, float]] = {}
        for t in self._h_ttft.label_values("tenant"):
            xs = self._h_ttft.samples({"tenant": t})
            row = {"completed": float(len(xs))}
            if xs:
                row["ttft_p50_ms"] = float(np.percentile(xs, 50) * 1e3)
                row["ttft_p95_ms"] = float(np.percentile(xs, 95) * 1e3)
            tp = self._h_tpot.samples({"tenant": t})
            if tp:
                row["tpot_p50_ms"] = float(np.percentile(tp, 50))
                row["tpot_p95_ms"] = float(np.percentile(tp, 95))
            out[t] = row
        return out

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
        - warm-tier audit: its byte ledger equals the sum over its entries,
          and no chain hash is resident in both the hot prefix cache and
          the warm tier;
        - adapter-pool audit (with ``lora=``): the same identity over
          pages, and page refs equal the occupied slots holding each page.

        Returns the audited numbers (the JAX server's keys less the
        tensor-parallel shards')."""
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
        warm = self._offload.warm
        warm_bytes = sum(nb for _, _, nb, _ in warm.entries())
        if warm_bytes != warm.bytes_in_use:
            errs.append(f"warm tier ledger {warm.bytes_in_use} != sum of "
                        f"parked entries {warm_bytes}")
        dual = [h for h, _, _, _ in warm.entries() if a.contains_hash(h)]
        if dual:
            # promotion takes the warm copy and demotion unregisters the
            # hot block: a hash in both tiers is a half-finished handoff
            errs.append(f"{len(dual)} chain hashes resident in both the "
                        f"hot prefix cache and the warm tier")
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
                "warm_blocks": len(warm),
                "warm_bytes_in_use": warm.bytes_in_use,
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
        adapterless request's chain), hot or warm. Read-only: takes no
        references."""
        return self.alloc.probe_prefix(list(prompt))

    def set_rid_base(self, base: int) -> None:
        """Start this server's rid counter at ``base`` — only on a fresh
        server (nothing submitted yet): servers that trade requests
        (:meth:`admit_migrated`) take disjoint rid spaces."""
        if (self._next_rid != 0 or len(self._sched)
                or any(sl is not None for sl in self._slots)
                or self._results or self._dropped):
            raise ValueError("set_rid_base() requires a fresh server — "
                             "rids already handed out would collide")
        if not isinstance(base, int) or isinstance(base, bool) or base < 0:
            raise ValueError(f"rid base must be an int >= 0, got {base!r}")
        self._next_rid = base

    def fail(self, reason: str) -> None:
        """Mark this server terminally failed (idempotent — the first
        reason sticks). ``submit``, ``restore`` and ``admit_migrated``
        refuse afterwards; ``snapshot(trust_kv=False)`` still salvages its
        host state."""
        if self._failed is None:
            self._failed = str(reason)

    # --------------------------------------------------- snapshot / restore
    def _snapshot_fingerprint(self) -> Dict[str, Any]:
        """The configuration a snapshot can only restore into: what fixes
        the programs' shapes and the KV payloads' layout."""
        return {"cache": "paged",
                "block_size": self.block_size,
                "max_len": self.max_len,
                "max_batch": self.max_batch,
                "kv_quant": self.kv_quant,
                "tick_window": self.tick_window,
                "table_width": self._table_width,
                "num_blocks": self.alloc.num_blocks,
                "spec_k": self.spec_k if self.spec is not None else None,
                "lora": self._lora is not None,
                "kernels": self.kernels,
                "mk_geometry": (self.mk_geometry.asdict()
                                if self.mk_geometry is not None else None)}

    def _req_state(self, req: _Request) -> Dict[str, Any]:
        return {"rid": req.rid, "prompt": list(req.prompt),
                "max_new_tokens": req.max_new_tokens,
                "temperature": req.temperature, "top_k": req.top_k,
                "top_p": req.top_p, "generated": list(req.generated),
                "draft_k": req.draft_k, "adapter": req.adapter,
                "replay": (list(req.replay) if req.replay is not None
                           else None),
                "force": list(req.force) if req.force else None,
                "hashes": list(req.hashes)}

    def _sched_state(self, ent: SchedEntry) -> Dict[str, Any]:
        now = self._sched.now()
        return {"priority": ent.priority, "tenant": ent.tenant,
                "ttl_remaining": (None if ent.deadline is None
                                  else max(ent.deadline - now, 0.0)),
                "seq": ent.seq, "cost": ent.cost, "vtag": ent.vtag,
                "preempted": ent.preempted, "started": ent.started}

    def snapshot(self, *, trust_kv: bool = True) -> Dict[str, Any]:
        """Capture of the whole in-flight state — the drain / migrate
        primitive: every queued, prefilling, decoding and swapped request,
        with enough state that :meth:`restore` on a FRESH server over the
        same model continues each one with the greedy tokens this server
        goes on to produce.

        A decoding slot's blocks are copied into host memory
        (``KVOffloadEngine.gather_payload``: one ``index_select`` a pool
        tensor; the blocks are neither freed nor changed — this server
        keeps serving); an already-swapped entry's parked payload is
        copied; prefilling and queued work is recomputable and restores as
        queued. Each payload carries its CRC, so a payload damaged in
        transit degrades to re-prefill on the restoring side. The server's
        generator state (``torch.Generator.get_state()``) rides along in
        place of the JAX snapshot's sampling key.

        ``trust_kv=False`` captures decoding slots as replay work
        (``prompt + generated`` up to their position, re-prefilled on the
        restoring side) instead of copying their device KV — the salvage
        mode for a server whose device state cannot be trusted (a failed
        one): host request state is consistent at the last harvest, the
        pools may not be. Swapped entries keep their payloads either way
        (host memory behind a CRC)."""
        if self._failed is not None and trust_kv:
            raise ValueError(
                f"server failed ({self._failed}): device KV is untrusted "
                f"after a post-dispatch failure — capture with "
                f"snapshot(trust_kv=False) to salvage from host state")
        pools = self._exec._flat_pools
        reqs: List[Dict[str, Any]] = []
        for s in range(self.max_batch):
            req = self._slots[s]
            if req is None:
                continue
            d = self._req_state(req)
            d["sched"] = self._sched_state(req.sched)
            if self._prefilling[s]:
                # recomputable (its KV may end inside a chunk): re-queued
                d["phase"] = "queued"
            elif not trust_kv:
                # salvage through the re-prefill rung: the KV of prompt +
                # generated[:-1] rebuilt, then decode resumes with the last
                # generated token (a rebuild in progress starts over)
                d["phase"] = "queued"
                d["replay"] = (list(req.prompt) + list(req.generated))[
                    :len(req.prompt) + len(req.generated) - 1]
                d["force"] = None
            else:
                arrays = self._offload.gather_payload(req.table, pools)
                d["phase"] = "kv"
                d["kv"] = {
                    "arrays": arrays,
                    "n_tokens": int(self.pos[s]),
                    "last_token": int(self.tokens[s]),
                    "n_blocks": len(req.table),
                    "hashes": list(
                        req.hashes[:min(len(req.hashes), len(req.table))]),
                    "nbytes": len(req.table) * self.alloc.bytes_per_block,
                    "checksum": payload_checksum(arrays)}
            reqs.append(d)
        for ent in self._sched.waiting():
            d = self._req_state(ent.req)
            d["sched"] = self._sched_state(ent)
            if ent.swap is not None:
                h = ent.swap
                d["phase"] = "kv"
                d["kv"] = {"arrays": [a.clone() for a in
                                      self._offload.host.peek(h.rid)],
                           "n_tokens": h.n_tokens,
                           "last_token": h.last_token,
                           "n_blocks": h.n_blocks,
                           "hashes": list(h.hashes), "nbytes": h.nbytes,
                           "checksum": h.checksum}
            else:
                d["phase"] = "queued"
            reqs.append(d)
        snap: Dict[str, Any] = {
            "format": 1,
            "config": self._snapshot_fingerprint(),
            "generator_state": self._gen.get_state(),
            "step_no": self._step_no,
            "next_rid": self._next_rid,
            "sched": {"vnow": self._sched._vnow,
                      "tenant_tag": dict(self._sched._tenant_tag)},
            "requests": reqs,
            "results": {r: list(t) for r, t in self._results.items()},
            "dropped": dict(self._dropped),
            # the warm tier rides along in both modes: host memory behind
            # per-block CRCs, which an untrusted device cannot taint; the
            # restoring side adopts it (adopt_warm, best effort)
            "warm_tier": [
                {"hash": h, "arrays": [x.clone() for x in arrs],
                 "nbytes": nb, "checksum": crc}
                for h, arrs, nb, crc in self._offload.warm.entries()],
        }
        if self.spec is not None:
            snap["spec_state"] = {
                "gate_off": self._spec_gate_off,
                "plain_windows": self._spec_plain_windows,
                "turbo": self._spec_turbo,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted}
        return snap

    def restore(self, snap: Dict[str, Any]) -> int:
        """Rebuild a :meth:`snapshot` into THIS (idle) server; returns the
        number of requests restored.

        Every request re-enters through the normal machinery: a KV-bearing
        one becomes a swapped queue entry whose payload is adopted into the
        host pool and written into this server's own pools by the
        CRC-verified swap-in at its admission; queued and replay work
        re-queues. The configuration, the host pool's room and every
        request's adapter are checked before anything changes (a refused
        snapshot leaves this server as it was). The generator state is set
        here, before this server's next replay (and, on a fresh server, its
        first capture); the speculation gate's state with ``spec=``."""
        if self._failed is not None:
            raise ValueError(f"cannot restore into a failed server "
                             f"({self._failed}) — build a fresh one")
        if any(sl is not None for sl in self._slots) or len(self._sched):
            raise ValueError("restore() needs an idle server: slots and "
                             "queue must be empty")
        if snap.get("format") != 1:
            raise ValueError(f"unknown snapshot format "
                             f"{snap.get('format')!r}")
        self._check_snapshot_config(snap["config"])
        # the per-request ladder runs BEFORE anything changes: a rejection
        # midway would be a partial restore — corruption, not an error
        for d in snap["requests"]:
            self._validate_snapshot_request(d)
        self._gen.set_state(snap["generator_state"])
        self._step_no = int(snap["step_no"])
        self._next_rid = max(self._next_rid, int(snap["next_rid"]))
        self._sched.restore_state(snap["sched"]["vnow"],
                                  snap["sched"]["tenant_tag"])
        if self.spec is not None and "spec_state" in snap:
            st = snap["spec_state"]
            self._spec_gate_off = int(st["gate_off"])
            self._spec_plain_windows = int(st["plain_windows"])
            self._spec_turbo = bool(st["turbo"])
            self._spec_proposed = int(st["proposed"])
            self._spec_accepted = int(st["accepted"])
        self._results.update(
            {int(r): list(t) for r, t in snap["results"].items()})
        self._dropped.update(snap["dropped"])
        now = self._sched.now()
        restored = 0
        for d in sorted(snap["requests"], key=lambda d: d["sched"]["seq"]):
            self._admit_snapshot_request(d, now)
            restored += 1
        self._weights_checked = False
        self.adopt_warm(snap.get("warm_tier", ()))
        return restored

    def _check_snapshot_config(self, want: Dict[str, Any]) -> None:
        """Validate a snapshot's config fingerprint against this server's
        (shared by :meth:`restore` and :meth:`admit_migrated`)."""
        for k, hv in self._snapshot_fingerprint().items():
            wv = want.get(k)
            if k == "num_blocks":
                if hv < wv:
                    raise ValueError(
                        f"restoring pool has {hv} blocks but the snapshot "
                        f"was taken with {wv} — a smaller pool cannot "
                        f"guarantee the captured requests stay feasible")
            elif hv != wv:
                raise ValueError(
                    f"snapshot/server config mismatch on {k!r}: snapshot "
                    f"has {wv!r}, this server has {hv!r}")

    def _validate_snapshot_request(self, d: Dict[str, Any]) -> None:
        """Reject-at-the-door checks for one snapshot request — run before
        any server state changes."""
        if d["adapter"] is not None:
            if self._lora is None:
                raise ValueError(
                    f"request {d['rid']} names adapter "
                    f"{d['adapter']!r} but this server has no lora=")
            self._lora.validate(d["adapter"])

    def _admit_snapshot_request(self, d: Dict[str, Any],
                                now: float) -> None:
        """Re-admit one validated snapshot request: a KV payload is adopted
        into the host pool and re-enters through the CRC-verified swap-in
        at admission; queued and replay work re-queues. The per-request
        half of :meth:`restore`, shared with :meth:`admit_migrated`."""
        req = _Request(int(d["rid"]), list(d["prompt"]),
                       int(d["max_new_tokens"]),
                       temperature=float(d["temperature"]),
                       top_k=int(d["top_k"]), top_p=float(d["top_p"]),
                       draft_k=d["draft_k"], adapter=d["adapter"])
        req.generated = list(d["generated"])
        req.replay = (list(d["replay"]) if d["replay"] is not None
                      else None)
        req.force = list(d["force"]) if d.get("force") else None
        req.hashes = list(d["hashes"])
        sd = d["sched"]
        ent = SchedEntry(req=req, rid=req.rid,
                         priority=int(sd["priority"]),
                         tenant=sd["tenant"],
                         deadline=(None if sd["ttl_remaining"] is None
                                   else now + sd["ttl_remaining"]),
                         seq=int(sd["seq"]), cost=float(sd["cost"]),
                         vtag=float(sd["vtag"]),
                         preempted=bool(sd["preempted"]),
                         started=bool(sd["started"]),
                         adapter=req.adapter)
        req.sched = ent
        if d["phase"] == "kv":
            kv = d["kv"]
            handle = SwapHandle(
                rid=req.rid, n_tokens=int(kv["n_tokens"]),
                last_token=int(kv["last_token"]),
                n_blocks=int(kv["n_blocks"]),
                hashes=list(kv["hashes"]), nbytes=int(kv["nbytes"]),
                checksum=int(kv["checksum"]))
            self._offload.adopt(handle, [_host_tensor(a)
                                         for a in kv["arrays"]])
            ent.swap = handle
        self._sched.restore_entry(ent)
        # fresh clock marks: the captured server's clock does not
        # transfer, and mixing the two would observe negative latencies
        m: Dict[str, Any] = {"submit_t": self._wall(),
                             "tenant": ent.tenant}
        if req.generated:
            m["first_token_t"] = m["submit_t"]
        self._req_metrics[req.rid] = m
        if self._tel.enabled:
            tr = self._tel.tracer
            tr.set_meta(req.rid, tenant=ent.tenant, priority=ent.priority,
                        prompt_len=len(req.prompt),
                        adapter=req.adapter or "")
            tr.begin(req.rid, "queued", restored=True)

    def admit_migrated(self, d: Dict[str, Any], *,
                       source_config: Optional[Dict[str, Any]] = None
                       ) -> int:
        """Admit ONE snapshot request into this — possibly busy — server:
        the migration primitive. Unlike :meth:`restore` (a whole snapshot,
        an idle target) this re-admits a single request through the same
        validated path while the target serves its own traffic; a KV
        payload resumes through the CRC-verified swap-in. ``source_config``
        (the snapshot's ``config``) is checked when given. The caller
        keeps rids unique across servers. Returns the admitted rid."""
        if self._failed is not None:
            raise EngineFailedError(
                f"cannot migrate into a failed server ({self._failed})")
        if source_config is not None:
            self._check_snapshot_config(source_config)
        self._validate_snapshot_request(d)
        self._admit_snapshot_request(d, self._sched.now())
        self._weights_checked = False
        return int(d["rid"])

    def adopt_warm(self, entries: Sequence[Dict[str, Any]]) -> int:
        """Adopt a peer's warm-tier entries (a snapshot's ``warm_tier``)
        into this server's warm tier, so that a prompt prefix prefilled on
        the captured server stays promotable here. Best effort and
        CRC-verified per entry: a corrupt payload is dropped (counted in
        ``serving_swap_reprefills``), a hash already hot here is skipped,
        and the tier's own capacity rules apply. Returns the number of
        entries adopted."""
        adopted = 0
        for d in entries:
            h = int(d["hash"])
            if self.alloc.contains_hash(h) or h in self._offload.warm:
                continue
            arrays = [_host_tensor(a) for a in d["arrays"]]
            if payload_checksum(arrays) != int(d["checksum"]):
                self._c_corrupt.inc()
                continue
            if self._offload.warm.put(h, arrays, int(d["nbytes"]),
                                      int(d["checksum"])):
                adopted += 1
        return adopted

    def evacuate(self, *, trust_kv: bool = True,
                 rids: Optional[Sequence[int]] = None) -> Dict[str, Any]:
        """Take a :meth:`snapshot`, then RELEASE every in-flight request
        from this server — the drain half of a migration: the caller
        re-admits the snapshot's requests elsewhere, and this server ends
        empty (slots free, queue empty, host pool drained). Finished
        results and dropped markers stay readable here (and ride the
        snapshot). ``trust_kv=False`` salvages a failed server from host
        state. ``rids=``: evacuate only those requests (the snapshot's
        ``requests`` are filtered to them and only they leave); the warm
        tier is dropped only by a full evacuation."""
        snap = self.snapshot(trust_kv=trust_kv)
        keep = None if rids is None else {int(r) for r in rids}
        if keep is not None:
            snap["requests"] = [d for d in snap["requests"]
                                if d["rid"] in keep]
        for s in range(self.max_batch):
            req = self._slots[s]
            if req is None or (keep is not None and req.rid not in keep):
                continue
            req.table = self.alloc.truncate(req.table, 0)
            self._tel.tracer.close(req.rid, "migrated")
            self._release_slot(s)
        for ent in list(self._sched.waiting()):
            if keep is not None and ent.rid not in keep:
                continue
            self._sched.remove(ent.rid)
            if ent.swap is not None:
                self._offload.discard(ent.swap)
            self._tel.tracer.close(ent.rid, "migrated")
        if keep is None:
            # the warm entries left with the snapshot
            self._offload.warm.clear()
        return snap

    # -------------------------------------------------------------- metrics
    def kv_stats(self) -> Dict[str, int]:
        """Paged-pool occupancy and prefix-cache counters, merged with the
        warm tier's (``warm_*``) and the cold-refill count."""
        out = self.alloc.stats()
        out.update(self._offload.tier_stats())
        out["cold_refills"] = self._cold_refills
        return out

    # ------------------------------------------------------------ read-outs
    def watchdog_findings(self) -> List[Dict[str, Any]]:
        """The flight-recorder watchdog's findings (see
        :meth:`~paddle_tpu_torch.telemetry.ServingTelemetry.watchdog`); a
        ``steady_state_recompile`` is a CUDA graph captured on an
        already-warm program key."""
        return self._tel.watchdog()

    def slo_observations(self) -> Dict[str, Dict[str, List[float]]]:
        """Per-tenant latency samples: ``{"ttft": {tenant: [seconds...]},
        "tpot": {tenant: [ms...]}}``, from the tenant-labeled histograms —
        the shape a fleet roll-up merges across replicas."""
        out: Dict[str, Dict[str, List[float]]] = {"ttft": {}, "tpot": {}}
        for hname, key in (("serving_ttft_s", "ttft"),
                           ("serving_tpot_ms", "tpot")):
            h = self._tel.registry.get(hname)
            if h is None:
                continue
            for tenant in h.label_values("tenant"):
                out[key][tenant] = list(h.samples({"tenant": tenant}))
        return out

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """Sync the point-in-time gauges (pool occupancy, host pool, warm
        tier, adapter pool, spec counters, queue depth) into the registry,
        then return the telemetry blob: registry JSON (histograms with
        p50 / p95), watchdog findings over the flight ring, and the
        serving configuration. (The JAX blob's kernel-geometry gauge is
        left out: the port has no tuned kernel geometry.)"""
        reg = self._tel.registry
        reg.gauge("serving_queue_depth").set(float(len(self._sched)))
        reg.gauge("serving_slots_occupied").set(
            float(sum(sl is not None for sl in self._slots)))
        reg.gauge("serving_slots_total").set(float(self.max_batch))
        self.alloc.publish(reg)
        for k, v in self._offload.host.stats().items():
            reg.gauge(f"serving_host_pool_{k}").set(float(v))
        for k, v in self._offload.tier_stats().items():
            reg.gauge(f"serving_tier_{k}").set(float(v))
        reg.gauge("serving_tier_cold_refills").set(float(self._cold_refills))
        if self._lora is not None:
            for k, v in self._lora.stats().items():
                reg.gauge(f"serving_{k}").set(float(v))
        for k, v in self.spec_metrics().items():
            reg.gauge(f"serving_spec_{k}").set(float(v))
        snap = self._tel.snapshot()
        snap["config"] = {"cache": "paged",
                          "max_batch": self.max_batch,
                          "max_len": self.max_len,
                          "tick_window": self.tick_window,
                          "kv_quant": self.kv_quant,
                          "policy": self._sched.policy}
        if self.spec is not None:
            snap["config"]["spec"] = self.spec.describe()
        return snap

    def export_chrome_trace(self, path: str) -> str:
        """Write the span tracer's chrome trace (one timeline row per
        request: queued / prefill / decode / spec / preempt / swap spans);
        empty when telemetry is disabled."""
        return self._tel.export_chrome_trace(path)

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


def _host_tensor(a) -> torch.Tensor:
    """A snapshot payload array as a host tensor (numpy arrays of the
    pool's dtype are taken as they are)."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
