"""Config + workload -> predicted throughput, calibrated from trials —
port of ``paddle_tpu/autotune/cost.py`` (the standard library only; the
KV block bytes are the port server's ``kv_block_bytes``). Every
prediction is the JAX package's, term for term; :func:`geometry_cost_proxy`
ranks against the Hopper shared-memory model when asked for an NVIDIA
device kind.

:class:`ServingCostModel` is the search's pruning oracle. It maps a
candidate serving config (``space.py`` dict) and a workload
(``workload.WorkloadSpec``) onto the analytic
:class:`~paddle_tpu.cost_model.PagedTickCostModel` features — how many
host trips, fused ticks, FLOPs and HBM bytes the run will take — and
predicts end-to-end seconds and tok/s. Measured trials feed
:meth:`observe`; :meth:`recalibrate` ridge-fits the four tick
coefficients to them, so ranking sharpens as the search spends budget.

The prediction is a *ranking* device, not a stopwatch: every term is
chosen to move in the right direction under each knob (bigger pools
fewer swaps, wider tick windows fewer trips, speculation paying only
above break-even acceptance) rather than to be absolutely accurate.
Hard accept/reject decisions always come from measurement
(``search.py``), never from here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional

from ..cost_model import PagedTickCostModel, REF_BLOCK_BYTES, TickShape
from .workload import WorkloadSpec

#: prior per-draft match probability for the n-gram drafter — repeated
#: suffixes lock the drafter on; random-token prompts
#: rarely match. Calibration via measured acceptance replaces this.
ACCEPT_P_REPEAT = 0.85
ACCEPT_P_RANDOM = 0.25


def expected_acceptance(k: int, p: float) -> float:
    """E[accepted drafts per verify window] under a geometric match
    model: draft i lands only if all i drafts before it did."""
    return sum(p ** i for i in range(1, k + 1))


def count_params(cfg) -> int:
    """Parameter count of a Llama-shaped config (embeddings + untied
    head + per-layer attention/MLP/norms) — the flop feature's scale."""
    h = cfg.hidden_size
    d = h // cfg.num_attention_heads
    kv = cfg.num_key_value_heads
    attn = h * h + 2 * h * kv * d + h * h        # q, k, v, o projections
    mlp = 3 * h * cfg.intermediate_size          # gate, up, down
    per_layer = attn + mlp + 2 * h               # + the two norms
    return (2 * cfg.vocab_size * h               # embed + lm head
            + cfg.num_hidden_layers * per_layer + h)


def _block_bytes(cfg, block_size: int, kv_quant: str) -> int:
    if cfg is not None:
        from ..inference.serving import kv_block_bytes
        return kv_block_bytes(cfg, block_size, kv_quant)
    scale = 0.25 if kv_quant == "int8" else 1.0
    return int(REF_BLOCK_BYTES * (block_size / 16.0) * scale)


class ServingCostModel:
    """Analytic throughput predictor over (config, workload), online-
    calibrated from measured trials."""

    def __init__(self, model_cfg=None, *, max_batch: int = 8,
                 n_params: Optional[int] = None,
                 tick_model: Optional[PagedTickCostModel] = None):
        self.model_cfg = model_cfg
        self.max_batch = int(max_batch)
        self.n_params = int(n_params) if n_params is not None else (
            count_params(model_cfg) if model_cfg is not None
            else TickShape.__dataclass_fields__["n_params"].default)
        self.tick_model = tick_model or PagedTickCostModel()
        self._trials: List[Dict[str, float]] = []
        #: measured acceptance per window, once any spec trial ran —
        #: replaces the ACCEPT_P_* prior for subsequent predictions
        self.measured_acceptance: Optional[float] = None

    # ------------------------------------------------------------ features
    def aggregates(self, config: Mapping[str, Any],
                   workload: WorkloadSpec) -> Dict[str, float]:
        """Trial totals (trips, ticks, flops, bytes) for one full run of
        ``workload`` under ``config`` — the calibration feature row."""
        bs = int(config.get("block_size", 16))
        tw = int(config.get("tick_window", 16))
        k = int(config.get("draft_k", 0))
        pool_frac = float(config.get("pool_frac", 1.0))
        block_bytes = _block_bytes(self.model_cfg, bs,
                                   str(config.get("kv_quant", "none")))
        decoding = float(min(self.max_batch, workload.requests))
        mean_prompt = (sum(workload.prompt_ladder)
                       / len(workload.prompt_ladder))
        # mean resident context midway through a request's decode
        ctx_tokens = mean_prompt + workload.max_new / 2.0
        ctx_blocks = max(1.0, ctx_tokens / bs)

        total_new = float(workload.requests * workload.max_new)
        if k > 0:
            p = (self.measured_acceptance / k
                 if self.measured_acceptance is not None
                 else (ACCEPT_P_REPEAT if workload.repeat_suffix
                       else ACCEPT_P_RANDOM))
            p = min(max(p, 0.0), 0.99)
            gain = 1.0 + expected_acceptance(k, p)   # tokens per window
            width = k + 1
        else:
            gain, width = 1.0, 1
        ticks = max(1.0, total_new / (decoding * gain))

        shape = TickShape(decoding=int(decoding), width=width,
                          n_params=self.n_params, ctx_blocks=ctx_blocks,
                          block_bytes=block_bytes)
        tick_flops = shape.flops()
        tick_bytes = shape.hbm_bytes()
        if pool_frac < 1.0:
            # overflow fraction of the working set swaps through the
            # host pool every tick-ish — a deliberate overestimate that
            # ranks starved pools below parity ones
            tick_bytes += (1.0 - pool_frac) * decoding \
                * ctx_blocks * block_bytes

        # chunked prefill: one program dispatch per chunk, batched into
        # the same trips as decode
        chunk = int(config.get("prefill_chunk", 64))
        total_prompt = float(workload.requests) * mean_prompt
        pf_ticks = max(1.0, total_prompt / chunk)
        pf_flops = 2.0 * self.n_params * total_prompt
        pf_bytes = pf_ticks * 4.0 * self.n_params

        trips = max(1.0, ticks / tw) + pf_ticks
        return {
            "trips": trips,
            "ticks": ticks + pf_ticks,
            "flops": ticks * tick_flops + pf_flops,
            "bytes": ticks * tick_bytes + pf_bytes,
        }

    # ------------------------------------------------------------- predict
    def predict_seconds(self, config: Mapping[str, Any],
                        workload: WorkloadSpec) -> float:
        a = self.aggregates(config, workload)
        return self.tick_model.predict(a["trips"], a["ticks"],
                                       a["flops"], a["bytes"])

    def predict_tok_s(self, config: Mapping[str, Any],
                      workload: WorkloadSpec) -> float:
        total_new = workload.requests * workload.max_new
        sec = self.predict_seconds(config, workload)
        return total_new / sec if sec > 0 else 0.0

    # ----------------------------------------------------------- calibrate
    def observe(self, config: Mapping[str, Any], workload: WorkloadSpec,
                seconds: float,
                acceptance: Optional[float] = None) -> None:
        """Record one measured trial (analytic features, measured
        seconds). ``acceptance`` is the trial's measured accepted-drafts
        per verify window, if it ran speculation."""
        row = dict(self.aggregates(config, workload))
        row["seconds"] = float(seconds)
        self._trials.append(row)
        if acceptance is not None:
            self.measured_acceptance = float(acceptance)

    def recalibrate(self, ridge: float = 1e-3) -> None:
        """Refit the tick coefficients to every observed trial."""
        if self._trials:
            self.tick_model = self.tick_model.calibrate(self._trials,
                                                        ridge=ridge)

    # ------------------------------------------------------------ capacity
    def capacity_tok_s(self, config: Mapping[str, Any],
                       workload: WorkloadSpec) -> float:
        """Predicted steady-state serving capacity of ONE replica under
        this (config, workload) — new tokens per second, end to end.
        The fleet autoscaler's sizing oracle: like every prediction
        here it is a *ranking/sizing* device that sharpens as measured
        trials feed :meth:`observe`, not a stopwatch."""
        return self.predict_tok_s(config, workload)

    def replicas_for(self, demand_tok_s: float,
                     config: Mapping[str, Any],
                     workload: WorkloadSpec, *,
                     utilization: float = 1.0) -> int:
        """Replicas needed to serve ``demand_tok_s`` with each replica
        loaded to at most ``utilization`` of its predicted capacity —
        the capacity-planning half of elastic autoscaling (the burn-rate
        gauges are the reactive half). Always at least 1: a fleet with
        zero replicas can serve nothing and drain nothing."""
        if not 0.0 < utilization <= 1.0:
            raise ValueError(
                f"utilization must be in (0, 1], got {utilization!r}")
        cap = self.capacity_tok_s(config, workload) * utilization
        if cap <= 0.0 or demand_tok_s <= 0.0:
            return 1
        return max(1, int(math.ceil(demand_tok_s / cap)))

    def spec_break_even(self, k: int,
                        workload: WorkloadSpec,
                        config: Optional[Mapping[str, Any]] = None) -> float:
        """Accepted drafts per window where draft_k=k starts paying, at
        this workload's shapes (compare to SpecConfig.gate_low)."""
        cfg = dict(config or {})
        bs = int(cfg.get("block_size", 16))
        mean_prompt = (sum(workload.prompt_ladder)
                       / len(workload.prompt_ladder))
        shape = TickShape(
            decoding=int(min(self.max_batch, workload.requests)),
            n_params=self.n_params,
            ctx_blocks=max(1.0, (mean_prompt + workload.max_new / 2.0) / bs),
            block_bytes=_block_bytes(self.model_cfg, bs,
                                     str(cfg.get("kv_quant", "none"))))
        return self.tick_model.spec_break_even(k, shape)


def geometry_cost_proxy(op: str, geometry, device_kind: Optional[str] = None,
                        **shape) -> float:
    """Analytic rank proxy for one kernel-geometry candidate — the
    per-op analogue of the tick model, used only to ORDER sweep rungs
    deterministically (measure promising schedules first so a truncated
    sweep still lands near the winner); the measured clock always
    decides. Lower is better. The terms are the obvious first-order
    costs: grid-step count (launch/bookkeeping overhead amortized by
    deeper streaming / larger tiles) plus a VMEM-pressure penalty once
    the occupancy model nears the per-core budget. ``device_kind``: None
    or a ``"cpu"`` / TPU kind ranks with JAX's VMEM model (the JAX
    package's proxy, bit for bit); an NVIDIA kind charges the pressure of
    the kernel's shared memory against a Hopper block's 227 KB (paged
    attention's layout; the other ops' shared memory does not change with
    their schedule)."""
    from .kernel_geometry import (HOPPER_SMEM_LIMIT, CEGeometry,
                                  FlashAttentionGeometry, LoRAGeometry,
                                  NormGeometry, PagedAttentionGeometry,
                                  uses_hopper_model)
    from .space import MK_VMEM_LIMIT_BYTES

    hopper = device_kind is not None and uses_hopper_model(device_kind)

    if isinstance(geometry, PagedAttentionGeometry):
        blocks = float(shape.get("blocks", 64))
        steps = blocks / geometry.kv_block_depth
        vmem = geometry.vmem_bytes(
            head_dim=shape.get("head_dim", 128),
            block_size=shape.get("block_size", 16),
            window=shape.get("window", 4), rep=shape.get("rep", 4),
            quantized=shape.get("quantized", False))
    elif isinstance(geometry, LoRAGeometry):
        rank = int(shape.get("rank", 8))
        rp = geometry.padded_rank(rank)
        # padding trades wasted MACs for MXU alignment; charge the waste
        steps = 1.0 + 0.1 * (rp - rank) / max(rank, 1)
        vmem = geometry.vmem_bytes(
            seq=shape.get("seq", 1), in_dim=shape.get("in_dim", 1024),
            out_dim=shape.get("out_dim", 1024), rank=rank)
    elif isinstance(geometry, FlashAttentionGeometry):
        seq = float(shape.get("seq_q", 2048))
        steps = seq / float(geometry.block_q or 512)
        vmem = geometry.vmem_bytes(head_dim=shape.get("head_dim", 128),
                                   seq_k=shape.get("seq_k", 2048))
    elif isinstance(geometry, (NormGeometry, CEGeometry)):
        rows_total = float(shape.get("rows_total", 2048))
        tile = float(geometry.rows or min(512, rows_total))
        steps = rows_total / max(tile, 1.0)
        width = shape.get("vocab" if isinstance(geometry, CEGeometry)
                          else "width", 4096)
        vmem = geometry.vmem_bytes(**(
            {"hidden": shape.get("hidden", 1024), "vocab": width}
            if isinstance(geometry, CEGeometry) else {"width": width}))
    else:
        raise ValueError(f"no cost proxy for {type(geometry).__name__}")
    if hopper:
        smem = (geometry.smem_bytes(quantized=shape.get("quantized", False))
                if isinstance(geometry, PagedAttentionGeometry) else 0)
        pressure = max(0.0, smem / HOPPER_SMEM_LIMIT - 0.5)
        return float(steps * (1.0 + 4.0 * pressure * pressure))
    pressure = max(0.0, vmem / MK_VMEM_LIMIT_BYTES - 0.5)
    return float(steps * (1.0 + 4.0 * pressure * pressure))
