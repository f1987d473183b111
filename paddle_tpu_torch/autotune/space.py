"""The serving config space: every tunable knob, typed and constrained —
port of ``paddle_tpu/autotune/space.py`` (numpy and the standard library
only). The knobs, their choices, defaults, validity rules,
canonicalization and the seeded sampling are the JAX package's, so one
seed draws the same configs in both packages. Two meanings are the
port's own:

- ``cp``: the space's ``devices`` is ``torch.cuda.device_count()`` on the
  card (:func:`~.search.autotune`), so ``cp > 1`` on one card is invalid,
  not a crash; a ``mesh=`` is not ported (ROADMAP A10).
- the kernel tier's occupancy arithmetic follows the target device kind
  (``device_kind``; the local one when None): JAX's per-core VMEM model
  (:data:`MK_VMEM_LIMIT_BYTES`) for ``"cpu"`` and TPU kinds, and on an
  NVIDIA card the whole-tick kernel's shared memory of one block against
  the 227 KB a Hopper block may take, plus the rule that the down
  projection's K slice (``mk_ffn_tile``) fits the kernel's x slab at the
  rows a tick runs (:meth:`~..ops.decode_megakernel.MegakernelGeometry.
  hopper_errors`).

The JAX module's notes follow.

One :class:`ConfigSpace` declares the full knob surface the serving
stack has grown — paged-cache geometry, tick batching, speculative
decoding, KV quantization, pool sizing, scheduler policy, and the fleet
tier (replica count, routing weights, probe cadence). A *config* is a
plain ``{knob: value}`` dict over exactly these knobs, so it JSON
round-trips into tuned profiles unchanged.

Knobs interact, so validity is first-class:

- ``spec_gate_low`` is dead weight when ``draft_k == 0``; canonicalize
  rather than reject, so fingerprints never differ on a knob that
  cannot matter.
- ``pool_frac < 1`` (pool sized below demand) REQUIRES a host pool to
  swap victims into (``host_pool_mb != 0``); with swapping disabled the
  starved pool degrades to stall livelock, which no search should ever
  measure as a candidate.
- speculation caps the tick window (``draft_k > 0`` requires
  ``tick_window <= 8``): the fused verify scan compiles one program
  spanning ``tick_window`` windows of width ``k+1``, so wide windows
  blow up both program size (multi-minute XLA compiles) and the
  surplus verify work past finished requests — the same reason the
  benchmark drops its tick-window default to 4 under ``--spec``.
- the fleet knobs (``prefix_weight``/``load_weight``/``probe_every``/
  ``degrade_cooldown_s``) are dead at ``fleet_replicas == 1`` and
  canonicalize to their defaults.
- the kernel tier (``mk_ffn_tile``/``mk_prefetch_depth``/``mk_dequant``
  — the megakernel's :class:`~..ops.decode_megakernel.MegakernelGeometry`
  as knobs) is dead weight when ``kernels != "megakernel"`` and
  canonicalizes to defaults; under ``kernels == "megakernel"`` with a
  ``model_cfg`` bound to the space, validity runs the geometry's
  VMEM-residency arithmetic against the per-core budget (~16 MiB on
  current TPUs) and the ffn-tile divisibility check — a geometry that
  cannot fit VMEM is invalid, not an OOM mid-search.
- ``cp > 1`` (context-parallel prefill) requires a mesh the host can
  actually build (the space's ``devices`` bound) and must divide
  ``prefill_chunk`` — the chunk shards evenly by construction.
- the tier watermarks are one ladder: ``tier_demote_low`` without
  ``tier_demote_high`` (or an unordered pair) is invalid, and the high
  watermark canonicalizes to None when the low trigger is off.

Sampling and mutation take an explicit ``numpy.random.RandomState`` and
are fully deterministic per seed — the search's trial sequence replays
bit-for-bit (see tests/test_torch_autotune.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable: a finite choice set plus the untuned default."""

    name: str
    choices: Tuple[Any, ...]
    default: Any
    help: str = ""

    def __post_init__(self):
        if self.default not in self.choices:
            raise ValueError(
                f"knob {self.name!r}: default {self.default!r} not in "
                f"choices {self.choices!r}")


#: the serving knob surface (engine tier first, fleet tier after).
#: Choice sets are small on purpose: the space is combinatorial anyway
#: (~1e5 engine-tier configs) and every value here is one the suite has
#: actually exercised.
ENGINE_KNOBS: Tuple[Knob, ...] = (
    Knob("block_size", (8, 16, 32), 16,
         "tokens per KV block (pool geometry + attention table width)"),
    Knob("tick_window", (1, 2, 4, 8, 16, 32), 16,
         "decode ticks fused per host round trip"),
    Knob("prefill_chunk", (32, 64, 128), 64,
         "tokens per chunked-prefill program"),
    Knob("draft_k", (0, 2, 4, 8), 0,
         "speculative drafts per verify window; 0 = speculation off"),
    Knob("spec_gate_low", (0.5, 1.0, 2.0, 4.0), 2.0,
         "dynamic-gate acceptance floor (accepted drafts/window)"),
    Knob("kv_quant", ("none", "int8"), "none",
         "KV pool storage: fp blocks or int8 codes + f32 scales"),
    Knob("pool_frac", (0.5, 0.75, 1.0), 1.0,
         "KV pool byte budget as a fraction of fp dense parity"),
    Knob("host_pool_mb", (None, 16, 64), None,
         "host swap-pool cap in MB; None = unbounded, 0 = no swapping"),
    Knob("policy", ("fifo", "priority", "wfq"), "fifo",
         "request scheduler (inference/scheduler.py)"),
    Knob("cp", (1, 2, 4), 1,
         "context-parallel mesh axis sharding the chunked prefill's "
         "sequence dimension (long-context prefill scaling); 1 = off"),
    Knob("tier_demote_low", (None, 0.1, 0.2), None,
         "free-block fraction that TRIGGERS hot->warm KV demotion; "
         "None = watermark-driven demotion off"),
    Knob("tier_demote_high", (None, 0.3, 0.5), None,
         "free-block fraction demotion restores before it stops; dead "
         "(canonicalized to None) when tier_demote_low is None"),
)

#: the kernel tier: dispatch mode plus the whole-tick megakernel's
#: geometry (ops/decode_megakernel.MegakernelGeometry) expressed as
#: knobs — dead (canonicalized to defaults) unless kernels="megakernel".
KERNEL_KNOBS: Tuple[Knob, ...] = (
    Knob("kernels", ("auto", "pallas", "megakernel", "reference"), "auto",
         "kernel dispatch rung for the compiled serving programs "
         "(ops.set_kernel_mode)"),
    Knob("mk_ffn_tile", (0, 512, 1024, 2048), 0,
         "megakernel FFN intermediate-dim tile width; 0 streams each "
         "layer's full gate/up/down weights (reference-exact contraction "
         "order)"),
    Knob("mk_prefetch_depth", (1, 2, 4), 2,
         "megakernel weight-stream lookahead in chunks (VMEM buffers per "
         "stream); 2 = classic double buffering"),
    Knob("mk_dequant", ("scores", "tile"), "scores",
         "megakernel int8 KV dequant placement: 'scores' folds scales "
         "into the softmax accumulators (token-exact vs reference), "
         "'tile' dequantizes the whole VMEM tile up front"),
)

FLEET_KNOBS: Tuple[Knob, ...] = (
    Knob("fleet_replicas", (1, 2, 4), 1,
         "FleetRouter replica count; 1 = single engine"),
    Knob("prefix_weight", (0.5, 1.0, 2.0), 1.0,
         "routing score weight on matched prefix blocks"),
    Knob("load_weight", (0.5, 1.0, 2.0), 1.0,
         "routing score weight on queue depth + occupancy"),
    Knob("probe_every", (8, 16, 32), 16,
         "router ticks between watchdog deep probes"),
    Knob("degrade_cooldown_s", (0.0, 2.0), 0.0,
         "seconds a degraded replica sits out before re-probe"),
)

ALL_KNOBS: Tuple[Knob, ...] = ENGINE_KNOBS + KERNEL_KNOBS + FLEET_KNOBS

#: per-core VMEM the megakernel's residency estimate is checked against
#: (~16 MiB on current TPU generations; override per space if yours
#: differs)
MK_VMEM_LIMIT_BYTES = 16 << 20


class ConfigSpace:
    """Typed knob space with validity, canonicalization, and seeded
    sampling/mutation.

    ``pins`` freezes knobs to a single value (the engine-tier search
    pins the fleet knobs to their defaults); ``max_len`` bounds
    ``block_size`` choices so one block never exceeds the serving
    horizon; ``devices`` bounds the ``cp`` mesh axis — a cp degree the
    host cannot build a mesh for is invalid, not a runtime crash.

    ``model_cfg`` binds a model geometry to the space and arms the
    kernel tier's validity arithmetic: under ``kernels="megakernel"``
    the candidate :class:`~..ops.decode_megakernel.MegakernelGeometry`'s
    worst-case VMEM residency (``vmem_bytes``, at ``max_batch`` rows ×
    the config's verify window) must fit ``vmem_limit_bytes``
    (default :data:`MK_VMEM_LIMIT_BYTES`), and ``mk_ffn_tile`` must
    divide the model's intermediate size. Without a bound model the
    kernel knobs only get the geometry's own range checks.
    """

    def __init__(self, knobs: Sequence[Knob] = ALL_KNOBS, *,
                 pins: Optional[Dict[str, Any]] = None,
                 max_len: Optional[int] = None,
                 devices: Optional[int] = None,
                 model_cfg=None, max_batch: int = 8,
                 vmem_limit_bytes: int = MK_VMEM_LIMIT_BYTES,
                 device_kind: Optional[str] = None):
        self.devices = devices
        self.device_kind = device_kind
        self.model_cfg = model_cfg
        self.max_batch = int(max_batch)
        self.vmem_limit_bytes = int(vmem_limit_bytes)
        self.knobs: Tuple[Knob, ...] = tuple(knobs)
        names = [k.name for k in self.knobs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate knob names in {names}")
        self._by_name = {k.name: k for k in self.knobs}
        self.pins: Dict[str, Any] = dict(pins or {})
        for name, val in self.pins.items():
            k = self._by_name.get(name)
            if k is None:
                raise ValueError(f"pin for unknown knob {name!r}")
            if val not in k.choices:
                raise ValueError(
                    f"pin {name}={val!r} not in choices {k.choices!r}")
        if max_len is not None:
            bs = self._by_name.get("block_size")
            if bs is not None:
                fit = tuple(c for c in bs.choices if c <= max_len)
                if not fit:
                    raise ValueError(
                        f"no block_size choice fits max_len={max_len}")
                self._by_name["block_size"] = dataclasses.replace(
                    bs, choices=fit, default=fit[-1]
                    if bs.default not in fit else bs.default)
                self.knobs = tuple(self._by_name[k.name]
                                   for k in self.knobs)

    # ------------------------------------------------------------- basics
    def knob(self, name: str) -> Knob:
        return self._by_name[name]

    def default(self) -> Dict[str, Any]:
        cfg = {k.name: k.default for k in self.knobs}
        cfg.update(self.pins)
        return self.canonicalize(cfg)

    def size(self) -> int:
        """Raw cartesian size (pre-constraint, pins collapse to 1)."""
        n = 1
        for k in self.knobs:
            n *= 1 if k.name in self.pins else len(k.choices)
        return n

    # -------------------------------------------------------- constraints
    def errors(self, config: Dict[str, Any]) -> List[str]:
        """Why this config is invalid; empty list = valid. Unknown or
        missing knobs and off-menu values are errors too — a profile
        edited by hand fails loudly, not at serving time."""
        errs: List[str] = []
        for name in config:
            if name not in self._by_name:
                errs.append(f"unknown knob {name!r}")
        for k in self.knobs:
            if k.name not in config:
                errs.append(f"missing knob {k.name!r}")
            elif config[k.name] not in k.choices:
                errs.append(f"{k.name}={config[k.name]!r} not in "
                            f"{k.choices!r}")
        for name, val in self.pins.items():
            if name in config and config[name] != val:
                errs.append(f"{name}={config[name]!r} violates pin "
                            f"{name}={val!r}")
        if errs:
            return errs
        # cross-knob feasibility
        if config.get("pool_frac", 1.0) < 1.0 \
                and config.get("host_pool_mb", None) == 0:
            errs.append(
                "pool_frac < 1.0 starves the KV pool below demand but "
                "host_pool_mb=0 disables swapping — victims would stall "
                "forever; give the overloaded pool a host pool")
        if config.get("draft_k", 0) > 0 and config.get("tick_window", 1) > 8:
            errs.append(
                "draft_k > 0 with tick_window > 8: the fused verify scan "
                "spans tick_window windows of width k+1, so wide windows "
                "explode program size (multi-minute compiles) and surplus "
                "verify work — cap the window at 8 when speculating")
        cp = int(config.get("cp", 1))
        if cp > 1:
            if self.devices is not None and cp > self.devices:
                errs.append(
                    f"cp={cp} needs a {cp}-device mesh but the space was "
                    f"built for {self.devices} device(s)")
            pc = int(config.get("prefill_chunk", 64))
            if pc % cp:
                errs.append(
                    f"cp={cp} must divide prefill_chunk={pc} — the chunk "
                    f"shards evenly over the cp axis by construction")
        lo = config.get("tier_demote_low", None)
        hi = config.get("tier_demote_high", None)
        if lo is not None:
            if hi is None:
                errs.append(
                    "tier_demote_low set without tier_demote_high — the "
                    "watermarks are one ladder, set both or neither")
            elif not (0.0 < lo < hi <= 1.0):
                errs.append(
                    f"tier watermarks must satisfy 0 < low < high <= 1, "
                    f"got low={lo} high={hi}")
        if config.get("kernels", "auto") == "megakernel":
            errs.extend(self._megakernel_errors(config))
        return errs

    def _megakernel_errors(self, config: Dict[str, Any]) -> List[str]:
        """Kernel-tier feasibility: the candidate geometry's own range
        checks, plus — with a model bound — ffn-tile divisibility and
        the worst-case VMEM-residency arithmetic against the per-core
        budget."""
        errs: List[str] = []
        from ..ops.decode_megakernel import MegakernelGeometry

        try:
            geom = MegakernelGeometry(
                ffn_tile=int(config.get("mk_ffn_tile", 0)),
                prefetch_depth=int(config.get("mk_prefetch_depth", 2)),
                dequant=str(config.get("mk_dequant", "scores")))
            geom.validate()
        except ValueError as e:
            return [f"megakernel geometry: {e}"]
        mc = self.model_cfg
        if mc is None:
            return errs
        I = int(mc.intermediate_size)
        if geom.ffn_tile and I % geom.ffn_tile:
            errs.append(
                f"mk_ffn_tile={geom.ffn_tile} does not divide the bound "
                f"model's intermediate_size={I}")
            return errs
        heads = int(mc.num_attention_heads)
        head_dim = int(mc.hidden_size) // heads
        from .kernel_geometry import local_device_kind, uses_hopper_model

        kind = self.device_kind if self.device_kind is not None \
            else local_device_kind()
        if uses_hopper_model(kind):
            # the card's counterpart of the VMEM arithmetic below: the
            # whole-tick kernel's shared memory of one block, and the down
            # product's K slice inside its x slab at the tick's rows
            errs.extend(geom.hopper_errors(
                intermediate=I,
                rows=self.max_batch * (int(config.get("draft_k", 0)) + 1)))
            return errs
        need = geom.vmem_bytes(
            hidden=int(mc.hidden_size), heads=heads,
            kv_heads=int(mc.num_key_value_heads), head_dim=head_dim,
            intermediate=I, layers=int(mc.num_hidden_layers),
            batch=self.max_batch,
            window=int(config.get("draft_k", 0)) + 1,
            block_size=int(config.get("block_size", 16)),
            quantized=config.get("kv_quant", "none") == "int8")
        if need > self.vmem_limit_bytes:
            errs.append(
                f"megakernel geometry needs ~{need / (1 << 20):.1f} MiB "
                f"VMEM residency, over the "
                f"{self.vmem_limit_bytes / (1 << 20):.1f} MiB per-core "
                f"budget — shrink mk_ffn_tile/mk_prefetch_depth")
        return errs

    def is_valid(self, config: Dict[str, Any]) -> bool:
        return not self.errors(config)

    def canonicalize(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Collapse dead knobs to their defaults so two configs that
        cannot behave differently share one fingerprint: the spec gate
        without speculation, the host pool without overload, the fleet
        routing knobs without a fleet."""
        cfg = dict(config)
        if cfg.get("draft_k", 0) == 0 and "spec_gate_low" in self._by_name:
            cfg["spec_gate_low"] = self._by_name["spec_gate_low"].default
        if cfg.get("tier_demote_low", None) is None \
                and "tier_demote_high" in self._by_name:
            # the high watermark is dead without the low trigger (cp=1
            # analogously needs no collapse: the cp axis carries no
            # satellite knobs, 1 IS its canonical off value)
            cfg["tier_demote_high"] = \
                self._by_name["tier_demote_high"].default
        if cfg.get("pool_frac", 1.0) >= 1.0 \
                and "host_pool_mb" in self._by_name:
            cfg["host_pool_mb"] = self._by_name["host_pool_mb"].default
        if cfg.get("fleet_replicas", 1) == 1:
            for name in ("prefix_weight", "load_weight", "probe_every",
                         "degrade_cooldown_s"):
                if name in self._by_name:
                    cfg[name] = self._by_name[name].default
        if cfg.get("kernels", "auto") != "megakernel":
            # the megakernel geometry is dead weight on every other
            # dispatch rung — two configs that cannot behave differently
            # must share one fingerprint
            for name in ("mk_ffn_tile", "mk_prefetch_depth", "mk_dequant"):
                if name in self._by_name:
                    cfg[name] = self._by_name[name].default
        return cfg

    def validate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Canonicalize then raise on any remaining invalidity."""
        cfg = self.canonicalize(config)
        errs = self.errors(cfg)
        if errs:
            raise ValueError("invalid serving config: " + "; ".join(errs))
        return cfg

    # ----------------------------------------------------------- sampling
    def sample(self, rng: np.random.RandomState,
               max_tries: int = 64) -> Dict[str, Any]:
        """One valid config, drawn knob-by-knob in declaration order
        (rejection-sampled against the cross-knob constraints). Same rng
        state -> same config, always."""
        for _ in range(max_tries):
            cfg = {}
            for k in self.knobs:
                if k.name in self.pins:
                    cfg[k.name] = self.pins[k.name]
                else:
                    cfg[k.name] = k.choices[int(rng.randint(len(k.choices)))]
            cfg = self.canonicalize(cfg)
            if self.is_valid(cfg):
                return cfg
        raise RuntimeError(
            f"could not sample a valid config in {max_tries} tries — "
            f"the pins/constraints have emptied the space")

    def mutate(self, config: Dict[str, Any], rng: np.random.RandomState,
               mutations: int = 1, max_tries: int = 64) -> Dict[str, Any]:
        """Evolutionary neighbor: flip ``mutations`` unpinned knobs to a
        different choice, keeping the result valid. Deterministic per
        rng state."""
        base = self.validate(config)
        free = [k for k in self.knobs
                if k.name not in self.pins and len(k.choices) > 1]
        if not free:
            return dict(base)
        for _ in range(max_tries):
            cfg = dict(base)
            idx = rng.choice(len(free), size=min(mutations, len(free)),
                             replace=False)
            for i in sorted(int(j) for j in idx):
                k = free[i]
                alts = [c for c in k.choices if c != base[k.name]]
                cfg[k.name] = alts[int(rng.randint(len(alts)))]
            cfg = self.canonicalize(cfg)
            if self.is_valid(cfg) and cfg != base:
                return cfg
        return dict(base)

    # -------------------------------------------------------- fingerprint
    def fingerprint(self, config: Dict[str, Any]) -> str:
        """Stable id of the canonical config — the key trials, profiles
        and dedup all share."""
        cfg = self.validate(config)
        return hashlib.sha256(
            json.dumps(cfg, sort_keys=True, default=str).encode()
        ).hexdigest()[:12]


def engine_space(max_len: Optional[int] = None,
                 pins: Optional[Dict[str, Any]] = None,
                 devices: Optional[int] = None,
                 model_cfg=None, max_batch: int = 8,
                 vmem_limit_bytes: int = MK_VMEM_LIMIT_BYTES,
                 device_kind: Optional[str] = None
                 ) -> ConfigSpace:
    """The single-engine search space: full knob surface declared, fleet
    tier pinned to its defaults (fleet_replicas=1 collapses the routing
    knobs too). ``devices`` bounds the cp axis to meshes the host can
    build; ``model_cfg``/``max_batch``/``vmem_limit_bytes`` arm the
    kernel tier's VMEM-validity arithmetic (see :class:`ConfigSpace`).
    This is what the JAX package's ``tools/autotune.py`` searches."""
    p = {k.name: k.default for k in FLEET_KNOBS}
    p.update(pins or {})
    return ConfigSpace(ALL_KNOBS, pins=p, max_len=max_len, devices=devices,
                       model_cfg=model_cfg, max_batch=max_batch,
                       vmem_limit_bytes=vmem_limit_bytes,
                       device_kind=device_kind)
