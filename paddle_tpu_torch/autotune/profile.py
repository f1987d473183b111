"""Tuned-profile JSON: the autotuner's durable artifact — port of
``paddle_tpu/autotune/profile.py``. The schema (v3), the canonical JSON,
the fingerprints and the load checks are the JAX package's, so a profile
written by either package loads in the other. One mapping is the port's
own (:func:`config_server_kwargs`): the ``kernels`` knob's ``"pallas"``
rung — the per-layer kernels — is the port's per-layer CUDA kernels,
i.e. the server's ``kernels="auto"`` on the card.

A profile records the winning config, the exact workload it was tuned
against (spec + drawn-trace signature), the measured metrics that won,
the baseline they beat, and the calibrated cost coefficients — enough
to (a) apply the config (``GenerationServer(profile=...)``), (b) audit
the decision (``telemetry_dump`` trials mode), and (c) detect drift
(replay the recorded workload, compare signatures).

``config_fingerprint`` is recomputed on load; a hand-edited config
fails loudly at load time, not as a mystery regression in production.
``created_unix`` is the only non-deterministic field — byte-equality
tests compare :meth:`TunedProfile.canonical_json`, which strips it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional

from .space import ALL_KNOBS, ConfigSpace
from .workload import WorkloadSpec

# v2: the config gained the kernel tier (kernels + mk_* megakernel
# geometry knobs) — v1 profiles are missing knobs under the new space
# and must retune rather than guess
# v3: profiles carry the per-layer kernel-geometry winner cache
# (``kernel_geometry``, a GeometryCache dict keyed by (op, dtype,
# shape, chip)) — v2 profiles lack the per-op tier entirely, and a
# default-geometry guess would silently discard the sweep, so they
# must retune rather than guess, same rule as v1->v2
PROFILE_SCHEMA_VERSION = 3


@dataclasses.dataclass
class TunedProfile:
    config: Dict[str, Any]
    config_fingerprint: str
    workload: Dict[str, Any]
    workload_signature: str
    metrics: Dict[str, Any]                 # winner's FeatureVector dict
    baseline: Dict[str, Any]                # default config's, same traffic
    search: Dict[str, Any]                  # budget/seed/trials/rejects
    cost_model: Dict[str, float]            # calibrated tick coefficients
    schema: int = PROFILE_SCHEMA_VERSION
    created_unix: Optional[float] = None
    # per-layer kernel-geometry winner cache (GeometryCache.to_dict();
    # None = no per-op sweep ran — servers keep default geometry)
    kernel_geometry: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------- (de)ser
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any],
                  verify: bool = True) -> "TunedProfile":
        if d.get("schema") != PROFILE_SCHEMA_VERSION:
            raise ValueError(
                f"tuned profile schema {d.get('schema')!r} != "
                f"{PROFILE_SCHEMA_VERSION} — retune rather than guess")
        known = {f.name for f in dataclasses.fields(cls)}
        prof = cls(**{k: v for k, v in d.items() if k in known})
        if verify:
            space = ConfigSpace(ALL_KNOBS)
            fp = space.fingerprint(prof.config)   # validates the config too
            if fp != prof.config_fingerprint:
                raise ValueError(
                    f"profile config fingerprint mismatch: recorded "
                    f"{prof.config_fingerprint!r}, recomputed {fp!r} — "
                    f"the config was edited after tuning")
            if prof.kernel_geometry is not None:
                from .kernel_geometry import GeometryCache

                # recomputes the cache's own fingerprint — a tampered
                # geometry entry fails here, same contract as the config
                GeometryCache.from_dict(prof.kernel_geometry)
        return prof

    def geometry_cache(self):
        """The per-layer winner cache this profile carries, parsed
        (verified on access), or None when no per-op sweep ran."""
        if self.kernel_geometry is None:
            return None
        from .kernel_geometry import GeometryCache

        return GeometryCache.from_dict(self.kernel_geometry)

    def canonical_json(self) -> str:
        """Deterministic serialization (timestamp stripped) — what the
        determinism tests byte-compare."""
        d = self.to_dict()
        d.pop("created_unix", None)
        return json.dumps(d, sort_keys=True, indent=2, default=str) + "\n"

    def save(self, path: str, now: Optional[float] = None) -> str:
        """``now`` stamps ``created_unix`` (callers outside the
        deterministic search — the CLI — pass ``time.time()``; the
        search itself leaves it None so replays stay byte-equal)."""
        d = self.to_dict()
        if d.get("created_unix") is None and now is not None:
            d["created_unix"] = float(now)
        with open(path, "w") as f:
            json.dump(d, f, sort_keys=True, indent=2, default=str)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str, verify: bool = True) -> "TunedProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f), verify=verify)

    # ------------------------------------------------------------ apply
    def workload_spec(self) -> WorkloadSpec:
        return WorkloadSpec.from_dict(self.workload)

    def server_kwargs(self, model_cfg, *, max_batch: int,
                      max_len: int) -> Dict[str, Any]:
        """The ``GenerationServer`` ctor kwargs this profile pins. The
        caller still owns model/max_batch/max_len (they are workload
        inputs, not tuned knobs)."""
        return config_server_kwargs(self.config, model_cfg,
                                    max_batch=max_batch, max_len=max_len)

    def fleet_kwargs(self) -> Dict[str, Any]:
        """The fleet-tier knobs (``FleetRouter`` ctor args + replica
        count) for fleet deployments; single-engine users ignore this."""
        cfg = self.config
        return {
            "replicas": int(cfg.get("fleet_replicas", 1)),
            "prefix_weight": float(cfg.get("prefix_weight", 1.0)),
            "load_weight": float(cfg.get("load_weight", 1.0)),
            "probe_every": int(cfg.get("probe_every", 16)),
            "degrade_cooldown_s": float(cfg.get("degrade_cooldown_s", 0.0)),
        }


def config_server_kwargs(config: Mapping[str, Any], model_cfg, *,
                         max_batch: int, max_len: int) -> Dict[str, Any]:
    """Map a canonical space config onto ``GenerationServer`` ctor
    kwargs. ``pool_frac`` resolves against THIS geometry's fp-parity
    byte budget (``(max_batch*ceil(max_len/bs)+1) * fp block bytes``) so
    the fraction means the same thing at any batch shape or kv_quant —
    and the int8 pool keeps its capacity win at the same fraction."""
    from ..inference.serving import kv_block_bytes
    from ..inference.speculative import SpecConfig

    cfg = dict(config)
    bs = int(cfg["block_size"])
    kw: Dict[str, Any] = {
        "cache": "paged",
        "block_size": bs,
        "tick_window": int(cfg["tick_window"]),
        "prefill_chunk": int(cfg["prefill_chunk"]),
        "kv_quant": str(cfg["kv_quant"]),
        "policy": str(cfg["policy"]),
    }
    k = int(cfg.get("draft_k", 0))
    if k > 0:
        kw["spec"] = SpecConfig(k=k, gate_low=float(cfg["spec_gate_low"]))
    cp = int(cfg.get("cp", 1))
    if cp > 1:
        kw["mesh"] = f"cp={cp}"
    lo = cfg.get("tier_demote_low", None)
    if lo is not None:
        kw["tier_demote_low"] = float(lo)
        kw["tier_demote_high"] = float(cfg["tier_demote_high"])
    pool_frac = float(cfg.get("pool_frac", 1.0))
    if pool_frac < 1.0:
        entries = -(-max_len // bs)
        parity_bytes = (max_batch * entries + 1) \
            * kv_block_bytes(model_cfg, bs, "none")
        kw["pool_bytes"] = max(1, int(parity_bytes * pool_frac))
        mb = cfg.get("host_pool_mb", None)
        kw["host_pool_bytes"] = None if mb is None else int(mb) << 20
    kernels = str(cfg.get("kernels", "auto"))
    # "pallas" (the per-layer kernels) is the port's per-layer CUDA
    # kernels: kernels="auto" (the server refuses "pallas" by name)
    if kernels not in ("auto", "pallas"):
        kw["kernels"] = kernels
    if kernels == "megakernel":
        from ..ops.decode_megakernel import MegakernelGeometry

        kw["mk_geometry"] = MegakernelGeometry(
            ffn_tile=int(cfg.get("mk_ffn_tile", 0)),
            prefetch_depth=int(cfg.get("mk_prefetch_depth", 2)),
            dequant=str(cfg.get("mk_dequant", "scores")))
    return kw


def resolve_profile(profile) -> Optional[TunedProfile]:
    """Accept what ``GenerationServer(profile=)`` accepts: None, a path
    to a profile JSON, a parsed dict, or a :class:`TunedProfile`."""
    if profile is None or isinstance(profile, TunedProfile):
        return profile
    if isinstance(profile, str):
        return TunedProfile.load(profile)
    if isinstance(profile, Mapping):
        return TunedProfile.from_dict(profile)
    raise ValueError(
        f"profile must be None, a path, a dict, or a TunedProfile, "
        f"got {type(profile).__name__}")
