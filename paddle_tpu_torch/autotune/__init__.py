"""Cost-model-driven serving autotuner — port of ``paddle_tpu/autotune/``
(torch, numpy and the standard library only).

Layers, as in the JAX package::

    workload.py          seeded traffic, decoupled from the serving config
    space.py             typed ConfigSpace over every serving knob
    features.py          telemetry snapshot -> flat FeatureVector per trial
    cost.py              analytic paged-tick predictor, calibrated online
    search.py            seeded search: warmup -> prune -> halving -> gates
    profile.py           tuned-profile JSON; GenerationServer(profile=...)
    kernel_geometry.py   per-layer kernel schedules + the per-(op, dtype,
                         shape, chip) winner cache (the per-op tier)

Entry points: :func:`search.autotune` over a :class:`search.TrialRunner`
(each trial a fresh ``GenerationServer`` on the card, closed before the
next), :func:`search.sweep_kernel_geometry` (the per-op tier: the Hopper
schedules of the paged-attention, norm, fused-LoRA and CE ops, each
candidate held bitwise to the default's output), and
``GenerationServer(profile=)``. Everything here is host-side and
deterministic per seed.

Not ported yet (ROADMAP A9c): the flash kernels' ``block_q`` /
``block_kv``, the fused-LoRA ``accum`` order and paged attention's
``q_rows`` on the card; a non-default value of any raises
NotImplementedError where it is resolved.
"""
from .cost import ServingCostModel, geometry_cost_proxy
from .features import FeatureVector, extract
from .kernel_geometry import (CEGeometry, FlashAttentionGeometry,
                              GeometryCache, LoRAGeometry, NormGeometry,
                              OP_FAMILIES, PagedAttentionGeometry,
                              default_geometry, geometry_candidates,
                              geometry_from_dict, install_geometry_cache,
                              local_device_kind, resolve_geometry,
                              resolve_server_geometries)
from .profile import (PROFILE_SCHEMA_VERSION, TunedProfile,
                      config_server_kwargs, resolve_profile)
from .search import (GeometrySweepResult, GeometryTrial, TrialResult,
                     TrialRunner, autotune, sweep_kernel_geometry,
                     tokens_fingerprint)
from .space import (ALL_KNOBS, ConfigSpace, ENGINE_KNOBS, FLEET_KNOBS,
                    Knob, engine_space)
from .workload import (LONG_CONTEXT_LADDER, LONG_PROMPT_LADDER,
                       SHORT_PROMPT_LADDER, Traffic, TrafficRequest,
                       WorkloadSpec, draw_traffic, submit_traffic,
                       warmup_traffic)

__all__ = [
    "ALL_KNOBS", "CEGeometry", "ConfigSpace", "ENGINE_KNOBS",
    "FLEET_KNOBS", "FeatureVector", "FlashAttentionGeometry",
    "GeometryCache", "GeometrySweepResult", "GeometryTrial", "Knob",
    "LONG_CONTEXT_LADDER", "LONG_PROMPT_LADDER", "LoRAGeometry",
    "NormGeometry", "OP_FAMILIES",
    "PROFILE_SCHEMA_VERSION", "PagedAttentionGeometry",
    "SHORT_PROMPT_LADDER", "ServingCostModel",
    "Traffic", "TrafficRequest", "TrialResult", "TrialRunner",
    "TunedProfile", "WorkloadSpec", "autotune", "config_server_kwargs",
    "default_geometry", "draw_traffic", "engine_space", "extract",
    "geometry_candidates", "geometry_cost_proxy", "geometry_from_dict",
    "install_geometry_cache", "local_device_kind", "resolve_geometry",
    "resolve_profile", "resolve_server_geometries", "submit_traffic",
    "sweep_kernel_geometry", "tokens_fingerprint", "warmup_traffic",
]
