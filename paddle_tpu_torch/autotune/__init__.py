"""The serving autotuner — port of ``paddle_tpu/autotune/``, so far its
seeded workloads (``workload.py``): the traffic a tuning trial and the
fleet simulator (:mod:`paddle_tpu_torch.fleetsim`) draw, decoupled from
the serving configuration.

The rest of the JAX package's surface — the config space, the cost model,
the feature extractor, the search, tuned profiles and the per-op kernel
geometries — is not ported yet (ROADMAP A9b): each of its names raises
NotImplementedError here.
"""
from .workload import (LONG_CONTEXT_LADDER, LONG_PROMPT_LADDER,
                       SHORT_PROMPT_LADDER, Traffic, TrafficRequest,
                       WorkloadSpec, draw_traffic, submit_traffic,
                       warmup_traffic)

__all__ = [
    "LONG_CONTEXT_LADDER", "LONG_PROMPT_LADDER", "SHORT_PROMPT_LADDER",
    "Traffic", "TrafficRequest", "WorkloadSpec", "draw_traffic",
    "submit_traffic", "warmup_traffic",
]

#: the JAX package's ``paddle_tpu.autotune`` names this port does not
#: serve yet (ROADMAP A9b: the autotuner, ``profile=``, Hopper kernel
#: geometries)
UNPORTED = frozenset({
    "ALL_KNOBS", "CEGeometry", "ConfigSpace", "ENGINE_KNOBS",
    "FLEET_KNOBS", "FeatureVector", "FlashAttentionGeometry",
    "GeometryCache", "GeometrySweepResult", "GeometryTrial", "Knob",
    "LoRAGeometry", "NormGeometry", "OP_FAMILIES",
    "PROFILE_SCHEMA_VERSION", "PagedAttentionGeometry", "ServingCostModel",
    "TrialResult", "TrialRunner", "TunedProfile", "autotune",
    "config_server_kwargs", "default_geometry", "engine_space", "extract",
    "geometry_candidates", "geometry_cost_proxy", "geometry_from_dict",
    "install_geometry_cache", "local_device_kind", "resolve_geometry",
    "resolve_profile", "resolve_server_geometries", "sweep_kernel_geometry",
    "tokens_fingerprint",
    # the submodules
    "cost", "features", "kernel_geometry", "profile", "search", "space",
})


def __getattr__(name: str):
    if name in UNPORTED:
        raise NotImplementedError(
            f"paddle_tpu_torch.autotune.{name} is not ported yet (ROADMAP "
            f"A9b: the autotuner, profile= and the Hopper kernel "
            f"geometries); only the seeded workloads are")
    raise AttributeError(
        f"module 'paddle_tpu_torch.autotune' has no attribute {name!r}")
