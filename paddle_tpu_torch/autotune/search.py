"""Seeded, measurement-gated search over the serving config space — port
of ``paddle_tpu/autotune/search.py``. The loop, the plan, the gates and
the records are the JAX package's, so with the same runner the same seed
gives the same trial sequence and profile bytes. What is the port's own:
a trial's server runs on the card (its CUDA graphs and pool are freed
before the next trial is built, and the search's peak device memory is
read by the caller from ``torch.cuda.max_memory_allocated``), the cp
axis is bounded by ``torch.cuda.device_count()``, and a kernel-geometry
sweep's ``measure`` on the card times the kernel on the device.

The loop (``autotune()``):

1. **Reference trial** — the space's default config runs the full
   workload first. Its token fingerprint becomes the correctness
   reference (greedy serving is token-exact across every valid config —
   an invariant of the serving stack), and its throughput is the
   baseline a winner must beat.
2. **Random warmup** — a few seeded samples run the full workload;
   every measurement feeds the analytic cost model's online calibration
   (``ServingCostModel.observe``/``recalibrate``).
3. **Cost-model pruning** — a larger seeded candidate pool (fresh
   samples + evolutionary mutations of the incumbent) is ranked by
   *predicted* tok/s; only the top slice is measured at all.
4. **Successive halving** — the top slice runs a truncated short rung
   first; short-rung survivors are promoted to full-workload trials.
5. **Hard gates** — any measured trial with a watchdog finding
   (preemption storm, pool-pressure stall, steady-state recompile) is
   rejected outright; full-rung trials must also match the reference
   token fingerprint bit-for-bit. A config that is fast but wrong, or
   fast but pathological, never becomes a profile.

Determinism: candidates come from one ``RandomState(seed)``; traffic is
pre-drawn per workload (``workload.py``); with an injected counting
clock the measurements themselves are reproducible, so the same seed
yields byte-identical trial sequences and winning profiles (the suite
asserts this).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .cost import ServingCostModel
from .features import FeatureVector, extract
from .profile import TunedProfile, config_server_kwargs
from .space import ConfigSpace, engine_space
from .workload import (Traffic, WorkloadSpec, draw_traffic, submit_traffic,
                       warmup_traffic)


def tokens_fingerprint(results_in_order: List[List[int]]) -> str:
    """Hash of the measured token streams, in submission order — the
    cross-config correctness gate."""
    return hashlib.sha256(
        json.dumps(results_in_order).encode()).hexdigest()[:16]


@dataclasses.dataclass
class TrialResult:
    index: int
    rung: str                       # "full" | "short"
    config: Dict[str, Any]
    fingerprint: str
    features: FeatureVector
    tokens_fp: str
    accepted: bool
    reject_reason: Optional[str] = None
    predicted_tok_s: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["features"] = self.features.to_dict()
        d["kind"] = "autotune_trial"
        return d


class TrialRunner:
    """Runs one candidate config against pre-drawn seeded traffic and
    returns (features, token fingerprint, watchdog findings).

    ``clock`` is injectable: tests pass a counting
    clock and every measured duration — hence the whole search — becomes
    deterministic. The default is the wall clock. The trial's server runs
    where the model is, and is closed (its graphs, their memory pool and
    its KV pool freed) before :meth:`run` returns."""

    def __init__(self, model, workload: WorkloadSpec, *,
                 max_batch: int = 8, max_len: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 warmup_requests: int = 2):
        self.model = model
        self.workload = workload
        self.max_batch = int(max_batch)
        need = max(workload.prompt_ladder) + workload.max_new + 1
        self.max_len = int(max_len) if max_len is not None else need
        if self.max_len < need:
            raise ValueError(
                f"max_len={self.max_len} cannot hold the workload "
                f"(needs {need})")
        self.clock = clock if clock is not None else time.perf_counter
        self.warmup_requests = int(warmup_requests)
        self._traffic_cache: Dict[str, Traffic] = {}

    def traffic_for(self, spec: WorkloadSpec) -> Traffic:
        key = json.dumps(spec.to_dict(), sort_keys=True)
        if key not in self._traffic_cache:
            self._traffic_cache[key] = draw_traffic(spec)
        return self._traffic_cache[key]

    def run(self, config: Dict[str, Any],
            workload: Optional[WorkloadSpec] = None) \
            -> Tuple[FeatureVector, str, List[Dict[str, Any]]]:
        from ..inference.serving import GenerationServer
        from ..telemetry import ServingTelemetry

        spec = workload if workload is not None else self.workload
        traffic = self.traffic_for(spec)
        tel = ServingTelemetry(enabled=True, clock=self.clock)
        srv = GenerationServer(
            self.model, max_batch=self.max_batch, max_len=self.max_len,
            telemetry=tel, clock=self.clock,
            device=getattr(self.model, "device", None),
            **config_server_kwargs(config, self.model.cfg,
                                   max_batch=self.max_batch,
                                   max_len=self.max_len))
        # warmup from the DISJOINT rng stream: compiles the programs this
        # config uses, then the telemetry reset folds their keys into
        # warm_progs so the watchdog charges any measured-phase recompile
        if self.warmup_requests:
            submit_traffic(srv, warmup_traffic(spec, self.warmup_requests))
            srv.run()
        tel.reset()

        t0 = self.clock()
        if traffic.schedule:
            # open loop: release bursts at their pre-drawn instants,
            # ticking the server while waiting
            base = self.clock()
            handed: Dict[int, Any] = {}
            i = 0
            for t_at, n in traffic.schedule:
                while self.clock() - base < t_at:
                    srv.step()
                handed.update(submit_traffic(
                    srv, traffic.requests[i:i + n]))
                i += n
            results = srv.run()
        else:
            handed = submit_traffic(srv, traffic.requests)
            results = srv.run()
        seconds = self.clock() - t0

        in_order = []
        new_tokens = 0
        for rid, req in handed.items():
            toks = results.get(rid, [])
            gen = toks[len(req.prompt):]
            new_tokens += len(gen)
            in_order.append(list(toks))
        fp = tokens_fingerprint(in_order)
        records = tel.flight.dump()
        findings = tel.watchdog()
        fv = extract(tel, tokens=new_tokens, seconds=seconds,
                     records=records, findings=findings)
        srv.close()
        return fv, fp, findings


@dataclasses.dataclass
class GeometryTrial:
    index: int
    geometry: Dict[str, Any]
    seconds: float
    exact: bool                     # bitwise-equal to the default's output
    accepted: bool
    reject_reason: Optional[str] = None
    proxy_cost: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["kind"] = "geometry_trial"
        return d


@dataclasses.dataclass
class GeometrySweepResult:
    op: str
    dtype: str
    key: int
    device_kind: str
    trials: List[GeometryTrial]
    winner: Dict[str, Any]
    winner_index: int
    speedup: float                  # default seconds / winner seconds

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["trials"] = [t.to_dict() for t in self.trials]
        return d


def sweep_kernel_geometry(measure: Callable[[Any], Tuple[Any, float]],
                          op: str, *, dtype: str, key: int,
                          device_kind: Optional[str] = None,
                          candidates: Optional[List[Any]] = None,
                          quantized: bool = False,
                          shape: Optional[Dict[str, Any]] = None,
                          max_candidates: Optional[int] = None,
                          cache=None,
                          log: Optional[Callable[[str], None]] = None) \
        -> GeometrySweepResult:
    """The per-op kernel-geometry tier: measure every candidate schedule
    for one ``(op, dtype, key, chip)`` cell and cache the winner.

    ``measure(geometry) -> (output, seconds)`` runs the kernel under one
    candidate — the caller supplies it (on the card, a closure over the
    kernel's wrapper timed on the device; in tests, a counting clock, so
    that the whole sweep is deterministic). Candidate index 0 is ALWAYS the default geometry; its
    output is the parity reference and every other candidate is
    HARD-REJECTED unless bitwise equal (np.array_equal — a schedule that
    regroups floating-point math can never become a cached winner). Ties
    on the clock resolve toward the earlier index, i.e. toward the
    default. ``max_candidates`` truncates the rung by the analytic
    ``geometry_cost_proxy`` rank (default always kept) so a short sweep
    still measures the promising schedules first."""
    from .cost import geometry_cost_proxy
    from .kernel_geometry import geometry_candidates, local_device_kind

    emit = log or (lambda s: None)
    if device_kind is None:
        device_kind = local_device_kind()
    shape = dict(shape or {})
    if candidates is None:
        candidates = geometry_candidates(op, quantized=quantized,
                                         device_kind=device_kind,
                                         **{k: v for k, v in shape.items()
                                            if k != "quantized"})
    proxies = []
    for g in candidates:
        try:
            proxies.append(geometry_cost_proxy(op, g, device_kind=device_kind,
                                               quantized=quantized,
                                               **shape))
        except Exception:
            proxies.append(None)
    if max_candidates is not None and len(candidates) > max_candidates:
        ranked = sorted(range(1, len(candidates)),
                        key=lambda i: (proxies[i] if proxies[i] is not None
                                       else float("inf"), i))
        keep = [0] + sorted(ranked[:max(0, max_candidates - 1)])
        emit(f"{op}: proxy rank truncated "
             f"{len(candidates) - len(keep)}/{len(candidates)} candidates")
        candidates = [candidates[i] for i in keep]
        proxies = [proxies[i] for i in keep]

    ref_out = None
    trials: List[GeometryTrial] = []
    best: Optional[Tuple[float, int]] = None
    for i, geom in enumerate(candidates):
        out, secs = measure(geom)
        out = np.asarray(out)
        if i == 0:
            ref_out = out
            exact = True
        else:
            exact = (out.shape == ref_out.shape
                     and out.dtype == ref_out.dtype
                     and bool(np.array_equal(out, ref_out)))
        reason = None if exact else "parity_mismatch_vs_default"
        trials.append(GeometryTrial(
            index=i, geometry=geom.asdict(), seconds=float(secs),
            exact=exact, accepted=exact, reject_reason=reason,
            proxy_cost=proxies[i]))
        emit(f"{op} geom {i:2d} {json.dumps(geom.asdict(), sort_keys=True)} "
             f"{secs * 1e3:8.3f} ms "
             f"{'ok' if exact else 'REJECT parity'}")
        if exact and (best is None or secs < best[0]):
            best = (secs, i)
    wi = best[1]
    winner = candidates[wi]
    speedup = trials[0].seconds / max(trials[wi].seconds, 1e-30)
    if cache is not None:
        cache.put(op, str(dtype), int(key), device_kind, winner)
    emit(f"{op} winner: geom {wi} "
         f"{json.dumps(winner.asdict(), sort_keys=True)} "
         f"speedup x{speedup:.2f} vs default")
    return GeometrySweepResult(op=op, dtype=str(dtype), key=int(key),
                               device_kind=device_kind, trials=trials,
                               winner=winner.asdict(), winner_index=wi,
                               speedup=float(speedup))


def _plan(budget: int) -> Tuple[int, int, int]:
    """Split a trial budget into (warmup, short-rung, full-rung)."""
    budget = max(1, int(budget))
    if budget <= 2:
        return budget, 0, 0
    n_warm = max(1, budget // 4)
    n_short = max(1, (budget - n_warm) * 2 // 3)
    n_full = max(0, budget - n_warm - n_short)
    return n_warm, n_short, n_full


def autotune(runner: TrialRunner, *, budget: int = 8, seed: int = 0,
             space: Optional[ConfigSpace] = None,
             cost: Optional[ServingCostModel] = None,
             geometry_cache=None,
             log: Optional[Callable[[str], None]] = None) \
        -> Tuple[TunedProfile, List[TrialResult]]:
    """Search ``space`` with ``budget`` measured candidate trials (the
    default-config reference trial is extra) and return the tuned
    profile plus every trial record (accepted and rejected).

    ``geometry_cache`` (a :class:`~paddle_tpu.autotune.kernel_geometry
    .GeometryCache` from ``sweep_kernel_geometry`` /
    a caller's own sweep) is stamped into the profile's
    per-op tier so ``GenerationServer(profile=)`` resolves per-layer
    kernel geometry the same way it resolves ``mk_geometry``."""
    emit = log or (lambda s: None)
    if space is None:
        import torch

        # bound the cp axis to meshes THIS host can build — a sampled
        # cp=4 on a 1-device box must be invalid, not a trial crash
        space = engine_space(max_len=runner.max_len,
                             devices=max(1, torch.cuda.device_count()))
    cost = cost or ServingCostModel(runner.model.cfg,
                                    max_batch=runner.max_batch)
    rng = np.random.RandomState(seed)
    workload = runner.workload
    trials: List[TrialResult] = []
    seen: set = set()

    def measure(config: Dict[str, Any], rung: str,
                reference_fp: Optional[str],
                predicted: Optional[float] = None) -> TrialResult:
        cfg = space.validate(config)
        fp_cfg = space.fingerprint(cfg)
        spec = workload if rung == "full" else short_workload
        fv, tok_fp, findings = runner.run(cfg, workload=spec)
        reason = None
        if findings:
            kinds = ",".join(f["kind"] for f in findings)
            reason = f"watchdog:{kinds}"
        elif reference_fp is not None and tok_fp != reference_fp:
            reason = (f"token_fingerprint_mismatch:{tok_fp}"
                      f"!={reference_fp}")
        tr = TrialResult(index=len(trials), rung=rung, config=cfg,
                         fingerprint=fp_cfg, features=fv,
                         tokens_fp=tok_fp, accepted=reason is None,
                         reject_reason=reason, predicted_tok_s=predicted)
        trials.append(tr)
        cost.observe(cfg, spec, fv.seconds, acceptance=fv.acceptance)
        emit(f"trial {tr.index:2d} [{rung:5s}] cfg={fp_cfg} "
             f"tok/s={fv.tok_s:8.1f} "
             f"{'ok' if tr.accepted else 'REJECT ' + (reason or '')}")
        return tr

    def sample_new(n: int, mutate_from: Optional[Dict[str, Any]] = None) \
            -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        tries = 0
        while len(out) < n and tries < 64 * n:
            tries += 1
            cfg = (space.mutate(mutate_from, rng) if mutate_from is not None
                   else space.sample(rng))
            fp = space.fingerprint(cfg)
            if fp not in seen:
                seen.add(fp)
                out.append(cfg)
        return out

    n_warm, n_short, n_full = _plan(budget)
    short_workload = workload.truncated(max(2, workload.requests // 4))

    # 1. reference trial: default config, full workload
    default_cfg = space.default()
    seen.add(space.fingerprint(default_cfg))
    ref = measure(default_cfg, "full", None)
    reference_fp = ref.tokens_fp
    baseline = ref.features

    # 2. random warmup (full rung — these calibrate the cost model)
    for cfg in sample_new(n_warm):
        measure(cfg, "full", reference_fp)
    cost.recalibrate()

    def incumbent() -> TrialResult:
        best = ref
        for t in trials:
            if t.rung == "full" and t.accepted \
                    and t.features.tok_s > best.features.tok_s:
                best = t
        return best

    # 3. candidate pool: fresh samples + mutations of the incumbent,
    #    ranked by the calibrated model's predicted throughput
    if n_short:
        pool = sample_new(4 * n_short)
        pool += sample_new(max(1, n_short // 2),
                           mutate_from=incumbent().config)
        ranked = sorted(
            ((cost.predict_tok_s(c, workload), i, c)
             for i, c in enumerate(pool)),
            key=lambda t: (-t[0], t[1]))
        pruned = len(ranked) - n_short
        if pruned > 0:
            emit(f"cost model pruned {pruned}/{len(ranked)} candidates "
                 f"without measuring them")

        # 4. short rung, then promote the best survivors to full trials
        short_done: List[Tuple[float, int, TrialResult]] = []
        for pred, _, cfg in ranked[:n_short]:
            tr = measure(cfg, "short", None, predicted=pred)
            if tr.accepted:
                short_done.append((tr.features.tok_s, tr.index, tr))
        short_done.sort(key=lambda t: (-t[0], t[1]))
        for _, _, tr in short_done[:n_full]:
            measure(tr.config, "full", reference_fp,
                    predicted=cost.predict_tok_s(tr.config, workload))
        cost.recalibrate()

    # 5. winner: best ACCEPTED full trial (the reference trial makes the
    #    set non-empty unless even the default misbehaved)
    win = incumbent()
    emit(f"winner: trial {win.index} cfg={win.fingerprint} "
         f"tok/s={win.features.tok_s:.1f} "
         f"(default {baseline.tok_s:.1f})")

    traffic_sig = runner.traffic_for(workload).signature()
    profile = TunedProfile(
        config=win.config,
        config_fingerprint=win.fingerprint,
        workload=workload.to_dict(),
        workload_signature=traffic_sig,
        metrics=win.features.to_dict(),
        baseline=baseline.to_dict(),
        search={
            "budget": int(budget),
            "seed": int(seed),
            "objective": "tok_s",
            "trials": len(trials),
            "plan": {"warmup": n_warm, "short": n_short, "full": n_full},
            "winner_trial": win.index,
            "rejected": [
                {"index": t.index, "fingerprint": t.fingerprint,
                 "reason": t.reject_reason}
                for t in trials if not t.accepted],
        },
        cost_model=cost.tick_model.to_dict(),
        kernel_geometry=(None if geometry_cache is None
                         else geometry_cache.to_dict()),
    )
    return profile, trials
