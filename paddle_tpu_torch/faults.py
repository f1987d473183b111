"""Deterministic fault injection — port of ``paddle_tpu/faults.py``, the
substrate the serving and training stacks share.

Everything here is host-only: injector hooks fire between the programs the
device runs (CUDA graph replays on the card), never inside them, and the
disabled path is a single attribute check, so production servers and train
loops pay nothing. Faults are *scripted*, not random at run time: a
``FaultPlan`` names the hook site, the call ordinal at which to fire, and how
many consecutive calls to hit, so a chaos run replays bit-identically from
its seed — the property every token-identity and bit-exact-resume check
leans on. :meth:`FaultPlan.chaos` scripts the JAX package's specs, seed for
seed, and :meth:`FaultInjector.corrupt` flips the same seeded bit, in numpy
arrays or in CPU (pinned) tensors of any dtype, bfloat16 included.

Serving hook sites (threaded through ``paddle_tpu_torch/inference/``; the
fleet sites ``replica_down``, ``migrate_payload`` and ``route`` fire in
``inference/fleet.py``):

========== =================================================== ==========
site       fires inside                                        effect
========== =================================================== ==========
alloc      ``BlockAllocator.alloc``                            raises the same pool-exhausted ``RuntimeError`` as a genuinely dry pool
host_put   ``KVOffloadEngine.swap_out``                        host pool refuses the payload (swap-out returns ``None`` → stall path)
swap_corrupt ``KVOffloadEngine.swap_in``                       flips one bit in the parked payload before checksum verification
drafter    ``GenerationServer._spec_tick`` / drafter.propose   raises ``DrafterFault`` (server falls back to the plain decode program)
tick       ``GenerationServer._dispatch_trips``                raises ``TickFault`` *before* the graph replay (``kind="fatal"`` raises a plain ``RuntimeError`` instead — unrecoverable)
clock      ``FaultInjector.wrap_clock`` wrapper                stalls the clock (``kind="stall"``) or jumps it backwards (``kind="jump_back"`` by ``magnitude`` seconds)
replica_down ``FleetRouter.step`` health probe                 marks the probed replica dead mid-decode; the router salvages its in-flight requests onto peers (``inference/fleet.py``)
migrate_payload ``FleetRouter`` migration transfer             flips one bit in a migrating KV payload; the receiving engine's CRC-verified swap-in degrades it to re-prefill
route      ``FleetRouter`` routing decision                    misroutes one submission to the worst-scoring live replica (correctness unaffected — routing is a hint)
========== =================================================== ==========

Training hook sites (``train_step`` is threaded through
``parallel/engine.py``; ``data_feed``, ``ckpt_write``, ``ckpt_read`` and
``kill`` come with the port's ``distributed/train_checkpoint.py`` and the
elastic chaos harness, which are not ported yet):

========== =================================================== ==========
site       fires inside                                        effect
========== =================================================== ==========
train_step ``ParallelEngine.train_batch``                      raises ``StepFault`` *before* the graph replay — parameters, optimizer state, step count and lr untouched, the step retries verbatim (``kind="fatal"`` → plain ``RuntimeError``, unrecoverable)
data_feed  ``CheckpointableDataFeed.next_batch``               raises ``DataFeedFault`` before the cursor advances; a retry re-fetches the identical batch
ckpt_write ``TrainCheckpointer`` commit                        torn write: partial files land in the staging dir and the commit raises ``OSError`` before the atomic rename — the degradation ladder retries, then falls back to the last manifest-valid generation
ckpt_read  ``TrainCheckpointer`` manifest verification         flips one seeded bit in a committed checkpoint file ON DISK; the CRC32 manifest must detect it and restore must skip to the previous generation
kill       elastic chaos harness step loop                     raises ``SimulatedKill`` — the in-process analogue of SIGKILL; the harness drives rendezvous + restore-latest-valid + continue
========== =================================================== ==========

Injected faults at the ``tick``/``train_step`` sites fire *before* the
program is replayed (a replay writes the KV pools or the parameters in
place and advances a sampled window's generator), so nothing the retry
would not rewrite has changed and the trip can be retried verbatim — that
ordering is what makes the degradation ladders' retry rung safe on both
stacks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SITES = frozenset({
    "alloc", "host_put", "swap_corrupt", "drafter", "tick", "clock",
    "replica_down", "migrate_payload", "route",
    "train_step", "data_feed", "ckpt_write", "ckpt_read", "kill",
})


class TickFault(RuntimeError):
    """A decode/prefill trip failed before its graph replay.

    Recoverable by construction: nothing was replayed, nothing moved, so
    the server retries the trip after a backoff. ``rid`` (optional)
    attributes the fault to one request for poison quarantine.
    """

    def __init__(self, msg: str = "injected tick fault",
                 rid: Optional[int] = None):
        super().__init__(msg)
        self.rid = rid


class StepFault(RuntimeError):
    """A train step failed before its graph replay (site ``train_step``).

    The training twin of :class:`TickFault`: the injector fires before the
    step updates the parameters, the optimizer state, the step count and
    the lr on the device, so the engine is untouched and ``train_batch``
    can be retried with the same batch.
    """


class DataFeedFault(RuntimeError):
    """The host data feed failed to produce a batch (site ``data_feed``).

    Raised before the feed's cursor advances, so a retry fetches the
    bit-identical batch — resume determinism is unaffected.
    """


class SimulatedKill(Exception):
    """In-process stand-in for SIGKILL (site ``kill``).

    Raised by the elastic chaos harness between train steps; nothing
    downstream may catch-and-continue it except the harness's restart
    loop (mirroring the launcher's --max_restart relaunch path).
    """


class EngineFailedError(RuntimeError):
    """The server hit an unrecoverable error and refuses further work.

    Raised by ``submit()`` once the engine is in a terminal failed state
    (an exception that escaped *after* a replay may have left the KV pools
    half written, so no further trip is safe). Restore a snapshot into a
    fresh server instead.
    """


@dataclass
class FaultSpec:
    """One scripted fault: fire at site-call ordinal ``at`` (0-based),
    for ``count`` consecutive calls. ``kind`` selects a site-specific
    variant, ``rid`` attributes tick faults to a request, ``magnitude``
    parameterises clock jumps."""

    site: str
    at: int = 0
    count: int = 1
    kind: str = ""
    rid: Optional[int] = None
    magnitude: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; expected one of "
                f"{sorted(SITES)}")
        if self.at < 0 or self.count < 1:
            raise ValueError("FaultSpec needs at >= 0 and count >= 1")


@dataclass
class FaultPlan:
    """An ordered script of :class:`FaultSpec` plus the seed that makes
    payload corruption deterministic."""

    specs: List[FaultSpec] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def chaos(cls, seed: int, *, intensity: int = 2,
              horizon: int = 240) -> "FaultPlan":
        """A seeded mixed plan for serving soak runs: allocator-exhaustion
        bursts, host-pool refusals, swap corruption, drafter failures,
        and sub-quarantine tick faults spread over ``horizon`` site
        calls. Same seed → same plan → same run."""
        # explicit-seed generator ON PURPOSE: a fault plan must replay
        # bit-identically across processes (capture vs. restore vs. CI),
        # independent of whatever paddle.seed the host program set
        rng = np.random.RandomState(seed)
        specs: List[FaultSpec] = []
        for _ in range(intensity):
            specs.append(FaultSpec("alloc", at=int(rng.randint(8, horizon)),
                                   count=int(rng.randint(1, 4))))
            specs.append(FaultSpec("tick", at=int(rng.randint(4, horizon)),
                                   count=1))
        specs.append(FaultSpec("host_put",
                               at=int(rng.randint(0, max(4, horizon // 8)))))
        specs.append(FaultSpec("swap_corrupt",
                               at=int(rng.randint(0, 2))))
        specs.append(FaultSpec("drafter",
                               at=int(rng.randint(0, max(4, horizon // 4)))))
        return cls(specs=specs, seed=seed)

    @classmethod
    def fleet_chaos(cls, seed: int, *, replicas: int = 2,
                    horizon: int = 24) -> "FaultPlan":
        """A seeded fleet plan: kill one replica mid-decode, corrupt one
        migrating payload, and misroute a couple of submissions. The
        ``replica_down`` ordinal counts the router's per-replica health
        probes (``replicas`` per router step), so the kill lands at a
        deterministic (step, replica) pair within the first
        ``horizon // replicas`` router ticks — early enough that any
        real workload is still mid-decode when the replica dies. Same
        seed → same plan."""
        rng = np.random.RandomState(seed)
        kill_step = int(rng.randint(2, max(3, horizon // replicas)))
        specs = [
            FaultSpec("replica_down",
                      at=kill_step * replicas + int(rng.randint(0, replicas))),
            FaultSpec("migrate_payload", at=int(rng.randint(0, 2))),
            FaultSpec("route", at=int(rng.randint(0, 8)),
                      count=int(rng.randint(1, 3))),
        ]
        return cls(specs=specs, seed=seed)

    @classmethod
    def disagg_chaos(cls, seed: int, *, replicas: int = 2,
                     prefill: int = 1, horizon: int = 24) -> "FaultPlan":
        """A seeded plan for DISAGGREGATED fleets: kill one
        PREFILL-class replica mid-chunk and corrupt one handoff payload.
        The caller orders its replicas prefill-first, so a
        ``replica_down`` ordinal of ``step * replicas + idx`` with
        ``idx < prefill`` is guaranteed to land on the prefill class —
        the generic :meth:`fleet_chaos` draw could hit a decode replica
        instead, which tests a different (and for a 1+1 fleet,
        unrecoverable-by-class) failure. Same seed → same plan."""
        if not 1 <= prefill < replicas:
            raise ValueError("disagg_chaos needs 1 <= prefill < replicas")
        rng = np.random.RandomState(seed)
        kill_step = int(rng.randint(2, max(3, horizon // replicas)))
        specs = [
            FaultSpec("replica_down",
                      at=kill_step * replicas + int(rng.randint(0, prefill))),
            FaultSpec("migrate_payload", at=int(rng.randint(0, 2))),
        ]
        return cls(specs=specs, seed=seed)

    @classmethod
    def train_chaos(cls, seed: int, *, horizon: int = 32,
                    intensity: int = 1, kills: int = 1) -> "FaultPlan":
        """A seeded training plan for the elastic chaos harness:
        transient step-dispatch faults, a data-feed hiccup, one torn
        checkpoint write, one on-disk bit corruption caught at restore,
        and ``kills`` scripted SIGKILL analogues spread over ``horizon``
        train steps. Same seed → same plan → same (bit-exact) run."""
        rng = np.random.RandomState(seed)
        specs: List[FaultSpec] = []
        for _ in range(intensity):
            specs.append(FaultSpec(
                "train_step", at=int(rng.randint(1, max(2, horizon // 2)))))
            specs.append(FaultSpec(
                "data_feed", at=int(rng.randint(1, max(2, horizon)))))
        specs.append(FaultSpec(
            "ckpt_write", at=int(rng.randint(1, max(2, horizon // 4))),
            kind="torn"))
        specs.append(FaultSpec("ckpt_read", at=int(rng.randint(0, 2))))
        # distinct kill ordinals: two kills scripted at the same site-call
        # ordinal collapse into one firing (fire() returns the first
        # match), silently halving the restart coverage the plan promises
        lo = min(2, max(1, horizon - 2))
        pool = list(range(lo, max(lo + 1, horizon - 1)))
        rng.shuffle(pool)
        ats = sorted(pool[:kills])
        while len(ats) < kills:
            ats.append((ats[-1] + 2) if ats else lo)
        for at in ats:
            specs.append(FaultSpec("kill", at=int(at)))
        return cls(specs=specs, seed=seed)


def _nbytes(a) -> int:
    if isinstance(a, np.ndarray):
        return a.nbytes
    return a.numel() * a.element_size()


def _bytes_of(a):
    """A writable uint8 view of ``a``'s bytes (a numpy array, or a
    contiguous CPU tensor)."""
    if isinstance(a, np.ndarray):
        return a.reshape(-1).view(np.uint8)
    if a.device.type != "cpu" or not a.is_contiguous():
        raise ValueError("corrupt() flips bits in contiguous host "
                         "payloads only")
    return a.reshape(-1).view(torch.uint8)


class FaultInjector:
    """Consults a :class:`FaultPlan` at named hook sites.

    Each ``fire(site)`` call increments that site's ordinal counter and
    returns the matching :class:`FaultSpec` (or ``None``). With no plan
    the injector is permanently disabled — hooks check ``enabled`` first
    so the production path is one attribute read.
    """

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan
        self.enabled = plan is not None and bool(plan.specs)
        self._by_site: Dict[str, List[FaultSpec]] = {}
        if plan is not None:
            for spec in plan.specs:
                self._by_site.setdefault(spec.site, []).append(spec)
        self._counts: Dict[str, int] = {}
        # same rationale as FaultPlan.chaos: plan-seeded, paddle-independent
        self._rng = np.random.RandomState(
            plan.seed if plan else 0)
        self.fired: List[Tuple[str, int]] = []

    def fire(self, site: str) -> Optional[FaultSpec]:
        """Host-only hook. Returns the spec to apply, or ``None``."""
        if not self.enabled:
            return None
        n = self._counts.get(site, 0)
        self._counts[site] = n + 1
        for spec in self._by_site.get(site, ()):
            if spec.at <= n < spec.at + spec.count:
                self.fired.append((site, n))
                return spec
        return None

    def corrupt(self, arrays: Sequence[Any]) -> None:
        """Flip one seeded-deterministic bit in-place across ``arrays``
        (a parked swap payload: numpy arrays, or contiguous CPU tensors of
        any dtype, read as their bytes) — the checksum verifier must catch
        it. The same plan seed flips the same byte and bit as the JAX
        injector over the same bytes."""
        sizes = [_nbytes(a) for a in arrays]
        total = int(sum(sizes))
        if total == 0:
            return
        off = int(self._rng.randint(0, total))
        bit = int(self._rng.randint(0, 8))
        for a, sz in zip(arrays, sizes):
            if off < sz:
                flat = _bytes_of(a)
                flat[off] = int(flat[off]) ^ (1 << bit)
                return
            off -= sz

    def corrupt_file(self, path: str) -> int:
        """Flip one seeded-deterministic bit of the file at ``path``, in
        place on disk (site ``ckpt_read`` uses this against a committed
        checkpoint shard) — the CRC32 manifest must catch it. Returns
        the byte offset flipped, or -1 for an empty file."""
        import os

        size = os.path.getsize(path)
        if size == 0:
            return -1
        off = int(self._rng.randint(0, size))
        bit = int(self._rng.randint(0, 8))
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ (1 << bit)]))
        return off

    def wrap_clock(self, clock: Callable[[], float]) -> Callable[[], float]:
        """Wrap an injectable clock with scripted stalls and backwards
        jumps (site ``clock``). The scheduler's monotonic clamp is the
        defense this exercises."""
        state: Dict[str, Any] = {"last": None}

        def faulty_clock() -> float:
            t = clock()
            spec = self.fire("clock")
            if spec is not None:
                if spec.kind == "stall" and state["last"] is not None:
                    return state["last"]
                if spec.kind == "jump_back":
                    t = t - (spec.magnitude or 10.0)
            state["last"] = t
            return t

        return faulty_clock

    def stats(self) -> Dict[str, Any]:
        """Site-call ordinals seen and faults actually fired."""
        return {
            "calls": dict(self._counts),
            "fired": len(self.fired),
            "fired_sites": sorted({s for s, _ in self.fired}),
        }


#: Shared disabled injector — hook sites default to this so the hot path
#: is a single ``enabled`` attribute check.
NULL_INJECTOR = FaultInjector()
