"""Process-isolated replicas: one handle interface, two backends — port
of ``paddle_tpu/inference/transport.py``.

The fleet router (``fleet.py``) was written against the router-facing
surface of :class:`~.serving.GenerationServer` — submit / step / status
/ cancel / take_results / load_metrics / snapshot / evacuate /
admit_migrated and friends. This module puts a *real process boundary*
behind that surface without changing it:

- :class:`InProcessReplica` wraps a live server in the same handle
  shape (the zero-cost backend);
- :class:`SubprocessReplica` spawns ``python -m
  paddle_tpu_torch.inference.replica_worker`` connected over a
  ``socket.socketpair()`` and serializes every call as a length-prefixed,
  CRC-stamped, pickled frame with request/response correlation ids.

A frame carries host data only: :func:`send_frame` turns every
``torch.Tensor`` in the object into a numpy array before pickling (a
bf16 tensor as an ``ml_dtypes.bfloat16`` array of the same bits, as
``paddle_tpu_torch.save`` writes it), so no frame holds a tensor and the
receiver rebuilds nothing on a device. The snapshot / migration payloads
are host memory behind per-payload CRCs (pinned CPU tensors in-process:
their asynchronous uploads are tracked by the caching host allocator,
which a numpy view would bypass), so migration across the process
boundary moves the same bytes the in-process path moves; the transport
adds its own frame CRC on top, and a frame corrupted in transit surfaces
as :class:`ReplicaTransportError`, never as silently wrong state.

**Liveness across the boundary.** Every worker reply piggybacks the
engine's current step counter plus a monotone reply sequence number;
the handle caches both. ``handle.steps`` is therefore the *last
observed* value — possibly stale between RPCs — and
``handle.progress_seq`` tells the router whether a FRESH observation
arrived since it last looked, which is what lets the heartbeat
tolerate transport round-trip latency without mis-counting stalls
(see ``FleetRouter._heartbeat``). ``ping()`` refreshes both without
stepping the engine.

**Real crashes.** The in-process fault sites model ``replica_down`` as
a poisoned object; with a subprocess backend the same event is a dead
socket. The handle keeps a host-side *journal* of every request it
admitted (prompt + sampling/scheduling parameters, updated on migration
in/out, pruned on harvest), so when the connection drops it can still
answer ``evacuate(trust_kv=False)`` locally: it synthesizes a salvage
snapshot of journaled requests as replay-queued work, and the router
re-admits them on peers through the normal re-prefill rung. Greedy
continuations are token-exact by the same argument as the CRC-mismatch
fallback — rebuilding a known prefix regenerates the same tokens.
(Sampled requests re-draw their tail; the chaos contract has always
been greedy.)

**Workers on the card.** A worker is a fresh interpreter (``subprocess``
runs ``python -m``, never a fork of a process with CUDA up). Its spec's
``device`` defaults to the CUDA card and the handle refuses to spawn
without one; on the card the parent builds the kernel library before
spawning, so the worker only loads it, and a worker that cannot reach
the card or load the kernels fails its hello with the error. The
worker's environment carries the repository root on ``PYTHONPATH``, so
the ``-m`` module resolves from any working directory.

No wall-clock waits live here: blocking is bounded by *socket
timeouts* only, and all engine-side timing stays behind the injectable
clock.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..faults import EngineFailedError
from .scheduler import PRIORITY_NORMAL, AdmissionError

__all__ = [
    "CountingClock", "InProcessReplica", "RemoteReplicaError",
    "ReplicaHandle", "ReplicaTransportError", "SubprocessReplica",
    "host_data", "recv_frame", "send_frame",
]

#: frame header: magic, flags (reserved), payload CRC32, payload length
FRAME_MAGIC = b"Pf"
_HEADER = struct.Struct(">2sHIQ")
#: refuse absurd frames before allocating for them (a corrupted length
#: field must not look like a 2**60-byte read)
MAX_FRAME_BYTES = 1 << 31


class ReplicaTransportError(ConnectionError):
    """The transport itself failed — connection dropped, timed out, or
    delivered a corrupt frame. Distinct from any error the remote engine
    *raised* (those re-raise as their own types / RemoteReplicaError)."""


class RemoteReplicaError(RuntimeError):
    """The worker's engine raised an exception type the handle does not
    reconstruct; carries the remote type name and message."""

    def __init__(self, type_name: str, msg: str):
        super().__init__(f"{type_name}: {msg}")
        self.type_name = type_name


class CountingClock:
    """Deterministic time source: every read advances by ``dt``. The
    worker builds its engine on one of these (``spec["server"]["clock"]
    = "counting"``) so cross-process runs produce byte-identical
    latency metrics at a fixed seed."""

    def __init__(self, dt: float = 0.001, start: float = 0.0):
        self.dt = float(dt)
        self.t = float(start)

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


# --------------------------------------------------------------------- frames
def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array (a copy); bf16 as an
    ``ml_dtypes.bfloat16`` array of the same bits, never widened."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def host_data(obj: Any) -> Any:
    """``obj`` with every ``torch.Tensor`` inside it (through dicts, lists
    and tuples) replaced by a host numpy array of its values — what a
    frame may carry. An object with no tensor in it comes back as it was
    (the same object), so its pickle is the JAX package's byte for
    byte."""
    if isinstance(obj, torch.Tensor):
        return _host_array(obj)
    if isinstance(obj, dict):
        vals = {k: host_data(v) for k, v in obj.items()}
        if all(vals[k] is v for k, v in obj.items()):
            return obj
        return type(obj)(vals) if type(obj) is not dict else vals
    if isinstance(obj, (list, tuple)):
        vals = [host_data(v) for v in obj]
        if all(a is b for a, b in zip(vals, obj)):
            return obj
        return type(obj)(vals)
    return obj


def send_frame(sock: socket.socket, obj: Any) -> None:
    """Pickle ``obj`` (its tensors as host numpy arrays:
    :func:`host_data`) and send it as one length-prefixed, CRC-stamped
    frame. Raises :class:`ReplicaTransportError` on a dead socket."""
    payload = pickle.dumps(host_data(obj), protocol=pickle.HIGHEST_PROTOCOL)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    header = _HEADER.pack(FRAME_MAGIC, 0, crc, len(payload))
    try:
        sock.sendall(header + payload)
    except (OSError, ValueError) as e:
        raise ReplicaTransportError(f"send failed: {e}") from e


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(min(n - len(buf), 1 << 20))
        except socket.timeout as e:
            raise ReplicaTransportError(
                f"receive timed out after {sock.gettimeout()}s "
                f"({len(buf)}/{n} bytes)") from e
        except OSError as e:
            raise ReplicaTransportError(f"receive failed: {e}") from e
        if not chunk:
            raise ReplicaTransportError(
                "connection closed by peer"
                + (" mid-frame" if buf else ""))
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Any:
    """Receive one frame; verifies magic, length bound, and CRC before
    unpickling. Any violation is :class:`ReplicaTransportError`."""
    magic, _flags, crc, length = _HEADER.unpack(
        _recv_exact(sock, _HEADER.size))
    if magic != FRAME_MAGIC:
        raise ReplicaTransportError(f"bad frame magic {magic!r}")
    if length > MAX_FRAME_BYTES:
        raise ReplicaTransportError(f"frame length {length} exceeds cap")
    payload = _recv_exact(sock, length)
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise ReplicaTransportError("frame CRC mismatch")
    try:
        return pickle.loads(payload)
    except Exception as e:   # truncated/garbage pickle
        raise ReplicaTransportError(f"frame unpickle failed: {e}") from e


#: remote exception types the handle reconstructs as themselves, so the
#: router's existing except-clauses (AdmissionError backpressure
#: fallthrough, EngineFailedError refusal) work unmodified across the
#: process boundary
_EXC_TYPES: Dict[str, type] = {
    "AdmissionError": AdmissionError,
    "EngineFailedError": EngineFailedError,
    "ValueError": ValueError,
    "KeyError": KeyError,
    "TypeError": TypeError,
    "RuntimeError": RuntimeError,
}


def _raise_remote(err: Dict[str, str]) -> None:
    cls = _EXC_TYPES.get(err.get("type", ""))
    if cls is not None:
        raise cls(err.get("msg", ""))
    raise RemoteReplicaError(err.get("type", "?"), err.get("msg", ""))


# -------------------------------------------------------------------- handles
class ReplicaHandle:
    """One interface in front of a replica regardless of where it runs.

    A handle exposes the router-facing :class:`GenerationServer`
    surface (submit/step/status/cancel/take_results/load_metrics/
    kv_stats/snapshot/evacuate/admit_migrated/adopt_warm/handoff_ready/
    set_rid_base/fail/probe_prefix/watchdog_findings/slo_observations/
    assert_conserved, plus ``steps``/``cache_mode``/``block_size``/
    ``role``) and adds two transport-aware members:

    - ``progress_seq`` — monotone count of fresh replica observations
      this handle has delivered; the router's heartbeat only charges a
      stall when a FRESH sample shows no progress;
    - ``close()`` — release the backend (a no-op in-process).
    """

    backend = "abstract"

    @property
    def steps(self) -> int:
        raise NotImplementedError

    @property
    def progress_seq(self) -> int:
        raise NotImplementedError

    def ping(self) -> None:
        """Refresh liveness state without stepping the engine."""

    def close(self) -> None:
        """Release the backend. Idempotent."""


class InProcessReplica(ReplicaHandle):
    """Zero-cost handle around a live in-process server: every
    observation is fresh by construction, so ``progress_seq`` advances
    on each ``steps`` read and the heartbeat behaves exactly as it does
    against a bare server."""

    backend = "inproc"

    def __init__(self, server: Any):
        self._server = server
        self._seq = 0

    @property
    def server(self) -> Any:
        return self._server

    @property
    def steps(self) -> int:
        self._seq += 1
        return self._server.steps

    @property
    def progress_seq(self) -> int:
        return self._seq

    def ping(self) -> None:
        self._seq += 1

    def __getattr__(self, name: str) -> Any:
        return getattr(self._server, name)


class _TelemetryProxy:
    """The slice of ``server.telemetry`` callers poke across the
    boundary (watchdog probe, between-pass counter reset)."""

    def __init__(self, handle: "SubprocessReplica"):
        self._handle = handle

    def watchdog(self) -> List[Dict[str, Any]]:
        return self._handle.watchdog_findings()

    def reset(self, counters: bool = False) -> None:
        self._handle._call("telemetry_reset", counters=counters)


#: worker ops forwarded 1:1 to the engine — anything else is refused at
#: the worker, so a corrupt frame cannot name an arbitrary attribute
PASSTHROUGH_OPS = frozenset({
    "submit", "step", "status", "cancel", "take_results", "load_metrics",
    "kv_stats", "sched_metrics", "spec_metrics", "assert_conserved",
    "snapshot", "restore", "evacuate", "admit_migrated", "adopt_warm",
    "handoff_ready", "fail", "set_rid_base", "probe_prefix",
    "watchdog_findings", "slo_observations", "telemetry_snapshot",
})


class SubprocessReplica(ReplicaHandle):
    """A replica living in its own OS process, driven over a socketpair.

    ``spec`` describes how the worker builds its engine::

        {"model": {"config": {...LlamaConfig kwargs...}, "seed": 7},
         "server": {...GenerationServer kwargs..., "clock": "counting"},
         "device": None}

    The worker rebuilds the model deterministically from (config, seed)
    on ``device`` (None: the CUDA card; ``"cpu"`` for the plain PyTorch
    versions) — weights are never shipped — and replies to the hello
    frame with its snapshot fingerprint, which the fleet's homogeneity
    check reads exactly as it would a local server's, and a fingerprint
    of its weights (:attr:`weights_fingerprint`, the worker's
    :func:`~.replica_worker.weights_fingerprint`). A spec without a
    device raises here, before anything is spawned, when this process
    sees no CUDA device; on the card the kernel library is built here
    first, so the worker only loads it.

    All calls are synchronous request/response with correlation ids;
    a reply that outlives its timed-out request is drained and its
    piggybacked progress recorded, never misdelivered. Once the
    connection drops the handle answers ``evacuate(trust_kv=False)``
    from its journal (see module docstring) and every other RPC raises
    :class:`ReplicaTransportError`.
    """

    backend = "subprocess"

    def __init__(self, spec: Dict[str, Any], *,
                 rpc_timeout_s: float = 300.0,
                 python: str = sys.executable,
                 env: Optional[Dict[str, str]] = None):
        self.spec = dict(spec)
        if resolve_device(self.spec.get("device")).type == "cuda":
            from ..ops import _build

            _build.library()
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ if env is None else env)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        parent, child = socket.socketpair()
        try:
            self._proc = subprocess.Popen(
                [python, "-m", "paddle_tpu_torch.inference.replica_worker",
                 "--fd", str(child.fileno())],
                pass_fds=(child.fileno(),), env=env)
        except Exception:
            parent.close()
            child.close()
            raise
        child.close()
        self._sock = parent
        self._sock.settimeout(float(rpc_timeout_s))
        self._alive = True
        self._down_reason: Optional[str] = None
        self._failed: Optional[str] = None
        self._next_id = 1
        self._steps = 0
        self._seq = 0
        self._journal: Dict[int, Dict[str, Any]] = {}
        self._journal_seq = 0
        try:
            send_frame(self._sock, {"id": 0, "op": "__hello__",
                                    "spec": self.spec})
            info = self._transact(0)
        except BaseException:
            self._mark_down("worker failed to boot")
            self._proc.kill()
            self._proc.wait()
            raise
        self._info = info

    # ----------------------------------------------------------------- rpc
    def _mark_down(self, reason: str) -> None:
        if self._alive:
            self._alive = False
            self._down_reason = reason
            try:
                self._sock.close()
            except OSError:
                pass

    def _note_progress(self, reply: Dict[str, Any]) -> None:
        seq = reply.get("seq")
        if seq is not None and int(seq) > self._seq:
            self._seq = int(seq)
            self._steps = int(reply.get("steps", self._steps))

    def _transact(self, mid: int) -> Any:
        """Receive until the reply correlated with ``mid`` arrives;
        record piggybacked progress from every frame on the way."""
        while True:
            reply = recv_frame(self._sock)
            self._note_progress(reply)
            if reply.get("id") != mid:
                continue     # stale reply from an earlier timed-out call
            if not reply.get("ok"):
                _raise_remote(reply.get("error") or {})
            return reply.get("value")

    def _call(self, op: str, *args: Any, **kw: Any) -> Any:
        if not self._alive:
            raise ReplicaTransportError(
                f"replica process is gone ({self._down_reason})")
        mid = self._next_id
        self._next_id += 1
        try:
            send_frame(self._sock,
                       {"id": mid, "op": op, "args": args, "kw": kw})
            return self._transact(mid)
        except ReplicaTransportError as e:
            self._mark_down(str(e))
            raise

    # ------------------------------------------------------------- identity
    @property
    def alive(self) -> bool:
        return self._alive

    @property
    def pid(self) -> int:
        return self._proc.pid

    @property
    def cache_mode(self) -> str:
        return self._info["cache_mode"]

    @property
    def block_size(self) -> int:
        return self._info["block_size"]

    @property
    def role(self) -> str:
        return self._info["role"]

    @property
    def telemetry(self) -> _TelemetryProxy:
        return _TelemetryProxy(self)

    @property
    def device(self) -> str:
        """The worker's device, as it reported it at hello."""
        return self._info["device"]

    @property
    def weights_fingerprint(self) -> str:
        """The worker's model weights' fingerprint, reported at hello."""
        return self._info["weights"]

    def _snapshot_fingerprint(self) -> Dict[str, Any]:
        return dict(self._info["fingerprint"])

    # ------------------------------------------------------------- liveness
    @property
    def steps(self) -> int:
        """Last OBSERVED step counter (piggybacked on every reply) —
        read ``progress_seq`` to learn whether it is fresh."""
        return self._steps

    @property
    def progress_seq(self) -> int:
        return self._seq

    def ping(self) -> None:
        self._call("ping")

    def launch_counts(self, reset: bool = False) -> Dict[str, int]:
        """The worker's kernel launch counters ({kernel: launches}, as
        ``paddle_tpu_torch.ops.launch_counts``); ``reset=True`` zeroes
        them after reading."""
        return dict(self._call("launch_counts", reset=reset))

    def throughput_stats(self) -> Dict[str, float]:
        """The worker server's ``throughput_stats()`` (its passes)."""
        return dict(self._call("throughput_stats"))

    # -------------------------------------------------------------- journal
    def _journal_submit(self, rid: int, prompt: List[int],
                        max_new_tokens: int, temperature: float,
                        top_k: int, top_p: float, draft_k: Optional[int],
                        adapter: Optional[str], priority: int, tenant: str,
                        ttl_s: Optional[float],
                        generated: Optional[List[int]] = None,
                        replay: Optional[List[int]] = None,
                        sched: Optional[Dict[str, Any]] = None) -> None:
        self._journal_seq += 1
        self._journal[int(rid)] = {
            "rid": int(rid), "prompt": list(prompt),
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature), "top_k": int(top_k),
            "top_p": float(top_p), "draft_k": draft_k,
            "adapter": adapter, "generated": list(generated or ()),
            "replay": (list(replay) if replay is not None else None),
            "hashes": [], "phase": "queued",
            "sched": dict(sched) if sched is not None else {
                "priority": int(priority), "tenant": tenant,
                "ttl_remaining": ttl_s, "seq": self._journal_seq,
                "cost": float(len(prompt) + max_new_tokens),
                "vtag": 0.0, "preempted": False, "started": False}}

    def _journal_snapshot_request(self, d: Dict[str, Any]) -> None:
        """Journal a request admitted via restore/admit_migrated: keep
        its known token prefix as the replay rung for a later salvage."""
        gen = list(d.get("generated") or ())
        replay = d.get("replay")
        if replay is None and gen:
            replay = list(d["prompt"]) + gen
        self._journal_submit(
            int(d["rid"]), list(d["prompt"]), int(d["max_new_tokens"]),
            float(d["temperature"]), int(d["top_k"]), float(d["top_p"]),
            d.get("draft_k"), d.get("adapter"),
            int(d["sched"]["priority"]), d["sched"]["tenant"],
            d["sched"]["ttl_remaining"], generated=gen, replay=replay,
            sched=d["sched"])

    def _salvage_snapshot(self, rids: Optional[Sequence[int]]
                          ) -> Dict[str, Any]:
        """Synthesize an ``evacuate(trust_kv=False)``-shaped snapshot
        from the journal — the handle's answer when the process is
        already gone. Requests re-enter peers as replay-queued work."""
        keep = None if rids is None else {int(r) for r in rids}
        reqs = []
        for rid in sorted(self._journal):
            if keep is not None and rid not in keep:
                continue
            d = self._journal[rid]
            reqs.append({**d, "prompt": list(d["prompt"]),
                         "generated": list(d["generated"]),
                         "replay": (list(d["replay"])
                                    if d["replay"] is not None else None),
                         "hashes": [], "sched": dict(d["sched"])})
        for d in reqs:
            self._journal.pop(d["rid"], None)
        return {"format": 1, "salvaged": True,
                "config": self._snapshot_fingerprint(),
                "requests": reqs, "results": {}, "dropped": {},
                "warm_tier": []}

    def _prune_journal(self, rids) -> None:
        for r in rids:
            self._journal.pop(int(r), None)

    # ----------------------------------------------------- engine surface
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, draft_k: Optional[int] = None,
               priority: int = PRIORITY_NORMAL, tenant: str = "default",
               ttl_s: Optional[float] = None,
               adapter: Optional[str] = None) -> int:
        if self._failed is not None:
            raise EngineFailedError(
                f"replica handle is failed ({self._failed})")
        prompt = list(prompt)
        rid = int(self._call(
            "submit", prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            draft_k=draft_k, priority=priority, tenant=tenant,
            ttl_s=ttl_s, adapter=adapter))
        self._journal_submit(rid, prompt, max_new_tokens, temperature,
                             top_k, top_p, draft_k, adapter, priority,
                             tenant, ttl_s)
        return rid

    def step(self) -> int:
        return int(self._call("step"))

    def status(self, rid: int) -> str:
        return self._call("status", int(rid))

    def cancel(self, rid: int) -> bool:
        ok = bool(self._call("cancel", int(rid)))
        if ok:
            self._journal.pop(int(rid), None)
        return ok

    def take_results(self) -> Dict[int, List[int]]:
        out = {int(r): list(t)
               for r, t in self._call("take_results").items()}
        self._prune_journal(out)
        return out

    def load_metrics(self) -> Dict[str, int]:
        return self._call("load_metrics")

    def kv_stats(self) -> Dict[str, int]:
        return self._call("kv_stats")

    def sched_metrics(self) -> Dict[str, Any]:
        return self._call("sched_metrics")

    def spec_metrics(self) -> Dict[str, float]:
        return self._call("spec_metrics")

    def assert_conserved(self) -> Dict[str, int]:
        if not self._alive:
            # a dead process holds no device state to audit; the journal
            # is empty once the router salvaged it
            return {}
        return self._call("assert_conserved")

    def probe_prefix(self, prompt: Sequence[int]) -> int:
        return int(self._call("probe_prefix", list(prompt)))

    def watchdog_findings(self) -> List[Dict[str, Any]]:
        return self._call("watchdog_findings")

    def slo_observations(self) -> Dict[str, Dict[str, List[float]]]:
        return self._call("slo_observations")

    def telemetry_snapshot(self) -> Dict[str, Any]:
        return self._call("telemetry_snapshot")

    def set_rid_base(self, base: int) -> None:
        self._call("set_rid_base", int(base))

    def handoff_ready(self) -> List[int]:
        return list(self._call("handoff_ready"))

    def snapshot(self, *, trust_kv: bool = True) -> Dict[str, Any]:
        return self._call("snapshot", trust_kv=trust_kv)

    def restore(self, snap: Dict[str, Any]) -> int:
        n = int(self._call("restore", snap))
        for d in snap.get("requests", ()):
            self._journal_snapshot_request(d)
        return n

    def evacuate(self, *, trust_kv: bool = True,
                 rids: Optional[Sequence[int]] = None) -> Dict[str, Any]:
        """Real drain over the wire while the worker lives (KV payloads
        and all); journal salvage once it does not — the subprocess
        twin of ``snapshot(trust_kv=False)`` on a crashed engine."""
        if self._alive:
            try:
                snap = self._call("evacuate", trust_kv=trust_kv,
                                  rids=rids)
            except ReplicaTransportError:
                return self._salvage_snapshot(rids)
            self._prune_journal(
                [d["rid"] for d in snap.get("requests", ())]
                if rids is not None else list(self._journal))
            return snap
        return self._salvage_snapshot(rids)

    def admit_migrated(self, d: Dict[str, Any], *,
                       source_config: Optional[Dict[str, Any]] = None
                       ) -> int:
        rid = int(self._call("admit_migrated", d,
                             source_config=source_config))
        self._journal_snapshot_request(d)
        return rid

    def adopt_warm(self, entries: Sequence[Dict[str, Any]]) -> int:
        return int(self._call("adopt_warm", list(entries)))

    def fail(self, reason: str) -> None:
        """Poison the replica (local flag first — idempotent and always
        effective — then best-effort over the wire)."""
        if self._failed is None:
            self._failed = str(reason)
        if self._alive:
            try:
                self._call("fail", str(reason))
            except (ReplicaTransportError, RemoteReplicaError):
                pass

    # ------------------------------------------------------------ lifecycle
    def kill_process(self) -> None:
        """Hard-kill the worker — the REAL-process twin of the
        ``replica_down`` fault site: the next RPC sees a dead socket."""
        self._proc.kill()
        self._proc.wait()
        self._mark_down("process killed")

    def close(self) -> None:
        if self._alive:
            try:
                send_frame(self._sock, {"id": self._next_id,
                                        "op": "shutdown",
                                        "args": (), "kw": {}})
            except ReplicaTransportError:
                pass
        try:
            self._proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._mark_down("closed")

    def __enter__(self) -> "SubprocessReplica":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
