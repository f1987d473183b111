"""Replica worker: one GenerationServer behind a socketpair fd — port of
``paddle_tpu/inference/replica_worker.py``.

Spawned by :class:`~.transport.SubprocessReplica` as ``python -m
paddle_tpu_torch.inference.replica_worker --fd N`` with one end of a
``socket.socketpair()`` passed as an inherited file descriptor — no
listener, no filesystem socket, no port to collide on. The protocol is
the frame codec from ``transport.py``:

1. the first frame is a hello carrying the build ``spec``; the worker
   constructs its model deterministically from ``(config kwargs, seed)``
   on the spec's ``device`` (None: the CUDA card, raising when there is
   none — a worker never comes up on the CPU unasked) — identical weights
   to any peer built from the same spec, which is what makes
   cross-process fleets migration-homogeneous — and replies with the
   engine's snapshot fingerprint and :func:`weights_fingerprint` of its
   model. On the card it loads the kernel library the parent built
   (``ops._build.library()``), and refuses ``kernels="reference"``: a
   failure of either fails the hello with its error;
2. every subsequent frame names one allowlisted engine op (the
   router-facing surface, nothing else) and is answered by exactly one
   correlated reply; engine exceptions travel back as ``(type, msg)``
   and re-raise on the client side — the worker never dies on one;
3. every reply piggybacks the engine's step counter plus a monotone
   reply sequence number — the fleet heartbeat's freshness signal;
4. a ``shutdown`` op (or the parent closing its end) exits the loop.

Besides the engine's surface the worker answers ``ping``, ``steps``,
``telemetry_reset``, ``launch_counts`` (this process's kernel launch
counters, ``reset=True`` zeroing them) and ``throughput_stats`` (the
server's passes), so the parent can hold what the worker's passes
launched to what they were.

The engine's time base is injectable like everywhere else:
``spec["server"]["clock"] = "counting"`` builds a
:class:`~.transport.CountingClock` so per-request latency metrics are
byte-deterministic across runs; the default leaves the server's own
default clock in place. The worker itself never sleeps and never reads
the wall clock.
"""
from __future__ import annotations

import argparse
import hashlib
import socket
import sys
from typing import Any, Dict, Optional

from .transport import (PASSTHROUGH_OPS, CountingClock,
                        ReplicaTransportError, recv_frame, send_frame)

#: bytes a device reduction of :func:`weights_fingerprint` reads at once
_FP_CHUNK = 1 << 26


def weights_fingerprint(model) -> str:
    """A fingerprint of ``model``'s weights: sha256 over every state entry's
    name, shape, dtype and two integer sums of its bytes (plain, and
    weighted by each byte's position mod 65521), the sums computed where
    the weights live (exact int64 arithmetic: no rounding, no host copy of
    the weights). Two models built from the same spec give the same
    string; one changed byte changes it."""
    import torch

    h = hashlib.sha256()
    with torch.no_grad():
        for name, p in sorted(model.state_dict().items()):
            b = p.detach().contiguous().reshape(-1).view(torch.uint8)
            s1 = s2 = 0
            for lo in range(0, b.numel(), _FP_CHUNK):
                c = b[lo:lo + _FP_CHUNK].to(torch.int64)
                w = torch.arange(lo, lo + c.numel(), device=c.device,
                                 dtype=torch.int64) % 65521 + 1
                s1 += int(c.sum())
                s2 += int((c * w).sum())
            h.update(f"{name}|{tuple(p.shape)}|{p.dtype}|{s1}|{s2};"
                     .encode())
    return h.hexdigest()


def build_server(spec: Dict[str, Any]):
    """Construct the worker's engine from a build spec (see module
    docstring); returns ``(server, model)``. Imports live here so the
    subprocess pays them once."""
    from .. import resolve_device
    from ..models.llama import LlamaConfig, LlamaForCausalLM
    from .serving import GenerationServer

    device = resolve_device(spec.get("device"))
    server_kw = dict(spec.get("server") or {})
    if device.type == "cuda":
        from ..ops import _build

        _build.library()        # the parent's build: load it, or fail here
        if server_kw.get("kernels") == "reference":
            raise ValueError("a worker on the card runs the kernels: "
                             "kernels='reference' is refused")
    model_spec = dict(spec.get("model") or {})
    cfg = LlamaConfig(**dict(model_spec.get("config") or {}))
    model = LlamaForCausalLM(cfg, device=device,
                             seed=int(model_spec.get("seed", 0)))
    clock = server_kw.pop("clock", None)
    if clock == "counting":
        server_kw["clock"] = CountingClock(
            float(server_kw.pop("clock_dt", 0.001)))
    elif clock is not None:
        raise ValueError(f"unknown worker clock {clock!r} — "
                         f"only 'counting' crosses the process boundary")
    return GenerationServer(model, device=device, **server_kw), model


def _dispatch(server: Any, op: str, args: tuple, kw: Dict[str, Any]) -> Any:
    if op == "ping":
        return None
    if op == "steps":
        return server.steps
    if op == "telemetry_reset":
        return server.telemetry.reset(**kw)
    if op == "launch_counts":
        from .. import ops

        counts = ops.launch_counts()
        if kw.get("reset"):
            ops.reset_launch_counts()
        return counts
    if op == "throughput_stats":
        return server.throughput_stats()
    if op in PASSTHROUGH_OPS:
        return getattr(server, op)(*args, **kw)
    raise ValueError(f"unknown replica op {op!r}")


def serve(sock: socket.socket) -> int:
    """Run the hello + dispatch loop until shutdown or a dead peer."""
    seq = 0
    server = None

    def reply(mid: int, **body: Any) -> None:
        nonlocal seq
        seq += 1
        body.update(id=mid, seq=seq,
                    steps=(server.steps if server is not None else 0))
        send_frame(sock, body)

    try:
        hello = recv_frame(sock)
    except ReplicaTransportError:
        return 1
    if hello.get("op") != "__hello__":
        reply(hello.get("id", 0), ok=False,
              error={"type": "ValueError",
                     "msg": f"expected hello, got {hello.get('op')!r}"})
        return 1
    try:
        server, model = build_server(hello.get("spec") or {})
        info = {"fingerprint": server._snapshot_fingerprint(),
                "cache_mode": server.cache_mode,
                "block_size": server.block_size,
                "role": server.role,
                "device": str(server.device),
                "weights": weights_fingerprint(model)}
    except Exception as e:
        server = None
        reply(hello.get("id", 0), ok=False,
              error={"type": type(e).__name__, "msg": str(e)})
        return 1
    reply(hello.get("id", 0), ok=True, value=info)

    while True:
        try:
            msg = recv_frame(sock)
        except ReplicaTransportError:
            return 0          # parent went away — nothing left to serve
        mid = msg.get("id", -1)
        op = msg.get("op", "")
        if op == "shutdown":
            try:
                reply(mid, ok=True, value=None)
            except ReplicaTransportError:
                pass
            return 0
        try:
            value = _dispatch(server, op,
                              tuple(msg.get("args") or ()),
                              dict(msg.get("kw") or {}))
        except Exception as e:
            try:
                reply(mid, ok=False,
                      error={"type": type(e).__name__, "msg": str(e)})
            except ReplicaTransportError:
                return 1
            continue
        try:
            reply(mid, ok=True, value=value)
        except ReplicaTransportError:
            return 1


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fd", type=int, required=True,
                    help="inherited socketpair fd connected to the "
                         "SubprocessReplica handle")
    args = ap.parse_args(argv)
    sock = socket.socket(fileno=args.fd)
    try:
        return serve(sock)
    finally:
        try:
            sock.close()
        except OSError:
            pass


if __name__ == "__main__":
    sys.exit(main())
