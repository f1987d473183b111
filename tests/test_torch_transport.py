"""The replica transport on the PyTorch port (``inference/transport.py``,
``inference/replica_worker.py``) against the JAX package, the cases of
``tests/test_transport.py``: framing over a bare socketpair (a frame's
bytes equal the JAX ``send_frame``'s for the same plain object; a
corrupted, truncated or foreign frame raises), the counting clock, the
in-process handle, and one real worker process on the CPU driven through
its whole lifecycle — hello with its fingerprints, token-exact RPCs, a
KV payload across the boundary as host numpy arrays, a remote exception
as its own type, journal salvage after a real SIGKILL, a fleet of two
workers finishing a killed worker's requests. A frame never holds a
tensor; a worker without ``device`` needs the card.

Tolerances: bytes and tokens exact."""
import os
import socket

import numpy as np
import pytest
import torch

from paddle_tpu.inference import transport as jtransport
from paddle_tpu_torch.inference import FleetRouter
from paddle_tpu_torch.inference.replica_worker import weights_fingerprint
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.inference.transport import (CountingClock,
                                                  InProcessReplica,
                                                  ReplicaTransportError,
                                                  SubprocessReplica,
                                                  host_data, recv_frame,
                                                  send_frame)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

MODEL_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=160,
                 dtype="float32", use_flash_attention=False)
SERVER_KW = dict(max_batch=2, max_len=96, cache="paged", block_size=8,
                 prefill_chunk=16)
SPEC = {"model": {"config": MODEL_CFG, "seed": 7},
        "server": dict(SERVER_KW, clock="counting"), "device": "cpu"}
# a worker's torch on one thread (the test processes share the cores)
WORKER_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    return LlamaForCausalLM(LlamaConfig(**MODEL_CFG), device="cpu", seed=7)


def _server(model=None):
    return GenerationServer(model or _model(), device="cpu", **SERVER_KW)


def _raw_frame(send, obj):
    a, b = socket.socketpair()
    try:
        send(a, obj)
        a.close()
        out = bytearray()
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return bytes(out)
            out += chunk
    finally:
        b.close()


def _contains_tensor(obj):
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, dict):
        return any(_contains_tensor(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_contains_tensor(v) for v in obj)
    return False


class TestFraming:
    @pytest.mark.parametrize("msg", [
        {"id": 7, "op": "step", "args": [1, 2], "blob": b"x" * 4096},
        {"id": 0, "op": "__hello__", "spec": SPEC},
        {"id": 3, "ok": True, "value": {2 ** 32 + 1: [1, 5, 9]},
         "seq": 4, "steps": 11}])
    def test_frames_are_the_jax_frames(self, msg):
        assert _raw_frame(send_frame, msg) == \
            _raw_frame(jtransport.send_frame, msg)
        a, b = socket.socketpair()
        try:
            send_frame(a, msg)
            assert recv_frame(b) == msg
        finally:
            a.close()
            b.close()

    def test_a_frame_holds_no_tensor(self):
        """Tensors become host numpy arrays of the same values before
        pickling (bf16 as ``ml_dtypes.bfloat16``, bit for bit); the
        frame's pickle names no torch class; a plain object is passed
        through as the same object."""
        import ml_dtypes

        bf = torch.randn(3, 5).to(torch.bfloat16)
        msg = {"kv": {"arrays": [bf, torch.arange(6, dtype=torch.int8)]},
               "generator_state": torch.Generator().get_state(),
               "nested": ({"x": torch.ones(2)},)}
        plain = {"id": 1, "value": [1, 2, {"a": 3}]}
        assert host_data(plain) is plain
        wire = host_data(msg)
        assert not _contains_tensor(wire)
        assert wire["kv"]["arrays"][0].dtype == ml_dtypes.bfloat16
        assert wire["kv"]["arrays"][0].view(np.int16).tolist() == \
            bf.view(torch.int16).tolist()
        assert wire["generator_state"].dtype == np.uint8
        raw = _raw_frame(send_frame, msg)
        assert b"torch" not in raw
        a, b = socket.socketpair()
        try:
            send_frame(a, msg)
            got = recv_frame(b)
        finally:
            a.close()
            b.close()
        assert not _contains_tensor(got)
        assert np.array_equal(got["nested"][0]["x"], np.ones(2, np.float32))

    def test_corrupted_payload_raises(self):
        raw = bytearray(_raw_frame(send_frame, {"id": 1}))
        raw[-1] ^= 0xFF      # flip a payload bit -> CRC mismatch
        c, d = socket.socketpair()
        c.sendall(bytes(raw))
        c.close()
        with pytest.raises(ReplicaTransportError, match="CRC"):
            recv_frame(d)
        d.close()

    def test_truncated_stream_raises(self):
        raw = _raw_frame(send_frame, {"id": 1, "pad": b"y" * 1024})
        c, d = socket.socketpair()
        c.sendall(raw[: len(raw) // 2])
        c.close()             # peer dies mid-frame
        with pytest.raises(ReplicaTransportError, match="mid-frame"):
            recv_frame(d)
        d.close()

    def test_garbage_magic_raises(self):
        c, d = socket.socketpair()
        try:
            c.sendall(b"HTTP/1.1 200 OK\r\n" + b"\x00" * 32)
            with pytest.raises(ReplicaTransportError, match="magic"):
                recv_frame(d)
        finally:
            c.close()
            d.close()

    def test_unpicklable_payload_raises(self):
        c, d = socket.socketpair()
        try:
            jtransport.send_frame(c, {"id": 1})
            raw = b"\x80\x05garbage"
            import struct
            import zlib
            hdr = struct.Struct(">2sHIQ").pack(
                b"Pf", 0, zlib.crc32(raw) & 0xFFFFFFFF, len(raw))
            c.sendall(hdr + raw)
            assert recv_frame(d) == {"id": 1}
            with pytest.raises(ReplicaTransportError, match="unpickle"):
                recv_frame(d)
        finally:
            c.close()
            d.close()


class TestCountingClock:
    def test_each_read_advances_as_the_jax_clock(self):
        clk, jclk = CountingClock(dt=0.5), jtransport.CountingClock(dt=0.5)
        assert [clk() for _ in range(5)] == [jclk() for _ in range(5)] \
            == [0.5, 1.0, 1.5, 2.0, 2.5]


class TestInProcessReplica:
    def test_delegates_tracks_progress_and_matches_bare_tokens(self):
        model = _model()
        bare = _server(model)
        rid_b = bare.submit([3, 5, 7], max_new_tokens=4)
        ref = bare.run()[rid_b]
        h = InProcessReplica(_server(model))
        assert h.server is not bare and h.backend == "inproc"
        rid = h.submit([3, 5, 7], max_new_tokens=4)
        s0 = h.progress_seq
        while h.step():
            pass
        out = h.take_results()
        assert out == {rid: ref}
        assert h.steps > 0 and h.progress_seq > s0
        h.ping()
        h.close()


def test_subprocess_replica_needs_the_card_without_a_device(monkeypatch):
    """A spec without ``device`` means the CUDA card: the handle refuses
    to spawn anything where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = {k: v for k, v in SPEC.items() if k != "device"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SubprocessReplica(spec, env=WORKER_ENV)


def test_subprocess_lifecycle_and_kill_salvage():
    """One worker on the CPU, from hello to SIGKILL: the hello carries the
    engine identity and a weights fingerprint equal to a local build's;
    tokens over RPC equal the in-process server's; a KV payload
    evacuated across the boundary arrives as host numpy arrays and
    resumes; a remote ValueError re-raises as one; the worker's launch
    counters answer; after a real SIGKILL the journal salvages the
    in-flight request, which replays token-exactly on a fresh server."""
    model = _model()
    ref_srv = _server(model)
    r1 = ref_srv.submit([3, 5, 7], max_new_tokens=4)
    r2 = ref_srv.submit([2, 4, 6, 8], max_new_tokens=6)
    ref = ref_srv.run()

    h = SubprocessReplica(SPEC, env=WORKER_ENV)
    try:
        assert h.cache_mode == "paged" and h.block_size == 8
        assert h.role == "any" and h.device == "cpu" and h.alive
        assert h._snapshot_fingerprint() == ref_srv._snapshot_fingerprint()
        assert h.weights_fingerprint == weights_fingerprint(model)
        assert h.weights_fingerprint != weights_fingerprint(
            LlamaForCausalLM(LlamaConfig(**MODEL_CFG), device="cpu",
                             seed=8))

        rid1 = h.submit([3, 5, 7], max_new_tokens=4)
        s0 = h.progress_seq
        while h.step():
            pass
        assert h.take_results() == {rid1: ref[r1]}   # token-exact over RPC
        assert h.progress_seq > s0
        counts = h.launch_counts(reset=True)
        assert set(counts) >= {"paged_attention", "rms_norm",
                               "stream_matmul"}

        with pytest.raises(ValueError, match="exceeds max_len"):
            h.submit(list(range(1, 200)), max_new_tokens=4)

        # a KV payload across the boundary, and back in
        rid2 = h.submit([2, 4, 6, 8], max_new_tokens=6)
        h.step()
        h.step()
        snap = h.evacuate(trust_kv=True)
        (d,) = snap["requests"]
        assert d["phase"] == "kv" and not _contains_tensor(snap)
        assert all(isinstance(a, np.ndarray) for a in d["kv"]["arrays"])
        assert h.admit_migrated(d, source_config=snap["config"]) == rid2
        h.step()

        # the worker dies with the request in flight: journal salvage
        h.kill_process()
        assert not h.alive
        salvage = h.evacuate(trust_kv=False)
        assert salvage.get("salvaged") is True
        reqs = {r["rid"]: r for r in salvage["requests"]}
        assert list(reqs) == [rid2]
        assert reqs[rid2]["prompt"] == [2, 4, 6, 8]
        fresh = _server(model)
        fresh.admit_migrated(reqs[rid2], source_config=salvage["config"])
        assert fresh.run()[rid2] == ref[r2]
        assert h.assert_conserved() == {}
        with pytest.raises(ReplicaTransportError, match="gone"):
            h.step()
    finally:
        h.close()
    h.close()    # idempotent


def test_a_fleet_of_workers_salvages_a_killed_worker():
    """Two worker processes behind a router: one is SIGKILLed mid-decode;
    the router salvages its journaled requests onto the survivor, and
    every request finishes with the in-process server's tokens."""
    prompts = [[3, 5, 7, 9, 11], [2, 4, 6, 8], [1, 2, 3], [9, 8, 7, 6, 5]]
    ref_srv = _server()
    rr = [ref_srv.submit(p, max_new_tokens=8) for p in prompts]
    ref = ref_srv.run()
    handles = [SubprocessReplica(SPEC, env=WORKER_ENV) for _ in range(2)]
    try:
        fleet = FleetRouter(handles)
        rids = [fleet.submit(p, max_new_tokens=8) for p in prompts]
        assert {r >> 32 for r in rids} == {0, 1}
        fleet.step()
        fleet.step()
        handles[0].kill_process()
        out = fleet.run()
        assert [out[r] for r in rids] == [ref[r] for r in rr]
        fm = fleet.fleet_metrics()
        assert fm["deaths"] == 1 and fm["quarantined"] == 0
        assert fleet.replica_states() == ["dead", "live"]
    finally:
        for h in handles:
            h.close()


def test_worker_refuses_a_bad_hello_with_its_error():
    """A worker whose build fails answers the hello with the error, which
    re-raises here as its own type; the process is reaped."""
    bad = dict(SPEC, server=dict(SERVER_KW, clock="wall"))
    with pytest.raises(ValueError, match="unknown worker clock"):
        SubprocessReplica(bad, env=WORKER_ENV)
