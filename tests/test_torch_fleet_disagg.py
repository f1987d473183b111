"""Disaggregated prefill/decode fleets on the PyTorch port
(``inference/fleet.py`` + ``GenerationServer(role=)``) against the JAX
package on the CPU, the cases of ``tests/test_fleet_disagg.py``: a prefill
class (chunked prefill only; a finished request parks, ``handoff_ready``)
and a decode class, the handoff over the same CRC-verified
``evacuate(rids=)`` / ``admit_migrated`` path as every migration, a
seeded prefill-replica kill mid-chunk (salvaged onto the decode class)
and a corrupted handoff payload (CRC catch → re-prefill).

Tolerances: tokens exact (greedy), against the port's single engine and
the JAX fleet; the rid → replica assignment and ``fleet_metrics`` (clock
readings aside) exact against the JAX router, except where a request
takes the re-prefill rung, whose decode rebuild adds engine steps in the
port (``tests/test_torch_fleet.py`` says why)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.faults import FaultInjector as JInjector
from paddle_tpu.inference.faults import FaultPlan as JPlan
from paddle_tpu.inference.faults import FaultSpec as JSpec
from paddle_tpu.inference.fleet import FleetRouter as JFleet
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch.faults import FaultInjector, FaultPlan, FaultSpec
from paddle_tpu_torch.inference.fleet import (REPLICA_DEGRADED,
                                              REPLICA_LIVE, FleetRouter)
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from torch_tensor_parity import jax_jit_at_o0

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
SERVE = dict(max_batch=2, max_len=96, cache="paged", block_size=8,
             prefill_chunk=16)
TIMING = ("migration_latency_p50_s", "migration_latency_p95_s", "slo")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the plain twins' row-at-a-time products are
    too small to split over a thread team other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JModel(JConfig(**SMALL, use_flash_attention=False))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**SMALL)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm


def _prompts(lens=(18, 11, 7, 9)):
    rng = np.random.RandomState(11)
    return [rng.randint(1, 128, (n,)).tolist() for n in lens]


def _port(models, **kw):
    return GenerationServer(models[1], device="cpu", **{**SERVE, **kw})


def _jax(models, **kw):
    return JServer(models[0], **{**SERVE, **kw})


def _baseline(make, prompts, max_new=12):
    srv = make()
    rids = [srv.submit(p, max_new_tokens=max_new) for p in prompts]
    out = srv.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def clean(models):
    """The port's single-engine tokens, held to the JAX server's."""
    with jax_jit_at_o0():
        want = _baseline(lambda: _jax(models), _prompts())
    got = _baseline(lambda: _port(models), _prompts())
    assert got == want
    return got


def _disagg(models, pkg, faults=None):
    """A 1 prefill + 1 decode fleet of package ``pkg`` over the default
    prompts: (tokens, rid → home at submit, rid → home at the end, fleet
    view, replica states, the fleet)."""
    make = _jax if pkg == "jax" else _port
    cls = JFleet if pkg == "jax" else FleetRouter
    fleet = cls([make(models, role="prefill"), make(models, role="decode")],
                faults=faults)
    rids = [fleet.submit(p, max_new_tokens=12) for p in _prompts()]
    first = {r: fleet._home[r] for r in rids}
    out = fleet.run()
    fm = fleet.fleet_metrics()
    view = {k: v for k, v in fm.items() if k not in TIMING}
    fleet.assert_conserved()
    return ([out[r] for r in rids], first,
            {r: fleet._home[r] for r in rids}, view,
            fleet.replica_states(), fleet)


def _plans(specs, seed):
    return (JInjector(JPlan(specs=[JSpec(*s) for s in specs], seed=seed)),
            FaultInjector(FaultPlan(specs=[FaultSpec(*s) for s in specs],
                                    seed=seed)))


def _steps_aside(view):
    out = {k: v for k, v in view.items()
           if k not in ("ticks", "heartbeat_stalls")}
    out["replicas"] = [{k: v for k, v in r.items() if k != "steps"}
                       for r in view["replicas"]]
    return out


@pytest.mark.parametrize("case", ["handoff", "prefill_kill",
                                  "corrupt_handoff"])
def test_disagg_fleet_matches_the_jax_fleet(models, clean, case):
    """Every request prefills on the prefill class and hands off to the
    decode class (no decode pass ever runs on the prefill replica); a
    ``replica_down`` on the prefill replica mid-chunk (ordinal 2, router
    tick 2) salvages its prompts onto the decode class; two corrupted
    handoff payloads degrade to re-prefill. Tokens equal the single
    engine's and the JAX fleet's, as do the homes and ``fleet_metrics``."""
    jinj = pinj = None
    if case == "prefill_kill":
        jinj, pinj = _plans([("replica_down", 2)], seed=5)
    elif case == "corrupt_handoff":
        jinj, pinj = _plans([("migrate_payload", 0, 2)], seed=9)
    with jax_jit_at_o0():
        want = _disagg(models, "jax", jinj)
    got = _disagg(models, "port", pinj)
    assert got[0] == clean
    assert got[0] == want[0]
    assert got[1] == want[1] and all(v == 0 for v in got[1].values())
    assert got[2] == want[2] and all(v == 1 for v in got[2].values())
    assert got[4] == want[4]
    fm = got[3]
    prefill = got[5]._replicas[0].server
    assert prefill.throughput_stats()["decode_trips"] == 0, \
        "a decode pass ran on the prefill replica"
    if case == "prefill_kill":
        assert _steps_aside(fm) == _steps_aside(want[3])
        assert fm["deaths"] == 1 and got[4] == ["dead", "live"]
        assert fm["prefill_replicas"] == 0 and fm["decode_replicas"] == 1
    else:
        if case == "handoff":
            assert fm == want[3]
        else:
            assert _steps_aside(fm) == _steps_aside(want[3])
            assert fm["migrate_corruptions"] == 2
        assert fm["disagg"] is True
        assert fm["prefill_replicas"] == 1 and fm["decode_replicas"] == 1
        assert fm["handoff_requests"] == len(clean) == \
            fm["migration_latency_samples"]
        assert fm["handoffs"] >= 1


def test_prefill_class_refuses_decode_phase_admits(models):
    """A prefill-class replica rejects decode-phase payloads at the door —
    a KV handoff and a replayed request that already generated tokens —
    without changing any state; a decode-class replica takes and
    finishes the same payload."""
    donor = _port(models)
    rid = donor.submit(_prompts()[0], max_new_tokens=12)
    for _ in range(8):   # past prefill, into decode
        donor.step()
    snap = donor.evacuate(trust_kv=True)
    (d,) = snap["requests"]
    assert d["phase"] == "kv"

    pre = _port(models, role="prefill")
    with pytest.raises(ValueError, match="decode-phase"):
        pre.admit_migrated(d, source_config=snap["config"])
    replay = dict(d, phase="queued", kv=None,
                  replay=list(d["prompt"]) + [5], generated=[5])
    with pytest.raises(ValueError, match="decode-phase"):
        pre.admit_migrated(replay, source_config=snap["config"])
    assert pre.load_metrics()["queue_depth"] == 0
    assert pre.load_metrics()["slots_occupied"] == 0
    assert pre.handoff_ready() == []
    pre.assert_conserved()
    dec = _port(models, role="decode")
    dec.admit_migrated(d, source_config=snap["config"])
    assert rid in dec.run()


def test_handoff_ready_parks_after_the_last_chunk(models, clean):
    """A prefill-class server parks each request once its last chunk has
    prefilled and its first token is taken — sorted, pruned of cancelled
    rids — and ``evacuate(rids=)`` moves exactly the parked ones."""
    srv = _port(models, role="prefill")
    assert srv.role == "prefill"
    rids = [srv.submit(p, max_new_tokens=12) for p in _prompts()[:3]]
    parked = []
    for _ in range(4):
        srv.step()
        parked = srv.handoff_ready()
        if len(parked) == 2:
            break
    assert parked == sorted(rids[:2])       # two slots, both prefilled
    assert srv.throughput_stats()["decode_trips"] == 0
    assert srv.cancel(rids[0])
    assert srv.handoff_ready() == [rids[1]]
    snap = srv.evacuate(trust_kv=True, rids=[rids[1]])
    assert [d["rid"] for d in snap["requests"]] == [rids[1]]
    assert snap["requests"][0]["phase"] == "kv"
    assert len(snap["requests"][0]["generated"]) == 1
    assert srv.handoff_ready() == []
    dec = _port(models, role="decode")
    dec.admit_migrated(snap["requests"][0], source_config=snap["config"])
    assert dec.run()[rids[1]] == clean[1]
    srv.evacuate(trust_kv=True)
    srv.assert_conserved()


def test_route_scores_only_same_class_peers(models, clean):
    """route() considers only prefill-capable peers for fresh
    submissions; with the whole prefill class down it degrades to the
    decode class (re-prefill) instead of refusing."""
    fleet = FleetRouter([_port(models, role="prefill"),
                         _port(models, role="prefill"),
                         _port(models, role="decode")])
    p = _prompts()[0]
    assert [r.idx for r in fleet._route(p)] == [0, 1]
    fleet.kill(0)
    assert [r.idx for r in fleet._route(p)] == [1]
    fleet.kill(1)
    assert [r.idx for r in fleet._route(p)] == [2]   # degraded fallback
    rid = fleet.submit(p, max_new_tokens=12)
    assert fleet.run()[rid] == clean[0]


def test_class_membership_survives_degrade_recover(models):
    """A degraded prefill replica recovers as a PREFILL replica: the
    health ladder moves state, never class."""
    clk = {"t": 0.0}
    fleet = FleetRouter([_port(models, role="prefill"),
                         _port(models, role="decode")],
                        clock=lambda: clk["t"], degrade_cooldown_s=5.0)
    rep = fleet._replicas[0]
    fleet._degrade(rep, "test")
    assert rep.state == REPLICA_DEGRADED and rep.role == "prefill"
    assert [r.idx for r in fleet._route(_prompts()[0])] == [0]
    clk["t"] = 2.0
    fleet.step()
    assert rep.state == REPLICA_DEGRADED
    clk["t"] = 7.0
    fleet.step()
    assert rep.state == REPLICA_LIVE and rep.role == "prefill"
    fm = fleet.fleet_metrics()
    assert fm["prefill_replicas"] == 1 and fm["decode_replicas"] == 1


def test_disagg_router_validation(models):
    with pytest.raises(ValueError, match="decode-capable"):
        FleetRouter([_port(models, role="prefill")])
    with pytest.raises(ValueError, match="prefill-capable"):
        FleetRouter([_port(models, role="decode")])
    fleet = FleetRouter([_port(models, role="prefill"), _port(models)])
    assert fleet.disagg
    with pytest.raises(ValueError, match="role must be"):
        _port(models, role="bogus")
