"""The serving autotuner of the port (``paddle_tpu_torch/autotune/``,
``paddle_tpu_torch/cost_model.py``) against the JAX package's: the config
space (defaults, validity, canonicalisation, fingerprints, seeded
``sample`` / ``mutate`` sequences), the cost models (predictions,
calibration, ``replicas_for``, ``spec_break_even``), ``extract`` on one
recorded telemetry, tuned profiles (bytes written by either package load
in the other; a hand edit fails in both), the whole search over one stub
runner (byte-equal trial sequences and profile JSON), and ``paddle.flops``.

Then the port on its own, on the CPU: one small end-to-end search of the
port's server under a counting clock (same seed, same profile bytes),
``GenerationServer(profile=)`` filling the arguments left at their
defaults and installing the profile's kernel-geometry cache (the gauge
reads ``source="profile"``), and a snapshot refusing to restore into a
server of another geometry. The JAX search over JAX servers is not rerun
here (it takes over a minute on the CPU)."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu.autotune as J
from paddle_tpu import cost_model as jcm
from paddle_tpu.telemetry import ServingTelemetry as JTelemetry

import paddle_tpu_torch as paddle
import paddle_tpu_torch.autotune as P
from paddle_tpu_torch import cost_model as pcm
from paddle_tpu_torch import ops
from paddle_tpu_torch.autotune import kernel_geometry as pkg
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.telemetry import ServingTelemetry as PTelemetry


@pytest.fixture(autouse=True)
def _reset_geometry_and_mode():
    yield
    P.install_geometry_cache(None)
    J.install_geometry_cache(None)
    ops.set_kernel_mode("auto")


def _mk_cfg():
    """A model-shaped config both spaces' megakernel arithmetic reads."""
    return SimpleNamespace(hidden_size=4096, num_attention_heads=32,
                           num_key_value_heads=8, intermediate_size=14336,
                           num_hidden_layers=2)


def _spaces():
    """(JAX space, port space) pairs: the full surface, the engine space,
    and one with a bound model (the VMEM arithmetic, on the "cpu" kind)."""
    return [
        (J.ConfigSpace(J.ALL_KNOBS), P.ConfigSpace(P.ALL_KNOBS)),
        (J.engine_space(max_len=161, devices=1),
         P.engine_space(max_len=161, devices=1)),
        (J.engine_space(max_len=24, devices=4, model_cfg=_mk_cfg(),
                        max_batch=8),
         P.engine_space(max_len=24, devices=4, model_cfg=_mk_cfg(),
                        max_batch=8, device_kind="cpu")),
    ]


# ---------------------------------------------------------------- the space
@pytest.mark.parametrize("which", [0, 1, 2])
def test_space_defaults_sizes_and_seeded_draws_equal_jax(which):
    js, ps = _spaces()[which]
    assert [(k.name, k.choices, k.default) for k in js.knobs] == \
        [(k.name, k.choices, k.default) for k in ps.knobs]
    assert js.default() == ps.default()
    assert js.size() == ps.size()
    assert js.fingerprint(js.default()) == ps.fingerprint(ps.default())
    jr, pr = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(25):
        jc, pc = js.sample(jr), ps.sample(pr)
        assert jc == pc
        assert js.fingerprint(jc) == ps.fingerprint(pc)
        assert js.mutate(jc, jr, mutations=2) == ps.mutate(pc, pr,
                                                           mutations=2)
    assert jr.randint(1 << 30) == pr.randint(1 << 30)


def test_space_validity_and_canonicalisation_equal_jax():
    js, ps = _spaces()[2]
    base = js.default()
    cases = [dict(base, pool_frac=0.5, host_pool_mb=0),
             dict(base, draft_k=4, tick_window=16),
             dict(base, cp=4, prefill_chunk=32),
             dict(base, cp=2),
             dict(base, tier_demote_low=0.1),
             dict(base, tier_demote_low=0.2, tier_demote_high=0.3),
             dict(base, kernels="megakernel", mk_prefetch_depth=4),
             dict(base, kernels="megakernel", mk_ffn_tile=2048),
             dict(base, kernels="megakernel", mk_ffn_tile=512,
                  mk_dequant="tile"),
             dict(base, draft_k=0, spec_gate_low=0.5),
             dict(base, kernels="auto", mk_ffn_tile=1024),
             dict(base, block_size=32),
             dict(base, bogus=1),
             {k: v for k, v in base.items() if k != "policy"}]
    for cfg in cases:
        assert js.errors(cfg) == ps.errors(cfg), cfg
        assert js.canonicalize(cfg) == ps.canonicalize(cfg)
        assert js.is_valid(cfg) == ps.is_valid(cfg)


def test_hopper_space_keeps_megakernel_configs_the_card_takes():
    """On an NVIDIA kind the kernel tier follows the card's kernel: a ring
    past a block's 227 KB and a down slice past the x slab are invalid."""
    ps = P.engine_space(max_len=161, devices=1, model_cfg=_mk_cfg(),
                        max_batch=8, device_kind="NVIDIA H100 80GB HBM3")
    base = dict(ps.default(), kernels="megakernel")
    assert ps.is_valid(base)
    assert ps.is_valid(dict(base, mk_prefetch_depth=1))
    assert ps.is_valid(dict(base, mk_ffn_tile=2048))
    assert any("227" in e or "232448" in e for e in ps.errors(
        dict(base, mk_prefetch_depth=4)))
    assert any("x slab" in e for e in ps.errors(
        dict(base, mk_ffn_tile=2048, draft_k=4, tick_window=4)))


# ----------------------------------------------------------- the cost models
def _cfg_pair():
    from paddle_tpu.models import LlamaConfig as JConfig

    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256,
              dtype="float32")
    return JConfig(**kw), llama_tiny_config(**kw)


@pytest.mark.parametrize("bound", [False, True])
def test_serving_cost_model_predictions_and_calibration_equal_jax(bound):
    jc, pc = _cfg_pair() if bound else (None, None)
    jm = J.ServingCostModel(jc, max_batch=4)
    pm = P.ServingCostModel(pc, max_batch=4)
    assert jm.n_params == pm.n_params
    wl_j = J.WorkloadSpec(requests=12, max_new=16, prompt_ladder=(8, 24),
                          seed=3)
    wl_p = P.WorkloadSpec(requests=12, max_new=16, prompt_ladder=(8, 24),
                          seed=3)
    space = J.ConfigSpace(J.ALL_KNOBS)
    rng = np.random.RandomState(5)
    cfgs = [space.default()] + [space.sample(rng) for _ in range(8)]
    for cfg in cfgs:
        assert jm.aggregates(cfg, wl_j) == pm.aggregates(cfg, wl_p)
        assert jm.predict_seconds(cfg, wl_j) == pm.predict_seconds(cfg, wl_p)
        assert jm.predict_tok_s(cfg, wl_j) == pm.predict_tok_s(cfg, wl_p)
        assert jm.capacity_tok_s(cfg, wl_j) == pm.capacity_tok_s(cfg, wl_p)
        for demand, util in ((1e3, 1.0), (5e4, 0.7), (0.0, 0.5)):
            assert jm.replicas_for(demand, cfg, wl_j, utilization=util) == \
                pm.replicas_for(demand, cfg, wl_p, utilization=util)
    for k in (2, 4, 8):
        assert jm.spec_break_even(k, wl_j) == pm.spec_break_even(k, wl_p)
    for i, cfg in enumerate(cfgs):
        secs = 0.5 + 0.25 * i
        acc = 1.5 if cfg.get("draft_k", 0) else None
        jm.observe(cfg, wl_j, secs, acceptance=acc)
        pm.observe(cfg, wl_p, secs, acceptance=acc)
    jm.recalibrate()
    pm.recalibrate()
    assert jm.tick_model.to_dict() == pm.tick_model.to_dict()
    assert jm.measured_acceptance == pm.measured_acceptance
    assert jm.predict_tok_s(cfgs[3], wl_j) == pm.predict_tok_s(cfgs[3], wl_p)
    with pytest.raises(ValueError, match="utilization"):
        pm.replicas_for(1.0, cfgs[0], wl_p, utilization=0.0)


def test_paged_tick_cost_model_equals_jax():
    assert pcm.C_FLOP_PRIOR == jcm.C_FLOP_PRIOR
    shape_j = jcm.TickShape(decoding=8, n_params=10 ** 6, ctx_blocks=6.5,
                            block_bytes=4096)
    shape_p = pcm.TickShape(decoding=8, n_params=10 ** 6, ctx_blocks=6.5,
                            block_bytes=4096)
    jt, pt = jcm.PagedTickCostModel(), pcm.PagedTickCostModel()
    assert jt.tick_seconds(shape_j) == pt.tick_seconds(shape_p)
    assert jt.trip_seconds(shape_j, 16) == pt.trip_seconds(shape_p, 16)
    assert jt.spec_break_even(4, shape_j) == pt.spec_break_even(4, shape_p)
    rng = np.random.RandomState(1)
    trials = [dict(trips=float(a), ticks=float(b), flops=float(c),
                   bytes=float(d), seconds=float(e))
              for a, b, c, d, e in rng.uniform(1, 1e6, (6, 5))]
    jt2, pt2 = jt.calibrate(trials), pt.calibrate(trials)
    assert jt2.to_dict() == pt2.to_dict()
    assert pcm.PagedTickCostModel.from_dict(jt2.to_dict()).to_dict() == \
        jt2.to_dict()
    assert P.cost.count_params(_cfg_pair()[1]) == \
        J.cost.count_params(_cfg_pair()[0])


# ------------------------------------------------------------ the features
def _record(tel):
    """The same telemetry, event for event, into either package's
    ServingTelemetry."""
    reg = tel.registry
    reg.gauge("serving_slots_total").set(4.0)
    for v in (0.01, 0.02, 0.05, 0.4):
        reg.histogram("serving_ttft_s").observe(v)
    for v in (1.0, 3.0, 9.0):
        reg.histogram("serving_tpot_ms",
                      buckets=(0.5, 1.0, 2.5, 5.0, 10.0)).observe(v)
    for i in range(6):
        tel.flight.record(step=i, decoding=1 + i % 3, blocks_in_use=4 + i,
                          queue_depth=i % 2, preemptions=int(i == 3),
                          stalls=0, swap_out_blocks=2 * int(i == 3),
                          swap_in_blocks=int(i == 4), recompiles=0,
                          spec_proposed=4 * (i % 2),
                          spec_accepted=2 * (i % 2))


def test_extract_equals_jax_on_a_recorded_telemetry():
    jt, pt = JTelemetry(enabled=True), PTelemetry(enabled=True)
    _record(jt)
    _record(pt)
    jf = J.extract(jt, tokens=96, seconds=1.5)
    pf = P.extract(pt, tokens=96, seconds=1.5)
    assert jf.to_dict() == pf.to_dict()
    assert P.FeatureVector.from_dict(jf.to_dict()) == pf
    assert pf.acceptance == 2.0 and pf.clean == jf.clean


# ------------------------------------------------------------- the profiles
def _profile_dict(pkg, cache=None):
    space = pkg.ConfigSpace(pkg.ALL_KNOBS)
    cfg = dict(space.default(), tick_window=4, block_size=8,
               kv_quant="int8", kernels="pallas")
    wl = pkg.WorkloadSpec(requests=6, max_new=8, prompt_ladder=(8, 12),
                          vocab_size=64, seed=0)
    prof = pkg.TunedProfile(
        config=space.validate(cfg), config_fingerprint=space.fingerprint(cfg),
        workload=wl.to_dict(),
        workload_signature=pkg.draw_traffic(wl).signature(),
        metrics={"tok_s": 1.0}, baseline={"tok_s": 0.5},
        search={"budget": 0}, cost_model={"c_trip": 1.0, "c_tick": 2.0,
                                          "c_flop": 3.0, "c_byte": 4.0},
        kernel_geometry=None if cache is None else cache.to_dict())
    return prof


def _caches():
    out = []
    for pkg in (J, P):
        c = pkg.GeometryCache()
        c.put("paged_attention", "int8", 128, "NVIDIA H100 80GB HBM3",
              pkg.PagedAttentionGeometry(kv_block_depth=2, grid_order="gbm",
                                         dequant="early"))
        c.put("fused_norm", "bfloat16", 4096, "cpu",
              pkg.NormGeometry(rows=64))
        c.put("fused_lora", "bfloat16", 8, "cpu",
              pkg.LoRAGeometry(rank_pad=16))
        c.put("fused_ce", "float32", 64, "TPU v5e", pkg.CEGeometry(rows=128))
        out.append(c)
    return out


def test_profiles_round_trip_between_the_packages(tmp_path):
    jc, pc = _caches()
    assert jc.to_dict() == pc.to_dict()
    jp, pp = _profile_dict(J, jc), _profile_dict(P, pc)
    assert jp.canonical_json() == pp.canonical_json()
    jp.save(str(tmp_path / "j.json"))
    pp.save(str(tmp_path / "p.json"))
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "p.json").read_bytes()
    from_j = P.TunedProfile.load(str(tmp_path / "j.json"))
    from_p = J.TunedProfile.load(str(tmp_path / "p.json"))
    assert from_j.canonical_json() == jp.canonical_json()
    assert from_p.canonical_json() == pp.canonical_json()
    assert from_j.geometry_cache() == pc
    assert P.resolve_profile(str(tmp_path / "j.json")).config == jp.config
    assert P.resolve_profile(json.loads((tmp_path / "j.json").read_text())
                             ).config == jp.config
    assert from_j.fleet_kwargs() == jp.fleet_kwargs()


@pytest.mark.parametrize("edit", ["config", "geometry", "schema"])
def test_a_hand_edited_profile_fails_in_both_packages(tmp_path, edit):
    d = _profile_dict(J, _caches()[0]).to_dict()
    if edit == "config":
        d["config"]["tick_window"] = 8
        match = "fingerprint mismatch"
    elif edit == "geometry":
        d["kernel_geometry"]["entries"][
            "fused_norm|bfloat16|4096|cpu"]["rows"] = 8
        match = "fingerprint mismatch"
    else:
        d["schema"] = 2
        match = "schema"
    for pkg in (J, P):
        with pytest.raises(ValueError, match=match):
            pkg.TunedProfile.from_dict(d)


def test_config_server_kwargs_equal_jax_but_pallas_is_auto():
    jc, pc = _cfg_pair()
    space = J.ConfigSpace(J.ALL_KNOBS)
    rng = np.random.RandomState(2)
    for cfg in [space.default()] + [space.sample(rng) for _ in range(30)]:
        jk = J.config_server_kwargs(cfg, jc, max_batch=4, max_len=64)
        pk = P.config_server_kwargs(cfg, pc, max_batch=4, max_len=64)
        if cfg["kernels"] == "pallas":
            assert jk.pop("kernels") == "pallas" and "kernels" not in pk
        spec_j, spec_p = jk.pop("spec", None), pk.pop("spec", None)
        assert (spec_j is None) == (spec_p is None)
        if spec_j is not None:
            assert (spec_j.k, spec_j.gate_low) == (spec_p.k, spec_p.gate_low)
        geo_j, geo_p = jk.pop("mk_geometry", None), pk.pop("mk_geometry",
                                                           None)
        assert (geo_j and geo_j.asdict()) == (geo_p and geo_p.asdict())
        assert jk == pk


# --------------------------------------------------------------- the search
class _StubRunner:
    """Duck-typed TrialRunner over one package: instant measurements, the
    non-default configs faster, and optionally wrong tokens past the
    first few (the gates must reject them)."""

    def __init__(self, pkg, workload):
        self.pkg = pkg
        self.workload = workload
        self.max_len = 256
        self.max_batch = 4
        self.model = None
        self.space = pkg.engine_space(max_len=self.max_len)
        self._default_fp = self.space.fingerprint(self.space.default())

    def traffic_for(self, spec):
        return self.pkg.draw_traffic(spec)

    def run(self, config, workload=None):
        spec = workload if workload is not None else self.workload
        fp = self.space.fingerprint(config)
        default = fp == self._default_fp
        tokens = spec.requests * spec.max_new
        # a deterministic per-config time, faster than the default's
        seconds = 1.0 if default else 0.2 + int(fp[:4], 16) / 65536.0
        fv = self.pkg.FeatureVector(tokens=tokens, seconds=seconds,
                                    tok_s=tokens / seconds)
        wrong = not default and config["tick_window"] >= 16
        findings = ([{"kind": "preemption_storm"}]
                    if not default and config["pool_frac"] < 1.0 else [])
        return fv, ("bad-" + fp if wrong else "ref0"), findings


@pytest.mark.parametrize("budget,seed", [(4, 0), (8, 3), (12, 1)])
def test_autotune_over_one_stub_runner_equals_jax(budget, seed):
    runs = []
    for pkg in (J, P):
        wl = pkg.WorkloadSpec(requests=8, max_new=8, seed=0)
        runner = _StubRunner(pkg, wl)
        logs = []
        prof, trials = pkg.autotune(
            runner, budget=budget, seed=seed, space=runner.space,
            cost=pkg.ServingCostModel(None, max_batch=runner.max_batch),
            geometry_cache=_caches()[0 if pkg is J else 1], log=logs.append)
        runs.append((prof, [json.dumps(t.to_dict(), sort_keys=True)
                            for t in trials], logs))
    (jp, jt, jl), (pp, pt, pl) = runs
    assert jt == pt
    assert jl == pl
    assert jp.canonical_json() == pp.canonical_json()
    assert any("REJECT" in line for line in pl) or budget < 8


# ------------------------------------------------------- paddle.flops
def _nets(kind):
    import paddle_tpu as jpaddle

    if kind == "matmul":
        def build(nn, **dev):
            return nn.Sequential(nn.Linear(32, 64, bias_attr=False, **dev),
                                 nn.Linear(64, 16, bias_attr=False, **dev))
        size = (4, 32)
    else:
        def build(nn, **dev):
            return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1, **dev),
                                 nn.ReLU(),
                                 nn.Conv2D(8, 16, 3, padding=1, **dev),
                                 nn.ReLU(), nn.Flatten(),
                                 nn.Linear(16 * 8 * 8, 10, **dev))
        size = (2, 3, 8, 8)
    jpaddle.seed(0)
    return build(jpaddle.nn), build(paddle.nn, device="cpu"), size


def test_flops_counts_products_as_jax_does():
    """A net of bias-free products: the port's count is the JAX
    package's, exactly."""
    jnet, pnet, size = _nets("matmul")
    import paddle_tpu as jpaddle

    assert paddle.flops(pnet, size) == jpaddle.flops(jnet, size) == \
        2 * 4 * (32 * 64 + 64 * 16)


def test_flops_on_a_conv_net_counts_the_products_only():
    """A padded conv net with biases and ReLUs: the two counts follow two
    rules. The port counts every product term, padding taps included, and
    no elementwise work (``FlopCounterMode``); XLA counts the taps that
    land inside the input only, plus one flop an element for each bias add
    and ReLU. Both are held to their rule exactly, and here the port's
    count is within 15% of the JAX package's (above it: the padding taps
    outweigh the elementwise work)."""
    jnet, pnet, size = _nets("conv")
    import paddle_tpu as jpaddle

    full = 2 * 2 * 8 * 8 * (8 * 3 + 16 * 8) * 9 + 2 * 2 * 1024 * 10
    inside = (2 + 3 * 6 + 2) ** 2        # taps of a 3x3, pad-1 conv on 8x8
    xla_products = 2 * 2 * (8 * 3 + 16 * 8) * inside + 2 * 2 * 1024 * 10
    elementwise = 2 * (2 * 8 * 64 + 2 * 16 * 64) + 2 * 10
    got, ref = paddle.flops(pnet, size), jpaddle.flops(jnet, size)
    assert got == full
    assert ref == xla_products + elementwise
    assert abs(got - ref) <= 0.15 * ref


def test_cost_model_profile_measure_on_the_cpu():
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    res = pcm.CostModel().profile_measure(torch.matmul, a, b)
    assert res["flops"] == 2 * 16 * 32 * 8
    assert res["bytes accessed"] == (16 * 32 + 32 * 8 + 16 * 8) * 4
    assert res["time"] > 0.0


# ------------------------------------------- the port's server, on the CPU
class _CountingClock:
    """Every read advances one quantum: durations count clock reads."""

    def __init__(self, quantum: float = 1e-4):
        self.t = 0.0
        self.quantum = quantum

    def __call__(self) -> float:
        self.t += self.quantum
        return self.t


@pytest.fixture(scope="module")
def tiny():
    cfg = llama_tiny_config(vocab_size=64, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=1,
                            num_attention_heads=2, num_key_value_heads=1,
                            max_position_embeddings=256)
    torch.manual_seed(0)
    return LlamaForCausalLM(cfg, device="cpu")


_TUNE_WL = dict(requests=6, max_new=8, prompt_ladder=(8, 12, 16),
                vocab_size=64, seed=0)


def _search(model, budget=3, seed=0):
    wl = P.WorkloadSpec(**_TUNE_WL)
    runner = P.TrialRunner(model, wl, max_batch=4, clock=_CountingClock())
    return P.autotune(runner, budget=budget, seed=seed)


def test_port_search_same_seed_same_profile_bytes(tiny):
    p1, t1 = _search(tiny)
    p2, t2 = _search(tiny)
    assert p1.canonical_json() == p2.canonical_json()
    assert [(t.fingerprint, t.rung, t.accepted, t.tokens_fp) for t in t1] == \
        [(t.fingerprint, t.rung, t.accepted, t.tokens_fp) for t in t2]
    assert t1[0].index == 0 and t1[0].rung == "full" and t1[0].accepted
    win = t1[p1.search["winner_trial"]]
    assert win.accepted and p1.config == win.config
    assert ops.kernel_mode() == "auto"   # every trial's server was closed


def _tiny_cache():
    c = P.GeometryCache()
    c.put("paged_attention", "float32", 16, "cpu",
          P.PagedAttentionGeometry(kv_block_depth=2, grid_order="gbm"))
    c.put("fused_norm", "float32", 32, "cpu", P.NormGeometry(rows=8))
    c.put("fused_ce", "float32", 32, "cpu", P.CEGeometry(rows=8))
    return c


def _geometry_profile(cache=None, **knobs):
    space = P.ConfigSpace(P.ALL_KNOBS)
    cfg = space.validate(dict(space.default(), **knobs))
    wl = P.WorkloadSpec(**_TUNE_WL)
    return P.TunedProfile(
        config=cfg, config_fingerprint=space.fingerprint(cfg),
        workload=wl.to_dict(),
        workload_signature=P.draw_traffic(wl).signature(),
        metrics={}, baseline={}, search={}, cost_model={},
        kernel_geometry=None if cache is None else cache.to_dict())


def test_profile_fills_defaults_and_installs_its_geometry(tiny):
    prof = _geometry_profile(_tiny_cache(), tick_window=4, block_size=8,
                             kv_quant="int8")
    srv = GenerationServer(tiny, max_batch=2, max_len=64, profile=prof,
                           device="cpu")
    assert srv.profile is prof
    assert (srv.cache_mode, srv.tick_window, srv.block_size,
            srv.kv_quant) == ("paged", 4, 8, "int8")
    # the paged op is keyed int8 under kv_quant="int8": no winner there
    assert srv.kernel_geometry["paged_attention"][1] == "default"
    assert srv.kernel_geometry["fused_norm"] == (P.NormGeometry(rows=8),
                                                 "profile")
    srv2 = GenerationServer(tiny, max_batch=2, max_len=64, profile=prof,
                            tick_window=2, block_size=32, device="cpu")
    assert (srv2.tick_window, srv2.block_size, srv2.kv_quant) == \
        (2, 32, "int8")
    # tokens: the profile's schedules are the default's bits
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 64, (n,)).tolist() for n in (5, 9)]
    P.install_geometry_cache(None)
    ref = GenerationServer(tiny, max_batch=2, max_len=64, cache="paged",
                           block_size=8, tick_window=4, device="cpu")
    fp_prof = _geometry_profile(_tiny_cache(), tick_window=4, block_size=8)
    srv3 = GenerationServer(tiny, max_batch=2, max_len=64, profile=fp_prof,
                            device="cpu")
    assert srv3.kernel_geometry["paged_attention"][1] == "profile"
    outs = []
    for s in (ref, srv3):
        rids = [s.submit(p, max_new_tokens=5) for p in prompts]
        got = s.run()
        outs.append([got[r] for r in rids])
    assert outs[0] == outs[1]
    srv3.telemetry_snapshot()
    g = srv3.telemetry.registry.get("serving_kernel_geometry")
    for op in ("paged_attention", "fused_norm", "fused_ce"):
        assert g.value(op=op, source="profile") == 1.0
    assert g.value(op="flash_attention", source="default") == 1.0


def test_snapshot_refuses_cross_geometry_restore(tiny):
    a = GenerationServer(tiny, max_len=64, cache="paged", block_size=4,
                         device="cpu")
    a.submit([1, 2, 3], max_new_tokens=4)
    a.run()
    snap = a.snapshot()
    assert snap["config"]["kernel_geometry"] is None
    P.install_geometry_cache(_tiny_cache(), source="swept")
    b = GenerationServer(tiny, max_len=64, cache="paged", block_size=4,
                         device="cpu")
    assert b.kernel_geometry["paged_attention"][1] == "swept"
    with pytest.raises(ValueError, match="kernel_geometry"):
        b.restore(snap)
    b.submit([4, 5], max_new_tokens=4)
    b.run()
    snap_b = b.snapshot()
    P.install_geometry_cache(None)
    c = GenerationServer(tiny, max_len=64, cache="paged", block_size=4,
                         device="cpu")
    with pytest.raises(ValueError, match="kernel_geometry"):
        c.restore(snap_b)


def test_a9c_axes_in_a_profile_raise_at_construction(tiny):
    c = P.GeometryCache()
    c.put("flash_attention", "float32", 16, "cpu",
          P.FlashAttentionGeometry(block_q=128))
    with pytest.raises(NotImplementedError, match="A9c"):
        GenerationServer(tiny, max_len=64, cache="paged", device="cpu",
                         profile=_geometry_profile(c))
    assert pkg.local_device_kind() == ("cpu" if not torch.cuda.is_available()
                                       else torch.cuda.get_device_name())


def test_the_fleet_simulator_takes_the_ported_cost_model():
    """``ReplicaServiceModel.from_cost_model`` over the port's
    ``ServingCostModel``: decode capacity its ``capacity_tok_s``, the JAX
    simulator's numbers from the JAX cost model."""
    from paddle_tpu.fleetsim.sim import ReplicaServiceModel as JRSM

    from paddle_tpu_torch.fleetsim.sim import ReplicaServiceModel

    jc, pc = _cfg_pair()
    cfg = J.ConfigSpace(J.ALL_KNOBS).default()
    pm = P.ServingCostModel(pc, max_batch=8)
    wl = P.WorkloadSpec(requests=8, max_new=16, seed=1)
    got = ReplicaServiceModel.from_cost_model(pm, cfg, wl)
    want = JRSM.from_cost_model(J.ServingCostModel(jc, max_batch=8), cfg,
                                J.WorkloadSpec(requests=8, max_new=16,
                                               seed=1))
    assert got.decode_tok_s == pm.capacity_tok_s(cfg, wl) == \
        want.decode_tok_s
    assert (got.prefill_tok_s, got.slots) == (want.prefill_tok_s,
                                              want.slots)
