"""The serving executor's programs (``paddle_tpu_torch/inference/
executor.py``) on the CPU in fp32: a decode window of ``tick_window`` ticks
and a prefill chunk with device ``start`` / ``last_idx``, through the same
static-buffer code that a CUDA device replays from CUDA graphs.

Greedy ``GenerationServer(tick_window=4)`` tokens equal the JAX server's at
the same window and the port's at W = 1, with and without an eos inside a
window, over fp, int8-KV and LoRA pools and under ``kernels="megakernel"``
(its plain twin here); a chunk with a device ``start`` equals the host-int
call; and the launch-count arithmetic of a captured program (the capture's
and the warm-up's bumps taken back, the captured launches added at each
replay) on stubs of the CUDA graph API; a weight replaced after the
server was built raises at the next run, checked once a run."""
import contextlib
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as jops
from paddle_tpu.inference import AdapterRegistry as JRegistry
from paddle_tpu.inference import LoRAConfig as JLoRAConfig
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch import ops
from paddle_tpu_torch.inference.lora import (AdapterRegistry, LoRAConfig,
                                             target_dims)
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
SERVE = dict(max_batch=2, max_len=96, block_size=4, prefill_chunk=8)
W = 4
MAX_NEW = 9
# fp32 on both sides of a host-int / device-int call: the same ops
EXACT = dict(rtol=0, atol=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work on one intra-op thread: the plain twins'
    row-at-a-time products are too small to split over a thread team
    that the other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_kernel_modes():
    yield
    ops.set_kernel_mode("auto")
    jops.set_kernel_mode("auto")


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JModel(JConfig(**SMALL, use_flash_attention=False))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**SMALL)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm


def _prompts():
    """Three prompts through two slots: one-chunk, multi-chunk and a
    partial final block; the third waits for a slot."""
    rng = np.random.RandomState(2)
    return [rng.randint(1, 128, n).tolist() for n in (5, 17, 11)]


def _lora_configs(cfg):
    """The same two adapters in a JAX and a port registry, as their
    servers' ``lora=``."""
    jr, tr = JRegistry(), AdapterRegistry()
    for i, (name, rank, alpha) in enumerate((("a1", 4, 8.0),
                                             ("a2", 2, 4.0))):
        rng = np.random.RandomState(3 + i)
        w = {(layer, t): (rng.normal(0, 0.02, (fi, rank)).astype(np.float32),
                          rng.normal(0, 0.05, (rank, fo)).astype(np.float32))
             for layer in range(cfg.num_hidden_layers)
             for t, (fi, fo) in target_dims(cfg).items()}
        jr.register(name, w, rank=rank, alpha=alpha)
        tr.register(name, w, rank=rank, alpha=alpha)
    return (JLoRAConfig(jr, max_live_adapters=2, max_rank=4),
            LoRAConfig(tr, max_live_adapters=2, max_rank=4))


def _serve(server_cls, model, window, variant, eos=None, **kw):
    """The prompts through ``server_cls`` at ``tick_window=window``;
    returns (outputs in submit order, server)."""
    prompts = _prompts()
    adapters = [None] * len(prompts)
    if variant == "int8":
        kw["kv_quant"] = "int8"
    if variant == "lora":
        adapters = ["a1", None, "a2"]
    srv = server_cls(model, cache="paged", tick_window=window,
                     eos_token_id=eos, **SERVE, **kw)
    rids = [srv.submit(p, max_new_tokens=MAX_NEW, adapter=a)
            for p, a in zip(prompts, adapters)]
    out = srv.run()
    return [out[r] for r in rids], srv


@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("variant", ["fp", "int8", "lora", "megakernel"])
def test_window_tokens_match_jax_window_and_port_single_ticks(models,
                                                              variant, eos):
    """Greedy tokens at W = 4 equal the JAX server's at W = 4 and the
    port's at W = 1; with an eos taken from the third generated token of
    the first request (inside the first window), each request is cut at
    its eos and the window's surplus is discarded."""
    jm, tm = models
    jkw, tkw = {}, dict(device="cpu")
    if variant == "lora":
        jl, tl = _lora_configs(tm.cfg)
        jkw["lora"], tkw["lora"] = jl, tl
    if variant == "megakernel":
        jkw["kernels"] = "reference"
        tkw["kernels"] = "megakernel"
    eos_id = None
    if eos:
        free, _ = _serve(GenerationServer, tm, 1, variant, **tkw)
        eos_id = free[0][len(_prompts()[0]) + 2]
    single, _ = _serve(GenerationServer, tm, 1, variant, eos=eos_id, **tkw)
    window, srv = _serve(GenerationServer, tm, W, variant, eos=eos_id,
                         **tkw)
    assert srv._exec.megakernel == (variant == "megakernel")
    ref, _ = _serve(JServer, jm, W, variant, eos=eos_id, **jkw)
    assert window == ref
    assert window == single
    for toks, p in zip(window, _prompts()):
        gen = toks[len(p):]
        if eos:
            assert eos_id not in gen[:-1]
            assert len(gen) == MAX_NEW or gen[-1] == eos_id
        else:
            assert len(gen) == MAX_NEW
    if eos:
        assert len(window[0]) <= len(_prompts()[0]) + 3    # cut at its eos
    st = srv.throughput_stats()
    assert st["decode_ticks"] == W * st["decode_trips"]
    assert st["decode_tokens"] == sum(len(t) - len(p) - 1
                                      for t, p in zip(window, _prompts()))
    assert srv.alloc.blocks_in_use == 0


def test_sampled_slot_in_a_window_leaves_greedy_slot_unchanged(models):
    """A sampled request sharing W = 4 windows with a greedy one: the
    greedy request's tokens equal its W = 1 run alone, and the sampled
    ones are valid ids."""
    _, tm = models
    pg, ps = _prompts()[:2]
    alone = GenerationServer(tm, cache="paged", device="cpu", **SERVE)
    rg = alone.submit(pg, max_new_tokens=MAX_NEW)
    want = alone.run()[rg]
    srv = GenerationServer(tm, cache="paged", device="cpu", tick_window=W,
                           seed=11, **SERVE)
    rg = srv.submit(pg, max_new_tokens=MAX_NEW)
    rs = srv.submit(ps, max_new_tokens=MAX_NEW, temperature=0.9, top_k=20,
                    top_p=0.9)
    out = srv.run()
    assert out[rg] == want
    assert len(out[rs]) == len(ps) + MAX_NEW
    assert all(0 <= t < 128 for t in out[rs][len(ps):])


@pytest.mark.parametrize("window", [0, -1])
def test_window_under_one_tick_raises_as_jax(models, window):
    jm, tm = models
    with pytest.raises(ValueError, match="tick_window"):
        JServer(jm, cache="paged", tick_window=window, **SERVE)
    with pytest.raises(ValueError, match="tick_window"):
        GenerationServer(tm, cache="paged", device="cpu", tick_window=window,
                         **SERVE)


def test_table_width_covers_a_window_past_the_chunk(models):
    """A window longer than a prefill chunk widens the tables' scratch
    slack, so a finished row's last ticks stay on the row."""
    _, tm = models
    narrow = GenerationServer(tm, cache="paged", device="cpu", **SERVE)
    wide = GenerationServer(tm, cache="paged", device="cpu", tick_window=13,
                            **SERVE)
    bs = SERVE["block_size"]
    assert narrow._table_width == -(-SERVE["max_len"] // bs) + 8 // bs
    assert wide._table_width == -(-SERVE["max_len"] // bs) + -(-13 // bs)
    r = wide.submit(_prompts()[0], max_new_tokens=MAX_NEW)
    assert len(wide.run()[r]) == len(_prompts()[0]) + MAX_NEW


def _pools(cfg, quant, N=12, bs=4):
    KV, D = cfg.num_key_value_heads, cfg.head_dim
    shape = (N, bs, KV, D)
    if quant:
        return [(torch.zeros(shape, dtype=torch.int8), torch.zeros(N, KV),
                 torch.zeros(shape, dtype=torch.int8), torch.zeros(N, KV))
                for _ in range(cfg.num_hidden_layers)]
    return [(torch.zeros(shape), torch.zeros(shape))
            for _ in range(cfg.num_hidden_layers)]


@pytest.mark.parametrize("form", ["vector", "scalar"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_prefill_chunk_with_device_start_equals_host_int(models, quant,
                                                         form):
    """``paged_prefill_chunk`` with ``start`` as an int32 (1,) or 0-d
    tensor gives the hidden states and pools of the host-int call, chunk
    after chunk (the second behind the first)."""
    _, tm = models
    rng = np.random.RandomState(4)
    table = torch.tensor([3, 7, 1, 9, 5, 0, 0, 0], dtype=torch.int32)
    host, dev = _pools(tm.cfg, quant), _pools(tm.cfg, quant)
    for start in (0, 8):
        chunk = torch.from_numpy(rng.randint(1, 128, (1, 8)).astype(np.int32))
        st = torch.tensor([start] if form == "vector" else start,
                          dtype=torch.int32)
        with torch.no_grad():
            hh, _ = tm.model.paged_prefill_chunk(chunk, host, table, start)
            hd, _ = tm.model.paged_prefill_chunk(chunk, dev, table, st)
        np.testing.assert_allclose(hd.numpy(), hh.numpy(), **EXACT)
    for ph, pd in zip(host, dev):
        for a, b in zip(ph, pd):
            assert torch.equal(a, b)


def test_executor_chunk_with_device_scalars_equals_host_ints(models):
    """The executor's chunk program takes ``start`` / ``last_idx`` as
    device int32 scalars and selects the last row on the device: the
    logits equal the host-int call's on a second server."""
    _, tm = models
    prompt = _prompts()[1]                          # 17 tokens: 3 chunks
    out = []
    for as_tensor in (False, True):
        srv = GenerationServer(tm, cache="paged", device="cpu", **SERVE)
        ex = srv._exec
        table = torch.tensor([1, 2, 3, 0, 0, 0, 0, 0] + [0] * 18,
                             dtype=torch.int32)[:srv._table_width]
        logits = []
        for start in (0, 8, 16):
            chunk = torch.zeros(1, 8, dtype=torch.int32)
            part = prompt[start:start + 8]
            chunk[0, :len(part)] = torch.tensor(part)
            last = len(part) - 1
            if as_tensor:
                start = torch.tensor([start], dtype=torch.int32)
                last = torch.tensor([last], dtype=torch.int32)
            logits.append(ex.chunk_prefill(chunk, table, start, last).clone())
        out.append(torch.cat(logits))
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), **EXACT)


def test_captured_launches_taken_back_and_added_per_replay():
    """``captured_launches`` records the launches counted inside it and
    takes them back; ``add_launch_counts`` adds them, once a replay."""
    ops.reset_launch_counts()
    rms, attn = ops.rms_norm_cuda, ops.paged_attention_cuda
    rms.launches = 5
    with ops.captured_launches() as got:
        rms.launches += 3
        attn.launches += 2
    assert got == {"rms_norm": 3, "paged_attention": 2}
    assert rms.launches == 5 and attn.launches == 0
    for _ in range(4):
        ops.add_launch_counts(got)
    assert rms.launches == 5 + 4 * 3 and attn.launches == 4 * 2
    ops.reset_launch_counts()


class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay runs nothing, it is
    only counted; a registered generator is recorded."""

    def __init__(self):
        self.replays = 0
        self.generators = []

    def replay(self):
        self.replays += 1

    def register_generator_state(self, gen):
        self.generators.append(gen)


@pytest.fixture
def stub_cuda(monkeypatch):
    """The CUDA graph API the executor calls, stubbed so that its capture
    bookkeeping runs on the CPU: a 'capture' runs the body once, eagerly."""
    stream = type("Stream", (), {"wait_stream": lambda self, other: None})
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None: contextlib.nullcontext())
    return monkeypatch


def test_replayed_program_counts_the_launches_of_eager_passes(models,
                                                               stub_cuda):
    """A program whose body counts 2 launches: its warm-up and capture
    count none, each of 3 passes (1 capture, 3 replays) counts 2; the
    capture zeroes the static inputs before the warm-up; a sampled
    program registers its generator and is a graph too; reference mode
    runs eagerly."""
    _, tm = models
    srv = GenerationServer(tm, cache="paged", device="cpu", **SERVE)
    ex = srv._exec
    ex.graphs = True
    runs = []

    def body():
        runs.append(ex._dec["pos"].clone())
        ops.rms_norm_cuda.launches += 2
        return torch.zeros(2, dtype=torch.int32)

    ops.reset_launch_counts()
    ex._dec["pos"].fill_(5)
    for _ in range(3):
        prog = ex._program(("decode", True, 1), body, ex._dec, None)
        assert prog is not None
        ex._replay(prog, "decode")
    assert ops.rms_norm_cuda.launches == 3 * 2
    assert ex.captures == 1 and ex.replays["decode"] == 3
    assert prog.graph.replays == 3 and prog.launches == {"rms_norm": 2}
    assert len(runs) == 2 and all(int(r.abs().sum()) == 0 for r in runs)
    gen = torch.Generator()
    sampled = ex._program(("decode", False, 1), body, ex._dec, gen)
    assert sampled.graph.generators == [gen]
    with pytest.raises(ValueError, match="generator"):
        ex._program(("decode", False, 1), body, ex._dec, torch.Generator())
    assert ex._program(("decode", False, 2), body, ex._dec,
                       gen).graph.generators == [gen]
    assert ex.captures == 3
    ops.set_kernel_mode("reference")
    assert ex._program(("decode", True, 1), body, ex._dec, None) is None
    ops.reset_launch_counts()


def test_replaced_weights_are_refused_in_place_updates_served(models):
    """The executor serves the tensors it was built over (a graph reads
    them by address): a weight replaced after construction raises at the
    next run, before any pass; a weight updated in place is served, as the
    per-layer path reads it."""
    _, tm = models
    model = copy.deepcopy(tm)
    srv = GenerationServer(model, cache="paged", device="cpu", **SERVE)
    prompt = [3, 1, 4, 1, 5]
    rid = srv.submit(prompt, max_new_tokens=4)
    before = srv.run()[rid]
    assert len(before) == len(prompt) + 4
    mlp = model.model.layers[1].mlp
    with torch.no_grad():
        mlp.down_proj.weight.mul_(-1.0)
    rid = srv.submit(prompt, max_new_tokens=4)
    flipped = srv.run()[rid]
    fresh = GenerationServer(model, cache="paged", device="cpu", **SERVE)
    rid = fresh.submit(prompt, max_new_tokens=4)
    assert flipped == fresh.run()[rid]
    mlp.down_proj.weight = torch.nn.Parameter(mlp.down_proj.weight.clone(),
                                              requires_grad=False)
    srv.submit(prompt, max_new_tokens=4)
    stats = srv.throughput_stats()
    with pytest.raises(RuntimeError, match="weights were replaced"):
        srv.run()
    assert srv.throughput_stats() == stats      # no pass ran


def test_weights_checked_once_a_run_not_a_pass(models, monkeypatch):
    """The weight check costs no pass: one check for each run(), and one
    on the first step after each submit."""
    _, tm = models
    srv = GenerationServer(tm, cache="paged", device="cpu", **SERVE)
    calls = []
    real = srv._exec.check_weights
    monkeypatch.setattr(srv._exec, "check_weights",
                        lambda: calls.append(1) or real())
    for n in (5, 9, 7):
        srv.submit(list(range(1, n + 1)), max_new_tokens=6)
    srv.run()
    assert len(calls) == 1
    assert srv.throughput_stats()["decode_trips"] > 1
    srv.submit([2, 7, 1], max_new_tokens=3)
    while srv.step():
        pass
    assert len(calls) == 2
