"""Batch invariance of the decode and verify products in the PyTorch port
(``ops/stream_matmul.py``, ``ops/int8.py``, ``nn/lora.py``): row r of a
product depends only on row r of x and on the weight, not on the number of
rows or on the other rows. On the card the kernels hold it (chip_smoke.py
phase 28); here their plain twins, which sum the kernels' K slices in
fp32 in order a row at a time, are held to it bit for bit at M in {1, 8,
40, 128, 160} in fp32 and bf16, with a planted twin that splits K by the row
count shown to fail the same check. Then the int8 shape rule (up to 128
rows stream, prefill chunks included; the decode and verify paths at every
row count) against the JAX package, and a small
bf16 Llama served with ``spec=``: its greedy tokens equal the plain
server's, and its verify logits equal its decode logits bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as jops
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.ops import int8 as jint8
from paddle_tpu_torch import ops
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.inference.speculative import SpecConfig
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.nn.lora import _lora_plain
from paddle_tpu_torch.ops import int8 as tint8
from paddle_tpu_torch.ops import stream_matmul as sm

# a decode tick, a verify window, one full token tile, and a verify window
# of 32 x 5 rows past it
ROWS = (1, 8, 40, 128, 160)
# K of 6 K steps, N a multiple of 128 (int8's rule: K and N multiples of
# 128 stream)
K, N, R = 384, 384, 8


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
def _restore_modes():
    yield
    ops.set_kernel_mode("auto")
    jops.set_kernel_mode("auto")


def _weights(dtype):
    g = torch.Generator().manual_seed(5)
    w = (torch.randn(K, N, generator=g) * 0.05).to(dtype)
    wq, scale = tint8.quantize_per_channel(torch.randn(K, N, generator=g)
                                           * 0.05)
    A = torch.randn(3, K, R, generator=g) * 0.05
    B = torch.randn(3, R, N, generator=g) * 0.05
    s = torch.tensor([0.0, 0.5, 2.0])
    return w, wq, scale, A, B, s


def _twins(dtype):
    """name -> f(x (M, K), r) -> (M, N): each twin at the row count of x
    (the LoRA twin with an entry a row, adapters cycling over 3 pages, row
    r on page 1)."""
    w, wq, scale, A, B, s = _weights(dtype)

    def lora(x, r):
        M = x.shape[0]
        page = torch.arange(M) % 3
        page[r] = 1
        return _lora_plain(x[:, None, :], w, A[page], B[page],
                           s[page])[:, 0]
    return {"stream": lambda x, r: sm.stream_matmul(x, w),
            "stream_tied": lambda x, r: sm.stream_matmul(
                x, w.t().contiguous(), transpose_w=True),
            "w8": lambda x, r: tint8.w8_matmul(x, wq, scale, any_rows=True),
            "lora": lora}


def _row_differences(fn, dtype, seed=0):
    """Row r of x (two positions) inside batches of every M in ROWS, the
    other rows random, twice each: the rows' results against the same row
    at M = 8. Returns the number of batches where a bit differed."""
    g = torch.Generator().manual_seed(seed)
    row = torch.randn(1, K, generator=g).to(dtype)
    want = None
    bad = 0
    for M in (8,) + ROWS:
        for trial in range(2):
            x = torch.randn(M, K, generator=g).to(dtype)
            r = 0 if trial == 0 else M - 1
            x[r] = row[0]
            got = fn(x, r)[r]
            if want is None:
                want = got
            elif not torch.equal(got, want):
                bad += 1
    return bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", ["stream", "stream_tied", "w8", "lora"])
def test_twins_are_batch_invariant(name, dtype):
    """The bf16 streaming product's twin (W and a tied head's W^T), the
    int8 matmul's (row 9) and the fused LoRA kernel's (row 12): a row's
    bits do not depend on M or on the rows beside it."""
    fn = _twins(dtype)[name]
    assert _row_differences(fn, dtype) == 0


def test_a_twin_that_splits_k_by_rows_fails_the_check(monkeypatch):
    """The planted fault: a streaming twin whose K split follows the row
    count (one slice above 8 rows), as a library product's does. The
    same check sees the rows differ."""
    w = _weights(torch.float32)[0]

    def by_rows(x2, wk, transpose_w=False):
        slices = sm.k_slices(K, N) if x2.shape[0] <= 8 else [(0, K)]
        return sm.sliced_sum(x2, wk, slices).to(x2.dtype)

    monkeypatch.setattr(sm, "_stream_plain", by_rows)
    assert _row_differences(lambda x, r: sm.stream_matmul(x, w),
                            torch.float32) > 0


def test_the_twins_slices_are_the_kernels_plan():
    """The twin sums K in the plan's slices (``stream_tiles::k_split``)
    and agrees with the plain product; a CPU tensor takes the H100's 132
    SMs."""
    assert sm.sm_count("cpu") == sm.DEFAULT_SMS == 132
    assert sm.k_slices(4096, 4096) == [(i * 1024, (i + 1) * 1024)
                                       for i in range(4)]
    assert sm.k_slices(14336, 4096) == [(i * 3584, (i + 1) * 3584)
                                        for i in range(4)]
    assert sm.k_slices(4096, 128256) == [(0, 4096)]
    assert sm.k_slices(352, N) == [(0, 64), (64, 128), (128, 192),
                                   (192, 256), (256, 320), (320, 352)]
    w = _weights(torch.float32)[0]
    x = torch.randn(40, K)
    torch.testing.assert_close(sm.stream_matmul(x, w), x @ w, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("M,streams", [(1, True), (16, True), (40, True),
                                       (128, True), (129, False)])
def test_int8_streams_up_to_128_rows(M, streams):
    """Decode ticks, verify windows and prefill chunks up to 128 rows
    stream int8 weights; past 128 rows they dequantize once, but on the
    decode and verify paths (``any_rows``) they stream at every M."""
    assert tint8.streams_int8(M, 4096, 14336) is streams
    assert tint8.streams_int8(M, 4096, 14336, any_rows=True)
    assert not tint8.streams_int8(M, 4096, 14336 + 64, any_rows=True)
    assert tint8.streams_int8(M, 4096, 14336 + 64) is False
    assert tint8.STREAM_MAX_ROWS == 128


def test_int8_linear_streams_every_row_count_on_the_decode_path(
        monkeypatch):
    """``Int8Linear.stream`` (the decode and verify projections) runs the
    streaming twin at 160 rows (a 32-slot server's k = 4 window), where
    ``forward`` (prefill) dequantizes once."""
    from paddle_tpu_torch.nn.quant.quant_layers import Int8Linear

    _, wq, scale, *_ = _weights(torch.float32)
    lin = Int8Linear(wq, scale)
    streamed = []
    orig = tint8._w8_plain
    monkeypatch.setattr(tint8, "_w8_plain", lambda x2, *a: streamed.append(
        x2.shape[0]) or orig(x2, *a))
    x = torch.randn(160, K, generator=torch.Generator().manual_seed(2))
    got = lin.stream(x)
    assert streamed == [160]
    assert torch.equal(got[7], lin.stream(x[7:8])[0])
    lin(x)
    assert streamed == [160, 1]


INT8 = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=160,
            dtype="float32")


@pytest.fixture(scope="module")
def int8_models():
    paddle.seed(3)
    jm = JModel(JConfig(**INT8, use_flash_attention=False))
    jm.quantize_int8()
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**INT8)
    tm = LlamaForCausalLM(cfg, device="cpu").quantize_int8()
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm


def test_int8_prefill_streams_and_matches_jax(int8_models, monkeypatch):
    """An int8 prefill chunk of 64 rows streams through the twin and
    agrees with JAX's ``w8_matmul``, which dequantizes past 16 rows, to
    fp32 rounding (the two round differently: ROADMAP §C); the int8
    server's greedy tokens, 64-token prefill chunks streaming their
    projections, equal the JAX int8 server's."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
    tq, ts = tint8.quantize_per_channel(torch.from_numpy(w))
    want = np.asarray(jint8.w8_matmul(jnp.asarray(x), jnp.asarray(tq.numpy()),
                                      jnp.asarray(ts.numpy())))
    np.testing.assert_allclose(tint8.w8_matmul(torch.from_numpy(x), tq,
                                               ts).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    jm, tm = int8_models
    rows = []
    orig = tint8._w8_plain
    monkeypatch.setattr(tint8, "_w8_plain", lambda x2, *a: rows.append(
        x2.shape[0]) or orig(x2, *a))
    prompts = [rng.integers(1, 256, n).tolist() for n in (70, 9, 33)]
    kw = dict(cache="paged", max_batch=2, max_len=128, block_size=8,
              prefill_chunk=64)
    ts_ = GenerationServer(tm, device="cpu", **kw)
    tr = [ts_.submit(p, max_new_tokens=6) for p in prompts]
    got = ts_.run()
    js = JServer(jm, **kw)
    jr = [js.submit(p, max_new_tokens=6) for p in prompts]
    jo = js.run()
    assert [got[r] for r in tr] == [jo[r] for r in jr]
    assert 64 in rows                   # the chunks' projections streamed


# --------------------------------------------------------------------------- #
# A small bf16 model, speculative against plain
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def bf16_model():
    cfg = llama_tiny_config(dtype="bfloat16", vocab_size=512,
                            hidden_size=128, intermediate_size=320,
                            num_attention_heads=4, num_key_value_heads=2)
    return LlamaForCausalLM(cfg, device="cpu", seed=3)


def _serve(model, prompts, **kw):
    srv = GenerationServer(model, cache="paged", device="cpu", max_batch=2,
                           max_len=64, block_size=8, prefill_chunk=16, **kw)
    rids = [srv.submit(p, max_new_tokens=16) for p in prompts]
    out = srv.run()
    return [out[r] for r in rids], srv


def _repeat_prompts():
    rng = np.random.RandomState(4)
    motif = rng.randint(1, 512, 6).tolist()
    return [(motif * 8)[:n] for n in (13, 21, 8, 17)]


def _verify_vs_decode(model):
    """The bf16 model's logits of a W = 5 window in one verify pass and in
    5 decode ticks, 4 rows at once (20 rows against 4)."""
    cfg = model.cfg
    B, W, bs, N = 4, 5, 8, 24
    shape = (N, bs, cfg.num_key_value_heads, cfg.head_dim)
    g = torch.Generator().manual_seed(1)
    pools = [tuple((torch.randn(shape, generator=g) * 0.5).to(torch.bfloat16)
                   for _ in range(2))
             for _ in range(cfg.num_hidden_layers)]
    tables = torch.arange(1, 1 + B * 5, dtype=torch.int32).reshape(B, 5)
    pos = torch.tensor([3, 9, 17, 12], dtype=torch.int32)
    win = torch.randint(1, cfg.vocab_size, (B, W), generator=g)

    def copy():
        return [tuple(p.clone() for p in pool) for pool in pools]

    with torch.no_grad():
        h, _ = model.model.paged_verify_step(win, copy(), tables, pos)
        ver = model.head(h, stream=True)
        dec_pools = copy()
        dec = torch.cat([model.head(model.model.paged_decode_step(
            win[:, j:j + 1], dec_pools, tables, pos + j)[0], stream=True)
            for j in range(W)], 1)
    return ver, dec


def test_bf16_spec_tokens_equal_plain_and_verify_equals_decode(bf16_model):
    """A 2-layer bf16 Llama (narrow widths) on repeat-suffix traffic:
    greedy speculative tokens (n-gram, k = 4, the gate off) equal the
    plain server's, and a verify window's logits equal its decode ticks'
    bit for bit (the products at 20 rows against 4)."""
    prompts = _repeat_prompts()
    plain, _ = _serve(bf16_model, prompts)
    spec, srv = _serve(bf16_model, prompts,
                       spec=SpecConfig(k=4, gate_cooldown=0))
    assert srv.spec_metrics()["draft_tokens_accepted"] > 0
    assert spec == plain
    ver, dec = _verify_vs_decode(bf16_model)
    assert torch.equal(ver, dec)


def test_a_twin_that_splits_k_by_rows_breaks_verify_equals_decode(
        bf16_model, monkeypatch):
    """The planted fault on the served path: the streaming twin's K split
    following the row count. The verify window's logits then differ from
    its decode ticks'."""
    def by_rows(x2, w, transpose_w=False):
        wk = w.t() if transpose_w else w
        Kw, Nw = wk.shape
        slices = sm.k_slices(Kw, Nw) if x2.shape[0] <= 4 else [(0, Kw)]
        return sm.sliced_sum(x2, wk, slices).to(x2.dtype)

    monkeypatch.setattr(sm, "_stream_plain", by_rows)
    ver, dec = _verify_vs_decode(bf16_model)
    assert not torch.equal(ver, dec)
