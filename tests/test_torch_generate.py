"""Fixed-cache generation in the port (``paddle_tpu_torch/models/
generation.py``, ``LlamaForCausalLM.generate``, ``GPTForCausalLM``) held
against the JAX package on the CPU in fp32, with the same weights carried
over (``models/convert.py``): the cases of ``tests/test_generate.py`` —
cached against cacheless, prefill filling the caches as decode does, zero
new tokens, eos and sampling, top-p, beam search against an exhaustive
oracle and against JAX's search (EOS-frozen beams included), one beam as
greedy, GPT through the mixin — plus int8 generate
(``tests/test_int8_decode.py``), ``gather_tree`` and ``advance_tokens``
against JAX's, the one-token-prompt edges, and the programs' bookkeeping:
on a CPU stand-in for the CUDA graph calls one capture a body per key and
one replay a step, giving the eager tokens, and no host read in any
body. The JAX side runs ``use_flash_attention=False`` (one case runs its
flash kernel in interpret mode); the port runs flash on (its plain twin)
and off (the masked einsum). Greedy tokens are compared exactly."""
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.jit import state_values
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models.generation import GenerationMixin as JMixin
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu_torch import graphs
from paddle_tpu_torch.models import generation
from paddle_tpu_torch.models.convert import (gpt_params_from_jax,
                                             params_from_jax)
from paddle_tpu_torch.models.generation import (GenerationMixin,
                                                advance_tokens, next_token)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.functional import gather_tree

TINY = dict(vocab_size=61, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=32,
            dtype="float32")
PREFILL = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=64,
               dtype="float32")
BEAM = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
INT8 = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
GPT_MIXIN = dict(vocab_size=61, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=32)
GPT_BEAM = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=48,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
FLASH = [True, False]
FLASH_IDS = ["flash", "einsum"]

_aten = torch.ops.aten
# the ops that make the host wait for a device value: a CUDA graph capture
# refuses each
HOST_READS = {_aten._local_scalar_dense, _aten.item, _aten.nonzero,
              _aten.masked_select, _aten.is_nonzero, _aten.equal}
MASK_INDEXING = {_aten.index, _aten.index_put, _aten.index_put_}


class NoHostRead(TorchDispatchMode):
    """Raises on any op of ``HOST_READS`` and on boolean-mask indexing."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func.overloadpacket
        if op in HOST_READS or op in MASK_INDEXING and any(
                i is not None and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]):
            raise AssertionError(f"host read of a device value: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work on one intra-op thread: the plain twins'
    row-at-a-time products are too small to split over a thread team
    that the other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(jm):
    return {k: np.asarray(v) for k, v in state_values(jm).items()}


def _llama(cfg_kw, seed=0, flash=False, jax_flash=False):
    """A JAX Llama and the port's with its weights."""
    paddle.seed(seed)
    jm = JModel(JConfig(**cfg_kw, use_flash_attention=jax_flash))
    cfg = LlamaConfig(**cfg_kw, use_flash_attention=flash)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(_state(jm), cfg))
    return jm, tm


def _gpt(cfg_kw, seed=0):
    paddle.seed(seed)
    jm = JGPT(JGPTConfig(**cfg_kw))
    cfg = GPTConfig(**cfg_kw)
    tm = GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(_state(jm), cfg, device="cpu"))
    return jm, tm


def _jgen(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).value)


def _tgen(tm, ids, **kw):
    return tm.generate(torch.from_numpy(ids), **kw).numpy()


def _tlogits(tm, seq):
    with torch.no_grad():
        return tm(torch.from_numpy(np.asarray(seq, np.int32))).numpy()


@pytest.fixture(scope="module")
def tiny():
    return {flash: _llama(TINY, flash=flash) for flash in FLASH}


@pytest.fixture(scope="module")
def prefill_models():
    return {flash: _llama(PREFILL, flash=flash) for flash in FLASH}


@pytest.fixture(scope="module")
def beam_models():
    return _llama(BEAM)


@pytest.fixture(scope="module")
def gpt_beam():
    return _gpt(GPT_BEAM)


# ---------------------------------------------------------------- greedy
@pytest.mark.parametrize("flash", FLASH, ids=FLASH_IDS)
def test_greedy_matches_forward_argmax(tiny, flash):
    jm, tm = tiny[flash]
    ids = np.random.RandomState(0).randint(0, 61, (2, 6)).astype(np.int32)
    out = _tgen(tm, ids, max_new_tokens=4)
    assert out.shape == (2, 10) and out.dtype == np.int32
    np.testing.assert_array_equal(out[:, :6], ids)
    np.testing.assert_array_equal(out[:, 6],
                                  _tlogits(tm, ids)[:, -1].argmax(-1))
    np.testing.assert_array_equal(out, _jgen(jm, ids, max_new_tokens=4))


@pytest.mark.parametrize("flash", FLASH, ids=FLASH_IDS)
def test_greedy_multi_step_matches_incremental_forward(tiny, flash):
    """Every generated token equals the argmax of the full forward over
    the sequence so far (the cache across steps), and JAX's."""
    jm, tm = tiny[flash]
    ids = np.random.RandomState(1).randint(0, 61, (1, 5)).astype(np.int32)
    out = _tgen(tm, ids, max_new_tokens=3)
    seq = ids.copy()
    for t in range(3):
        nxt = _tlogits(tm, seq)[:, -1].argmax(-1).astype(np.int32)
        assert out[0, 5 + t] == nxt[0], f"step {t} diverged"
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(out, _jgen(jm, ids, max_new_tokens=3))


def test_sampling_and_eos(tiny):
    """The same seed draws the same tokens, in range (the draws are not
    JAX's); after eos a row keeps emitting eos, and the greedy eos run
    equals JAX's."""
    jm, tm = tiny[True]
    ids = np.random.RandomState(2).randint(0, 61, (2, 4)).astype(np.int32)
    kw = dict(max_new_tokens=5, temperature=0.9, top_k=7, seed=3)
    s1, s2 = _tgen(tm, ids, **kw), _tgen(tm, ids, **kw)
    np.testing.assert_array_equal(s1, s2)
    assert (s1[:, 4:] < 61).all() and (s1[:, 4:] >= 0).all()
    assert not np.array_equal(s1, _tgen(tm, ids, **{**kw, "seed": 4}))
    eos = int(_tlogits(tm, ids)[0, -1].argmax())
    out = _tgen(tm, ids, max_new_tokens=6, eos_token_id=eos)
    row = out[0, 4:]
    assert row[0] == eos and (row == eos).all()
    np.testing.assert_array_equal(
        out, _jgen(jm, ids, max_new_tokens=6, eos_token_id=eos))


def test_one_token_prompt_decodes_from_position_zero(tiny):
    """P = 1 skips the prefill (every token through the decode step)."""
    jm, tm = tiny[True]
    ids = np.asarray([[7], [19]], np.int32)
    np.testing.assert_array_equal(_tgen(tm, ids, max_new_tokens=5),
                                  _jgen(jm, ids, max_new_tokens=5))


def test_prompt_past_the_position_table_raises(tiny):
    _, tm = tiny[True]
    ids = np.zeros((1, 30), np.int32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        _tgen(tm, ids, max_new_tokens=3)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        _tgen(tm, ids, max_new_tokens=3, num_beams=2)


# --------------------------------------------------------------- GPT
def test_gpt_generate_via_mixin():
    """GPT (dropout 0.1, switched off for generation) greedy: the first
    token is the eval forward's argmax, the tokens JAX's."""
    jm, tm = _gpt(GPT_MIXIN)
    ids = np.random.RandomState(0).randint(0, 61, (2, 6)).astype(np.int32)
    assert tm.training
    out = _tgen(tm, ids, max_new_tokens=4)
    assert tm.training and out.shape == (2, 10)
    np.testing.assert_array_equal(out[:, :6], ids)
    tm.eval()
    np.testing.assert_array_equal(out[:, 6],
                                  _tlogits(tm, ids)[:, -1].argmax(-1))
    np.testing.assert_array_equal(out, _jgen(jm, ids, max_new_tokens=4))


def test_gpt_cached_matches_cacheless():
    paddle.seed(0)
    from paddle_tpu.models.gpt import gpt_tiny_config as jtiny
    from paddle_tpu_torch.models.gpt import gpt_tiny_config

    jm = JGPT(jtiny())
    cfg = gpt_tiny_config()
    tm = GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(_state(jm), cfg, device="cpu"))
    ids = np.array([[3, 1, 4, 1, 5]], dtype=np.int32)
    cached = _tgen(tm, ids, max_new_tokens=8)
    cacheless = GenerationMixin.generate(tm, torch.from_numpy(ids),
                                         max_new_tokens=8).numpy()
    np.testing.assert_array_equal(cached, cacheless)
    np.testing.assert_array_equal(cached, _jgen(jm, ids, max_new_tokens=8))
    np.testing.assert_array_equal(cacheless, np.asarray(JMixin.generate(
        jm, paddle.to_tensor(ids), max_new_tokens=8).value))


def test_gpt_eos_and_sampling_shapes(gpt_beam):
    _, tm = gpt_beam
    ids = np.array([[2, 7], [9, 4]], dtype=np.int32)
    out = _tgen(tm, ids, max_new_tokens=5, temperature=0.8, top_k=4, seed=3,
                eos_token_id=0)
    assert out.shape == (2, 7)
    assert ((out[:, 2:] >= 0) & (out[:, 2:] < 64)).all()


def test_gpt_decode_step_matches_the_forward(gpt_beam):
    """The decode step at each position (wpe read at pos) gives the
    forward's logits of that position."""
    _, tm = gpt_beam
    cfg = tm.cfg
    ids = torch.from_numpy(
        np.random.RandomState(4).randint(0, 64, (2, 7)).astype(np.int32))
    caches = [(torch.zeros(2, 16, 4, 8), torch.zeros(2, 16, 4, 8))
              for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        full = tm(ids)
        for t in range(7):
            h, caches = tm.transformer.decode_step(ids[:, t:t + 1], caches,
                                                   t)
            torch.testing.assert_close(tm._logits(h)[:, 0], full[:, t],
                                       rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ prefill
@pytest.mark.parametrize("flash", FLASH, ids=FLASH_IDS)
def test_prefill_generate_matches_cacheless(prefill_models, flash):
    """The prompt in one prefill, then cached decode, gives the cacheless
    full-forward loop's tokens, and JAX's."""
    jm, tm = prefill_models[flash]
    ids = np.random.RandomState(3).randint(0, 96, (2, 9)).astype(np.int32)
    cached = _tgen(tm, ids, max_new_tokens=7)
    cacheless = GenerationMixin.generate(tm, torch.from_numpy(ids),
                                         max_new_tokens=7).numpy()
    np.testing.assert_array_equal(cached, cacheless)
    np.testing.assert_array_equal(cached, _jgen(jm, ids, max_new_tokens=7))


def test_prefill_fills_cache_like_decode(prefill_models):
    """``model.prefill``'s caches equal P single-token decode writes (the
    same RoPE positions and layout) and JAX's prefill caches."""
    from paddle_tpu.framework.core import Tensor

    jm, tm = prefill_models[True]
    B, Pn, KV, D = 2, 6, 2, 8
    ids = np.random.RandomState(1).randint(0, 96, (B, Pn)).astype(np.int32)

    def mk():
        return [(torch.zeros(B, 16, KV, D), torch.zeros(B, 16, KV, D))
                for _ in range(tm.cfg.num_hidden_layers)]

    with torch.no_grad():
        _, pre = tm.model.prefill(torch.from_numpy(ids), mk())
        dec = mk()
        for t in range(Pn):
            _, dec = tm.model.decode_step(torch.from_numpy(ids[:, t:t + 1]),
                                          dec, t)
    jmk = [(Tensor(np.zeros((B, 16, KV, D), np.float32)),
            Tensor(np.zeros((B, 16, KV, D), np.float32)))
           for _ in range(tm.cfg.num_hidden_layers)]
    _, jpre = jm.model.prefill(paddle.to_tensor(ids), jmk)
    for (pk, pv), (dk, dv), (jk, jv) in zip(pre, dec, jpre):
        for p, d, j in ((pk, dk, jk), (pv, dv, jv)):
            np.testing.assert_allclose(p[:, :Pn].numpy(), d[:, :Pn].numpy(),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(p.numpy(), np.asarray(j.value),
                                       rtol=1e-5, atol=1e-6)


def test_zero_new_tokens_returns_prompt_unchanged(prefill_models):
    _, tm = prefill_models[True]
    ids = np.random.RandomState(5).randint(0, 96, (2, 6)).astype(np.int32)
    np.testing.assert_array_equal(_tgen(tm, ids, max_new_tokens=0), ids)
    np.testing.assert_array_equal(
        GenerationMixin.generate(tm, torch.from_numpy(ids),
                                 max_new_tokens=0).numpy(), ids)


def test_flash_prefill_against_the_jax_kernel_in_interpret_mode():
    """JAX with its flash kernel (Pallas, interpret mode) in the prefill
    against the port's flash path (its plain twin): the same tokens."""
    kw = dict(PREFILL, hidden_size=128, num_attention_heads=2,
              num_key_value_heads=1)
    os.environ["PT_FLASH_INTERPRET"] = "1"
    try:
        jm, tm = _llama(kw, seed=2, flash=True, jax_flash=True)
        ids = np.random.RandomState(6).randint(0, 96, (1, 16)).astype(
            np.int32)
        want = _jgen(jm, ids, max_new_tokens=4)
    finally:
        os.environ.pop("PT_FLASH_INTERPRET", None)
    np.testing.assert_array_equal(_tgen(tm, ids, max_new_tokens=4), want)


# --------------------------------------------------------- beam search
def _oracle(logp_of, prompt, T, K, V, eos=None):
    beams = [(list(prompt), 0.0, False)]
    for _ in range(T):
        cand = []
        for seq, sc, done in beams:
            if done:
                cand.append((seq + [eos], sc, True))
                continue
            lp = logp_of(seq)
            for v in range(V):
                cand.append((seq + [v], sc + lp[v],
                             eos is not None and v == eos))
        cand.sort(key=lambda x: -x[1])
        beams = cand[:K]
    return [int(x) for x in beams[0][0]]


def _logp_of(tm):
    def logp_of(seq):
        out = _tlogits(tm, [seq])[0, -1].astype(np.float64)
        return out - np.log(np.exp(out).sum())
    return logp_of


def test_beam_matches_exhaustive_beam_search(beam_models):
    jm, tm = beam_models
    prompt = np.random.RandomState(0).randint(1, 64, (2, 5)).astype(np.int32)
    out = _tgen(tm, prompt, max_new_tokens=4, num_beams=3)
    for b in range(2):
        assert out[b].tolist() == _oracle(_logp_of(tm), prompt[b], 4, 3,
                                          64), b
    np.testing.assert_array_equal(
        out, _jgen(jm, prompt, max_new_tokens=4, num_beams=3))


def test_beam_eos_freezes_finished_beams(beam_models):
    """The first step's argmax as eos: the top beam finishes at once and
    must stay frozen yet win; the frozen beams' equal scores keep JAX's
    order (ties to the lower index)."""
    jm, tm = beam_models
    prompt = np.random.RandomState(1).randint(1, 64, (1, 4)).astype(np.int32)
    eos = int(_tlogits(tm, prompt)[0, -1].argmax())
    out = _tgen(tm, prompt, max_new_tokens=5, num_beams=3, eos_token_id=eos)
    assert out[0].tolist() == _oracle(_logp_of(tm), prompt[0], 5, 3, 64,
                                      eos=eos)
    gen = out[0].tolist()[4:]
    assert gen[0] == eos and all(t == eos for t in gen)
    np.testing.assert_array_equal(
        out, _jgen(jm, prompt, max_new_tokens=5, num_beams=3,
                   eos_token_id=eos))


def test_beam_with_a_length_penalty_and_one_token_prompts(beam_models):
    """Length-normalised choice by full length, teacher-forced one-token
    prompts, an eos that some beams reach: JAX's tokens."""
    jm, tm = beam_models
    prompt = np.asarray([[5], [40]], np.int32)
    eos = int(_tlogits(tm, prompt[:1])[0, -1].argsort()[-2])
    kw = dict(max_new_tokens=6, num_beams=4, eos_token_id=eos,
              length_penalty=1.0)
    np.testing.assert_array_equal(_tgen(tm, prompt, **kw),
                                  _jgen(jm, prompt, **kw))


def test_beam_one_equals_greedy(beam_models):
    _, tm = beam_models
    prompt = np.random.RandomState(2).randint(1, 64, (2, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        _tgen(tm, prompt, max_new_tokens=5),
        _tgen(tm, prompt, max_new_tokens=5, num_beams=1))


def test_gpt_beam_search_matches_oracle(gpt_beam):
    jm, tm = gpt_beam
    prompt = np.random.RandomState(3).randint(1, 64, (1, 5)).astype(np.int32)
    out = _tgen(tm, prompt, max_new_tokens=3, num_beams=3)
    assert out[0].tolist() == _oracle(_logp_of(tm), prompt[0], 3, 3, 64)
    np.testing.assert_array_equal(
        out, _jgen(jm, prompt, max_new_tokens=3, num_beams=3))


def test_gather_tree_matches_jax():
    from paddle_tpu.framework.core import Tensor
    from paddle_tpu.nn.functional.extras import gather_tree as jgather

    rng = np.random.RandomState(7)
    ids = rng.randint(0, 50, (6, 3, 4)).astype(np.int32)
    parents = rng.randint(0, 4, (6, 3, 4)).astype(np.int32)
    got = gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    want = np.asarray(jgather(Tensor(ids), Tensor(parents)).value)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_advance_tokens_matches_jax():
    """Teacher forcing inside the prompt, the sampled token past it, eos
    latched: the buffer and the done flags JAX's, at host and device
    steps."""
    import jax.numpy as jnp

    from paddle_tpu.models.generation import advance_tokens as jadvance

    rng = np.random.RandomState(8)
    P, L = 4, 9
    toks = np.zeros((3, L), np.int32)
    toks[:, :P] = rng.randint(0, 20, (3, P))
    done = np.zeros(3, bool)
    jt, jd = jnp.asarray(toks), jnp.asarray(done)
    tt, td = torch.from_numpy(toks.copy()), torch.from_numpy(done.copy())
    for t in range(L - 1):
        nxt = rng.randint(0, 20, (3,)).astype(np.int32)
        nxt[t % 3] = 5
        jt, jd = jadvance(jt, jd, jnp.asarray(nxt), t, P, L, 5)
        step = t if t % 2 else torch.tensor([t])
        advance_tokens(tt, td, torch.from_numpy(nxt), step, P, L, 5)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# -------------------------------------------------------------- top-p
def test_top_p_support_restricted_to_nucleus():
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05],
                                     [0.97, 0.01, 0.01, 0.01]]))
    g = torch.Generator()
    g.manual_seed(0)
    seen = [set(), set()]
    for _ in range(200):
        tok = next_token(logits, g, temperature=1.0, top_k=0, top_p=0.7)
        for b in range(2):
            seen[b].add(int(tok[b]))
    assert seen[0] <= {0, 1} and len(seen[0]) == 2
    assert seen[1] == {0}


def test_generate_accepts_top_p():
    cfg = dict(vocab_size=1024, hidden_size=256, intermediate_size=704,
               num_hidden_layers=2, num_attention_heads=8,
               num_key_value_heads=4, max_position_embeddings=64,
               dtype="float32")
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    prompt = np.random.RandomState(0).randint(1, 1024, (1, 5)).astype(
        np.int32)
    out = _tgen(tm, prompt, max_new_tokens=6, temperature=1.0, top_p=0.9)
    assert out.shape == (1, 11)
    assert (out >= 0).all() and (out < 1024).all()


# ---------------------------------------------------------------- int8
def test_int8_generate_matches_jax():
    """Weight-only int8 (the JAX model's codes and scales loaded into the
    port's quantized model): greedy tokens JAX's, the prompt kept."""
    jm, tm = _llama(dict(INT8, tie_word_embeddings=False), seed=0)
    ids = np.array([[5, 7, 11]], dtype=np.int32)
    jm.quantize_int8()
    cfg = tm.cfg
    tm.quantize_int8()
    tm.load_state_dict(params_from_jax(_state(jm), cfg))
    out = _tgen(tm, ids, max_new_tokens=6)
    assert out.shape == (1, 9)
    np.testing.assert_array_equal(out, _jgen(jm, ids, max_new_tokens=6))


def test_int8_generate_matches_the_fused_qkv_jax_path(monkeypatch):
    """JAX's fused q/k/v int8 weight (``PT_W8_FUSED_QKV=1``, equal to the
    unfused path there) against the port's own quantize_int8 of the same
    fp weights: the same greedy tokens."""
    cfg_kw = dict(INT8, intermediate_size=128)
    jm, tm = _llama(cfg_kw, seed=5)
    monkeypatch.setenv("PT_W8_FUSED_QKV", "1")
    jm.quantize_int8()
    tm.quantize_int8()
    ids = np.random.RandomState(3).randint(1, 128, (2, 12)).astype(np.int32)
    np.testing.assert_array_equal(_tgen(tm, ids, max_new_tokens=8),
                                  _jgen(jm, ids, max_new_tokens=8))


# ------------------------------------------------------------ programs
class _CpuGraph:
    """Stands in for a captured graph: the capture ran nothing, each
    replay runs the recorded body (a real replay re-runs its kernels)."""

    def __init__(self, body, generators):
        self.body = body
        self.generators = tuple(generators)

    def replay(self):
        return self.body()


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The programs' graph calls on the CPU: a warm-up runs the body, a
    capture records it, and a program is graphed as on a card."""
    made = []

    def capture(body, generators=(), pool=None):
        made.append(_CpuGraph(body, generators))
        return made[-1]

    monkeypatch.setattr(graphs, "warm_up", lambda body, device: body())
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(generation.Program, "graphed", lambda self: True)
    return made


@pytest.mark.parametrize("kind", ["greedy", "sampled", "beam", "cacheless"])
def test_graphed_programs_give_the_eager_tokens(tiny, cpu_graphs, kind):
    """The first call of a key captures each body once (after a warm-up
    on the state the bodies before it leave), later calls only replay:
    one replay a step; tokens equal the eager run's, bit for bit, and a
    sampled key's graphs draw from its seeded generator."""
    _, tm = tiny[True]
    ids = np.random.RandomState(9).randint(0, 61, (2, 5)).astype(np.int32)
    kw = {"greedy": dict(max_new_tokens=6),
          "sampled": dict(max_new_tokens=6, temperature=0.8, top_k=9,
                          seed=4),
          "beam": dict(max_new_tokens=6, num_beams=3),
          "cacheless": dict(max_new_tokens=6)}[kind]

    def run():
        if kind == "cacheless":
            return GenerationMixin.generate(tm, torch.from_numpy(ids),
                                            **kw).numpy()
        return _tgen(tm, ids, **kw)

    tm.__dict__.pop("_gen_cache", None)
    first = run()
    bodies = 3 if kind == "beam" else 2
    assert len(cpu_graphs) == bodies
    (prog,) = tm._gen_cache.values()
    # the prologue, a replay a step (P + N - 1 - P cached, N cacheless,
    # N - 1 beam steps) and the beam's backtrace
    replays = {"beam": 7, "cacheless": 7}.get(kind, 6)
    assert prog.captures == bodies and prog.replays == replays
    again = run()
    assert len(cpu_graphs) == bodies and prog.replays == 2 * replays
    tm.gen_graphs = False
    try:
        eager = run()
    finally:
        del tm.gen_graphs
    np.testing.assert_array_equal(first, eager)
    np.testing.assert_array_equal(again, eager)
    assert all(g.generators == (prog.generator,) for g in cpu_graphs)


def test_program_is_rebuilt_when_the_weights_move(tiny):
    _, tm = tiny[True]
    ids = np.zeros((1, 3), np.int32)
    tm.__dict__.pop("_gen_cache", None)
    _tgen(tm, ids, max_new_tokens=2)
    (old,) = tm._gen_cache.values()
    _tgen(tm, ids, max_new_tokens=2)
    assert tm._gen_cache[next(iter(tm._gen_cache))] is old
    tm.lm_head.weight = torch.nn.Parameter(tm.lm_head.weight.detach().clone(),
                                           requires_grad=False)
    _tgen(tm, ids, max_new_tokens=2)
    assert next(iter(tm._gen_cache.values())) is not old


@pytest.mark.parametrize("kind", ["greedy", "sampled", "beam", "gpt",
                                  "cacheless"])
def test_generation_bodies_read_nothing_on_the_host(tiny, gpt_beam, kind):
    """Every body a program captures runs without a host read of a device
    value (a capture on the card refuses one)."""
    _, tm = tiny[True]
    ids = torch.from_numpy(
        np.random.RandomState(10).randint(0, 61, (2, 4)).astype(np.int32))
    with NoHostRead():
        if kind == "greedy":
            tm.generate(ids, max_new_tokens=4, eos_token_id=3)
        elif kind == "sampled":
            tm.generate(ids, max_new_tokens=4, temperature=0.7, top_k=5,
                        top_p=0.9)
        elif kind == "beam":
            tm.generate(ids, max_new_tokens=4, num_beams=3, eos_token_id=3)
        elif kind == "gpt":
            gpt_beam[1].generate(ids, max_new_tokens=4, num_beams=2)
            gpt_beam[1].generate(ids, max_new_tokens=4)
        else:
            GenerationMixin.generate(tm, ids, max_new_tokens=4)
