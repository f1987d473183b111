"""The whole-tick decode megakernel's int8-KV variant and LoRA streams
(``paddle_tpu_torch/ops/decode_megakernel.py``) against the JAX package, on
the CPU in fp32: the plain twin of the CUDA kernel against the JAX
``decode_tick`` (Pallas in interpret mode) and against the JAX per-layer
loop (``LlamaDecoderLayer.paged_verify``), activations and written pools
(codes and scales); the null adapter page against the fp tick; greedy
``GenerationServer(kernels="megakernel")`` tokens with ``kv_quant="int8"``
and with ``lora=`` against the JAX server's and the port's per-layer
server's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as jops
from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference import AdapterRegistry as JRegistry
from paddle_tpu.inference import LoRAConfig as JLoRAConfig
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.ops import decode_megakernel as jmk
from paddle_tpu_torch import ops
from paddle_tpu_torch.inference.lora import (LORA_TARGETS, AdapterPool,
                                             AdapterRegistry, LoRAConfig,
                                             target_dims)
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import decode_megakernel as mk
from paddle_tpu_torch.ops.paged_attention import quantize_block_kv

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=160, dtype="float32")
BS = 8
# the JAX test's tolerances for its own kernel (tests/test_megakernel.py):
# fp32 products summed in other orders; int8 codes compared as numbers
ACT = dict(rtol=2e-5, atol=2e-5)
POOL = dict(rtol=1e-5, atol=1e-5)
# rows: mid-block, a block boundary, early; adapters (rank, alpha) in a
# pool of max_rank 4, and the row on the null page
POS = [10, 16, 5]
ADAPTERS = (("a1", 4, 8.0), ("a2", 2, 4.0))


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


_MODELS = {}


def _models(layers):
    """(JAX model, port model carrying its weights, port config)."""
    if layers not in _MODELS:
        paddle.seed(7)
        jm = JModel(JConfig(**SMALL, num_hidden_layers=layers,
                            use_flash_attention=False))
        state = {k: np.asarray(v) for k, v in state_values(jm).items()}
        cfg = LlamaConfig(**SMALL, num_hidden_layers=layers)
        tm = LlamaForCausalLM(cfg, device="cpu")
        tm.load_state_dict(params_from_jax(state, cfg))
        _MODELS[layers] = (jm, tm, cfg)
    return _MODELS[layers]


def _adapter_weights(cfg, rank, seed):
    rng = np.random.RandomState(seed)
    return {(layer, t): (rng.normal(0, 0.02, (fi, rank)).astype(np.float32),
                         rng.normal(0, 0.05, (rank, fo)).astype(np.float32))
            for layer in range(cfg.num_hidden_layers)
            for t, (fi, fo) in target_dims(cfg).items()}


def _registries(cfg):
    """The same two adapters in a JAX and in a port registry."""
    jr, tr = JRegistry(), AdapterRegistry()
    for i, (name, rank, alpha) in enumerate(ADAPTERS):
        w = _adapter_weights(cfg, rank, 3 + i)
        jr.register(name, w, rank=rank, alpha=alpha)
        tr.register(name, w, rank=rank, alpha=alpha)
    return jr, tr


def _tick_case(cfg, W, quant, lora, B=3, seed=0):
    """Flat pools (fp: K, V a layer; int8: codes and scales of K, then V),
    tables with blocks in a scrambled order and scratch block 0 zeroed,
    positions, tokens, and with ``lora`` the adapter pool with rows on a1,
    the null page and a2 (aidx)."""
    rng = np.random.RandomState(seed)
    L, KV = cfg.num_hidden_layers, cfg.num_key_value_heads
    D = cfg.hidden_size // cfg.num_attention_heads
    pos = np.array(POS[:B], np.int32)
    M = int(max(pos) + W - 1) // BS + 2
    N = B * M + 2
    tables = np.zeros((B, M), np.int32)
    free = rng.permutation(np.arange(1, N))
    took = 0
    for b in range(B):
        nblk = (pos[b] + W - 1) // BS + 1
        tables[b, :nblk] = free[took:took + nblk]
        took += nblk
    flat = []
    for _ in range(2 * L):
        p = rng.randn(N, BS, KV, D).astype(np.float32) * 0.5
        p[0] = 0.0
        if quant:
            codes, scales = quantize_block_kv(torch.from_numpy(p))
            flat += [codes.numpy(), scales.numpy()]
        else:
            flat.append(p)
    tokens = rng.randint(1, cfg.vocab_size, (B, W)).astype(np.int32)
    pool = aidx = None
    if lora:
        _, reg = _registries(cfg)
        pool = AdapterPool(cfg, LoRAConfig(reg, max_live_adapters=2,
                                           max_rank=4), device="cpu")
        pages = [pool.acquire(name) for name, _, _ in ADAPTERS]
        aidx = torch.tensor([pages[0], 0, pages[1]][:B], dtype=torch.int32)
    return tokens, flat, tables, pos, pool, aidx


def _rows(tm, tokens, pos, W):
    m = tm.model
    with torch.no_grad():
        x = m.embed_tokens(torch.from_numpy(tokens).long())
    cosr, sinr = mk.gather_rope_rows(m._cos, m._sin, torch.from_numpy(pos), W)
    return x, cosr, sinr


def _twin(tm, tokens, flat, tables, pos, pool, aidx, W, dequant="scores"):
    """The port's tick (plain twin on the CPU): (activations, pools)."""
    x, cosr, sinr = _rows(tm, tokens, pos, W)
    pools = [torch.from_numpy(p.copy()) for p in flat]
    lora = None if pool is None else mk.lora_tables(pool, aidx)
    with torch.no_grad():
        xo, pools = mk.decode_tick(
            x, pools, torch.from_numpy(tables), torch.from_numpy(pos),
            mk.stack_layer_weights(tm), cosr, sinr, block_size=BS,
            geometry=mk.MegakernelGeometry(dequant=dequant),
            eps=tm.cfg.rms_norm_eps, lora=lora)
    return xo.numpy(), [p.numpy() for p in pools]


def _jax_lora(pool, aidx):
    """JAX per-layer {target: (A, B, s)} gathered at the rows' pages."""
    if pool is None:
        return None
    return [{t: tuple(jnp.asarray(v.numpy()) for v in f)
             for t, f in layer.items()} for layer in pool.gather_rows(aidx)]


def _check(tx, tflat, jx, jflat):
    np.testing.assert_allclose(tx, np.asarray(jx), **ACT)
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(a.astype(np.float32),
                                   np.asarray(b, np.float32), **POOL)


@pytest.mark.parametrize("variant", ["int8", "lora"])
def test_twin_matches_jax_decode_tick_interpret(variant):
    """One layer, W = 1: the twin against the JAX Pallas kernel run in
    interpret mode (int8 pools; fp pools with LoRA on every target),
    activations and written pools."""
    jm, tm, cfg = _models(1)
    quant, lora = variant == "int8", variant == "lora"
    tokens, flat, tables, pos, pool, aidx = _tick_case(cfg, 1, quant, lora)
    tx, tflat = _twin(tm, tokens, flat, tables, pos, pool, aidx, 1)
    m = jm.model
    x = np.array(m.embed_tokens(Tensor(jnp.asarray(tokens))).value)
    cosr, sinr = jmk.gather_rope_rows(m._cos, m._sin, jnp.asarray(pos), 1)
    jops.set_kernel_mode("megakernel")
    jx, jflat = jmk.decode_tick(
        jnp.asarray(x), [jnp.asarray(p) for p in flat], jnp.asarray(tables),
        jnp.asarray(pos), jmk.stack_layer_weights(jm), cosr, sinr,
        block_size=BS, eps=cfg.rms_norm_eps,
        lora=jmk.stack_lora(_jax_lora(pool, aidx)))
    jops.set_kernel_mode("auto")
    _check(tx, tflat, jx, jflat)
    # the window's tokens landed in the live blocks, nowhere else
    for a, p in zip(tflat, flat):
        if a.ndim == 4:
            changed = np.nonzero((a != p).any(axis=(1, 2, 3)))[0]
            assert set(changed) <= set(tables[tables > 0].tolist())


@pytest.mark.parametrize("variant", ["int8", "int8_tile", "lora", "int8_lora"])
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("layers", [2, 4])
def test_twin_matches_jax_layer_loop(layers, W, variant):
    """The twin against the JAX per-layer loop (``paged_verify`` with int8
    pools and the gathered LoRA factors), activations and written pools.
    ``dequant="tile"`` rounds a dequantized tile to the activations' dtype,
    which in fp32 is the reference's arithmetic."""
    jm, tm, cfg = _models(layers)
    quant, lora = variant.startswith("int8"), variant.endswith("lora")
    tokens, flat, tables, pos, pool, aidx = _tick_case(cfg, W, quant, lora)
    tx, tflat = _twin(tm, tokens, flat, tables, pos, pool, aidx, W,
                      dequant="tile" if variant == "int8_tile" else "scores")
    m = jm.model
    jl = _jax_lora(pool, aidx)
    st = 4 if quant else 2
    h = m.embed_tokens(Tensor(jnp.asarray(tokens)))
    jflat = []
    for i, layer in enumerate(m.layers):
        lp = tuple(Tensor(jnp.asarray(flat[st * i + j])) for j in range(st))
        h, lp = layer.paged_verify(h, m._cos, m._sin, lp, jnp.asarray(tables),
                                   jnp.asarray(pos),
                                   lora=None if jl is None else jl[i])
        jflat += [t.value for t in lp]
    _check(tx, tflat, h.value, jflat)
    if lora:
        # the deltas move the rows on an adapter page, not the null row
        fx, _ = _twin(tm, tokens, flat, tables, pos, None, None, W)
        moved = np.abs(tx - fx).max(axis=(1, 2))
        assert moved[1] == 0.0 and (moved[[0, 2]] > 1e-3).all()


@pytest.mark.parametrize("quant", [False, True])
def test_null_page_twin_equals_the_fp_twin(quant):
    """Every row on page 0 (zero factors, scale 0): the LoRA twin's tick is
    the tick without LoRA, exactly, activations and pools."""
    _, tm, cfg = _models(2)
    tokens, flat, tables, pos, pool, _ = _tick_case(cfg, 4, quant, True)
    zero = torch.zeros(len(POS), dtype=torch.int32)
    lx, lflat = _twin(tm, tokens, flat, tables, pos, pool, zero, 4)
    fx, fflat = _twin(tm, tokens, flat, tables, pos, None, None, 4)
    assert np.array_equal(lx, fx)
    for a, b in zip(lflat, fflat):
        assert np.array_equal(a, b)


def test_lora_tables_read_the_pool_in_place():
    """lora_tables copies nothing: the twin's per-layer factors are views of
    the adapter pool's pages, as the kernel reads them."""
    _, _, cfg = _models(2)
    _, _, _, _, pool, aidx = _tick_case(cfg, 1, False, True)
    lt = mk.lora_tables(pool, aidx)
    assert lt.max_rank == 4 and set(lt.factors) == set(LORA_TARGETS)
    for t, (A, B) in pool._tensors.items():
        assert lt.factors[t][0] is A and lt.factors[t][1] is B
    f = lt.pooled(1, "down")
    assert f.a is pool._tensors["down"][0] and f.layer == 1 and f.aidx is aidx
    assert mk.LoraTables({}, lt.scale, aidx, 4).pooled(0, "q") is None


def _serve(server_cls, model, prompts, adapters, **kw):
    srv = server_cls(model, cache="paged", max_batch=2, max_len=64,
                     block_size=4, prefill_chunk=8, **kw)
    rids = [srv.submit(p, max_new_tokens=8, adapter=a)
            for p, a in zip(prompts, adapters)]
    out = srv.run()
    return [out[r] for r in rids], srv


@pytest.mark.parametrize("variant", ["int8", "lora"])
def test_greedy_tokens_match_jax_server_and_per_layer_path(variant):
    """Greedy tokens of ``kernels="megakernel"`` (the twin on the CPU) with
    ``kv_quant="int8"``, and with ``lora=`` (adapters on alternate
    requests), equal the JAX server's under ``kernels="reference"`` and the
    port's per-layer server's, with multi-chunk prefill and partial
    blocks."""
    jm, tm, cfg = _models(2)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).tolist()
               for n in (5, 12, 7, 3)]
    adapters = [None] * len(prompts)
    jkw, tkw = {}, {}
    if variant == "int8":
        jkw = tkw = dict(kv_quant="int8")
    else:
        adapters = ["a1" if i % 2 == 0 else None for i in range(len(prompts))]
        jr, tr = _registries(cfg)
        jkw = dict(lora=JLoRAConfig(jr, max_live_adapters=2, max_rank=4))
        tkw = dict(lora=LoRAConfig(tr, max_live_adapters=2, max_rank=4))
    ref, _ = _serve(JServer, jm, prompts, adapters, kernels="reference",
                    **jkw)
    jops.set_kernel_mode("auto")
    mega, srv = _serve(GenerationServer, tm, prompts, adapters,
                       device="cpu", kernels="megakernel", **tkw)
    assert srv._exec.megakernel and srv._exec.megakernel_reason is None
    ops.set_kernel_mode("auto")
    auto, srv_auto = _serve(GenerationServer, tm, prompts, adapters,
                            device="cpu", **tkw)
    assert not srv_auto._exec.megakernel
    assert mega == ref
    assert auto == ref
    for toks, p in zip(mega, prompts):
        assert len(toks) == len(p) + 8
