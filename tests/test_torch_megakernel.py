"""The port's whole-tick decode megakernel (``paddle_tpu_torch/ops/
decode_megakernel.py``) against the JAX package, on the CPU in fp32: the
plain twin of the CUDA kernel against the JAX ``decode_tick`` (Pallas in
interpret mode) and against the JAX per-layer loop
(``LlamaDecoderLayer.paged_verify``), activations and written pools; greedy
``GenerationServer(kernels="megakernel")`` tokens against the JAX server's
and the port's per-layer server; the guard's reasons against the JAX
guard's; and the constructor's rules (no fallback)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as jops
from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.ops import decode_megakernel as jmk
from paddle_tpu_torch import ops
from paddle_tpu_torch.inference.lora import AdapterRegistry, LoRAConfig
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import decode_megakernel as mk

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=160, dtype="float32")
BS = 8
# the JAX test's tolerances for its own kernel (tests/test_megakernel.py)
ACT = dict(rtol=2e-5, atol=2e-5)
POOL = dict(rtol=1e-5, atol=1e-5)


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


def _jcfg(layers):
    return JConfig(**SMALL, num_hidden_layers=layers,
                   use_flash_attention=False)


def _models(layers):
    """(JAX model, port model carrying its weights, port config)."""
    if layers not in _MODELS:
        paddle.seed(7)
        jm = JModel(_jcfg(layers))
        state = {k: np.asarray(v) for k, v in state_values(jm).items()}
        cfg = LlamaConfig(**SMALL, num_hidden_layers=layers)
        tm = LlamaForCausalLM(cfg, device="cpu")
        tm.load_state_dict(params_from_jax(state, cfg))
        _MODELS[layers] = (jm, tm, cfg)
    return _MODELS[layers]


def _tick_case(cfg, W, seed=0, B=2):
    """Pools, tables, positions and tokens with the JAX test's edges:
    scratch block 0 zeroed, positions mid-block (10) and at a block
    boundary (16), blocks handed out in a scrambled order."""
    rng = np.random.RandomState(seed)
    L = cfg.num_hidden_layers
    KV = cfg.num_key_value_heads
    D = cfg.hidden_size // cfg.num_attention_heads
    pos = np.array([10, 16], np.int32)[:B]
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
        flat.append(p)
    tokens = rng.randint(1, cfg.vocab_size, (B, W)).astype(np.int32)
    return tokens, flat, tables, pos


def _twin(tm, x, flat, tables, pos, cosr, sinr):
    """The port's tick (plain twin on the CPU): (activations, pools)."""
    pools = [torch.from_numpy(p.copy()) for p in flat]
    xo, pools = mk.decode_tick(
        torch.from_numpy(x), pools, torch.from_numpy(tables),
        torch.from_numpy(pos), mk.stack_layer_weights(tm),
        torch.from_numpy(cosr), torch.from_numpy(sinr), block_size=BS,
        eps=tm.cfg.rms_norm_eps)
    return xo.numpy(), [p.numpy() for p in pools]


def _jax_rows(jm, tokens, pos, W):
    m = jm.model
    x = np.array(m.embed_tokens(Tensor(jnp.asarray(tokens))).value,
                 np.float32)
    cosr, sinr = jmk.gather_rope_rows(m._cos, m._sin, jnp.asarray(pos), W)
    return x, np.array(cosr, np.float32), np.array(sinr, np.float32)


def test_twin_matches_jax_decode_tick_interpret():
    """(a) One layer, W = 1: the twin against the JAX Pallas kernel run in
    interpret mode, activations and written pools."""
    jm, tm, cfg = _models(1)
    W = 1
    tokens, flat, tables, pos = _tick_case(cfg, W)
    x, cosr, sinr = _jax_rows(jm, tokens, pos, W)
    jops.set_kernel_mode("megakernel")
    jx, jflat = jmk.decode_tick(
        jnp.asarray(x), [jnp.asarray(p) for p in flat], jnp.asarray(tables),
        jnp.asarray(pos), jmk.stack_layer_weights(jm), jnp.asarray(cosr),
        jnp.asarray(sinr), block_size=BS, eps=cfg.rms_norm_eps)
    jops.set_kernel_mode("auto")
    tx, tflat = _twin(tm, x, flat, tables, pos, cosr, sinr)
    np.testing.assert_allclose(tx, np.asarray(jx), **ACT)
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **POOL)
    # the window's K/V landed in the live blocks, nowhere else
    for a, p in zip(tflat, flat):
        changed = np.nonzero((a != p).any(axis=(1, 2, 3)))[0]
        assert set(changed) <= set(tables[tables > 0].tolist())


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("layers", [2, 4])
def test_twin_matches_jax_layer_loop(layers, W):
    """(b) The twin against the JAX per-layer loop (``paged_verify``, the
    JAX megakernel's own reference), activations and written pools."""
    jm, tm, cfg = _models(layers)
    tokens, flat, tables, pos = _tick_case(cfg, W)
    x, cosr, sinr = _jax_rows(jm, tokens, pos, W)
    m = jm.model
    h = Tensor(jnp.asarray(x))
    jflat = []
    for i, layer in enumerate(m.layers):
        pool = (Tensor(jnp.asarray(flat[2 * i])),
                Tensor(jnp.asarray(flat[2 * i + 1])))
        h, pool = layer.paged_verify(h, m._cos, m._sin, pool,
                                     jnp.asarray(tables), jnp.asarray(pos))
        jflat += [np.asarray(t.value, np.float32) for t in pool]
    tx, tflat = _twin(tm, x, flat, tables, pos, cosr, sinr)
    np.testing.assert_allclose(tx, np.asarray(h.value), **ACT)
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(a, b, **POOL)


def test_gather_rope_rows_matches_jax():
    jm, tm, _ = _models(1)
    pos = np.array([0, 10, 158], np.int32)
    jc, js = jmk.gather_rope_rows(jm.model._cos, jm.model._sin,
                                  jnp.asarray(pos), 4)
    tc, ts = mk.gather_rope_rows(tm.model._cos, tm.model._sin,
                                 torch.from_numpy(pos), 4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_hbm_bytes_per_trip_matches_jax():
    _, _, cfg = _models(2)
    jcfg = JConfig(**SMALL, num_hidden_layers=2)
    for kw in (dict(batch=8, window=1, block_size=16, avg_ctx_blocks=32),
               dict(batch=2, window=4, block_size=8, avg_ctx_blocks=3,
                    kv_quant="int8", megakernel=False, dtype_bytes=2)):
        assert mk.hbm_bytes_per_trip(cfg, **kw) == \
            jmk.hbm_bytes_per_trip(jcfg, **kw)


def _serve(server_cls, model, prompts, **kw):
    srv = server_cls(model, cache="paged", max_batch=2, max_len=64,
                     block_size=4, prefill_chunk=8, **kw)
    rids = [srv.submit(p, max_new_tokens=8) for p in prompts]
    out = srv.run()
    return [out[r] for r in rids], srv


def test_greedy_tokens_match_jax_server_and_per_layer_path():
    """(c) Greedy tokens of ``kernels="megakernel"`` (the twin on the CPU)
    equal the JAX server's under ``kernels="reference"`` and the port's
    per-layer server's, with multi-chunk prefill and partial blocks."""
    jm, tm, cfg = _models(2)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).tolist()
               for n in (5, 12, 7, 3)]
    ref, _ = _serve(JServer, jm, prompts, kernels="reference")
    jops.set_kernel_mode("auto")
    mega, srv = _serve(GenerationServer, tm, prompts, device="cpu",
                       kernels="megakernel")
    assert srv._exec.megakernel and srv._exec.megakernel_reason is None
    ops.set_kernel_mode("auto")
    auto, srv_auto = _serve(GenerationServer, tm, prompts, device="cpu")
    assert not srv_auto._exec.megakernel
    assert mega == ref
    assert auto == ref
    for toks, p in zip(mega, prompts):
        assert len(toks) == len(p) + 8


def _reason_case(name, jm, tm, cfg):
    """(port args, JAX args) of megakernel_supported for one reason."""
    jcfg = _jcfg(cfg.num_hidden_layers)
    G, JG = mk.MegakernelGeometry, jmk.MegakernelGeometry
    if name == "tp":
        return (tm, cfg, dict(tp=2)), (jm, jcfg, dict(tp=2))
    if name == "cp":
        return (tm, cfg, dict(cp=4)), (jm, jcfg, dict(cp=4))
    if name == "moe":
        return ((tm, dataclasses.replace(cfg, moe_num_experts=4), {}),
                (jm, dataclasses.replace(jcfg, moe_num_experts=4), {}))
    if name == "not_llama":
        return (object(), cfg, {}), (object(), jcfg, {})
    if name == "ffn_tile":
        return ((tm, cfg, dict(geometry=G(ffn_tile=48))),
                (jm, jcfg, dict(geometry=JG(ffn_tile=48))))
    if name == "ffn_tile_lora":
        return ((tm, cfg, dict(geometry=G(ffn_tile=64), lora=True)),
                (jm, jcfg, dict(geometry=JG(ffn_tile=64), lora=True)))
    if name == "hidden":
        return ((tm, dataclasses.replace(cfg, hidden_size=66), {}),
                (jm, dataclasses.replace(jcfg, hidden_size=66), {}))
    if name == "odd_head_dim":
        kw = dict(hidden_size=60, num_attention_heads=4)
        return ((tm, dataclasses.replace(cfg, **kw), {}),
                (jm, dataclasses.replace(jcfg, **kw), {}))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["tp", "cp", "moe", "not_llama", "ffn_tile",
                                  "ffn_tile_lora", "hidden", "odd_head_dim"])
def test_megakernel_supported_gives_the_jax_reasons(name):
    """(d) One case per reason of the JAX guard: the same words."""
    jm, tm, cfg = _models(1)
    (pm, pc, pk), (jmod, jc, jk) = _reason_case(name, jm, tm, cfg)
    want = jmk.megakernel_supported(jmod, jc, **jk)
    assert want is not None
    assert mk.megakernel_supported(pm, pc, **pk) == want


def test_megakernel_supported_int8_model_and_cuda_rules():
    """An int8 model gives the JAX reason for its MLP; a plain fp model
    passes on the CPU; the CUDA kernel's own rules name the shape."""
    jm, tm, cfg = _models(1)
    assert mk.megakernel_supported(tm, cfg) is None
    q = LlamaForCausalLM(cfg, device="cpu").quantize_int8()
    assert mk.megakernel_supported(q, cfg) == \
        "layer 0: gate_proj is not a plain Linear (weight-only int8 or " \
        "LoRA-wrapped MLP)"
    assert "head_dim 16" in mk.cuda_shape_reason(cfg, 16)
    bf = dataclasses.replace(cfg, hidden_size=4096, num_attention_heads=32,
                             intermediate_size=14336)
    assert "dtype" in mk.cuda_shape_reason(bf, 16)
    bf = dataclasses.replace(bf, dtype="bfloat16")
    assert mk.cuda_shape_reason(bf, 16) is None
    assert "block_size 12" in mk.cuda_shape_reason(bf, 12)
    assert "intermediate dim 14000" in mk.cuda_shape_reason(
        dataclasses.replace(bf, intermediate_size=14000), 16)
    # the int8 variant's block-head and the LoRA streams' rank
    assert mk.cuda_shape_reason(bf, 128, kv_quant="int8") is None
    assert "block_size 256" in mk.cuda_shape_reason(bf, 256, kv_quant="int8")
    assert mk.cuda_shape_reason(bf, 16, lora_rank=16) is None
    assert "max_rank 32" in mk.cuda_shape_reason(bf, 16, lora_rank=32)


def test_cuda_shape_reason_takes_64_column_tiles():
    """The kernel streams 64-column weight tiles: hidden and intermediate
    sizes that are multiples of 64 are taken (14272 was refused while the
    rule asked for multiples of 256), others are refused by name."""
    jm, tm, cfg = _models(1)
    bf = dataclasses.replace(cfg, hidden_size=4096, num_attention_heads=32,
                             intermediate_size=14336, dtype="bfloat16")
    assert mk.K_STEP == 64
    assert mk.cuda_shape_reason(
        dataclasses.replace(bf, intermediate_size=14272), 16) is None
    assert "intermediate dim 14304" in mk.cuda_shape_reason(
        dataclasses.replace(bf, intermediate_size=14304), 16)


def _lora_config(cfg):
    from paddle_tpu_torch.inference.lora import LORA_TARGETS, target_dims

    rng = np.random.RandomState(3)
    reg = AdapterRegistry()
    w = {(layer, t): (rng.normal(0, 0.02, (fi, 4)).astype(np.float32),
                      rng.normal(0, 0.05, (4, fo)).astype(np.float32))
         for layer in range(cfg.num_hidden_layers)
         for t, (fi, fo) in target_dims(cfg).items() if t in LORA_TARGETS}
    reg.register("a1", w, rank=4, alpha=8.0)
    return LoRAConfig(reg, max_live_adapters=2, max_rank=4)


@pytest.mark.parametrize("case", ["int8_kv", "lora", "int8_model",
                                  "geometry_not_ported", "dense_cache",
                                  "geometry_without_megakernel", "pallas"])
def test_constructor_rules(case):
    """(e) Unsupported megakernel configurations raise at construction,
    naming the reason, and leave the kernel mode as they found it; int8 KV
    pools and LoRA build on the megakernel."""
    _, tm, cfg = _models(1)
    kw = dict(device="cpu", cache="paged", max_len=64, block_size=4,
              kernels="megakernel")
    model = tm
    want = {"int8_kv": None, "lora": None,
            "int8_model": (ValueError, "gate_proj is not a plain Linear"),
            # every geometry is served now: what still raises is one
            # the kernel cannot take (an ffn_tile that does not divide
            # the intermediate size)
            "geometry_not_ported": (ValueError, "ffn_tile .* does not "
                                                "divide"),
            "dense_cache": (ValueError, "paged"),
            "geometry_without_megakernel": (ValueError, "mk_geometry"),
            "pallas": (NotImplementedError, "interpret")}[case]
    if case == "int8_kv":
        kw["kv_quant"] = "int8"
    elif case == "lora":
        kw["lora"] = _lora_config(cfg)
    elif case == "int8_model":
        model = LlamaForCausalLM(cfg, device="cpu").quantize_int8()
    elif case == "geometry_not_ported":
        kw["mk_geometry"] = mk.MegakernelGeometry(
            ffn_tile=cfg.intermediate_size + 1)
    elif case == "dense_cache":
        kw["cache"] = "dense"
    elif case == "geometry_without_megakernel":
        kw.update(kernels="auto", mk_geometry=mk.MegakernelGeometry())
    elif case == "pallas":
        kw["kernels"] = "pallas"
    if want is None:
        srv = GenerationServer(model, **kw)
        assert srv._exec.megakernel is True
        assert srv._exec.megakernel_reason is None
        return
    with pytest.raises(want[0], match=want[1]):
        GenerationServer(model, **kw)
    assert ops.kernel_mode() == "auto"


def test_auto_never_selects_the_megakernel():
    ops.set_kernel_mode("auto")
    assert not ops.use_megakernel()
    ops.set_kernel_mode("reference")
    assert not ops.use_megakernel()
    ops.set_kernel_mode("megakernel")
    assert ops.use_megakernel()
    _, tm, _ = _models(1)
    ops.set_kernel_mode("auto")
    srv = GenerationServer(tm, cache="paged", device="cpu", max_len=64,
                           block_size=4)
    assert not srv._exec.megakernel and srv._exec._mk_weights is None


def test_replaced_weights_are_refused():
    """The weight table points at the model's own tensors: a weight
    replaced after construction raises instead of reading stale memory."""
    _, tm, cfg = _models(1)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(tm.state_dict())
    srv = GenerationServer(model, cache="paged", device="cpu", max_len=64,
                           block_size=4,
                           prefill_chunk=8, kernels="megakernel")
    srv.submit([1, 2, 3], max_new_tokens=2)
    srv.run()
    att = model.model.layers[0].self_attn
    att.o_proj.weight = torch.nn.Parameter(att.o_proj.weight.clone(),
                                           requires_grad=False)
    srv.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="wo weights were replaced"):
        srv.run()


def test_geometry_validation():
    with pytest.raises(ValueError, match="prefetch_depth"):
        mk.MegakernelGeometry(prefetch_depth=0).validate()
    with pytest.raises(ValueError, match="dequant"):
        mk.MegakernelGeometry(dequant="magic").validate()
    assert mk.MegakernelGeometry().asdict() == \
        jmk.MegakernelGeometry().asdict()
    # the CUDA kernel's rules (check_geometry, at resolution): a ring past
    # a block's shared memory, a down slice past the x slab at the rows
    with pytest.raises(ValueError, match="prefetch_depth=4"):
        mk.check_geometry(mk.MegakernelGeometry(prefetch_depth=4),
                          intermediate=14336, rows=8)
    with pytest.raises(ValueError, match="ffn_tile=2048 .* x slab"):
        mk.check_geometry(mk.MegakernelGeometry(ffn_tile=2048),
                          intermediate=14336, rows=64)
    for geom in (mk.MegakernelGeometry(dequant="tile"),
                 mk.MegakernelGeometry(prefetch_depth=1),
                 mk.MegakernelGeometry(ffn_tile=2048),
                 mk.MegakernelGeometry(ffn_tile=1024)):
        mk.check_geometry(geom, intermediate=14336, rows=8)
