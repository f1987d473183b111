"""The port's ``GenerationServer`` and ``ParallelEngine`` take their
parameters in the JAX package's order: the same positional call into both
packages gives the same configuration, or a NotImplementedError in the port
where it reaches a parameter the port does not serve yet. The JAX keywords
the port does not take are accepted at their JAX defaults and raise
NotImplementedError at any other value (never TypeError)."""
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.inference.serving import GenerationServer as JServer
from paddle_tpu.inference.speculative import SpecConfig as JSpec
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.parallel import ParallelEngine as JEngine
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.inference.serving import GenerationServer
from paddle_tpu_torch.inference.speculative import SpecConfig
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ParallelEngine

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=1, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=160,
             dtype="float32")
BUCKETS = (32, 64, 128)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work on one intra-op thread: the plain twins'
    row-at-a-time products are too small to split over a thread team
    that the other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JModel(JConfig(**SMALL, use_flash_attention=False))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = LlamaConfig(**SMALL)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    return jm, tm


@pytest.fixture(autouse=True)
def _restore_mode():
    yield
    tops.set_kernel_mode("auto")
    from paddle_tpu import ops as jops
    jops.set_kernel_mode("auto")


def _server_config(srv):
    """What a positional call sets, read alike from both servers."""
    seed = (int(np.asarray(srv._base_key)[-1]) if hasattr(srv, "_base_key")
            else srv._gen.initial_seed())
    return dict(max_batch=srv.max_batch, max_len=srv.max_len, eos=srv.eos,
                seed=seed, block_size=srv.block_size,
                prefill_chunk=srv.prefill_chunk,
                num_blocks=srv.alloc.num_blocks, kv_quant=srv.kv_quant,
                kernels=srv.kernels, tick_window=srv.tick_window,
                spec=None if srv.spec is None else srv.spec.describe(),
                policy=srv._sched.policy,
                host_pool_bytes=srv._offload.host.capacity_bytes,
                fault_retries=srv.fault_retries)


# positional arguments after the model, in the JAX order (model, max_batch,
# max_len, prompt_buckets, eos_token_id, seed, tick_window, cache,
# block_size, num_blocks, prefill_chunk, spec, kv_quant, pool_bytes,
# policy, host_pool_bytes, warm_pool_bytes, tier_demote_low,
# tier_demote_high, lora, telemetry, faults, fault_retries, kernels)
PAGED = (BUCKETS, 7, 3, 1, "paged", 4, 40, 8)
# stands for each package's own SpecConfig(k=3) in a call
SPEC = "spec"
SERVER_CALLS = {
    "batch_len": ((2, 64), None),
    "eos_seed": ((2, 64, BUCKETS, 7, 3), None),
    "dense": ((2, 64, BUCKETS, None, 0, 1, "dense"), "cache"),
    "paged_blocks_chunk": ((2, 64) + PAGED, None),
    "kv_quant": ((2, 64) + PAGED + (None, "int8"), None),
    "pool_bytes_policy": ((2, 64) + PAGED + (None, "none", None, "fifo"),
                          None),
    "kernels": ((2, 64) + PAGED + (None, "none", None, None, None, None,
                                   None, None, None, None, None, 3,
                                   "reference"), None),
    # the JAX paged server ignores prompt_buckets; the port takes only the
    # default
    "prompt_buckets": ((2, 64, (16, 32)), "prompt_buckets"),
    "tick_window": ((2, 64, BUCKETS, None, 0, 2, "paged"), None),
    "spec": ((2, 64) + PAGED + (SPEC, "int8"), None),
    "host_pool_bytes": ((2, 64) + PAGED + (None, "none", None, "wfq", 0),
                        None),
    "fault_retries": ((2, 64) + PAGED + (None, "none", None, None, None,
                                         None, None, None, None, None,
                                         None, 5), None),
}


@pytest.mark.parametrize("name", sorted(SERVER_CALLS))
def test_server_positional_calls_mean_the_same(models, name):
    jm, tm = models
    args, unported = SERVER_CALLS[name]
    # the JAX server's default cache is "dense", the port's "paged" (the
    # one it has): a call that leaves cache out names it for both
    kw = {} if len(args) >= 7 else dict(cache="paged")

    def call(spec):
        return tuple(spec(k=3) if a is SPEC else a for a in args)

    js = JServer(jm, *call(JSpec), **kw)
    if unported is not None:
        with pytest.raises(NotImplementedError, match=unported):
            GenerationServer(tm, *call(SpecConfig), device="cpu", **kw)
        return
    ts = GenerationServer(tm, *call(SpecConfig), device="cpu", **kw)
    assert _server_config(ts) == _server_config(js)
    if SPEC in args:
        # the scratch slack of a trip's windows and a gated trip's ticks
        assert ts._table_width == js._table_width
        assert ts.spec_k == js.spec_k == 3


def test_submit_keeps_the_jax_parameters():
    import inspect

    assert list(inspect.signature(GenerationServer.submit).parameters) == \
        list(inspect.signature(JServer.submit).parameters)


def test_server_device_comes_after_the_jax_parameters():
    import inspect

    jnames = list(inspect.signature(JServer.__init__).parameters)
    tnames = list(inspect.signature(GenerationServer.__init__).parameters)
    assert tnames == jnames + ["device"]


def _engine_config(eng):
    return dict(remat=bool(eng.remat), remat_policy=eng.remat_policy,
                grad_accum=eng.grad_accum)


# positional arguments after (model, optimizer), in the JAX order (loss_fn,
# mesh, fsdp, remat, remat_policy, batch_spec, donate, abstract,
# offload_opt_state, alias_model_params, grad_accum)
DEFAULTS = (None, None, False, False, "dots", P("data"), True, False, False,
            False)
ENGINE_CALLS = {
    "remat_policy": ((None, None, False, True, "nothing"), None),
    "grad_accum": (DEFAULTS + (2,), None),
    "remat_accum": ((None, None, False, True, "save_attn", P("data"), True,
                     False, False, False, 2), None),
    "fsdp": ((None, None, True), "fsdp"),
    "donate": ((None, None, False, False, "dots", P("data"), False),
               "donate"),
    "alias_model_params": ((None, None, False, False, "dots", P("data"),
                            True, False, False, True), "alias_model_params"),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CALLS))
def test_engine_positional_calls_mean_the_same(models, name):
    jm, tm = models
    args, unported = ENGINE_CALLS[name]
    je = JEngine(jm, JAdamW(learning_rate=1e-3, parameters=jm.parameters()),
                 *args)
    opt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters())
    if unported is not None:
        with pytest.raises(NotImplementedError, match=unported):
            ParallelEngine(tm, opt, *args)
        return
    te = ParallelEngine(tm, opt, *args)
    assert _engine_config(te) == _engine_config(je)


def test_engine_takes_the_jax_keywords_at_their_defaults(models):
    """``batch_spec``, ``donate``, ``abstract`` and ``alias_model_params``
    at the JAX defaults build an engine (they raised TypeError before);
    ``abstract=True`` raises NotImplementedError."""
    _, tm = models
    opt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters())
    eng = ParallelEngine(tm, optimizer=opt, batch_spec=P("data"),
                         donate=True, abstract=False,
                         alias_model_params=False)
    assert eng.grad_accum == 1 and not eng.remat
    with pytest.raises(NotImplementedError, match="abstract"):
        ParallelEngine(tm, optimizer=opt, abstract=True)
    with pytest.raises(NotImplementedError, match="batch_spec"):
        ParallelEngine(tm, optimizer=opt, batch_spec=P(None, "data"))


def test_engine_parameter_names_follow_the_jax_order():
    import inspect

    jnames = list(inspect.signature(JEngine.__init__).parameters)
    tnames = list(inspect.signature(ParallelEngine.__init__).parameters)
    assert tnames == jnames
