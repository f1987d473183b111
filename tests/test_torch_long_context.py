"""Long-context training in the PyTorch port on the CPU, fp32: a training
step at S = 8320, past the 8192 keys where flash attention takes its
streaming forms, against the JAX engine on the same weights (carried
across with ``params_from_jax``; the JAX side runs its reference
attention on the CPU), and the RoPE tables at 32768 positions against
the JAX model's."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import state_values
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.parallel import ParallelEngine as JEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ParallelEngine

S = 8320                 # > _FULL_K_MAX = 8192
LONG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=1, num_attention_heads=2,
            num_key_value_heads=1, max_position_embeddings=S,
            dtype="float32")
STEPS = 2
# as tests/test_torch_train_step.py: fp32 on both sides, the sums in
# other orders (over 8320 keys and tokens here)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)


def test_training_step_past_full_k_max_matches_jax_engine(monkeypatch):
    assert S > tfa._FULL_K_MAX
    paddle.seed(11)
    jm = JModel(JConfig(**LONG))
    state = {k: np.asarray(v) for k, v in state_values(jm).items()}
    cfg = tllama.LlamaConfig(**LONG)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(state, cfg))
    rng = np.random.default_rng(12)
    ids = rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((1, 1), -100)], 1).astype(
        np.int64)

    jopt = JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                  weight_decay=0.01, grad_clip=JClip(1.0))
    jeng = JEngine(jm, optimizer=jopt, donate=False)
    topt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                 weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    teng = ParallelEngine(tm, optimizer=topt)

    routes = []
    for name in ("_flash_fwd_bhsd_stream", "_flash_bwd_bhsd_stream"):
        orig = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _o=orig, _n=name:
                            routes.append(_n) or _o(*a))
    jl, tl = [], []
    for _ in range(STEPS):
        jl.append(float(jeng.train_batch(paddle.to_tensor(ids),
                                         paddle.to_tensor(labels))))
        tl.append(teng.train_batch(torch.from_numpy(ids),
                                   torch.from_numpy(labels)).item())
    # every step's one layer went through the streaming forms
    assert routes == ["_flash_fwd_bhsd_stream",
                      "_flash_bwd_bhsd_stream"] * STEPS
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    js, ts = jeng.engine_state_dict(), teng.engine_state_dict()
    assert set(ts["params"]) == set(js["params"])
    for n, want in js["params"].items():
        np.testing.assert_allclose(ts["params"][n], np.asarray(want),
                                   err_msg=n, **PARAM_TOL)


@pytest.mark.parametrize("head_dim,theta", [(128, 500000.0), (32, 10000.0)])
def test_rope_tables_match_jax_at_32768_positions(head_dim, theta):
    """fp32 angles t·inv_freq reach 32767 rad, where one ulp of the angle
    is 2**-9; both sides form the same fp32 angles and take cos/sin of
    them, so the tables agree to the last bit of the result (the
    libraries' pow, cos and sin round differently there): 2**-23."""
    jc, js = (np.asarray(t) for t in jllama._rope_tables(head_dim, 32768,
                                                         theta))
    tc, ts = tllama._rope_tables(head_dim, 32768, theta)
    assert tc.dtype == torch.float32 and tc.shape == (32768, head_dim // 2)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=2 ** -23)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=2 ** -23)
