"""Weights from the JAX package into the port.

The port keeps Paddle's ``Linear`` layout — every projection weight is
``(in, out)`` and the port computes ``x @ weight`` — so the conversion is a
name-for-name, array-for-array copy with no transpose. Parameter names are
the JAX model's (``paddle_tpu.jit.state_values(model)``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .llama import LlamaConfig


def param_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """Name → shape of every parameter of ``LlamaForCausalLM(cfg)``, in the
    JAX package's naming and layout."""
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hq = cfg.num_attention_heads * cfg.head_dim
    hkv = cfg.num_key_value_heads * cfg.head_dim
    out = {"model.embed_tokens.weight": (v, h)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (h, hq),
            p + "self_attn.k_proj.weight": (h, hkv),
            p + "self_attn.v_proj.weight": (h, hkv),
            p + "self_attn.o_proj.weight": (hq, h),
            p + "post_attention_layernorm.weight": (h,),
            p + "mlp.gate_proj.weight": (h, f),
            p + "mlp.up_proj.weight": (h, f),
            p + "mlp.down_proj.weight": (f, h),
        })
    out["model.norm.weight"] = (h,)
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = (h, v)
    return out


def params_from_jax(state: Dict[str, np.ndarray],
                    cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """Turn the JAX model's named parameters (``state_values(model)``
    converted to numpy) into a state dict for the port's
    ``LlamaForCausalLM.load_state_dict``, in ``cfg.dtype``. Raises on a
    missing, unexpected or mis-shaped parameter."""
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"params_from_jax: missing {missing[:5]}, unexpected "
                       f"{extra[:5]}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != shape:
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{tuple(arr.shape)}, want {shape}")
        # numpy has no bfloat16: widen (exactly) and narrow in torch
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        out[name] = t.to(cfg.torch_dtype)
    return out
