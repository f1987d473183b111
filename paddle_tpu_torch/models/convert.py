"""Weights from the JAX package into the port.

The port keeps Paddle's ``Linear`` layout — every projection weight is
``(in, out)`` and the port computes ``x @ weight`` — so the conversion is a
name-for-name, array-for-array copy with no transpose. Parameter names are
the JAX model's (``paddle_tpu.jit.state_values(model)``). A JAX model after
``quantize_int8()`` carries each projection as ``…weight_q`` (int8) and
``…weight_scale`` (f32): those load into a port model after its own
``quantize_int8()``, codes and scales unchanged.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .llama import LlamaConfig


_PROJECTIONS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                "mlp.down_proj")


def param_shapes(cfg: LlamaConfig, int8: bool = False) -> Dict[str, tuple]:
    """Name → shape of every parameter of ``LlamaForCausalLM(cfg)``, in the
    JAX package's naming and layout; with ``int8``, of the model after
    ``quantize_int8()`` (every projection and an untied lm-head as
    ``weight_q`` (in, out) + ``weight_scale`` (out,))."""
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
    if int8:
        for name in [n for n in out if n.endswith(".weight")
                     and (n.startswith("lm_head")
                          or any(p in n for p in _PROJECTIONS))]:
            shape = out.pop(name)
            base = name[:-len("weight")]
            out[base + "weight_q"] = shape
            out[base + "weight_scale"] = (shape[1],)
    return out


def params_from_jax(state: Dict[str, np.ndarray],
                    cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """Turn the JAX model's named parameters (``state_values(model)``
    converted to numpy) into a state dict for the port's
    ``LlamaForCausalLM.load_state_dict``: floating parameters in
    ``cfg.dtype``; an int8-quantized state keeps its int8 codes and f32
    scales (load it into a port model after ``quantize_int8()``). Raises
    on a missing, unexpected or mis-shaped parameter."""
    int8 = any(n.endswith(".weight_q") for n in state)
    want = param_shapes(cfg, int8=int8)
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
        if name.endswith(".weight_q"):
            if arr.dtype != np.int8:
                raise ValueError(f"params_from_jax: {name} is {arr.dtype}, "
                                 f"want int8 codes")
            out[name] = torch.from_numpy(arr.copy())
            continue
        # numpy has no bfloat16: widen (exactly) and narrow in torch
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        out[name] = t if name.endswith(".weight_scale") else \
            t.to(cfg.torch_dtype)
    return out
