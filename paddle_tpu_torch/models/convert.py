"""Weights from the JAX package into the port: Llama
(:func:`params_from_jax`), ERNIE (:func:`ernie_params_from_jax`), GPT
(:func:`gpt_params_from_jax`) and any ``Layer`` model built of the same
layers, such as the ResNet family (:func:`layer_params_from_jax`).

The port keeps Paddle's ``Linear`` layout — every projection weight is
``(in, out)`` and the port computes ``x @ weight`` — so the conversion is a
name-for-name, array-for-array copy with no transpose. Parameter names are
the JAX model's (``paddle_tpu.jit.state_values(model)``). A JAX model after
``quantize_int8()`` carries each projection as ``…weight_q`` (int8) and
``…weight_scale`` (f32): those load into a port model after its own
``quantize_int8()``, codes and scales unchanged. A JAX model with LoRA
attached (``lora_rank``, ``attach_lora``) carries each wrapped projection
as ``…base.weight`` (the frozen base, in the model dtype) with its fp32
factors ``…lora_A`` (in, r) and ``…lora_B`` (r, out): those load into a
port model with the same LoRA attached.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from .ernie import ErnieConfig
from .gpt import GPTConfig
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


def _with_lora(out: Dict[str, tuple], state, suffixes) -> Dict[str, tuple]:
    """``out`` with every projection that ``state`` carries as
    ``<proj>.base.weight`` renamed so, and its factors ``<proj>.lora_A``
    (in, r) / ``<proj>.lora_B`` (r, out) added (r read from the state); a
    bias goes to ``<proj>.base.bias``."""
    for name in [n for n in out if n.endswith(".weight")
                 and any(n.endswith(f"{p}.weight") for p in suffixes)]:
        proj = name[:-len(".weight")]
        if proj + ".base.weight" not in state:
            continue
        n_in, n_out = out.pop(name)
        r = np.asarray(state[proj + ".lora_A"]).shape[-1]
        out.update({proj + ".base.weight": (n_in, n_out),
                    proj + ".lora_A": (n_in, r), proj + ".lora_B": (r, n_out)})
        if proj + ".bias" in out:
            out[proj + ".base.bias"] = out.pop(proj + ".bias")
    return out


def _is_factor(name: str) -> bool:
    return name.endswith((".lora_A", ".lora_B"))


def params_from_jax(state: Dict[str, np.ndarray],
                    cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """Turn the JAX model's named parameters (``state_values(model)``
    converted to numpy) into a state dict for the port's
    ``LlamaForCausalLM.load_state_dict``: floating parameters in
    ``cfg.dtype``; an int8-quantized state keeps its int8 codes and f32
    scales (load it into a port model after ``quantize_int8()``); LoRA
    factors stay fp32. Raises on a missing, unexpected or mis-shaped
    parameter."""
    int8 = any(n.endswith(".weight_q") for n in state)
    want = _with_lora(param_shapes(cfg, int8=int8), state, _PROJECTIONS)
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
        out[name] = t if name.endswith(".weight_scale") or \
            _is_factor(name) else t.to(cfg.torch_dtype)
    return out


def ernie_param_shapes(cfg: ErnieConfig, head: str,
                       num_classes: int = 2) -> Dict[str, tuple]:
    """Name → shape of every parameter of an ERNIE model with ``head``
    ``"classifier"`` (sequence or token classification with
    ``num_classes``; question answering is the same at 2) or
    ``"masked_lm"``, in the JAX package's naming and layout."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    e = "ernie.embeddings."
    out = {e + "word_embeddings.weight": (cfg.vocab_size, h),
           e + "position_embeddings.weight": (cfg.max_position_embeddings,
                                              h),
           e + "token_type_embeddings.weight": (cfg.type_vocab_size, h),
           e + "layer_norm.weight": (h,), e + "layer_norm.bias": (h,)}
    for i in range(cfg.num_hidden_layers):
        p = f"ernie.encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[p + f"self_attn.{proj}.weight"] = (h, h)
            out[p + f"self_attn.{proj}.bias"] = (h,)
        out.update({p + "linear1.weight": (h, f), p + "linear1.bias": (f,),
                    p + "linear2.weight": (f, h), p + "linear2.bias": (h,)})
        for norm in ("norm1", "norm2"):
            out[p + f"{norm}.weight"] = (h,)
            out[p + f"{norm}.bias"] = (h,)
    out.update({"ernie.pooler.weight": (h, h), "ernie.pooler.bias": (h,)})
    if head == "classifier":
        out.update({"classifier.weight": (h, num_classes),
                    "classifier.bias": (num_classes,)})
    elif head == "masked_lm":
        out.update({"lm_head.transform.weight": (h, h),
                    "lm_head.transform.bias": (h,),
                    "lm_head.norm.weight": (h,), "lm_head.norm.bias": (h,),
                    "lm_head.bias": (cfg.vocab_size,)})
    else:
        raise ValueError(f"ERNIE head must be 'classifier' or 'masked_lm', "
                         f"got {head!r}")
    return out


def ernie_params_from_jax(state: Dict[str, np.ndarray], cfg: ErnieConfig,
                          device=None,
                          dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Turn a JAX ERNIE model's named parameters (``state_values(model)``
    converted to numpy) into a state dict for the port's model of the same
    head (``load_state_dict``), in ``dtype`` on ``device`` (None: the CUDA
    card). The head is read from the names: ``lm_head.*`` is the masked-LM
    head, ``classifier.*`` a classification or question-answering head of
    as many classes as the classifier has columns. Raises on a missing,
    unexpected or mis-shaped parameter."""
    device = resolve_device(device)
    if any(n.startswith("lm_head.") for n in state):
        want = ernie_param_shapes(cfg, "masked_lm")
    elif "classifier.weight" in state:
        want = ernie_param_shapes(
            cfg, "classifier",
            int(np.asarray(state["classifier.weight"]).shape[-1]))
    else:
        raise KeyError("ernie_params_from_jax: neither classifier.* nor "
                       "lm_head.* parameters: not an ERNIE head's state")
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"ernie_params_from_jax: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != shape:
            raise ValueError(f"ernie_params_from_jax: {name} has shape "
                             f"{tuple(arr.shape)}, want {shape}")
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        out[name] = t.to(device=device, dtype=dtype)
    return out


def gpt_param_shapes(cfg: GPTConfig) -> Dict[str, tuple]:
    """Name → shape of every parameter of ``GPTForCausalLM(cfg)``, in the
    JAX package's naming and layout (the head is tied to ``wte``: no
    parameter of its own)."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    t = "transformer."
    out = {t + "wte.weight": (cfg.vocab_size, h),
           t + "wpe.weight": (cfg.max_position_embeddings, h)}
    for i in range(cfg.num_hidden_layers):
        p = f"{t}h.{i}."
        for name, (n_in, n_out) in (("c_attn", (h, 3 * h)),
                                    ("c_proj", (h, h)), ("c_fc", (h, f)),
                                    ("c_out", (f, h))):
            out[p + name + ".weight"] = (n_in, n_out)
            out[p + name + ".bias"] = (n_out,)
        for norm in ("ln_1", "ln_2"):
            out[p + norm + ".weight"] = (h,)
            out[p + norm + ".bias"] = (h,)
    out[t + "ln_f.weight"] = (h,)
    out[t + "ln_f.bias"] = (h,)
    return out


def gpt_params_from_jax(state: Dict[str, np.ndarray], cfg: GPTConfig,
                        device=None, dtype=None) -> Dict[str, torch.Tensor]:
    """Turn a JAX GPT model's named parameters (``state_values(model)``
    converted to numpy) into a state dict for the port's
    ``GPTForCausalLM.load_state_dict``, in ``dtype`` (default
    ``cfg.dtype``) on ``device`` (None: the CUDA card). Raises on a
    missing, unexpected or mis-shaped parameter. LoRA factors stay
    fp32."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype if dtype is None else dtype
    want = _with_lora(gpt_param_shapes(cfg), state,
                      ("c_attn", "c_proj", "c_fc", "c_out"))
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"gpt_params_from_jax: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != shape:
            raise ValueError(f"gpt_params_from_jax: {name} has shape "
                             f"{tuple(arr.shape)}, want {shape}")
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        out[name] = t.to(device=device,
                         dtype=torch.float32 if _is_factor(name) else dtype)
    return out


@torch.no_grad()
def layer_params_from_jax(state: Dict[str, np.ndarray], model):
    """Copy a JAX model's parameters AND buffers (``paddle_tpu.jit.
    state_values(model)`` converted to numpy: a ResNet-50's 161 parameters
    and 106 BatchNorm statistics) into the port model of the same
    architecture, name for name, in place (a CUDA graph reads them by
    address), each cast to the port tensor's dtype on its device. Raises
    KeyError on a missing or unexpected name and ValueError on a shape
    that differs. Returns ``model``."""
    from ..framework.io_state import from_numpy

    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"layer_params_from_jax: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for name, tgt in own.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"layer_params_from_jax: {name} has shape "
                             f"{tuple(arr.shape)}, want {tuple(tgt.shape)}")
        tgt.copy_(from_numpy(arr, "cpu").to(tgt.dtype))
    return model
