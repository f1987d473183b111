"""``scaled_dot_product_attention`` — port of
``paddle_tpu/nn/functional/attention.py``.

Inputs and output are (B, S, H, D), Paddle's head layout. The dispatch is
the JAX package's: with no mask, ``dropout_p == 0``, Sq and Sk multiples of
128 and D >= 64 the call takes flash attention
(``ops.flash_attention.flash_attention_bshd``: the hand-written kernels on
a CUDA tensor, their plain twins on a CPU one), otherwise :func:`_sdpa_ref`.
The SDPA check comes first, so S < 128 takes the reference even where the
flash path's own shape check would admit it. Unlike the JAX package there
is no ``except``-and-carry-on around the flash path: a CUDA tensor the
kernels do not take (fp32, D other than 64 or 128) raises.
"""
from __future__ import annotations

import math

import torch

from ...amp import cast_inputs
from ...ops.flash_attention import flash_attention_bshd

NEG_INF = -1e30


def _sdpa_ref(q, k, v, mask=None, dropout_p=0.0, is_causal=False,
              scale=None):
    """The JAX package's ``_sdpa_ref`` on (B, S, H, D): logits in the input
    dtype then fp32 times ``scale`` (1/sqrt(D) by default), causal and
    boolean masks set masked logits to -1e30, an additive mask is added in
    fp32, fp32 softmax cast to q's dtype before PV. ``dropout_p`` is taken
    and not applied: the JAX reference drops nothing from the attention
    probabilities, so neither does the port."""
    del dropout_p
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))     # B, H, S, D
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float() * s
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(sq, sk, dtype=torch.bool,
                        device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~cm, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)          # B, S, H, D


def _takes_flash(query, key, attn_mask, dropout_p) -> bool:
    """The JAX package's rule (``attention.py:46-53``)."""
    return (attn_mask is None and dropout_p == 0.0
            and query.shape[1] % 128 == 0 and key.shape[1] % 128 == 0
            and query.shape[-1] >= 64)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """(B, S, H, D) attention: flash attention where the JAX package's rule
    admits it, else :func:`_sdpa_ref` with the mask. ``training`` is taken
    for the signature's sake: callers pass ``dropout_p = 0`` outside
    training, as the JAX package's layers do. Under ``amp.auto_cast`` the
    inputs take the ``sdpa`` rule."""
    query, key, value = cast_inputs("sdpa", query, key, value)
    if _takes_flash(query, key, attn_mask, dropout_p):
        return flash_attention_bshd(query, key, value, causal=is_causal,
                                    scale=scale)
    return _sdpa_ref(query, key, value, attn_mask, dropout_p, is_causal,
                     scale)
