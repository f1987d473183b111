"""Transformer encoder layers — port of
``paddle_tpu/nn/layer/transformer.py`` (``MultiHeadAttention`` on its
self-attention path without a cache, ``TransformerEncoderLayer`` with
either ``normalize_before``, ``TransformerEncoder``).

``MultiHeadAttention`` keeps Paddle's (B, S, H, D) head layout and routes
its core through ``F.scaled_dot_product_attention``, so a call the JAX
package would send to its flash kernel (no mask, no attention dropout, S a
multiple of 128, D >= 64) takes the port's flash kernels on the card.
``TransformerEncoder`` deep-copies its first layer, as the JAX package's
does, so every layer of a freshly built encoder starts from the same
weights.

Not ported (they raise NotImplementedError): the decoding caches
(``Cache``/``StaticCache``, ``gen_cache``), ``TransformerDecoderLayer``,
``TransformerDecoder`` and ``Transformer``.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm

_NO_CACHE = "decoding caches of the transformer layers are not ported yet"


class MultiHeadAttention(nn.Module):
    """Multi-head attention over (B, S, embed_dim) inputs; ``dropout`` is
    the attention-probability dropout rate (taken by the dispatch of
    ``F.scaled_dot_product_attention``: a nonzero rate in training keeps
    the call off the flash path, as in the JAX package)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim if kdim is not None else embed_dim
        self.vdim = vdim if vdim is not None else embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def gen_cache(self, key, value=None, type=None):
        raise NotImplementedError(_NO_CACHE)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(_NO_CACHE)
        key = query if key is None else key
        value = query if value is None else value
        B, S = query.shape[0], query.shape[1]
        Sk = key.shape[1]
        q = self.q_proj(query).reshape(B, S, self.num_heads, self.head_dim)
        k = self.k_proj(key).reshape(B, Sk, self.num_heads, self.head_dim)
        v = self.v_proj(value).reshape(B, Sk, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(out.reshape(B, S, self.embed_dim))
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a feed-forward block, each with a residual and a
    LayerNorm: after it (post-norm, ``normalize_before=False``, ERNIE's and
    BERT's form) or before it (pre-norm)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def gen_cache(self, src):
        raise NotImplementedError(_NO_CACHE)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(_NO_CACHE)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` encoder layers: ``encoder_layer`` itself and deep
    copies of it, then ``norm`` when given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def gen_cache(self, src):
        raise NotImplementedError(_NO_CACHE)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(_NO_CACHE)
        output = src
        for layer in self.layers:
            output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output


class TransformerDecoderLayer(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("TransformerDecoderLayer is not ported "
                                  "yet")


class TransformerDecoder(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("TransformerDecoder is not ported yet")


class Transformer(nn.Module):
    """Encoder and decoder: not ported yet (it builds a
    ``TransformerDecoder``; ROADMAP item 11)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("Transformer is not ported yet: it needs "
                                  "TransformerDecoder (ROADMAP item 11)")
