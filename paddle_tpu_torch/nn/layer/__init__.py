"""Layers — port of ``paddle_tpu/nn/layer`` for the ERNIE encoder:
``Linear``, ``Embedding``, ``Dropout``, ``LayerNorm``,
``MultiHeadAttention``, ``TransformerEncoderLayer`` and
``TransformerEncoder``."""
from .common import Dropout, Embedding, Linear
from .norm import LayerNorm
from .transformer import (MultiHeadAttention, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
