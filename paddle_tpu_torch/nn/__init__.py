from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (Dropout, Embedding, LayerNorm, Linear,
                    MultiHeadAttention, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "functional"]
