"""Functional ops — port of ``paddle_tpu/nn/functional`` for the ops the
ERNIE encoder needs: activations (``gelu``, ``relu``, ``tanh``), ``linear``
and ``dropout``, ``layer_norm``, ``scaled_dot_product_attention`` and
``cross_entropy``, and the beam-search backtrace ``gather_tree``. Tensors
in and out; no ``Tensor`` wrapper, no ``apply_op``."""
from .activation import gelu, relu, tanh
from .attention import scaled_dot_product_attention
from .common import dropout, linear
from .extras import gather_tree
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["cross_entropy", "dropout", "gather_tree", "gelu", "layer_norm",
           "linear", "relu", "scaled_dot_product_attention", "tanh"]
