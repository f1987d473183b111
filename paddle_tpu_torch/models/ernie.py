"""ERNIE — port of ``paddle_tpu/models/ernie.py`` (ERNIE-3.0 base finetune:
embeddings, a post-norm ``TransformerEncoder``, the pooler, and the
sequence-classification, token-classification, question-answering and
masked-LM heads with their ``loss_fn``s).

Parameters keep the JAX package's names and Paddle's ``Linear`` layout
(weight (in, out)), so ``models/convert.py``'s ``ernie_params_from_jax``
carries a JAX state dict over name for name. A model is built on
``device`` (None: the CUDA card, raising without one; ``"cpu"`` for the
plain path) in fp32, as the JAX model is; call ``model.bfloat16()`` to
train it on the card, where the flash kernels take bfloat16 only. Weights
and dropout masks are drawn from one ``torch.Generator`` seeded with
``seed``, in the JAX model's order of construction; the encoder's layers
are deep copies of the first (``TransformerEncoder``), so they start
equal, as in the JAX package.

On the card every LayerNorm (the embeddings' and two a layer: 25 a forward
at 12 layers) launches the hand-written LayerNorm kernel, and attention
takes the flash kernels (head dim 64) when the JAX package's rule admits
it: no mask, no attention dropout in training, S a multiple of 128
(``nn.functional.attention``).

Kept from the reference: the encoder layers are built without
``layer_norm_eps``, so their norms use 1e-5, and only the embeddings' norm
(and the masked-LM head's) uses ``cfg.layer_norm_eps`` (1e-12).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import resolve_device
from ..nn import functional as F
from ..nn.layer import (Dropout, Embedding, LayerNorm, Linear,
                        TransformerEncoder, TransformerEncoderLayer)


@dataclasses.dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    layer_norm_eps: float = 1e-12


def ernie_tiny_config(**kw) -> ErnieConfig:
    return ErnieConfig(**{**dict(
        vocab_size=1024, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=512,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0), **kw})


class ErnieEmbeddings(nn.Module):
    def __init__(self, cfg: ErnieConfig, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class ErnieModel(nn.Module):
    """Embeddings, the encoder and the pooler: ``forward`` returns the
    sequence output (B, S, hidden) and the pooled first token (B, hidden).
    ``attention_mask`` goes to every layer's attention as it is (a boolean
    keep-mask or an additive fp mask, broadcast to (B, H, S, S))."""

    def __init__(self, cfg: ErnieConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, device=device,
                                          generator=generator)
        # no layer_norm_eps, as in the reference: the layers' norms use 1e-5
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob,
            normalize_before=False, device=device, generator=generator)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, device=device,
                             generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        x = self.encoder(x, attention_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class _ErnieHead(nn.Module):
    """Common set-up of the task heads: the device, the generator that
    draws the weights (in construction order) and then the dropout masks,
    and the encoder."""

    def _start(self, cfg, device, seed):
        self.cfg = cfg
        device = resolve_device(device)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))
        self.ernie = ErnieModel(cfg, device=device, generator=self.generator)
        return device

    def _finish(self):
        # after every deep copy: each Dropout draws from the one generator
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator

    @property
    def device(self) -> torch.device:
        return self.ernie.embeddings.word_embeddings.weight.device


class ErnieForSequenceClassification(_ErnieHead):
    """The finetune recipe's head: logits (B, num_classes) from the pooled
    first token."""

    def __init__(self, cfg: ErnieConfig, num_classes=2, dropout=None,
                 device=None, seed: int = 0):
        super().__init__()
        device = self._start(cfg, device, seed)
        self.dropout = Dropout(dropout if dropout is not None
                               else cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes, device=device,
                                 generator=self.generator)
        self._finish()

    def forward(self, input_ids, token_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids)
        return self.classifier(self.dropout(pooled))

    def loss_fn(self, logits, labels):
        return F.cross_entropy(logits, labels, reduction="mean")


class ErnieForTokenClassification(_ErnieHead):
    """Per-token logits (B, S, num_classes) (NER and the like)."""

    def __init__(self, cfg: ErnieConfig, num_classes=2, dropout=None,
                 device=None, seed: int = 0):
        super().__init__()
        device = self._start(cfg, device, seed)
        self.dropout = Dropout(dropout if dropout is not None
                               else cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes, device=device,
                                 generator=self.generator)
        self._finish()

    def forward(self, input_ids, token_type_ids=None):
        seq, _ = self.ernie(input_ids, token_type_ids)
        return self.classifier(self.dropout(seq))

    def loss_fn(self, logits, labels):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1), reduction="mean")


class ErnieForQuestionAnswering(_ErnieHead):
    """Span head: start and end logits (B, S)."""

    def __init__(self, cfg: ErnieConfig, dropout=None, device=None,
                 seed: int = 0):
        super().__init__()
        device = self._start(cfg, device, seed)
        self.dropout = Dropout(dropout if dropout is not None
                               else cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, 2, device=device,
                                 generator=self.generator)
        self._finish()

    def forward(self, input_ids, token_type_ids=None):
        seq, _ = self.ernie(input_ids, token_type_ids)
        start, end = self.classifier(self.dropout(seq)).unbind(-1)
        return start, end

    def loss_fn(self, start_logits, end_logits, start_pos, end_pos):
        l1 = F.cross_entropy(start_logits, start_pos, reduction="mean")
        l2 = F.cross_entropy(end_logits, end_pos, reduction="mean")
        return (l1 + l2) / 2


class ErnieLMHead(nn.Module):
    """Masked-LM transform (Linear, activation, LayerNorm) and the decoder
    tied to the word embedding: ``forward(x, embed_weight)`` takes the table
    from its caller, so the tie adds no parameter (as in the JAX package,
    whose head holds the table outside its parameters)."""

    def __init__(self, cfg: ErnieConfig, *, device, generator):
        super().__init__()
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                device=device, generator=generator)
        self.norm = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                              device=device)
        self._act = getattr(F, cfg.hidden_act)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))

    def forward(self, x, embed_weight):
        h = self.norm(self._act(self.transform(x)))
        return torch.matmul(h, embed_weight.t()) + self.bias


class ErnieForMaskedLM(_ErnieHead):
    """Masked-LM logits (B, S, vocab); labels of ``ignore_index`` (-100)
    carry no loss."""

    def __init__(self, cfg: ErnieConfig, device=None, seed: int = 0):
        super().__init__()
        device = self._start(cfg, device, seed)
        self.lm_head = ErnieLMHead(cfg, device=device,
                                   generator=self.generator)
        self._finish()

    def forward(self, input_ids, token_type_ids=None):
        seq, _ = self.ernie(input_ids, token_type_ids)
        return self.lm_head(seq,
                            self.ernie.embeddings.word_embeddings.weight)

    def loss_fn(self, logits, labels, ignore_index=-100):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1), ignore_index=ignore_index,
                               reduction="mean")
