"""Token sampling — port of ``paddle_tpu/models/generation.py``
(``next_token``, ``filtered_logits_rows``, ``filtered_probs_rows``,
``sample_token_rows``).

An explicit ``torch.Generator`` (on the logits' device) replaces the JAX key
and is advanced in place. The same seed gives other draws than JAX's
generator; greedy rows (temperature 0) are an argmax and match exactly.
"""
from __future__ import annotations

import torch

NEG = -1e30


def _categorical(lg, generator):
    """One draw per row from softmax(lg) (rows of fp32 logits):
    ``argmax(p / e)`` with ``e`` exponential draws, the arithmetic of
    ``torch.multinomial``'s one-sample path without its host-side check of
    the probabilities, so that a CUDA graph can capture it."""
    probs = torch.softmax(lg, dim=-1)
    e = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / e, dim=-1).to(torch.int32)


def next_token(logits, generator, temperature: float, top_k: int,
               top_p: float = 0.0):
    """Sample/argmax one token per row from (B, V) logits: temperature
    scaling, then top-k (keep logits >= the k-th largest), then nucleus
    (keep the smallest sorted prefix whose mass reaches p). Returns int32
    (B,)."""
    if temperature and temperature > 0:
        lg = logits.float() / temperature
        if top_k and top_k > 0:
            # a k past the vocabulary keeps every token, as JAX's clamped
            # index does
            k = min(int(top_k), lg.shape[-1])
            kth = torch.sort(lg, dim=-1).values[:, -k][:, None]
            lg = torch.where(lg < kth, torch.full_like(lg, NEG), lg)
        if top_p and 0 < top_p < 1:
            srt = torch.sort(lg, dim=-1, descending=True).values
            cdf = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
            keep = torch.cat([torch.ones_like(cdf[:, :1], dtype=torch.bool),
                              cdf[:, :-1] < top_p], dim=-1)
            cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                                 ).min(dim=-1, keepdim=True).values
            lg = torch.where(lg < cutoff, torch.full_like(lg, NEG), lg)
        return _categorical(lg, generator)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filtered_logits_rows(logits, temps, top_ks, top_ps):
    """Per-row temperature-scaled, top-k/top-p-filtered fp32 logits;
    filtered-out entries are -1e30. temps/top_ps float32 (B,), top_ks int32
    (B,) — 0 turns a filter off."""
    lg = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    V = lg.shape[-1]
    srt = torch.sort(lg, dim=-1, descending=True).values
    kidx = torch.clamp(top_ks.long() - 1, 0, V - 1)
    kth = torch.gather(srt, 1, kidx[:, None])
    neg = torch.full_like(lg, NEG)
    lg = torch.where((top_ks > 0)[:, None] & (lg < kth), neg, lg)
    srt = torch.sort(lg, dim=-1, descending=True).values
    cdf = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cdf[:, :1], dtype=torch.bool),
                      cdf[:, :-1] < top_ps[:, None]], dim=-1)
    cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                         ).min(dim=-1, keepdim=True).values
    nucleus = ((top_ps > 0) & (top_ps < 1))[:, None]
    return torch.where(nucleus & (lg < cutoff), neg, lg)


def filtered_probs_rows(logits, temps, top_ks, top_ps):
    """Softmax of :func:`filtered_logits_rows`: the distribution a sampled
    row draws from, the ``p`` of speculative rejection sampling
    (``inference/speculative.py``)."""
    return torch.softmax(filtered_logits_rows(logits, temps, top_ks, top_ps),
                         dim=-1)


def sample_token_rows(logits, generator, temps, top_ks, top_ps):
    """Per-ROW ``next_token`` for the serving decode tick: row ``i`` uses
    ``temps[i]`` (0 → greedy argmax), ``top_ks[i]`` and ``top_ps[i]``.
    Returns int32 (B,)."""
    sampled = _categorical(filtered_logits_rows(logits, temps, top_ks,
                                                top_ps), generator)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)
