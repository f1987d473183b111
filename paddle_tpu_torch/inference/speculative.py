"""Speculative decoding for the paged server — port of
``paddle_tpu/inference/speculative.py``: the drafters and the exact
accept/reject.

A drafter proposes ``k`` tokens a row; the target model scores the window
of ``k + 1`` positions (the current token, then the drafts) in one pass
(``models/llama.py`` ``paged_verify_step``, or one launch of the
whole-tick kernel at W = k+1) and :func:`speculative_accept` keeps the
leading drafts the target agrees with, then one correction or bonus token.

Exactness, as in the JAX package:

- **greedy** (temperature 0): a draft is accepted iff it equals the
  target's argmax at its position, and the first mismatch's argmax is
  emitted: the tokens equal the plain server's. Every product of a
  verify window is batch-invariant (``ops/stream_matmul.py``), so its
  logits are the decode ticks' bit for bit, on the card as on the CPU
  (over int8 KV pools only while no token of a window rescales a block
  an earlier query of it reads).
- **sampling**: speculative rejection sampling [Leviathan et al.; Chen
  et al.] against the filtered target distribution ``p``
  (``models/generation.py`` ``filtered_probs_rows``): a draft ``x`` with
  draft probability ``q(x)`` is kept with probability ``min(1, p(x) /
  q(x))``; on a rejection the token is drawn from ``max(p - q, 0)``
  renormalised, after a fully accepted window from ``p``. The output
  distribution is the target's. The uniforms and the draws come from an
  explicit ``torch.Generator`` (draws as ``argmax(p / Exp(1))``, which a
  CUDA graph can capture): the same distribution as JAX's, not the same
  stream.

:class:`NgramDrafter` (prompt lookup, no weights) also drafts on the device
(:func:`ngram_propose_device`), so a whole trip of draft, verify, accept
windows is one program (``PagedExecutor.spec_scan``).
:class:`DraftModelDrafter` runs a small causal LM ``k`` times over a fixed
(B, max_len) buffer: one CUDA graph a ``k`` on a CUDA device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.generation import _categorical, filtered_probs_rows

__all__ = ["SpecConfig", "NgramDrafter", "DraftModelDrafter",
           "DrafterFault", "speculative_accept", "ngram_propose_device"]


class DrafterFault(RuntimeError):
    """A drafter failed to produce proposals. The server runs the trip
    through the plain decode program instead and holds speculation off for
    a cooldown: the drafter is an accelerator, never a correctness
    dependency."""


# --------------------------------------------------------------------------- #
# Acceptance
# --------------------------------------------------------------------------- #


def speculative_accept(logits, proposals, temps, topks, topps, kcaps,
                       generator, qprobs=None, greedy=False):
    """Exact accept/reject over one verify window, branch-free and of fixed
    shapes (a CUDA graph captures it).

    logits: fp32 (B, W, V), ``logits[:, j]`` the target distribution of the
    token after window position j (W = k+1); proposals: int32 (B, k), the
    drafts at window positions 1..k; temps/topps fp32 (B,), topks int32
    (B,): per-row sampling (temperature 0: greedy); kcaps: int32 (B,), the
    row's draft budget <= k — positions at or past it consume no draft and
    emit from the full target distribution (kcap 0: a plain decode tick);
    generator: the ``torch.Generator`` of the draws (unread when
    ``greedy``); qprobs: optional fp32 (B, k, V) draft distributions, None
    for deterministic drafts (one-hot q). ``greedy`` promises that every
    row has temperature 0: acceptance is an argmax comparison.

    Returns ``(out, acc)``: out int32 (B, W), of which ``out[b, :acc[b] +
    1]`` are emitted (the accepted drafts, then one correction or bonus),
    and acc int32 (B,), the accepted drafts."""
    B, W, V = logits.shape
    k = W - 1
    dev = logits.device
    lg = logits.float()
    tgt = torch.argmax(lg, dim=-1).to(torch.int32)                # (B, W)
    jpos = torch.arange(k, device=dev)[None, :]
    wpos = torch.arange(W, device=dev)[None, :]
    prop_pad = torch.cat([proposals.to(torch.int32),
                          torch.zeros(B, 1, dtype=torch.int32, device=dev)],
                         dim=1)                                   # (B, W)

    def leading(acc_tok):
        # the first rejection (or kcap) ends the accepted run
        acc_tok = acc_tok & (jpos < kcaps[:, None])
        return torch.cumprod(acc_tok.to(torch.int32), dim=1).sum(
            dim=1).to(torch.int32)

    acc_greedy = proposals == tgt[:, :k]
    if greedy:
        acc = leading(acc_greedy)
        return torch.where(wpos < acc[:, None], prop_pad, tgt), acc

    # the filtered target distribution of every window position
    p = filtered_probs_rows(lg.reshape(B * W, V), temps.repeat_interleave(W),
                            topks.repeat_interleave(W),
                            topps.repeat_interleave(W)).reshape(B, W, V)
    prop = proposals.long()[..., None]
    if qprobs is None:
        q = torch.zeros(B, k, V, device=dev).scatter_(2, prop, 1.0)
        q_at_d = torch.ones(B, k, device=dev)
    else:
        q = qprobs.float()
        q_at_d = torch.gather(q, 2, prop)[..., 0]
    p_at_d = torch.gather(p[:, :k], 2, prop)[..., 0]              # (B, k)
    u = torch.rand(B, k, device=dev, generator=generator)
    acc_sample = u * torch.clamp(q_at_d, min=1e-20) < p_at_d
    acc = leading(torch.where((temps > 0)[:, None], acc_sample, acc_greedy))
    # corrections, one per window index (only index ``acc`` is emitted): a
    # true rejection (j < kcap) draws from the residual max(p - q, 0)
    # renormalised, a forced stop or the bonus (j >= kcap, j == k) from p
    resid = torch.clamp(p[:, :k] - q, min=0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rs > 0, resid / torch.clamp(rs, min=1e-20),
                        p[:, :k])
    corr_resid = _categorical(torch.log(resid + 1e-30).reshape(B * k, V),
                              generator).reshape(B, k)
    corr_full = _categorical(torch.log(p + 1e-30).reshape(B * W, V),
                             generator).reshape(B, W)
    corr_resid = torch.cat([corr_resid, corr_full[:, -1:]], dim=1)
    corr_sample = torch.where(wpos < kcaps[:, None], corr_resid, corr_full)
    corr = torch.where((temps > 0)[:, None], corr_sample, tgt)
    return torch.where(wpos < acc[:, None], prop_pad, corr), acc


# --------------------------------------------------------------------------- #
# Drafters
# --------------------------------------------------------------------------- #


def ngram_propose_device(ctx, pos, k, max_ngram=3, min_ngram=1):
    """Prompt-lookup drafting on the device, branch-free and of fixed
    shapes (no host read: a CUDA graph captures it) — the twin of
    :meth:`NgramDrafter.propose_one`.

    ctx: int32 (B, L), row b valid through index ``pos[b]`` (the current
    token); pos: int32 (B,). Returns int32 (B, k): the continuation of the
    most recent longest n-gram match of each row's suffix within its own
    context, clamped at the context end (a short continuation repeats the
    last token); a row with no match of at least ``min_ngram`` repeats its
    last token."""
    B, L = ctx.shape
    dev = ctx.device
    ar = torch.arange(L, device=dev)[None, :]                     # (1, L)
    posl = pos.long()
    cont_start = posl.clone()
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    for n in range(max_ngram, min_ngram - 1, -1):
        # suffix token j of the n-gram ending at pos: ctx[pos - n + 1 + j]
        sidx = torch.clamp(posl[:, None]
                           + torch.arange(1 - n, 1, device=dev)[None, :],
                           0, L - 1)
        suffix = torch.gather(ctx, 1, sidx)                       # (B, n)
        match = torch.ones(B, L, dtype=torch.bool, device=dev)
        for j in range(n):
            # the window starting at i matches suffix[j] at i + j (clamped
            # reads past L - 1 fall outside the valid starts below)
            shifted = ctx[:, torch.clamp(ar[0] + j, max=L - 1)]
            match = match & (shifted == suffix[:, j:j + 1])
        # valid starts: the window inside ctx[:pos] — not the trivial
        # match at pos - n + 1, and a continuation token exists
        valid = match & (ar <= (posl - n)[:, None])
        last = torch.where(valid, ar, -1).max(dim=1).values       # (B,)
        hit = (last >= 0) & ~found
        cont_start = torch.where(hit, last + n, cont_start)
        found = found | hit
    pidx = torch.minimum(cont_start[:, None]
                         + torch.arange(k, device=dev)[None, :],
                         posl[:, None])                           # (B, k)
    return torch.gather(ctx, 1, pidx).to(torch.int32)


class NgramDrafter:
    """Prompt-lookup decoding: propose the continuation of the most recent
    longest n-gram match of the context's own suffix. No weights: the
    draft source is the request's context (prompt + generated), searched on
    the host (:meth:`propose`) or on the device (:meth:`propose_device`).
    On a miss it repeats the last token, whose drafts are simply
    rejected."""

    deterministic = True
    fusible = True   # has propose_device: drafting can live in the program

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram}, max_ngram={max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose_one(self, ctx: Sequence[int], k: int) -> np.ndarray:
        """k proposed continuation tokens for one context (host numpy)."""
        ctx = np.asarray(ctx, np.int32)
        n_ctx = len(ctx)
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1,
                       -1):
            suffix = ctx[n_ctx - n:]
            # starts i <= n_ctx - 1 - n: windows over ctx[:-1] leave out
            # the trivial match at the end and keep a continuation token
            windows = np.lib.stride_tricks.sliding_window_view(
                ctx[:n_ctx - 1], n)
            hits = np.nonzero((windows == suffix).all(axis=1))[0]
            if hits.size:
                i = int(hits[-1])                 # most recent occurrence
                cont = ctx[i + n:i + n + k]
                if len(cont) < k:                 # pad: repeat last token
                    pad = np.full(k - len(cont), cont[-1] if len(cont)
                                  else ctx[-1], np.int32)
                    cont = np.concatenate([cont, pad])
                return cont.astype(np.int32)
        return np.full(k, ctx[-1], np.int32)      # miss: repeat last token

    def propose(self, contexts: List[Optional[Sequence[int]]], k: int,
                temps=None, generator=None) -> Tuple[np.ndarray, None]:
        """Batch proposals: (B, k) int32, one row a slot (an idle slot
        passes None and gets zeros: its row runs masked)."""
        out = np.zeros((len(contexts), k), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx is not None and len(ctx):
                out[i] = self.propose_one(ctx, k)
        return out, None

    def propose_device(self, ctx, pos, k):
        """In-program drafting: :func:`ngram_propose_device` with this
        drafter's n-gram bounds."""
        return ngram_propose_device(ctx, pos, k, max_ngram=self.max_ngram,
                                    min_ngram=self.min_ngram)


class DraftModelDrafter:
    """Small-LM drafter: a cheap causal model sharing the target's
    tokenizer proposes k tokens autoregressively.

    Its program runs k full causal forwards of ``model`` (a port
    ``LlamaForCausalLM``) over a fixed (B, max_len) token buffer, with no
    draft KV cache, as the JAX drafter's ``lax.scan`` does; the head runs
    on each row's hidden state at its position only (the same function as
    JAX's gather of full logits, without holding (B, max_len, V) logits).
    On a CUDA device the program of each ``k`` is one CUDA graph over
    static buffers, captured at its first use (``PagedExecutor`` does the
    same); on the CPU it runs eagerly.

    ``sample_draft=False`` (default): greedy proposals, a point-mass draft
    distribution. ``True``: rows with temperature > 0 sample at their
    temperature from the server's generator and the draft softmax goes to
    the verify window as ``q``."""

    fusible = False  # drafting needs its own program and the host

    def __init__(self, model, max_len: int, sample_draft: bool = False):
        self.model = model
        self.max_len = int(max_len)
        self.sample_draft = bool(sample_draft)
        self.deterministic = not self.sample_draft
        self._buf = None      # static inputs, made at the first propose
        self._graphs: Dict[int, Any] = {}

    @torch.no_grad()
    def _draft(self, k: int, generator):
        """The program over the static inputs: k forwards, each appending
        its token at ``pos + 1`` (clamped at max_len - 1). Returns (tokens
        (B, k) int32, q (B, k, V) fp32 or None)."""
        model = self.model
        b = self._buf
        buf, p = b["buf"], b["pos"].long()
        B, L = buf.shape
        rows = torch.arange(B, device=buf.device)
        toks, qs = [], []
        for _ in range(k):
            h = model.model(buf)                                  # (B, L, h)
            lg = model.head(h[rows, p]).float()                   # (B, V)
            greedy = torch.argmax(lg, dim=-1).to(torch.int32)
            if self.sample_draft:
                temps = b["temps"]
                scaled = lg / torch.clamp(temps, min=1e-6)[:, None]
                drawn = _categorical(scaled, generator)
                nxt = torch.where(temps > 0, drawn, greedy)
                onehot = torch.zeros_like(lg).scatter_(
                    1, greedy.long()[:, None], 1.0)
                qs.append(torch.where((temps > 0)[:, None],
                                      torch.softmax(scaled, dim=-1), onehot))
            else:
                nxt = greedy
            p = torch.clamp(p + 1, max=L - 1)
            buf[rows, p] = nxt
            toks.append(nxt)
        return (torch.stack(toks, dim=1),
                torch.stack(qs, dim=1) if self.sample_draft else None)

    def propose(self, contexts: List[Optional[Sequence[int]]], k: int,
                temps=None, generator=None):
        """(B, k) int32 draft tokens on the model's device and, with
        ``sample_draft``, their (B, k, V) distributions (else None). The
        outputs are the program's static buffers: they hold until the next
        call."""
        B = len(contexts)
        dev = self.model.device
        buf = np.zeros((B, self.max_len), np.int32)
        pos = np.zeros((B,), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx is not None and len(ctx):
                ctx = list(ctx)[-self.max_len:]
                buf[i, :len(ctx)] = ctx
                pos[i] = len(ctx) - 1
        if temps is None:
            temps = np.zeros((B,), np.float32)
        if self._buf is None:      # a server's batch: fixed from here on
            self._buf = dict(
                buf=torch.zeros(B, self.max_len, dtype=torch.int32,
                                device=dev),
                pos=torch.zeros(B, dtype=torch.int32, device=dev),
                temps=torch.zeros(B, dtype=torch.float32, device=dev))
        b = self._buf
        gen = generator if self.sample_draft else None
        prog = None
        if dev.type == "cuda":
            prog = self._graphs.get(k)
            if prog is None:
                from .executor import capture_graph

                prog = self._graphs[k] = capture_graph(
                    lambda: self._draft(k, gen), b, gen, dev)
        for name, v in (("buf", buf), ("pos", pos), ("temps", temps)):
            b[name].copy_(torch.as_tensor(np.asarray(v)), non_blocking=False)
        if prog is None:
            return self._draft(k, gen)
        return prog.replay()


# --------------------------------------------------------------------------- #
# Config
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class SpecConfig:
    """Speculative-decoding knobs for ``GenerationServer(..., spec=...)``,
    the JAX package's fields and defaults.

    k: draft tokens a verify window (width k+1; ``submit(..., draft_k=)``
    lowers it per request without changing shapes). drafter: ``"ngram"``
    (prompt lookup, default), ``"model"`` (requires ``draft_model``, a port
    ``LlamaForCausalLM`` on the server's device) or an object with the
    drafter protocol (``deterministic``, ``fusible``, ``propose(contexts,
    k, temps, generator)``, and ``propose_device`` when fusible).

    gate_low / gate_cooldown: the speculation gate. After each speculative
    trip the server takes the mean accepted drafts a window over the live
    rows; below ``gate_low`` it runs ``gate_cooldown`` plain decode trips
    of ``gate_ticks`` ticks, then probes speculation again
    (``gate_cooldown=0`` disables the gate). turbo_windows: with a fused
    drafter, trips of ``turbo_windows`` windows while the batch accepts at
    least k - 1 drafts a window (0 disables the tier)."""

    k: int = 4
    drafter: Union[str, Any] = "ngram"
    ngram_max: int = 3
    ngram_min: int = 1
    draft_model: Any = None
    sample_draft: bool = False
    gate_low: float = 2.0
    gate_cooldown: int = 3
    gate_ticks: int = 16
    turbo_windows: int = 0

    def validate(self) -> None:
        if isinstance(self.k, bool) or not isinstance(self.k, int) \
                or self.k < 1:
            raise ValueError(f"spec.k must be an int >= 1, got {self.k!r}")
        if isinstance(self.drafter, str) and \
                self.drafter not in ("ngram", "model"):
            raise ValueError(
                f"spec.drafter must be 'ngram', 'model', or a drafter "
                f"object, got {self.drafter!r}")
        if self.drafter == "model" and self.draft_model is None:
            raise ValueError(
                "spec.drafter='model' requires spec.draft_model (a small "
                "causal LM sharing the target tokenizer)")
        if self.ngram_min < 1 or self.ngram_max < self.ngram_min:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"ngram_min={self.ngram_min}, ngram_max={self.ngram_max}")
        if not isinstance(self.gate_cooldown, int) \
                or isinstance(self.gate_cooldown, bool) \
                or self.gate_cooldown < 0:
            raise ValueError(f"spec.gate_cooldown must be an int >= 0 "
                             f"(0 disables the gate), got "
                             f"{self.gate_cooldown!r}")
        if not self.gate_low >= 0.0:
            raise ValueError(
                f"spec.gate_low must be >= 0, got {self.gate_low!r}")
        if not isinstance(self.gate_ticks, int) \
                or isinstance(self.gate_ticks, bool) or self.gate_ticks < 1:
            raise ValueError(f"spec.gate_ticks must be an int >= 1, got "
                             f"{self.gate_ticks!r}")
        if not isinstance(self.turbo_windows, int) \
                or isinstance(self.turbo_windows, bool) \
                or self.turbo_windows < 0:
            raise ValueError(f"spec.turbo_windows must be an int >= 0 "
                             f"(0 disables the turbo tier), got "
                             f"{self.turbo_windows!r}")

    def describe(self) -> Dict[str, Any]:
        """Flat JSON-safe knob dict: the speculation configuration beside
        the numbers it produced."""
        return {"k": self.k,
                "drafter": (self.drafter if isinstance(self.drafter, str)
                            else type(self.drafter).__name__),
                "ngram_max": self.ngram_max, "ngram_min": self.ngram_min,
                "sample_draft": self.sample_draft,
                "gate_low": self.gate_low,
                "gate_cooldown": self.gate_cooldown,
                "gate_ticks": self.gate_ticks,
                "turbo_windows": self.turbo_windows}

    def build_drafter(self, max_len: int):
        if not isinstance(self.drafter, str):
            return self.drafter
        if self.drafter == "ngram":
            return NgramDrafter(max_ngram=self.ngram_max,
                                min_ngram=self.ngram_min)
        return DraftModelDrafter(self.draft_model, max_len,
                                 sample_draft=self.sample_draft)
