"""Autoregressive generation — port of ``paddle_tpu/models/generation.py``:
the samplers (``next_token``, ``filtered_logits_rows``,
``filtered_probs_rows``, ``sample_token_rows``), ``advance_tokens``, the
cacheless :class:`GenerationMixin` loop, the fixed-cache loop
:func:`compiled_cached_generate` and :func:`compiled_beam_search`.

An explicit ``torch.Generator`` (on the logits' device) replaces the JAX key
and is advanced in place. The same seed gives other draws than JAX's
generator; greedy rows (temperature 0) are an argmax and match exactly.

Where the JAX package compiles each loop as one ``lax.scan`` per static
key, the port keeps a :class:`Program` per key (the JAX key tuple) in the
model's ``_gen_cache``: static device buffers (the token buffer, the KV
caches, the position and the done flags) and, on a CUDA device, CUDA
graphs captured at the key's first call — a prologue (the caches zeroed,
the prompt's prefill and first token), one decode step, replayed once a
step with the position on the device, and, for beam search, the
backtrace. A call copies its prompt in, replays, and reads the buffer
once at the end. The sampled loop draws from the program's generator,
registered with its graphs and seeded with ``seed`` at every call. On the
CPU, under ``set_kernel_mode("reference")`` or with ``model.gen_graphs =
False`` the same bodies run eagerly.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import graphs

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


# --------------------------------------------------------------------------- #
# Generation loops
# --------------------------------------------------------------------------- #


def advance_tokens(toks, done, nxt, t, prompt_len: int, total_len: int,
                   eos_token_id: Optional[int]):
    """Write the step-``t`` output token into the buffer, in place: within
    the prompt the 'next' token is the given one (teacher forcing); after
    eos, keep emitting eos. toks int32 (B, total_len); done bool (B,);
    nxt (B,) the sampled tokens; t a host int or a device integer scalar
    (the graphs' position). Returns (toks, done), the same tensors."""
    if not isinstance(t, torch.Tensor):
        # a fill, not a host copy: legal inside a graph capture
        t = torch.full((1,), int(t), dtype=torch.long, device=toks.device)
    t = t.reshape(1).long()
    given = (t + 1) < prompt_len                        # (1,) bool
    at = torch.clamp(t + 1, max=total_len - 1)
    cur = toks.index_select(1, at)[:, 0]
    nxt = torch.where(given, cur, nxt.to(toks.dtype))
    if eos_token_id is not None:
        nxt = torch.where(done, torch.full_like(nxt, int(eos_token_id)),
                          nxt)
        done.copy_(done | ((nxt == eos_token_id) & ~given))
    toks.index_copy_(1, at, nxt[:, None])
    return toks, done


def _top_k(x, k: int):
    """The ``k`` largest of each row of x (values, indices), ties broken by
    the lower index, as ``jax.lax.top_k`` does (a stable descending sort:
    ``torch.topk`` promises no order among equal values, and frozen beams
    put equal scores side by side)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Program:
    """The static buffers and captured graphs of one generation key: each
    named body runs eagerly (on the CPU, under the reference kernel mode,
    or with ``model.gen_graphs = False``) or, on a CUDA device, as a replay
    of its graph, captured at its first run after one eager warm-up. The
    bodies read and write only ``self.buf`` (and the model's weights,
    read by address: the program is rebuilt when they change)."""

    def __init__(self, model, device, weights):
        self.model = model
        self.device = device
        self.weights = weights
        self.buf = {}
        self.generator = torch.Generator(device=device)
        self.graphs = {}
        self.pool = None
        self.captures = 0
        self.replays = 0

    def graphed(self) -> bool:
        from .. import ops

        return (self.device.type == "cuda"
                and getattr(self.model, "gen_graphs", True)
                and ops.kernel_mode() != "reference")

    def prepare(self, bodies) -> None:
        """Capture each (name, body) not captured yet, in order: each is
        warmed up on the state the ones before it leave (a body reads
        what the earlier ones wrote), then captured; the caller's run
        that follows starts the state afresh."""
        from .. import ops

        if not self.graphed():
            return
        for name, body in bodies:
            if name in self.graphs:
                continue
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            with ops.captured_launches():
                graphs.warm_up(body, self.device)
            self.graphs[name] = graphs.capture(body, (self.generator,),
                                               self.pool)
            self.captures += 1

    def run(self, name, body):
        """One run of ``body``: its graph's replay, or the body itself."""
        g = self.graphs.get(name) if self.graphed() else None
        if g is None:
            return body()
        self.replays += 1
        return g.replay()


def _program(model, key, device) -> Program:
    """The model's program of ``key`` (the JAX key tuple), built anew when
    the model's weights moved since it was made."""
    cache = model.__dict__.setdefault("_gen_cache", {})
    weights = graphs.weights_key(model.parameters(), model.buffers())
    prog = cache.get(key)
    if prog is None or prog.weights != weights:
        prog = cache[key] = Program(model, device, weights)
    return prog


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _ids(input_ids, device) -> torch.Tensor:
    """The prompt as int32 (B, P) on ``device`` (a tensor, an array or
    nested lists)."""
    t = input_ids if isinstance(input_ids, torch.Tensor) else \
        torch.as_tensor(input_ids)
    if t.dim() != 2:
        raise ValueError(f"input_ids must be (batch, prompt_len), got shape "
                         f"{tuple(t.shape)}")
    return t.to(device=device, dtype=torch.int32)


def _check_len(L: int, max_positions) -> None:
    if max_positions is not None and L > max_positions:
        raise ValueError(f"prompt+new tokens {L} exceeds "
                         f"max_position_embeddings {max_positions}")


def _in_eval(model, fn):
    """Run ``fn`` with the model in eval mode (stochastic layers off), its
    training flag restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return fn()
    finally:
        if was_training:
            model.train()


class GenerationMixin:
    """Mixin for models whose ``forward(input_ids)`` returns logits (B, S,
    V) with causal semantics: generation without a KV cache, re-running
    the whole forward over a fixed (B, P + max_new_tokens) buffer every
    step and reading the logits at the current position (causal masking
    keeps the padding past it out)."""

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 eos_token_id: Optional[int] = None):
        """Returns int32 (B, P + max_new_tokens): the prompt and the
        generated tokens, on the model's device."""
        device = _model_device(self)
        ids = _ids(input_ids, device)
        B, P = ids.shape
        N = int(max_new_tokens)
        L = P + N
        _check_len(L, getattr(getattr(self, "cfg", None),
                              "max_position_embeddings", None))
        key = ("cacheless", B, P, N, float(temperature or 0.0),
               int(top_k or 0), float(top_p or 0.0), eos_token_id)
        prog = _program(self, key, device)
        b = prog.buf
        if not b:
            b.update(toks=torch.zeros(B, L, dtype=torch.int32, device=device),
                     done=torch.zeros(B, dtype=torch.bool, device=device),
                     t=torch.zeros(1, dtype=torch.long, device=device))
        model = self

        def start():
            b["done"].zero_()
            b["t"].fill_(P - 1)

        def step():
            out = model(b["toks"])
            out = out[0] if isinstance(out, (list, tuple)) else out
            logits = out.index_select(1, b["t"])[:, 0]
            nxt = next_token(logits, prog.generator, temperature, top_k,
                             top_p)
            advance_tokens(b["toks"], b["done"], nxt, b["t"], P, L,
                           eos_token_id)
            b["t"].add_(1)

        def call():
            # captured first: the warm-ups write the buffers
            prog.prepare([("start", start), ("step", step)])
            b["toks"].zero_()
            b["toks"][:, :P] = ids
            prog.generator.manual_seed(int(seed))
            prog.run("start", start)
            for _ in range(N):
                prog.run("step", step)
            return b["toks"].clone()

        return _in_eval(self, call)


def compiled_cached_generate(model, input_ids, *, max_new_tokens,
                             temperature, top_k, seed, eos_token_id,
                             make_caches, run_one, prefill=None,
                             max_positions=None, extra_key=(),
                             top_p: float = 0.0):
    """The prefill + decode loop of models with a fixed-cache
    ``decode_step`` (Llama, GPT): one program per static key, a replay of
    its step graph a token (see the module docstring).

    make_caches(B, L) -> flat list of cache tensors (zeroed at each call).
    run_one(tok int (B, 1), flat, pos) -> (B, V) logits, writing position
    ``pos`` (a device scalar) of the caches in place.
    prefill(prompt int (B, P), flat) -> (B, V) logits at P - 1: the whole
    prompt in ONE forward filling positions [0, P); without it (or at P =
    1, or with no token to emit) the prompt is teacher-forced through
    single-token steps. Returns int32 (B, P + max_new_tokens)."""
    device = _model_device(model)
    ids = _ids(input_ids, device)
    B, P = ids.shape
    N = int(max_new_tokens)
    L = P + N
    _check_len(L, max_positions)
    key = (B, P, N, float(temperature or 0.0), int(top_k or 0),
           float(top_p or 0.0), eos_token_id, prefill is not None,
           tuple(extra_key))
    prog = _program(model, key, device)
    b = prog.buf
    if not b:
        b.update(toks=torch.zeros(B, L, dtype=torch.int32, device=device),
                 done=torch.zeros(B, dtype=torch.bool, device=device),
                 t=torch.zeros(1, dtype=torch.long, device=device))
        b["caches"] = make_caches(B, L)
    # a prefill needs a real prompt AND a token to emit: with no new token
    # the sampled one would overwrite toks[:, P - 1]
    use_prefill = prefill is not None and P > 1 and N > 0
    start_t = P if use_prefill else 0

    def start():
        for c in b["caches"]:
            c.zero_()
        b["done"].zero_()
        b["t"].fill_(start_t)
        if use_prefill:
            logits = prefill(b["toks"][:, :P], b["caches"])
            nxt = next_token(logits, prog.generator, temperature, top_k,
                             top_p)
            advance_tokens(b["toks"], b["done"], nxt, P - 1, P, L,
                           eos_token_id)

    def step():
        tok = b["toks"].index_select(1, b["t"])
        logits = run_one(tok, b["caches"], b["t"])
        nxt = next_token(logits, prog.generator, temperature, top_k, top_p)
        advance_tokens(b["toks"], b["done"], nxt, b["t"], P, L,
                       eos_token_id)
        b["t"].add_(1)

    def call():
        # captured first: the warm-ups write the buffers
        prog.prepare([("start", start), ("step", step)])
        b["toks"].zero_()
        b["toks"][:, :P] = ids
        prog.generator.manual_seed(int(seed))
        prog.run("start", start)
        for _ in range(L - 1 - start_t):
            prog.run("step", step)
        return b["toks"].clone()

    return _in_eval(model, call)


def compiled_beam_search(model, input_ids, *, num_beams, max_new_tokens,
                         eos_token_id, length_penalty, make_caches, run_one,
                         prefill=None, max_positions=None):
    """Beam search over the fixed-cache decode step (PaddleNLP
    ``decode_strategy="beam_search"``): a prologue graph runs the prompt
    at batch B and seeds the K beams from one top-k over V; each step
    graph runs the (B·K) decode batch, takes the joint top-k over K·V,
    gathers the caches along the beam dimension and records the
    token/parent trail; the backtrace (:func:`~paddle_tpu_torch.nn.
    functional.gather_tree`) and the choice by length-normalised score run
    as a third graph. Finished beams (they emitted EOS) are frozen: they
    re-emit EOS with no score change and keep competing. Every top-k
    breaks ties by the lower index, as the JAX search's. ``length_penalty``
    alpha: final score = cum_logprob / (full length ** alpha), the prompt
    included. Returns int32 (B, P + max_new_tokens)."""
    from ..nn.functional.extras import gather_tree

    device = _model_device(model)
    ids = _ids(input_ids, device)
    B, P = ids.shape
    K = int(num_beams)
    T = int(max_new_tokens)
    L = P + T
    _check_len(L, max_positions)
    if T < 1 or K < 1:
        raise ValueError(
            f"beam search needs max_new_tokens >= 1 and num_beams >= 1 "
            f"(got {T}, {K})")
    eos = -1 if eos_token_id is None else int(eos_token_id)
    key = ("beam", B, P, T, K, eos, float(length_penalty),
           prefill is not None)
    prog = _program(model, key, device)
    b = prog.buf
    if not b:
        i32 = dict(dtype=torch.int32, device=device)
        b.update(prompt=torch.zeros(B, P, **i32),
                 small=make_caches(B, L), big=make_caches(B * K, L),
                 cur=torch.zeros(B * K, **i32),
                 cum=torch.zeros(B, K, dtype=torch.float32, device=device),
                 done=torch.zeros(B, K, dtype=torch.bool, device=device),
                 gen_len=torch.zeros(B, K, **i32),
                 trail_tok=torch.zeros(T, B, K, **i32),
                 trail_par=torch.zeros(T, B, K, **i32),
                 t=torch.zeros(1, dtype=torch.long, device=device),
                 step=torch.zeros(1, dtype=torch.long, device=device),
                 out=torch.zeros(B, L, **i32))

    def start():
        for c in b["small"]:
            c.zero_()
        prompt = b["prompt"]
        if prefill is not None and P > 1:
            logits = prefill(prompt, b["small"])
        else:
            for t in range(P):
                logits = run_one(prompt[:, t:t + 1], b["small"],
                                 torch.full((1,), t, dtype=torch.long,
                                            device=device))
        # every beam starts from the one prompt state
        for big, small in zip(b["big"], b["small"]):
            big.view(B, K, *small.shape[1:]).copy_(small[:, None])
        logp = torch.log_softmax(logits.float(), dim=-1)       # (B, V)
        cum, tok0 = _top_k(logp, K)
        tok0 = tok0.to(torch.int32)
        b["cum"].copy_(cum)
        b["done"].copy_(tok0 == eos)
        b["gen_len"].fill_(1)
        b["cur"].copy_(tok0.reshape(B * K))
        b["trail_tok"][0] = tok0
        b["trail_par"][0] = 0
        b["t"].fill_(P)
        b["step"].fill_(1)

    def step():
        logits = run_one(b["cur"][:, None], b["big"], b["t"])
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        logp = logp.reshape(B, K, V)
        done = b["done"]
        if eos >= 0:
            # frozen finished beams: only EOS continues, score unchanged
            frozen = torch.full((V,), NEG, device=device)
            frozen[eos] = 0.0
            logp = torch.where(done[..., None], frozen, logp)
        total = b["cum"][..., None] + logp                      # (B, K, V)
        cum2, flat = _top_k(total.reshape(B, K * V), K)
        parent = torch.div(flat, V, rounding_mode="floor")
        tok = (flat % V).to(torch.int32)
        done2 = done.gather(1, parent)
        glen = b["gen_len"].gather(1, parent)
        gen2 = torch.where(done2, glen, glen + 1)
        if eos >= 0:
            done2 = done2 | (tok == eos)
        rows = torch.arange(B, device=device)[:, None]
        src = (rows * K + parent).reshape(B * K)
        for c in b["big"]:
            c.copy_(c.index_select(0, src))
        b["cur"].copy_(tok.reshape(B * K))
        b["cum"].copy_(cum2)
        done.copy_(done2)
        b["gen_len"].copy_(gen2)
        b["trail_tok"].index_copy_(0, b["step"], tok[None])
        b["trail_par"].index_copy_(0, b["step"],
                                   parent.to(torch.int32)[None])
        b["t"].add_(1)
        b["step"].add_(1)

    def finish():
        traced = gather_tree(b["trail_tok"], b["trail_par"])    # (T, B, K)
        full_len = (b["gen_len"] + P).float()
        norm = b["cum"] / torch.pow(full_len, float(length_penalty))
        best = torch.argmax(norm, dim=-1)                       # (B,)
        seq = traced[:, torch.arange(B, device=device), best].t()
        b["out"][:, :P] = b["prompt"]
        b["out"][:, P:] = seq.to(torch.int32)

    def call():
        # captured first: the warm-ups write the buffers
        prog.prepare([("start", start), ("step", step), ("finish", finish)])
        b["prompt"].copy_(ids)
        prog.run("start", start)
        for _ in range(T - 1):
            prog.run("step", step)
        prog.run("finish", finish)
        return b["out"].clone()

    return _in_eval(model, call)


def generate_with_caches(model, input_ids, *, max_new_tokens, temperature,
                         top_k, top_p, seed, eos_token_id, num_beams,
                         length_penalty, make_caches, run_one, prefill,
                         max_positions):
    """A fixed-cache model's ``generate`` (Llama's, GPT's): the beam search
    when ``num_beams > 1`` (temperature / top_k / seed ignored, with a
    warning, as in JAX), :func:`compiled_cached_generate` otherwise."""
    if num_beams > 1:
        if temperature or top_k:
            import warnings

            warnings.warn(
                "num_beams > 1 uses deterministic beam search; "
                "temperature/top_k/seed are ignored", UserWarning)
        return compiled_beam_search(
            model, input_ids, num_beams=num_beams,
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
            length_penalty=length_penalty, make_caches=make_caches,
            run_one=run_one, prefill=prefill, max_positions=max_positions)
    return compiled_cached_generate(
        model, input_ids, max_new_tokens=max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        eos_token_id=eos_token_id, make_caches=make_caches, run_one=run_one,
        prefill=prefill, max_positions=max_positions)
