"""The speculative-decoding module of the PyTorch port
(``paddle_tpu_torch/inference/speculative.py``) against the JAX package's
on the CPU: the greedy accept/reject equal to JAX's, out and acc, over
random logits, drafts and draft budgets; the sampled accept/reject's
output distribution equal to the filtered target distribution (the port's
own draws: a ``torch.Generator`` is another stream than JAX's keys); the
device n-gram matcher equal to JAX's and to the host drafter;
``filtered_probs_rows`` against JAX; ``SpecConfig`` refusing what JAX's
refuses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import speculative as jspec
from paddle_tpu.models import generation as jgen
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.models import generation as tgen

# the sampled cases: draws a case, and the largest |empirical - p| a token
# may show. A token's frequency over N draws has a standard deviation of at
# most sqrt(0.25 / N) = 0.0056 at N = 8000: the bound is over 5 of them
N_DRAWS = 8000
MAX_FREQ_GAP = 0.03


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _greedy_case(seed, B=12, k=4, V=32):
    """Random fp32 logits; drafts that follow the argmax chain for a random
    length and then miss; draft budgets 0..k."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, k + 1, V)).astype(np.float32)
    tgt = logits.argmax(-1).astype(np.int32)
    proposals = tgt[:, :k].copy()
    for b in range(B):
        miss = rng.integers(0, k + 1)
        if miss < k:
            proposals[b, miss] = (tgt[b, miss] + 1 + rng.integers(V - 1)) % V
    kcaps = rng.integers(0, k + 1, B).astype(np.int32)
    kcaps[:k + 1] = np.arange(k + 1)            # every budget at least once
    return logits, proposals, kcaps


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "general"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_accept_equals_jax(seed, greedy):
    """At temperature 0, ``out`` and ``acc`` equal JAX's exactly, through
    the argmax-only program (``greedy=True``) and the general one."""
    logits, proposals, kcaps = _greedy_case(seed)
    B = logits.shape[0]
    zf, zi = np.zeros(B, np.float32), np.zeros(B, np.int32)
    jout, jacc = jspec.speculative_accept(
        *_j(logits, proposals, zf, zi, zf, kcaps), jax.random.PRNGKey(seed),
        greedy=greedy)
    gen = torch.Generator().manual_seed(seed)
    tout, tacc = tspec.speculative_accept(
        *_t(logits, proposals, zf, zi, zf, kcaps), gen, greedy=greedy)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tout.dtype == tacc.dtype == torch.int32
    # the oracle: leading argmax matches under the budget, then the argmax
    tgt = logits.argmax(-1)
    for b in range(B):
        a = 0
        while a < kcaps[b] and proposals[b, a] == tgt[b, a]:
            a += 1
        assert int(tacc[b]) == a
        assert tout[b, :a + 1].tolist() == \
            proposals[b, :a].tolist() + [int(tgt[b, a])]


def _first_tokens(logits, prop, temps, topks, topps, kcap, qprobs=None,
                  seed=0):
    """The first emitted token of N_DRAWS rows of the same window, one
    call (a row's draws are independent of the others')."""
    N = N_DRAWS
    rep = lambda a: np.repeat(np.asarray(a)[None], N, 0)
    args = _t(rep(logits), rep(prop).astype(np.int32),
              np.full(N, temps, np.float32), np.full(N, topks, np.int32),
              np.full(N, topps, np.float32), np.full(N, kcap, np.int32))
    q = None if qprobs is None else torch.from_numpy(rep(qprobs))
    out, acc = tspec.speculative_accept(
        *args, torch.Generator().manual_seed(seed), qprobs=q)
    return out[:, 0].numpy(), acc.numpy()


def _target(logits, temps, topks, topps):
    return tgen.filtered_probs_rows(
        torch.from_numpy(logits[None]), torch.tensor([temps]),
        torch.tensor([topks], dtype=torch.int32),
        torch.tensor([topps]))[0].numpy()


@pytest.mark.parametrize("case", ["argmax_draft", "argmin_draft",
                                  "forced_stop", "filtered", "sampled_q"])
def test_sampled_accept_keeps_the_target_distribution(case):
    """Rejection sampling leaves the first emitted token distributed as the
    filtered target p, whatever was drafted: a likely draft, an unlikely
    one, a draft budget of 0 (no draft consumed), a top-k / top-p filtered
    target, and drafts sampled from a given non-one-hot q (the min(1, p/q)
    rule and the residual max(p - q, 0))."""
    rng = np.random.default_rng(2)
    V = 8
    logits = (rng.standard_normal((2, V)) * 1.5).astype(np.float32)  # k = 1
    temps, topks, topps, kcap = 1.0, 0, 0.0, 1
    if case == "filtered":
        temps, topks, topps = 0.8, 5, 0.9
    p = _target(logits[0], temps, topks, topps)
    qprobs = None
    if case == "sampled_q":
        qv = rng.dirichlet(np.ones(V)).astype(np.float32)
        qprobs = qv[None]                                  # (k, V)
        props = rng.choice(V, N_DRAWS, p=qv / qv.sum())
        N = N_DRAWS
        out, acc = tspec.speculative_accept(
            *_t(np.repeat(logits[None], N, 0), props[:, None].astype(np.int32),
                np.full(N, temps, np.float32), np.zeros(N, np.int32),
                np.zeros(N, np.float32), np.ones(N, np.int32)),
            torch.Generator().manual_seed(3),
            qprobs=torch.from_numpy(np.repeat(qprobs[None], N, 0)))
        toks = out[:, 0].numpy()
    else:
        prop = {"argmax_draft": p.argmax(), "argmin_draft": p.argmin(),
                "forced_stop": 3, "filtered": p.argmax()}[case]
        if case == "forced_stop":
            kcap = 0
        toks, acc = _first_tokens(logits, [prop], temps, topks, topps, kcap)
        if case == "forced_stop":
            assert int(acc.max()) == 0
    hist = np.bincount(toks, minlength=V) / N_DRAWS
    gap = np.abs(hist - p).max()
    assert gap < MAX_FREQ_GAP, (case, hist, p)
    if case == "filtered":
        assert hist[p == 0].sum() == 0          # filtered tokens never drawn


def test_sampled_accept_mixed_rows_keep_greedy_rows_exact():
    """A greedy row beside sampled rows in one call: its tokens are the
    greedy oracle's; a kcap of 0 on a sampled row accepts nothing."""
    logits, proposals, kcaps = _greedy_case(5, B=6)
    temps = np.array([0.0, 0.9, 0.0, 1.2, 0.7, 0.0], np.float32)
    kcaps[4] = 0
    out, acc = tspec.speculative_accept(
        *_t(logits, proposals, temps, np.zeros(6, np.int32),
            np.full(6, 0.9, np.float32), kcaps), torch.Generator())
    gout, gacc = tspec.speculative_accept(
        *_t(logits, proposals, np.zeros(6, np.float32),
            np.zeros(6, np.int32), np.zeros(6, np.float32), kcaps), None,
        greedy=True)
    for b in (0, 2, 5):
        assert int(acc[b]) == int(gacc[b])
        a = int(acc[b])
        assert out[b, :a + 1].tolist() == gout[b, :a + 1].tolist()
    assert int(acc[4]) == 0
    assert ((out >= 0) & (out < logits.shape[-1])).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_filtered_probs_rows_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, V = 6, 40
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    temps = np.array([1.0, 0.5, 0.8, 1.3, 0.0, 0.9], np.float32)
    topks = np.array([0, 5, 12, 0, 3, 50], np.int32)
    topps = np.array([0.0, 0.0, 0.9, 0.7, 0.5, 1.0], np.float32)
    want = np.asarray(jgen.filtered_probs_rows(*_j(logits, temps, topks,
                                                   topps)))
    got = tgen.filtered_probs_rows(*_t(logits, temps, topks, topps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _contexts(rng):
    """Repetitive and random contexts, contexts shorter than the n-gram,
    a context with no match, and continuations clamped at the end."""
    def motif(n, period):
        m = rng.integers(1, 100, period).tolist()
        return (m * (n // period + 1))[:n]

    return [motif(17, 5), rng.integers(1, 100, 31).tolist(), [3], [5, 6],
            [4, 4, 4, 4, 4], motif(40, 7), rng.integers(1, 5, 25).tolist(),
            [1, 2, 3, 50, 2, 3, 60, 1, 2, 3], [1, 2, 3, 4, 5, 6],
            [5, 6, 5], [9, 8, 7, 9, 8]]


@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_ngram_propose_device_equals_jax_and_host(seed, ngram):
    rng = np.random.default_rng(seed)
    max_n, min_n = ngram
    k, L = 4, 48
    contexts = _contexts(rng)
    B = len(contexts)
    buf = np.zeros((B, L), np.int32)
    pos = np.zeros((B,), np.int32)
    for i, c in enumerate(contexts):
        buf[i, :len(c)] = c
        pos[i] = len(c) - 1
    want = np.asarray(jspec.ngram_propose_device(
        *_j(buf, pos), k, max_ngram=max_n, min_ngram=min_n))
    got = tspec.ngram_propose_device(*_t(buf, pos), k, max_ngram=max_n,
                                     min_ngram=min_n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    d = tspec.NgramDrafter(max_ngram=max_n, min_ngram=min_n)
    for i, c in enumerate(contexts):
        assert got[i].tolist() == d.propose_one(c, k).tolist(), (i, c)
    # the batch host call: idle slots get zeros
    host, q = d.propose(contexts + [None], k)
    assert q is None and host[-1].tolist() == [0] * k
    np.testing.assert_array_equal(host[:-1], got.numpy())


def test_ngram_host_drafter_cases():
    """JAX's host-drafter cases, and the drafter's bounds checks."""
    for d in (tspec.NgramDrafter(3, 1), jspec.NgramDrafter(3, 1)):
        assert d.propose_one([7, 8, 9, 7, 8], 3).tolist() == [9, 7, 8]
        assert d.propose_one([5, 6, 5], 4).tolist() == [6, 5, 5, 5]
        assert d.propose_one([1, 2, 3, 4], 2).tolist() == [4, 4]
        assert d.propose_one([9], 2).tolist() == [9, 9]
        assert d.propose_one([1, 2, 3, 50, 2, 3, 60, 1, 2, 3],
                             1).tolist() == [50]
    for bad in ((2, 3), (2, 0)):
        with pytest.raises(ValueError, match="min_ngram"):
            tspec.NgramDrafter(*bad)
    assert tspec.NgramDrafter.fusible and tspec.NgramDrafter.deterministic
    assert not tspec.DraftModelDrafter.fusible


BAD_CONFIGS = [dict(k=0), dict(k=-1), dict(k=True), dict(k=1.5),
               dict(drafter="beam"), dict(drafter="model"),
               dict(ngram_max=1, ngram_min=2), dict(ngram_min=0),
               dict(gate_cooldown=-1), dict(gate_cooldown=True),
               dict(gate_cooldown=2.5), dict(gate_low=-0.5),
               dict(gate_low=float("nan")), dict(gate_ticks=0),
               dict(gate_ticks=-2), dict(gate_ticks=True),
               dict(turbo_windows=-1), dict(turbo_windows=True)]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: repr(kw))
def test_spec_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as je:
        jspec.SpecConfig(**kw).validate()
    with pytest.raises(ValueError) as te:
        tspec.SpecConfig(**kw).validate()
    assert str(te.value) == str(je.value)


def test_spec_config_defaults_describe_and_drafters():
    import dataclasses

    names = [f.name for f in dataclasses.fields(tspec.SpecConfig)]
    assert names == [f.name for f in dataclasses.fields(jspec.SpecConfig)]
    assert tspec.SpecConfig() == tspec.SpecConfig(
        **{f.name: f.default for f in dataclasses.fields(jspec.SpecConfig)})
    for kw in ({}, dict(k=3, gate_cooldown=0, turbo_windows=8)):
        tc, jc = tspec.SpecConfig(**kw), jspec.SpecConfig(**kw)
        tc.validate()
        assert tc.describe() == jc.describe()
    d = tspec.SpecConfig(ngram_max=4, ngram_min=2).build_drafter(64)
    assert isinstance(d, tspec.NgramDrafter)
    assert (d.max_ngram, d.min_ngram) == (4, 2)
    mine = tspec.NgramDrafter()
    assert tspec.SpecConfig(drafter=mine).build_drafter(64) is mine
    assert tspec.SpecConfig(drafter=mine).describe()["drafter"] == \
        "NgramDrafter"
