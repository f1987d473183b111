#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card — the quickest proof that the port still builds and serves on the GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. Card: prints ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compiles the port's CUDA kernels from ``paddle_tpu_torch/ops/
   csrc`` with nvcc for sm_90a and prints the build time and each kernel's
   registers / spills.
3. Kernels against their plain PyTorch versions on the card, in bf16, at
   the serving path's shapes: RMSNorm at rows {8, 128} x 4096; paged
   attention in decode form (B=8, H=32, KV=8, D=128, bs=16, mixed context
   lengths with partial final blocks, a block boundary and a poisoned
   scratch block 0) and in prefill form (B=1, C=128 behind earlier
   chunks). Tolerances are per element (RMSNorm) or per output row
   (attention), and the attention tolerance is shown to reject a causal
   mask one key off either way. Each prints its max abs error and
   its time beside the plain version's, the bound (the least time the card
   could take) and one PyTorch library call of the same function
   (``library_ms``, a yardstick the port never calls).
4. Serve: Llama-3-8B at full width and depth with random bf16 weights made
   on the card from a seed, behind ``GenerationServer(cache="paged")``,
   answering 12 greedy requests through 8 slots; checks every request's
   length and that every decode tick and prefill chunk went through both
   kernels (counts reset just before, read just after). Then one decode
   tick and one prefill chunk are timed on the host clock and, replayed
   from a CUDA graph, on the device: their ratio is the device's idle
   share in an eager pass.
5. End to end: one request's first prefill chunk plus 4 decode ticks with
   the kernels and with the plain versions, in bf16, and with the plain
   versions on an fp32 copy of the weights: the kernels' logits may be at
   most 1.25 x as far from the fp32 ones as the plain bf16 path's, and may
   differ from the plain bf16 path's by a bounded share of the rms logit.

Kernel times are device times from CUDA graphs of many calls (so the
Python wrappers' host cost is left out); serving rates are host wall time
around work that ends in a copy of its result to the host.

The second-to-last line is a JSON object listing each kernel with its
launches on the main path and its measurements; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
# the served configuration (phase 4) and the block-table width it gives
MAX_BATCH, BLOCK_SIZE, PREFILL_CHUNK, MAX_LEN = 8, 16, 128, 2048
TABLE_WIDTH = MAX_LEN // BLOCK_SIZE + PREFILL_CHUNK // BLOCK_SIZE
# phase 5 limits (see end_to_end). On an H100 the kernels' logits were
# 1.01x (max) and 0.97x (rms) as far from fp32 as the plain bf16 path's,
# and the two bf16 paths differed by 0.060 of the rms logit (1.28); the
# run is deterministic, so the limits leave room only for another
# machine's library versions
DRIFT_RATIO = 1.25
GAP_FRACTION = 0.1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(p.returncode == 0, f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()[0]


def _graph_ms(torch, body, iters: int, replays: int = 5) -> float:
    """Device time of one CUDA-graph replay of ``iters`` calls of ``body``
    (median of ``replays``), in ms. A graph launches its kernels back to
    back, so the host-side cost of the Python wrappers stays out of it."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            body()
    g.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def time_ms(fn, iters: int = 50, flush=None) -> float:
    """Device time of one call of ``fn`` in ms: ``iters`` calls captured in
    a CUDA graph and replayed, timed with CUDA events. With ``flush`` (a
    tensor larger than the 50 MB L2) each call follows a rewrite of it, so
    every call finds its inputs cold in device memory as the serving path
    does; the graph of the rewrites alone is timed too and subtracted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # warm-up before capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if flush is None:
        return _graph_ms(torch, fn, iters) / iters

    def flushed():
        flush.zero_()
        fn()

    total = _graph_ms(torch, flushed, iters)
    return max(total - _graph_ms(torch, flush.zero_, iters), 0.0) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --------------------------------------------------------------- phase 3
def kernel_rms_norm(torch, fused_norm, cfg):
    from torch.nn import functional as F

    D, eps = cfg.hidden_size, cfg.rms_norm_eps
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for rows in (8, 128):
        x = torch.randn(rows, D, generator=g, device="cuda").to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(
            torch.bfloat16)
        y = fused_norm.rms_norm_cuda(x, w, eps)
        ref = fused_norm._rms_ref(x, w, eps)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y.float()).all()), "rms_norm: non-finite")
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        # kernel and plain version differ only in fp32 summation order and
        # rsqrt rounding, so each output element may land one bf16 step
        # (2^-7 of its magnitude) away: the tolerance is elementwise
        tol_el = 2.0 ** -7 * ref.float().abs() + 1e-6
        worst = (diff / tol_el).max().item()
        check(worst <= 1.0, f"rms_norm rows={rows}: an element is off by "
                            f"{worst:.3g} x its tolerance of one bf16 step")
        b, by = bound_ms(2 * (2 * rows * D + D), 4 * rows * D, FP32_FLOPS)
        case = dict(rows=rows, dim=D, max_abs_err=err,
                    worst_err_over_tol=worst,
                    ms=time_ms(lambda: fused_norm.rms_norm_cuda(x, w, eps),
                               200),
                    plain_ms=time_ms(lambda: fused_norm._rms_ref(x, w, eps),
                                     200),
                    bound_ms=b, bound_by=by,
                    library_ms=time_ms(lambda: F.rms_norm(x, (D,), w, eps),
                                       200))
        log(f"kernel rms_norm rows={rows}x{D} bf16: " + json.dumps(case))
        cases.append(case)
    return cases


def _paged_case(torch, g, B, W, H, KV, D, bs, pos, M):
    """Block-table case: blocks handed out in a scrambled order, tail
    entries of every row (M wide) left on scratch block 0, scratch poisoned
    with +-1e9."""
    need = [(p + W - 1) // bs + 1 for p in pos]
    check(M > max(need), "table too narrow for the case")
    N = sum(need) + 8
    kp = torch.randn(N, bs, KV, D, generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn(N, bs, KV, D, generator=g, device="cuda").to(torch.bfloat16)
    kp[0] = 1e9
    vp[0] = -1e9
    q = torch.randn(B, W, H, D, generator=g, device="cuda").to(torch.bfloat16)
    perm = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(2))
            + 1).tolist()
    tables = torch.zeros(B, M, dtype=torch.int32)
    took = 0
    for b in range(B):
        tables[b, :need[b]] = torch.tensor(perm[took:took + need[b]])
        took += need[b]
    return (q, kp, vp, tables.cuda(), torch.tensor(pos, dtype=torch.int32,
                                                   device="cuda"))


def kernel_paged_attention(torch, ops, pa, cfg):
    from torch.nn import functional as F

    from paddle_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda

    H, KV, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    bs = BLOCK_SIZE
    g = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cases = []
    # decode: position of the new token per row — mid-block, a block
    # boundary on each side (511 ends block 31, 512 opens block 32), long
    # contexts and a short one (6 keys, where one key more or less moves
    # the output far past the tolerance)
    forms = [("decode", 8, 1, [1000, 511, 512, 255, 37, 700, 128, 5]),
             ("prefill", 1, 128, [384])]
    for form, B, W, pos in forms:
        q, kp, vp, tables, posv = _paged_case(torch, g, B, W, H, KV, D, bs,
                                              pos, TABLE_WIDTH)
        out = paged_attention_cuda(q, kp, vp, tables, posv)
        ops.set_kernel_mode("reference")
        ref = pa.paged_verify_attention(q, kp, vp, tables, posv)
        ops.set_kernel_mode("auto")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()),
              f"paged_attention {form}: non-finite output (scratch leaked?)")
        err = (out.float() - ref.float()).abs().max().item()
        # Tolerance per output row (b, w, h), scaled to what is compared:
        # each output is rounded to bf16 once on either side, which may
        # leave them one bf16 step apart (2^-7 x the row's largest value);
        # p is rounded to bf16 at another scale than in the plain version
        # (unnormalised per 64-key chunk vs normalised), a relative error
        # of at most 2^-8 per key that averages out over the keys: 2^-8 x
        # rms(V) bounds its sum even for a row with a single key
        rms_v = vp[1:].float().square().mean().sqrt().item()
        tol_row = (2.0 ** -7 * ref.float().abs().amax(-1)
                   + 2.0 ** -8 * rms_v)

        def row_ratio(o):
            return (o.float() - ref.float()).abs().amax(-1) / tol_row

        worst_k = row_ratio(out).max().item()
        check(worst_k <= 1.0, f"paged_attention {form}: a row is off by "
                              f"{worst_k:.3g} x its tolerance")
        # the tolerance must reject the faults a kernel plausibly has: the
        # causal frontier one key too far or too short (plain version with
        # qpos +- 1). Scratch block 0 gets ordinary values for this, so
        # that a key read past a row's last block is a plausible key, not
        # the poison
        kc, vc = kp.clone(), vp.clone()
        kc[0], vc[0] = kp[1], vp[1]
        ck = pa.gather_block_kv(kc, tables)
        cv = pa.gather_block_kv(vc, tables)
        qpos = posv.long()[:, None] + torch.arange(W, device="cuda")[None]
        mutants = {}
        for d in (1, -1):
            r = row_ratio(pa._attention_core(q, ck, cv, qpos + d))
            mutants[f"mask{d:+d}"] = dict(
                worst_err_over_tol=r.max().item(),
                rows_failed=(r > 1.0).float().mean().item())
        del kc, vc
        for name, m in mutants.items():
            check(m["worst_err_over_tol"] > 1.0,
                  f"paged_attention {form}: the tolerance passes the {name} "
                  f"fault ({m['worst_err_over_tol']:.3g} x tolerance)")
        # bytes this data needs: q and out once, each visible K/V row once
        ctx = [p + W for p in pos]                 # keys of the last row
        kv_bytes = sum(c * KV * D * 2 * 2 for c in ctx)
        nbytes = 2 * q.numel() * 2 + kv_bytes + tables.numel() * 4 + B * 4
        # QK and PV: 2 flops per multiply-add, each query row over its
        # visible keys
        vis = sum(p + w + 1 for p in pos for w in range(W))
        flops = 4 * D * H * vis
        b, by = bound_ms(nbytes, flops, BF16_FLOPS)
        # library yardstick: SDPA over the gathered dense K/V (GQA heads
        # expanded, boolean position mask), gathered outside the timing
        ck = ck.repeat_interleave(H // KV, 2)
        cv = cv.repeat_interleave(H // KV, 2)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, ck, cv))
        L = ck.shape[1]
        mask = (torch.arange(L, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]

        def plain():
            ops.set_kernel_mode("reference")
            pa.paged_verify_attention(q, kp, vp, tables, posv)
            ops.set_kernel_mode("auto")

        case = dict(form=form, B=B, W=W, H=H, KV=KV, D=D, block_size=bs,
                    pos=pos, max_abs_err=err, worst_err_over_tol=worst_k,
                    mutants=mutants,
                    ms=time_ms(lambda: paged_attention_cuda(q, kp, vp, tables,
                                                            posv), 50, flush),
                    plain_ms=time_ms(plain, 20, flush),
                    bound_ms=b, bound_by=by,
                    library_ms=time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qs, ks, vs, attn_mask=mask), 50, flush))
        log(f"kernel paged_attention {form} bf16: " + json.dumps(case))
        cases.append(case)
    return cases


# --------------------------------------------------------------- phase 4
def serve(torch, ops, model):
    import numpy as np

    from paddle_tpu_torch.inference.serving import GenerationServer

    cfg = model.cfg
    srv = GenerationServer(model, cache="paged", max_batch=MAX_BATCH,
                           block_size=BLOCK_SIZE, prefill_chunk=PREFILL_CHUNK,
                           max_len=MAX_LEN)
    check(srv._table_width == TABLE_WIDTH, "block-table width")
    # warm-up request (cuBLAS handles, allocator): not part of the run
    srv.submit(list(range(1, 40)), max_new_tokens=4)
    srv.run()
    rng = np.random.default_rng(0)
    # 12 requests > 8 slots: slots refill mid-flight; lengths span 1-8
    # chunks of 128, some ending mid-block, two on a chunk boundary
    lens = [100, 1000, 517, 256, 733, 129, 384, 960, 211, 640, 300, 871]
    news = rng.integers(32, 65, len(lens)).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    t_before = srv.throughput_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    out = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    t_after = srv.throughput_stats()
    st = {k: t_after[k] - t_before[k] for k in t_after}
    for rid, p, m in zip(rids, prompts, news):
        check(rid in out, f"request {rid} did not finish")
        toks = out[rid]
        check(toks[:len(p)] == p and len(toks) == len(p) + m,
              f"request {rid}: {len(toks)} tokens, want {len(p) + m}")
        check(all(0 <= t < cfg.vocab_size for t in toks[len(p):]),
              f"request {rid}: token id out of range")
    passes = st["decode_ticks"] + st["prefill_chunks"]
    L = cfg.num_hidden_layers
    # every decode tick and prefill chunk: one attention per layer, two
    # norms per layer plus the final norm
    check(launches["paged_attention"] == L * passes,
          f"paged_attention launches {launches['paged_attention']} != "
          f"{L} x {passes} model passes")
    check(launches["rms_norm"] == (2 * L + 1) * passes,
          f"rms_norm launches {launches['rms_norm']} != {2 * L + 1} x "
          f"{passes} model passes")
    res = dict(requests=len(rids), wall_s=wall,
               prefill_tokens=st["prefill_tokens"],
               prefill_chunks=st["prefill_chunks"],
               prefill_tok_s=st["prefill_tokens"] / st["prefill_s"],
               decode_ticks=st["decode_ticks"],
               decode_tokens=st["decode_tokens"],
               decode_tok_s=st["decode_tokens"] / st["decode_s"],
               ms_per_decode_tick=st["decode_s"] / st["decode_ticks"] * 1e3,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    log("serve llama3-8b paged: " + json.dumps(res))
    res["breakdown"] = pass_breakdown(torch, srv)
    return res, max(prompts, key=len)


def pass_breakdown(torch, srv):
    """Host against device time of one decode tick (every slot at 512
    tokens of context) and one 128-token prefill chunk (behind 384 tokens)
    through the server's executor: eager wall time (host clock up to a
    synchronize), the host's enqueue time (the call's return, before the
    device is done), and the device time of the same work replayed from a
    CUDA graph, with no host in the loop. Run after the served requests
    have finished, on blocks of the server's pool."""
    import statistics

    ex = srv._exec
    B, bs, C = srv.max_batch, srv.block_size, srv.prefill_chunk
    ctx, start = 512, 384
    nblk = ctx // bs + 1
    tables = torch.zeros(B, srv._table_width, dtype=torch.int32)
    for b in range(B):
        tables[b, :nblk] = torch.arange(1 + b * nblk, 1 + (b + 1) * nblk)
    tables = tables.cuda()
    pos = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    toks = torch.ones(B, dtype=torch.long, device="cuda")
    chunk = torch.ones(1, C, dtype=torch.long, device="cuda")

    def tick():
        return ex.decode_paged(toks, tables, pos, None, None, None,
                               greedy=True, generator=None)

    def prefill():
        return ex.chunk_prefill(chunk, tables[0], start, C - 1)

    res = {}
    for name, fn in (("decode_tick", tick), ("prefill_chunk", prefill)):
        fn()
        torch.cuda.synchronize()
        walls, enq = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            enq.append(t1 - t0)
        wall = statistics.median(walls) * 1e3
        device = time_ms(fn, iters=3)
        res[name] = dict(wall_ms=wall,
                         host_enqueue_ms=statistics.median(enq) * 1e3,
                         device_ms=device,
                         device_idle_share=max(0.0, 1.0 - device / wall))
    log("pass breakdown (host vs device): " + json.dumps(res))
    return res


# --------------------------------------------------------------- phase 5
def end_to_end(torch, ops, model, prompt):
    """First prefill chunk + 4 decode ticks of one request, run three times
    on fresh pools with the same tokens fed: bf16 with the kernels, bf16
    with the plain versions, and the plain versions on an fp32 copy of the
    same weights (the yardstick for bf16 rounding)."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = model.cfg
    C, bs, ticks = PREFILL_CHUNK, BLOCK_SIZE, 4
    nblk = (C + ticks) // bs + 2
    table = torch.arange(1, nblk + 1, dtype=torch.int32, device="cuda")
    shape = (nblk + 1, bs, cfg.num_key_value_heads, cfg.head_dim)

    def run(m, mode, feed):
        ops.set_kernel_mode(mode)
        dt = m.cfg.torch_dtype
        pools = [(torch.zeros(shape, dtype=dt, device="cuda"),
                  torch.zeros(shape, dtype=dt, device="cuda"))
                 for _ in range(cfg.num_hidden_layers)]
        ids = torch.tensor([prompt[:C]], device="cuda")
        with torch.no_grad():
            h, _ = m.model.paged_prefill_chunk(ids, pools, table, 0)
            logits = [m.head(h[:, -1:])[:, 0].float()]
            toks = []
            for t in range(ticks):
                tok = feed[t] if feed else int(logits[-1].argmax())
                toks.append(tok)
                h, _ = m.model.paged_decode_step(
                    torch.tensor([[tok]], device="cuda"), pools, table[None],
                    torch.tensor([C + t], dtype=torch.int32, device="cuda"))
                logits.append(m.head(h)[:, 0].float())
        ops.set_kernel_mode("auto")
        return torch.cat(logits), toks

    lk, toks = run(model, "auto", None)
    lr, _ = run(model, "reference", toks)
    # full-fp32 products for the yardstick (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    m32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                           device="cuda")
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), model.parameters()):
            p32.copy_(p16)                  # exact widening of bf16
    lf, _ = run(m32, "reference", toks)
    del m32
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(lk).all()), "end to end: non-finite logits")
    check(tuple(lk.shape) == (ticks + 1, cfg.vocab_size), "end to end: shape")
    # The kernels round to bf16 in other places than the plain versions (p
    # before PV unnormalised, summation order), so over 32 layers the two
    # bf16 paths drift apart; neither is the exact answer. The fp32 run of
    # the same weights is: the kernels' path may not be farther from it
    # than the plain bf16 path is, by more than DRIFT_RATIO, in the largest
    # and in the rms logit error; and the two bf16 paths may differ by at
    # most GAP_FRACTION of the rms logit.
    def rms(t):
        return t.square().mean().sqrt().item()

    res = dict(max_abs_logit_diff=(lk - lr).abs().max().item(),
               rms_logit_diff=rms(lk - lr),
               plain_bf16_vs_fp32_max=(lr - lf).abs().max().item(),
               kernels_bf16_vs_fp32_max=(lk - lf).abs().max().item(),
               plain_bf16_vs_fp32_rms=rms(lr - lf),
               kernels_bf16_vs_fp32_rms=rms(lk - lf),
               max_abs_logit=lf.abs().max().item(), rms_logit=rms(lf),
               argmax_agree_kernels_plain=int(
                   (lk.argmax(-1) == lr.argmax(-1)).sum()),
               positions=ticks + 1)
    res["drift_ratio_max"] = (res["kernels_bf16_vs_fp32_max"]
                              / res["plain_bf16_vs_fp32_max"])
    res["drift_ratio_rms"] = (res["kernels_bf16_vs_fp32_rms"]
                              / res["plain_bf16_vs_fp32_rms"])
    res["gap_fraction"] = res["rms_logit_diff"] / res["rms_logit"]
    log("end_to_end kernels vs plain vs fp32: " + json.dumps(res))
    for key in ("drift_ratio_max", "drift_ratio_rms"):
        check(res[key] <= DRIFT_RATIO, f"end to end: the kernels drift from "
              f"fp32 {res[key]:.3g} x as far as the plain bf16 path "
              f"(limit {DRIFT_RATIO})")
    check(res["gap_fraction"] <= GAP_FRACTION,
          f"end to end: kernels and plain versions differ by "
          f"{res['gap_fraction']:.3g} of the rms logit (limit {GAP_FRACTION})")
    return res


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print(f"FAIL: no paddle_tpu_torch package beside {__file__}: run "
              f"the script from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.ops import _build, fused_norm
    from paddle_tpu_torch.ops import paged_attention as pa

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(compiled {_build.BUILD_INFO['compiled']})")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "==" in line:
            log("  " + line.strip())

    cfg = llama3_8b_config()
    rms_cases = kernel_rms_norm(torch, fused_norm, cfg)
    attn_cases = kernel_paged_attention(torch, ops, pa, cfg)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg)   # on the card, seeded
    torch.cuda.synchronize()
    log(f"model: llama3-8b {sum(p.numel() for p in model.parameters())} "
        f"params bf16, made on the card in {time.perf_counter() - t0:.1f} s")
    serve_res, prompt = serve(torch, ops, model)
    e2e = end_to_end(torch, ops, model, prompt)

    def entry(name, source, replaces, cases):
        main_case = cases[0]      # the decode-shape case
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces,
                    launches=serve_res["launches"][name],
                    max_abs_err=max(c["max_abs_err"] for c in cases),
                    ms=main_case["ms"], plain_ms=main_case["plain_ms"],
                    bound_ms=main_case["bound_ms"],
                    bound_by=main_case["bound_by"],
                    library_ms=main_case["library_ms"], cases=cases)

    kernels = [
        entry("paged_attention", "paddle_tpu_torch/ops/csrc/paged_attention.cu",
              "paddle_tpu/ops/paged_attention_pallas.py:253", attn_cases),
        entry("rms_norm", "paddle_tpu_torch/ops/csrc/rms_norm.cu",
              "paddle_tpu/ops/fused_norm.py:84", rms_cases),
    ]
    # the run's serving, breakdown and end-to-end readings once more, so
    # that they stand in the last lines of the output beside the kernels
    breakdown = serve_res.pop("breakdown")
    log("serve llama3-8b paged: " + json.dumps(serve_res))
    log("pass breakdown (host vs device): " + json.dumps(breakdown))
    log("end_to_end kernels vs plain vs fp32: " + json.dumps(e2e))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
