#!/usr/bin/env python3
"""Measure the weight-streaming kernels (w8_matmul, fused LoRA) of the
PyTorch/CUDA port on one NVIDIA card, against another tree or against
variants of their design. Needs the card and nvcc.

    python3 chip_stream_ab.py --parent DIR [--rounds 2]
    python3 chip_stream_ab.py --variants NAME[,NAME...] [--rounds 3]

``--parent DIR``: DIR is a checkout of another commit (e.g. ``git archive``
of the parent unpacked under an ignored directory). Each tree times its own
wrappers (``w8_matmul_cuda``, ``fused_lora_matmul_cuda``) at the serving
shapes of Llama-3-8B, in its own process, in the order parent, this, this,
parent (repeated ``--rounds`` times): device ms a call (CUDA graph of 50
calls, inputs cold in device memory) and the wrapper's host us a call.

``--variants``: builds ``w8_matmul.cu`` and ``fused_lora.cu`` of this tree
once as they are ("kept") and once per named variant (a design choice
undone or changed: ``VARIANTS``) into libraries under ``chiprun_out/ab``,
and times their C entry points on the same inputs in turns, ``--rounds``
rounds, after holding each variant's output to the kept kernel's within
the tolerance of ``chip_smoke.py`` phase 9.

Prints one JSON line per measurement and a summary line of medians.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# (name, M, K, N): the int8 tick's projections and lm-head at 8 rows; a
# prefill chunk's 128 rows at gate and down
W8_CASES = [("gate", 8, 4096, 14336), ("down", 8, 14336, 4096),
            ("q", 8, 4096, 4096), ("k", 8, 4096, 1024),
            ("lm_head", 8, 4096, 128256), ("gate", 128, 4096, 14336),
            ("down", 128, 14336, 4096)]
# (name, E, S, K, N): decode (8 entries of 1 row) and prefill (1 of 128)
LORA_CASES = [("gate", 8, 1, 4096, 14336), ("down", 8, 1, 14336, 4096),
              ("q", 8, 1, 4096, 4096), ("k", 8, 1, 4096, 1024),
              ("gate", 1, 128, 4096, 14336), ("down", 1, 128, 14336, 4096),
              ("q", 1, 128, 4096, 4096)]
LORA_PAGES = [1, 2, 3, 0, 1, 0, 3, 2]
RANK = 8

# name -> [(file under csrc, old text, new text)]: each variant changes one
# choice of the kept design
VARIANTS = {
    # the first plan: 128-column tiles unless clusters of 8 could not fill
    # the SMs, K splits aiming at one block an SM
    "plan_first": [("stream_tiles.cuh",
                    "p.wg = 4 * cdiv(N, 2 * kColBlock) * p.tok_tiles >= "
                    "3 * sms ? 2 : 1;",
                    "p.wg = cdiv(N, 2 * kColBlock) * p.tok_tiles * "
                    "kMaxCluster >= sms ? 2 : 1;"),
                   ("stream_tiles.cuh",
                    "int s = (p.tok <= 16 ? 2 : 1) * sms / "
                    "(p.col_tiles * p.tok_tiles);",
                    "int s = sms / (p.col_tiles * p.tok_tiles);")],
    # no K split (no cluster): one block an output tile
    "no_split": [("stream_tiles.cuh",
                  "if (s > kMaxCluster) s = kMaxCluster;",
                  "s = 1;")],
    # ring depth at a decode token tile: 6 stages (kept) against 4, 8 and
    # as many as fit 110 KB (8-14 for the 64-column and int8 tiles)
    "stages4": [("stream_gemm.cuh",
                 "kStages = kX <= 16 ? 6 : 4;", "kStages = 4;")],
    "stages8": [("stream_gemm.cuh", "kStages = kX <= 16 ? 6 : 4;",
                 "kStages = kX <= 16 ? 8 : 4;")],
    "stages_fit": [("stream_gemm.cuh",
                    "kStages = kX <= 16 ? 6 : 4;",
                    "kStages = kX > 16 ? 4 : (110 * 1024 - kConv) / kStage "
                    "/ 2 * 2 < 16 ? (110 * 1024 - kConv) / kStage / 2 * 2 "
                    ": 16;")],
    # int8 W fetched into the L2 without the 256-byte promotion
    "promo_none": [("stream_gemm.cuh",
                    "         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,\n"
                    "         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != "
                    "CUDA_SUCCESS)",
                    "         int8 ? CU_TENSOR_MAP_L2_PROMOTION_NONE\n"
                    "              : CU_TENSOR_MAP_L2_PROMOTION_L2_256B,\n"
                    "         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != "
                    "CUDA_SUCCESS)")],
    # an int8 64-column tile converted by one consumer warpgroup (not two
    # taking the stages in turn)
    "no_share": [("stream_gemm.cuh",
                  "static constexpr bool kShare = kInt8 && kWG == 1 && "
                  "kX <= 16;",
                  "static constexpr bool kShare = false;")],
    # the epilogue's sum over the cluster one addend load at a time
    "serial_cluster_sum": [("stream_gemm.cuh", "constexpr int kLoadBatch = 8;",
                            "constexpr int kLoadBatch = 1;")],
    # diagnostic, wrong results: the int8 codes left unconverted (the
    # products read a stale tile), to time the conversion
    "no_convert": [("stream_gemm.cuh",
                    "        convert_tile(sbase + stage(j) + cb * L::kWBlock, "
                    "sbase + off, tid);", "")],
    # fused LoRA's second launch without programmatic dependent launch
    "no_pdl": [("fused_lora.cu",
                "e = sg::launch<false>(tw, x, p, M, K, N, epi, true, s);",
                "e = sg::launch<false>(tw, x, p, M, K, N, epi, false, s);")],
}


# variants whose results are wrong by design: timed, not checked
DIAGNOSTIC = {"no_convert"}


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _card():
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 else "?"


def _inputs(torch, g, K, N, int8):
    w = (0.02 * torch.randn(K, N, generator=g, device="cuda")).to(
        torch.bfloat16)
    if not int8:
        return w, None
    from paddle_tpu_torch.ops import int8 as i8

    return i8.quantize_per_channel(w)


def _lora_factors(torch, g, K, N):
    A = torch.zeros(4, 2, K, RANK, device="cuda")
    B = torch.zeros(4, 2, RANK, N, device="cuda")
    for p, r in ((1, 8), (2, 8), (3, 4)):
        A[p, :, :, :r] = 0.02 * torch.randn(2, K, r, generator=g,
                                            device="cuda")
        B[p, :, :r] = 0.02 * torch.randn(2, r, N, generator=g, device="cuda")
    s = torch.tensor([0.0, 2.0, 1.0, 2.0], device="cuda")
    return A, B, s


def _smoke():
    """This tree's ``chip_smoke.py`` (timing helpers, tolerances), whatever
    tree the package is imported from."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_this", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure_tree(root: str) -> list:
    """Time the wrappers of the tree at ``root`` (run in its own process)."""
    sys.path.insert(0, root)
    import torch

    cs = _smoke()
    from paddle_tpu_torch.ops.fused_lora_cuda import fused_lora_matmul_cuda
    from paddle_tpu_torch.ops.int8_cuda import w8_matmul_cuda

    g = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for name, M, K, N in W8_CASES:
        if M > 16:
            continue        # the parent's kernel takes M <= 16
        wq, sc = _inputs(torch, g, K, N, True)
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)

        def fn():
            return w8_matmul_cuda(x, wq, sc)
        rows.append(dict(kernel="w8_matmul", shape=name, M=M, K=K, N=N,
                         ms=cs.time_ms(fn, 50, flush),
                         host_us=cs.host_us(torch, fn)))
    for name, E, S, K, N in LORA_CASES:
        w, _ = _inputs(torch, g, K, N, False)
        A, B, s = _lora_factors(torch, g, K, N)
        x = torch.randn(E, S, K, generator=g, device="cuda").to(
            torch.bfloat16)
        ai = torch.tensor(LORA_PAGES[:E], dtype=torch.int32, device="cuda")

        def fn():
            return fused_lora_matmul_cuda(x, w, A, B, s, 1, ai)
        rows.append(dict(kernel="fused_lora", shape=name, rows=E * S, K=K,
                         N=N, ms=cs.time_ms(fn, 50, flush),
                         host_us=cs.host_us(torch, fn)))
    return rows


def _build_variant(name, edits, out_dir):
    from paddle_tpu_torch.ops import _build

    src = os.path.join(out_dir, name, "csrc")
    shutil.rmtree(os.path.dirname(src), ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    for fname, old, new in edits:
        path = os.path.join(src, fname)
        text = open(path).read()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: '{old}' not found once in "
                             f"{fname}")
        open(path, "w").write(text.replace(old, new))
    nvcc = _build.find_nvcc()
    objs, procs = [], []
    for f in ("w8_matmul.cu", "fused_lora.cu"):
        obj = os.path.join(src, f + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-c", os.path.join(src, f), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {name}: nvcc failed:\n{text}")
    lib = os.path.join(src, "lib.so")
    subprocess.run([nvcc, "-shared", "-o", lib, *objs], check=True)
    dll = ctypes.CDLL(lib)
    for fn in ("pt_w8_matmul", "pt_fused_lora"):
        getattr(dll, fn).argtypes = list(_build.SIGNATURES[fn])
        getattr(dll, fn).restype = ctypes.c_int
    return dll


def measure_variants(names, rounds):
    sys.path.insert(0, HERE)
    import torch

    cs = _smoke()
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import int8 as i8
    from paddle_tpu_torch.ops.fused_lora_cuda import MAX_SLICES

    out_dir = os.path.join(HERE, "chiprun_out", "ab")
    t0 = time.perf_counter()
    libs = {"kept": _build_variant("kept", [], out_dir)}
    for n in names:
        libs[n] = _build_variant(n, VARIANTS[n], out_dir)
    print(json.dumps({"built": list(libs), "seconds":
                      time.perf_counter() - t0}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(9)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    def stream():          # the capturing stream while a graph records
        return torch.cuda.current_stream().cuda_stream

    calls = []
    for name, M, K, N in W8_CASES:
        wq, sc = _inputs(torch, g, K, N, True)
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        ref = i8._w8_plain(x, wq, sc)
        mag = (x.float().abs() @ wq.float().abs()) * sc

        def make(lib, x=x, wq=wq, sc=sc, M=M, K=K, N=N):
            out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
            return out, lambda: lib.pt_w8_matmul(
                x.data_ptr(), wq.data_ptr(), sc.data_ptr(), out.data_ptr(),
                M, K, N, stream())
        calls.append((f"w8 {name} M={M}", K, make, ref, mag))
    for name, E, S, K, N in LORA_CASES:
        from paddle_tpu_torch.nn import lora as tl

        w, _ = _inputs(torch, g, K, N, False)
        A, B, s = _lora_factors(torch, g, K, N)
        x = torch.randn(E, S, K, generator=g, device="cuda").to(
            torch.bfloat16)
        ai = torch.tensor(LORA_PAGES[:E], dtype=torch.int32, device="cuda")
        pooled = tl.PooledFactors(A, B, s, 1, ai)
        ref = tl._lora_plain(x, w, *pooled.gather())
        Ag, Bg, sg = pooled.gather()
        mag = (x.float().abs() @ w.float().abs() + torch.bmm(
            torch.bmm(x.float(), Ag).abs(), Bg.abs()) * sg[:, None, None])
        part = torch.empty(MAX_SLICES, E * S, RANK, device="cuda")

        def make(lib, x=x, w=w, A=A, B=B, s=s, ai=ai, part=part, E=E, S=S,
                 K=K, N=N):
            out = torch.empty(E, S, N, dtype=torch.bfloat16, device="cuda")
            return out, lambda: lib.pt_fused_lora(
                x.data_ptr(), w.data_ptr(), A.data_ptr() + K * RANK * 4,
                B.data_ptr() + RANK * N * 4, s.data_ptr(), ai.data_ptr(),
                out.data_ptr(), part.data_ptr(), E * S, K, N, RANK, S,
                2 * K * RANK, 2 * RANK * N, stream())
        calls.append((f"lora {name} rows={E * S}", K, make, ref, mag))
    times = {}
    for label, K, make, ref, mag in calls:
        fns = {}
        for v, lib in libs.items():
            print(json.dumps({"check": label, "variant": v}), flush=True)
            out, fn = make(lib)
            _build.check(fn(), f"{v} {label}")
            torch.cuda.synchronize()
            worst = cs._el_ratio(out, ref, mag, K).max().item()
            cs.check(worst <= 1.0 or v in DIAGNOSTIC,
                     f"{v} {label}: off by {worst:.3g} x the tolerance")
            fns[v] = fn
        for r in range(rounds):
            order = list(fns) if r % 2 == 0 else list(fns)[::-1]
            for v in order:
                ms = cs.time_ms(fns[v], 50, flush)
                times.setdefault((label, v), []).append(ms)
                print(json.dumps({"case": label, "variant": v, "round": r,
                                  "ms": ms}), flush=True)
    summary = {}
    for (label, v), ms in times.items():
        summary.setdefault(label, {})[v] = _median(ms)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another tree to time beside this one")
    ap.add_argument("--variants", help="comma-separated names of VARIANTS")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--measure", help=argparse.SUPPRESS)   # one tree's run
    args = ap.parse_args()
    if args.measure:
        print("ROWS " + json.dumps(measure_tree(args.measure)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    if args.variants:
        summary = measure_variants(args.variants.split(","),
                                   args.rounds or 3)
        print(json.dumps({"card": card, "variants": summary}), flush=True)
    if args.parent:
        runs = {"parent": [], "this": []}
        for _ in range(args.rounds or 2):
            for tree in ("parent", "this", "this", "parent"):
                root = os.path.abspath(args.parent) if tree == "parent" \
                    else HERE
                p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                    "--measure", root], capture_output=True,
                                   text=True, cwd=root)
                line = [ln for ln in p.stdout.splitlines()
                        if ln.startswith("ROWS ")]
                if p.returncode or not line:
                    print(p.stdout[-4000:], p.stderr[-4000:], flush=True)
                    return 1
                rows = json.loads(line[0][5:])
                print(json.dumps({"tree": tree, "rows": rows}), flush=True)
                runs[tree].append(rows)
        summary = []
        for i, row in enumerate(runs["this"][0]):
            key = {k: row[k] for k in row if k not in ("ms", "host_us")}
            summary.append(dict(key, **{
                f"{t}_{m}": _median([r[i][m] for r in runs[t]])
                for t in runs for m in ("ms", "host_us")}))
        print(json.dumps({"card": card, "parent_vs_this": summary}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
