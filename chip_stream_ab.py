#!/usr/bin/env python3
"""Measure the weight-streaming kernels (w8_matmul, fused LoRA), the paged
attention kernel and the whole-tick decode kernel of the PyTorch/CUDA port
on one NVIDIA card, against another tree or against variants of their
design. Needs the card and nvcc.

    python3 chip_stream_ab.py --parent DIR [--rounds 2] [--only paged]
    python3 chip_stream_ab.py --parent DIR --only tick
    python3 chip_stream_ab.py --variants NAME[,NAME...] [--rounds 3]

``--parent DIR``: DIR is a checkout of another commit (e.g. ``git archive``
of the parent unpacked under an ignored directory). Each tree times its own
wrappers (``w8_matmul_cuda``, ``fused_lora_matmul_cuda``,
``paged_attention_cuda``, ``paged_attention_int8_cuda``) at the serving
shapes of Llama-3-8B (paged attention: every case of this tree's
``chip_smoke.PAGED_FORMS``, fp and int8 pools), in its own process, in the
order parent, this, this, parent (repeated ``--rounds`` times): device ms a
call (CUDA graph of 50 calls, inputs cold in device memory) and the
wrapper's host us a call. ``--only`` takes some of the families
(``w8``, ``lora``, ``paged``; ``tick``, not in the default: the
``decode_tick_cuda`` wrapper of each variant of ``chip_smoke.MK_VARIANTS``
at Llama-3-8B's full depth with seeded random weights, B = 8, W = 1 and 4,
on ``chip_smoke.py`` phase 13's inputs; device ms of 5 ticks a graph;
``paged_long``, not in the default: the paged attention wrappers at
``LONG_FORMS``, short rows in a table as wide as a server of ``max_len``
8192 gives them).

``--variants``: builds ``w8_matmul.cu``, ``fused_lora.cu`` and
``paged_attention.cu`` of this tree once as they are ("kept") and once per
named variant (a design choice undone or changed: ``VARIANTS``) into
libraries under the ignored output directory (``ab/``), and times their C
entry points on the same inputs in turns, ``--rounds`` rounds, after
holding each variant's output to the plain version within the tolerances
of ``chip_smoke.py`` phases 3 and 9 (only the families a variant changes
are built and timed).

Prints one JSON line per measurement and a summary line of medians.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys
import time

# the paged attention wrappers' module (the package exports a function
# of the same name, so it is imported by its full name)
PAGED_WRAPPERS = "paddle_tpu_torch.ops.paged_attention_cuda"
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
# (form, B, W, pos): decode and a k = 4 verify window at 512 keys a row,
# and decode at phase 3's mixed lengths, in the block table of a server of
# max_len 8192 (block 16, chunk 128: 520 entries a row)
LONG_FORMS = [("decode_512_table_8192", 8, 1, [512] * 8),
              ("verify5_512_table_8192", 8, 5, [512] * 8),
              ("decode_mixed_table_8192", 8, 1,
               [1000, 511, 512, 255, 37, 700, 128, 5])]
LONG_TABLE_WIDTH = 8192 // 16 + 128 // 16
RANK = 8

# name -> [(file under csrc, old text, new text)]: each variant changes one
# choice of the kept design
VARIANTS = {
    # the first plan: 128-column tiles unless clusters of 8 could not fill
    # the SMs, K splits aiming at one block an SM
    "plan_first": [("stream_tiles.cuh",
                    "return 4 * cdiv(N, 2 * kColBlock) >= 3 * sms ? 2 : 1;",
                    "return cdiv(N, 2 * kColBlock) * kMaxCluster >= sms ? "
                    "2 : 1;"),
                   ("stream_tiles.cuh",
                    "int s = 2 * sms / cdiv(N, col_wg(N, sms) * kColBlock);",
                    "int s = sms / cdiv(N, col_wg(N, sms) * kColBlock);")],
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
                  "static constexpr bool kShare = kInt8 && kWG == 1;",
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
                "e = sg::launch<false, false>(tw, x, p, M, K, N, epi, true, "
                "s);",
                "e = sg::launch<false, false>(tw, x, p, M, K, N, epi, false, "
                "s);")],
    # paged attention: a row's split keys sized from its own keys to one
    # wave of units were half the rows as long, at least 128 (kept); fixed at 128 or 256; at least
    # 256; no split at all (one block walks a tile's keys)
    "pa_fixed128": [("paged_tiles.cuh",
                     "  return ks > p.split_keys ? static_cast<int>(ks) : "
                     "p.split_keys;", "  return p.split_keys;")],
    "pa_fixed256": [("paged_tiles.cuh",
                     "  return ks > p.split_keys ? static_cast<int>(ks) : "
                     "p.split_keys;", "  return p.split_keys;"),
                    ("paged_tiles.cuh", "kSplitKeys = 128;",
                     "kSplitKeys = 256;")],
    "pa_min256": [("paged_tiles.cuh", "kSplitKeys = 128;",
                   "kSplitKeys = 256;")],
    # a row's split keys sized as if every row, a quarter of them or none
    # of the others were as long as it, not half (kept): up to 1, 4 or B
    # waves of units when every row is long
    "pa_rows_all": [("paged_tiles.cuh",
                     "  return split_keys_for(keys * ((B + 1) / 2), KV, p, "
                     "wave);",
                     "  return split_keys_for(keys * B, KV, p, wave);")],
    "pa_rows_quarter": [("paged_tiles.cuh",
                         "  return split_keys_for(keys * ((B + 1) / 2), KV, "
                         "p, wave);",
                         "  return split_keys_for(keys * ((B + 3) / 4), KV, "
                         "p, wave);")],
    "pa_row_alone": [("paged_tiles.cuh",
                      "  return split_keys_for(keys * ((B + 1) / 2), KV, p, "
                      "wave);",
                      "  return split_keys_for(keys, KV, p, wave);")],
    "pa_no_split": [("paged_tiles.cuh", "kSplitKeys = 128;",
                     "kSplitKeys = 1 << 16;")],
    # a block a work unit (no persistent grid of one wave)
    "pa_grid_all": [("paged_attention.cu",
                     "const int grid = pt::work_blocks(p, w);",
                     "const int grid = static_cast<int>(p.units);")],
    # the combine pass launched after the attention grid (no programmatic
    # dependent launch)
    "pa_no_pdl": [("paged_attention.cu", "  cfg.numAttrs = 1;",
                   "  cfg.numAttrs = 0;")],
    # registers a thread: consumers 216, producers 40 (208 / 48 kept)
    "pa_regs_216": [("paged_attention.cu",
                     "kConsumerRegs = 208, kProducerRegs = 48;",
                     "kConsumerRegs = 216, kProducerRegs = 40;")],
    # diagnostic, wrong results: the combine pass left out, to time it
    "pa_no_combine": [("paged_attention.cu",
                       "if (e != cudaSuccess || p.splits == 1) return (int)e;",
                       "return (int)e;")],
}

# the sources each family builds from, and its C entry points
FAMILIES = {"w8": (("w8_matmul.cu",), ("pt_w8_matmul",)),
            "lora": (("fused_lora.cu",), ("pt_fused_lora",)),
            "paged": (("paged_attention.cu",),
                      ("pt_paged_attention", "pt_paged_attention_int8",
                       "pt_paged_plan", "pt_paged_attention_config"))}


def _families(edits):
    """The families whose sources a variant's edits touch (a shared header
    touches every family that includes it)."""
    touched = {f for f, _, _ in edits}
    out = []
    for fam, (srcs, _) in FAMILIES.items():
        text = "".join(open(os.path.join(HERE, "paddle_tpu_torch", "ops",
                                         "csrc", f)).read() for f in srcs)
        if touched & set(srcs) or any(f'"{h}"' in text for h in touched):
            out.append(fam)
    return out


# variants whose results are wrong by design: timed, not checked
DIAGNOSTIC = {"no_convert", "pa_no_combine"}


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


def _paged_inputs(torch, cs, g, form, B, W, pos, quant, width=None):
    """One case of ``PAGED_FORMS`` as chip_smoke.py phases 3 and 9 make it,
    in a block table ``width`` entries wide (the served one by default):
    (the wrapper's arguments, rms of V for the tolerance)."""
    H, KV, D = 32, 8, 128
    q, kp, vp, tables, posv = cs._paged_case(torch, g, B, W, H, KV, D,
                                             cs.BLOCK_SIZE, pos,
                                             width or cs.TABLE_WIDTH)
    if not quant:
        return (q, kp, vp, tables, posv), \
            vp[1:].float().square().mean().sqrt().item()
    from paddle_tpu_torch.ops import paged_attention as pa

    kq, ks = pa.quantize_block_kv(kp)
    vq, vs = pa.quantize_block_kv(vp)
    kq[0], vq[0] = 127, -127
    ks[0], vs[0] = 1e9, 1e9
    rms_v = pa.dequantize_block_kv(vq[1:], vs[1:]).square().mean().sqrt() \
        .item()
    return (q, kq, ks, vq, vs, tables, posv), rms_v


def measure_tree(root: str, families) -> list:
    """Time the wrappers of the tree at ``root`` (run in its own process)."""
    sys.path.insert(0, root)
    import torch

    cs = _smoke()
    g = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for name, M, K, N in W8_CASES if "w8" in families else ():
        from paddle_tpu_torch.ops.int8_cuda import w8_matmul_cuda

        if M > 16:
            continue        # the parent's kernel takes M <= 16
        wq, sc = _inputs(torch, g, K, N, True)
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)

        def fn():
            return w8_matmul_cuda(x, wq, sc)
        rows.append(dict(kernel="w8_matmul", shape=name, M=M, K=K, N=N,
                         ms=cs.time_ms(fn, 50, flush),
                         host_us=cs.host_us(torch, fn)))
    for name, E, S, K, N in LORA_CASES if "lora" in families else ():
        from paddle_tpu_torch.ops.fused_lora_cuda import \
            fused_lora_matmul_cuda

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
    paged = [(form, None) for form in cs.PAGED_FORMS
             if "paged" in families]
    paged += [(form, LONG_TABLE_WIDTH) for form in LONG_FORMS
              if "paged_long" in families]
    for quant in (False, True) if paged else ():
        pac = importlib.import_module(PAGED_WRAPPERS)

        wrapper = pac.paged_attention_int8_cuda if quant else \
            pac.paged_attention_cuda
        for (form, B, W, pos), width in paged:
            args, _ = _paged_inputs(torch, cs, g, form, B, W, pos, quant,
                                    width)

            def fn():
                return wrapper(*args)
            rows.append(dict(kernel="paged_attention_int8" if quant
                             else "paged_attention", shape=form, B=B, W=W,
                             ms=cs.time_ms(fn, 50, flush),
                             host_us=cs.host_us(torch, fn)))
            del args
    if "tick" in families:
        rows += _measure_ticks(torch, cs, g)
    return rows


def _measure_ticks(torch, cs, g) -> list:
    """The tree's ``decode_tick_cuda`` at full depth, each variant at W = 1
    and 4 ("tile" at W = 1), as chip_smoke.py phase 13 times it."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.ops import decode_megakernel as mk
    from paddle_tpu_torch.ops.decode_megakernel_cuda import decode_tick_cuda

    model = LlamaForCausalLM(llama3_8b_config())
    cfg, L = model.cfg, model.cfg.num_hidden_layers
    weights = mk.stack_layer_weights(model)
    rows = []
    for name, quant, dequant, with_lora in cs.MK_VARIANTS:
        for W in (1, 4):
            if name == "int8_tile" and W == 4:
                continue
            x, pools, tables, pos, cosr, sinr = cs._tick_inputs(
                torch, model, g, L, W, quant)
            for pl in pools:
                pl[0] = 0
            kw = dict(eps=cfg.rms_norm_eps, dequant=dequant,
                      lora=cs._tick_lora(torch, cfg, L, g) if with_lora
                      else None)

            def fn():
                return decode_tick_cuda(x, pools, tables, pos, weights, cosr,
                                        sinr, **kw)
            with torch.no_grad():
                rows.append(dict(kernel="decode_tick", shape=name, W=W,
                                 ms=cs.time_ms(fn, 5),
                                 host_us=cs.host_us(torch, fn, 20)))
            del x, pools, kw
            torch.cuda.empty_cache()
    return rows


def _start_variant(name, edits, out_dir, families):
    """Copy this tree's sources with a variant's edits and start one nvcc
    a source of the families (all variants' builds run together)."""
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
    procs = []
    for f in (src_ for fam in families for src_ in FAMILIES[fam][0]):
        obj = os.path.join(src, f + ".o")
        procs.append((obj, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-c", os.path.join(src, f), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return name, src, procs


def _finish_variant(started, families):
    """Link a started variant's objects and load the library."""
    from paddle_tpu_torch.ops import _build

    name, src, procs = started
    for obj, p in procs:
        text, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {name}: nvcc failed:\n{text}")
        with open(obj + ".log", "w") as f:     # ptxas lines, for reading
            f.write(text)
    lib = os.path.join(src, "lib.so")
    subprocess.run([_build.find_nvcc(), "-shared", "-o", lib,
                    *(obj for obj, _ in procs)], check=True)
    dll = ctypes.CDLL(lib)
    for fn in (fn for fam in families for fn in FAMILIES[fam][1]):
        getattr(dll, fn).argtypes = list(_build.SIGNATURES[fn])
        getattr(dll, fn).restype = ctypes.c_int
    return dll


def measure_variants(names, rounds):
    sys.path.insert(0, HERE)
    import torch

    cs = _smoke()
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import int8 as i8
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.fused_lora_cuda import MAX_SLICES

    families = sorted({f for n in names for f in _families(VARIANTS[n])})
    out_dir = os.path.join(HERE, "chiprun_out", "ab")
    t0 = time.perf_counter()
    started = [_start_variant("kept", [], out_dir, families)] + [
        _start_variant(n, VARIANTS[n], out_dir, families) for n in names]
    libs = {st[0]: _finish_variant(st, families) for st in started}
    print(json.dumps({"built": list(libs), "families": families, "seconds":
                      time.perf_counter() - t0}), flush=True)
    if "paged" in families:
        from paddle_tpu_torch.ops.paged_attention_cuda import _CONFIG_KEYS

        for v, lib in libs.items():      # registers, local bytes, blocks
            for quant in (0, 1):
                vals = (ctypes.c_int * 8)()
                _build.check(lib.pt_paged_attention_config(quant, vals),
                             f"{v} config")
                print(json.dumps({"variant": v, "int8": quant,
                                  **dict(zip(_CONFIG_KEYS, vals))}),
                      flush=True)
    g = torch.Generator(device="cuda").manual_seed(9)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    def stream():          # the capturing stream while a graph records
        return torch.cuda.current_stream().cuda_stream

    # (label, make(lib) -> (out, fn), ratio(out) -> worst error / tolerance)
    calls = []
    for name, M, K, N in W8_CASES if "w8" in families else ():
        wq, sc = _inputs(torch, g, K, N, True)
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        ref = i8._w8_plain(x, wq, sc)
        mag = (x.float().abs() @ wq.float().abs()) * sc

        def make(lib, x=x, wq=wq, sc=sc, M=M, K=K, N=N):
            out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
            return out, lambda: lib.pt_w8_matmul(
                x.data_ptr(), wq.data_ptr(), sc.data_ptr(), out.data_ptr(),
                M, K, N, stream())
        calls.append((f"w8 {name} M={M}", make,
                      lambda o, ref=ref, mag=mag, K=K:
                      cs._el_ratio(o, ref, mag, K).max().item()))
    for name, E, S, K, N in LORA_CASES if "lora" in families else ():
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
        calls.append((f"lora {name} rows={E * S}", make,
                      lambda o, ref=ref, mag=mag, K=K:
                      cs._el_ratio(o, ref, mag, K).max().item()))
    for quant in (False, True) if "paged" in families else ():
        pac = importlib.import_module(PAGED_WRAPPERS)

        for form, B, W, pos in cs.PAGED_FORMS:
            args, rms_v = _paged_inputs(torch, cs, g, form, B, W, pos, quant)
            cs_plain = pa.paged_verify_attention_q if quant else \
                pa.paged_verify_attention
            from paddle_tpu_torch import ops
            ops.set_kernel_mode("reference")
            ref = cs_plain(*args)
            ops.set_kernel_mode("auto")
            H, KV, D = 32, 8, 128
            N, bs = args[1].shape[:2]
            M = cs.TABLE_WIDTH

            def make(lib, args=args, B=B, W=W, N=N, bs=bs, M=M,
                     quant=quant):
                vals = (ctypes.c_int * 7)()
                _build.check(lib.pt_paged_plan(B, W, H, KV, bs, M, vals),
                             "plan")
                p = dict(zip(pac._PLAN_KEYS, vals))
                out = torch.empty_like(args[0])
                ws = [torch.empty((B, KV, p["splits"], p["rows"], last),
                                  dtype=torch.float32, device="cuda")
                      for last in (D, 2)] if p["splits"] > 1 else [None] * 2
                ptr = [t.data_ptr() if t is not None else None for t in ws]
                a = [t.data_ptr() for t in args]
                # the workspace lives as long as the call (ws=ws)
                if quant:
                    return out, lambda ws=ws: lib.pt_paged_attention_int8(
                        *a, out.data_ptr(), *ptr, B, W, H, KV, D, N, bs, M,
                        stream())
                return out, lambda ws=ws: lib.pt_paged_attention(
                    *a, out.data_ptr(), *ptr, B, W, H, KV, D, N, bs, M,
                    stream())
            calls.append((f"paged{'_int8' if quant else ''} {form}", make,
                          lambda o, ref=ref, r=rms_v:
                          cs._row_ratio(o, ref, r).max().item()))
    times = {}
    for label, make, ratio in calls:
        fns = {}
        for v, lib in libs.items():
            print(json.dumps({"check": label, "variant": v}), flush=True)
            out, fn = make(lib)
            _build.check(fn(), f"{v} {label}")
            torch.cuda.synchronize()
            worst = ratio(out)
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
    ap.add_argument("--only", default=",".join(FAMILIES),
                    help="comma-separated families for --parent")
    ap.add_argument("--measure", help=argparse.SUPPRESS)   # one tree's run
    args = ap.parse_args()
    families = args.only.split(",")
    if args.measure:
        print("ROWS " + json.dumps(measure_tree(args.measure, families)),
              flush=True)
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
                                    "--measure", root, "--only",
                                    args.only], capture_output=True,
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
