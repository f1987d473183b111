"""Build and load the port's CUDA kernels: ``nvcc`` by hand into one shared
library with a plain C interface, loaded with ``ctypes``.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) into its own object
file — one ``nvcc`` per source, all started together — and the objects are
linked into one ``.so``. Objects and the library are named by a hash of
their inputs (source bytes, headers, flags), so a rebuild happens only when
a source changes. The build directory (``_build/`` next to this file) is
listed in ``.gitignore``; it is filled on first use, on the machine that has
the card and the CUDA toolkit. Nothing here runs at import time.

C interface: every entry point takes device pointers and the CUDA stream as
``void*`` (``ctypes.c_void_p``), sizes as ``int`` (strides that may pass
2^31 as ``long long``), and returns the
``cudaError_t`` of ``cudaGetLastError()`` after its launch; :func:`check`
raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry point -> argtypes (all return int: the launch's cudaError_t)
SIGNATURES = {
    # x, w, y, rows, dim, eps, rows a block (0: one), stream
    "pt_rms_norm": (_P, _P, _P, _I, _I, _F, _I, _P),
    # q, k_pool, v_pool, tables, pos, out, part_acc, part_ml,
    # B, W, H, KV, D, N, bs, M, ring depth (1, 2), order (0 bgm, 1 gbm),
    # stream
    "pt_paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # B, W, H, KV, bs, M, out (7 ints): the paged attention plan
    "pt_paged_plan": (_I, _I, _I, _I, _I, _I, _P),
    # quant (0 bf16 pools, 1 int8), ring depth, out (8 ints): its launch
    # shape, registers and local bytes
    "pt_paged_attention_config": (_I, _I, _P),
    # x, w, b, y, rows, dim, dtype (0 bf16, 1 fp32), eps, rows a block
    # (0: eight), stream
    "pt_layer_norm": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # q, k, v, out, lse, B, H, Hkv, Sq, Sk, D, causal, scale, stream
    "pt_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                     _P),
    # q, k, v, do, lse, delta, dq, B, H, Hkv, Sq, Sk, D, causal, scale,
    # stream
    "pt_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, do, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, D, causal, scale,
    # stream
    "pt_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # which (0 dQ, 1 dK/dV), D, out (8 ints): the backward kernels' launch
    # shape, registers and local bytes
    "pt_flash_bwd_config": (_I, _I, _P),
    # D, out (8 ints): the forward kernel's, as pt_flash_bwd_config
    "pt_flash_fwd_config": (_I, _P),
    # q, kq_pool, k_scales, vq_pool, v_scales, tables, pos, out, part_acc,
    # part_ml, B, W, H, KV, D, N, bs, M, ring depth, order, stream
    "pt_paged_attention_int8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, w_q, scale, out, M, K, N, stream
    "pt_w8_matmul": (_P, _P, _P, _P, _I, _I, _I, _P),
    # token tile, 64-column blocks of W a block, out (8 ints): the streaming
    # kernel's launch shape, registers and local bytes (int8 W; LoRA's
    # bf16 W)
    "pt_w8_matmul_config": (_I, _I, _P),
    "pt_fused_lora_config": (_I, _I, _P),
    # M, K, N, out (6 ints): the streaming product's plan on this device
    "pt_stream_plan": (_I, _I, _I, _P),
    # x, w, out, M, K, N, w_kmajor (0: w (K, N); 1: w (N, K)), stream
    "pt_stream_matmul": (_P, _P, _P, _I, _I, _I, _I, _P),
    # token tile, 64-column blocks of W a block, w_kmajor, out (8 ints)
    "pt_stream_matmul_config": (_I, _I, _I, _P),
    # x, w, a (at the layer), b (at the layer), scale, aidx, out, part,
    # M, K, N, R, rows_per_entry, a_page_stride, b_page_stride, stream
    "pt_fused_lora": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _L, _L, _P),
    # p, g, m, v, master (or NULL), n, g_is_fp32, p_is_fp32, sc (device
    # fp32 [lr,
    # 1/(1-b1^step), 1/(1-b2^step)]), b1, 1 - b1, b2, 1 - b2, eps, decay,
    # stream
    "pt_fused_adamw": (_P, _P, _P, _P, _P, _L, _I, _I, _P,
                       _F, _F, _F, _F, _F, _F, _P),
    # maps, wptrs, pools, tables, pos, cos_rows, sin_rows, xres, q, ao,
    # hbuf, ktok, vtok, lora_a (host), lora_b (host), lscale, laidx, lpart,
    # part, apart, gsync, trace (or NULL), L, B, W, H, KV, D, I, bs, M,
    # quant, dequant, R, NS, ring stages, ffn (down K steps a slice), eps,
    # stream
    "pt_decode_tick": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _F, _P),
    # wptrs (host, 9 x L int64), L, hid, KV * D, I, out (device, 7 L maps)
    "pt_decode_tick_maps": (_P, _I, _I, _I, _I, _P),
    # hid, KV, I, rows, ffn, out (7 ints): the tick's work plan on this
    # device
    "pt_decode_tick_plan": (_I, _I, _I, _I, _I, _P),
    # quant, lora, out (8 ints): an instantiation's launch shape,
    # registers and local bytes
    "pt_decode_tick_config": (_I, _I, _P),
}

_LOCK = threading.Lock()
_LIB = None
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin``, else the
    toolkit's default install prefix; raises when none exists."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of paddle_tpu_torch are built from source on first "
        "use and need the CUDA toolkit")


def _digest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
        h.update(b"\0")
    return h.hexdigest()[:16]


def sources():
    return sorted(CSRC.glob("*.cu"))


def compile_commands(nvcc: str, build_dir: Path = BUILD_DIR):
    """[(source, object path, nvcc argv)] — one compile per source; the
    object's name carries the hash of everything that shapes it."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS).encode()
    out = []
    for src in sources():
        tag = _digest(src.read_bytes(), headers, flags)
        obj = build_dir / f"{src.stem}-{tag}.o"
        out.append((src, obj, [nvcc, *NVCC_FLAGS, "-c", str(src),
                               "-o", str(obj)]))
    return out


def build() -> Path:
    """Compile what changed (in parallel) and link the library; returns
    its path. Records the compiler output and timings in
    :data:`BUILD_INFO`."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmds = compile_commands(nvcc)
    t0 = time.perf_counter()
    procs = []
    for src, obj, argv in cmds:
        if obj.exists():
            continue
        tmp = obj.with_suffix(f".{os.getpid()}.tmp.o")
        argv = argv[:-1] + [str(tmp)]
        procs.append((src, obj, tmp, subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    failed = []
    for src, obj, tmp, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {p.returncode}):\n{text}")
        else:
            os.replace(tmp, obj)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    objs = [obj for _, obj, _ in cmds]
    lib = BUILD_DIR / f"libpaddle_tpu_torch-{_digest(*(o.name.encode() for o in objs))}.so"
    if not lib.exists():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        p = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"CUDA kernel link failed (nvcc exit "
                               f"{p.returncode}):\n{p.stdout}{p.stderr}")
        os.replace(tmp, lib)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(lib),
                      compiled=[s.name for s, *_ in procs],
                      log="\n".join(logs))
    return lib


def library():
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream

