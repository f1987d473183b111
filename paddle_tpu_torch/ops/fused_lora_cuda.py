"""CUDA fused LoRA matmul — port of ``paddle_tpu/ops/paged_attention_pallas.py``
(``_lora_kernel`` / ``fused_lora_matmul``).

:func:`fused_lora_matmul_cuda` launches ``csrc/fused_lora.cu``: the base
projection ``x @ W`` (bf16 in, fp32 accumulate; the weight-streaming main
loop of ``csrc/stream_gemm.cuh``) plus each batch entry's LoRA delta
``((x32 @ A) @ B) · s``, combined in fp32 and rounded once, in two launches.
The factors are read in place from the adapter pool's pages (``A_t``
(pages, L, in, R), ``B_t`` (pages, L, R, out), ``scale`` (pages,)) at one
layer, through a per-entry page index; the plain twin is
``paddle_tpu_torch.nn.lora._lora_plain`` over the gathered factors.
"""
from __future__ import annotations

import torch

from .int8_cuda import _config

# the kernel's contract (csrc/fused_lora.cu, csrc/stream_tiles.cuh): in %
# K_STEP, out % BLOCK_N, rank 1..MAX_RANK; the first launch's K slices of
# xa partials, at most MAX_SLICES
BLOCK_N = 128
K_STEP = 32
MAX_RANK = 64
MAX_SLICES = 32


def kernel_config():
    """The second launch's instantiations (bf16 W), as
    ``int8_cuda.kernel_config``."""
    return _config("pt_fused_lora_config")


def fused_lora_matmul_cuda(x, w, a_pool, b_pool, scale, layer: int, aidx):
    """Launch the fused LoRA kernel.

    x: (E, S, in) bfloat16 — E batch entries of S tokens; w: (in, out)
    bfloat16; a_pool: (pages, L, in, R) float32; b_pool: (pages, L, R, out)
    float32; scale: (pages,) float32; layer: the pool layer to read; aidx:
    (E,) int32 page per entry, each in [0, pages). in % 32 == 0, out % 128
    == 0, 1 <= R <= 64. Returns (E, S, out) bfloat16. Raises on a shape,
    dtype or device the kernel does not take."""
    from . import _build

    name = "fused_lora_matmul_cuda"
    if x.dim() != 3 or w.dim() != 2 or a_pool.dim() != 4 or \
            b_pool.dim() != 4 or scale.dim() != 1 or aidx.dim() != 1:
        raise ValueError(f"{name}: want x (E, S, in), w (in, out), a_pool "
                         f"(pages, L, in, R), b_pool (pages, L, R, out), "
                         f"scale (pages,), aidx (E,)")
    E, S, K = x.shape
    N = w.shape[1]
    pages, L, Ka, R = a_pool.shape
    if w.shape[0] != K or Ka != K or b_pool.shape != (pages, L, R, N) or \
            scale.shape != (pages,) or aidx.shape != (E,):
        raise ValueError(f"{name}: shapes do not agree: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, a_pool {tuple(a_pool.shape)}, "
                         f"b_pool {tuple(b_pool.shape)}, scale "
                         f"{tuple(scale.shape)}, aidx {tuple(aidx.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or \
            {a_pool.dtype, b_pool.dtype, scale.dtype} != {torch.float32} or \
            aidx.dtype != torch.int32:
        raise TypeError(f"{name}: the kernel takes bfloat16 x and w, float32 "
                        f"factors and scale, int32 aidx; got {x.dtype}, "
                        f"{w.dtype}, {a_pool.dtype}, {b_pool.dtype}, "
                        f"{scale.dtype}, {aidx.dtype}")
    if K % K_STEP or N % BLOCK_N or not 1 <= R <= MAX_RANK or E * S == 0:
        raise ValueError(f"{name}: unsupported in={K}, out={N}, rank={R}, "
                         f"rows={E * S} (in % {K_STEP}, out % {BLOCK_N}, "
                         f"rank 1..{MAX_RANK})")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} of a {L}-layer pool")
    tensors = (x, w, a_pool, b_pool, scale, aidx)
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    x = x.contiguous()
    aidx = aidx.contiguous()
    for tname, t in (("w", w), ("a_pool", a_pool), ("b_pool", b_pool),
                     ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16 or b_pool.data_ptr() % 16:
        raise ValueError(f"{name}: x, w and b_pool must be 16-byte aligned")
    M = E * S
    out = torch.empty((E, S, N), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((MAX_SLICES, M, R), dtype=torch.float32,
                       device=x.device)
    a_layer = a_pool.data_ptr() + int(layer) * K * R * 4
    b_layer = b_pool.data_ptr() + int(layer) * R * N * 4
    lib = _build.library()
    err = lib.pt_fused_lora(x.data_ptr(), w.data_ptr(), a_layer, b_layer,
                            scale.data_ptr(), aidx.data_ptr(), out.data_ptr(),
                            part.data_ptr(), M, K, N, R, S, L * K * R,
                            L * R * N, _build.stream_ptr(x.device))
    _build.check(err, "fused_lora_matmul")
    fused_lora_matmul_cuda.launches += 1
    return out


fused_lora_matmul_cuda.launches = 0
