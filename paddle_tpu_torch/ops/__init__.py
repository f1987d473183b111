"""Hand-written Hopper kernels of the port and their plain PyTorch twins —
the counterpart of ``paddle_tpu/ops`` (whose Pallas TPU kernels they
replace).

Kernel dispatch contract (shared by every wrapper in this package):

* ``"auto"`` (default): a wrapper launches its CUDA kernel for CUDA tensors
  and runs its plain PyTorch version for CPU tensors. On a CUDA tensor it
  never falls back: a shape or dtype the kernel does not take raises.
* ``"megakernel"``: as ``"auto"``, and the serving executor runs each
  decode tick as one launch of the whole-tick kernel
  (``decode_megakernel.decode_tick``); prefill keeps the per-layer kernels.
  Only an explicit request selects it: ``"auto"`` never does.
* ``"reference"``: every wrapper runs its plain PyTorch version, on any
  device — ``chip_smoke.py`` uses it to hold each kernel against its plain
  version on the card.

``stream_matmul`` is the port's own kernel, not a port of a Pallas one:
the batch-invariant bf16 product of the decode and verify paths (the JAX
package leaves those products to XLA).

The mode is process-wide and read at call time (PyTorch runs eagerly, so
unlike the JAX package there is no trace to freeze it).

Every wrapper that launches a kernel carries a plain-integer launch counter
(``wrapper.launches``), bumped exactly where the kernel is launched and
nowhere else, so a run can show that its main path went through the kernels:
:func:`reset_launch_counts` before the run, :func:`launch_counts` after. A
CUDA graph launches its kernels without calling a wrapper: its capture runs
under :func:`captured_launches`, which takes the capture's bumps back and
records them, and each replay adds them (:func:`add_launch_counts`), so N
replayed passes count what N eager passes would.
"""
from __future__ import annotations

import contextlib

KERNEL_MODES = ("auto", "megakernel", "reference")

_KERNEL_MODE = "auto"


def set_kernel_mode(mode: str) -> None:
    """Pin the process-wide dispatch: ``"auto"`` (kernels on CUDA tensors,
    plain versions on CPU tensors), ``"megakernel"`` (the same, with the
    whole-tick decode kernel on the serving path) or ``"reference"`` (plain
    versions everywhere)."""
    global _KERNEL_MODE
    if mode not in KERNEL_MODES:
        raise ValueError(
            f"kernel mode must be one of {KERNEL_MODES}, got {mode!r}")
    _KERNEL_MODE = mode


def kernel_mode() -> str:
    return _KERNEL_MODE


def use_kernel(x) -> bool:
    """True when the wrapper must launch its CUDA kernel for tensor ``x``."""
    return _KERNEL_MODE != "reference" and x.is_cuda


def use_megakernel() -> bool:
    """True only under an explicit ``"megakernel"`` mode: the whole-tick
    fusion is a deliberate serving configuration, never picked by
    ``"auto"``."""
    return _KERNEL_MODE == "megakernel"


from .decode_megakernel_cuda import decode_tick_cuda  # noqa: E402
from .flash_attention_cuda import (flash_bwd_dkv_cuda,  # noqa: E402
                                   flash_bwd_dkv_stream_cuda,
                                   flash_bwd_dq_cuda,
                                   flash_bwd_dq_stream_cuda, flash_fwd_cuda,
                                   flash_fwd_stream_cuda)
from .fused_adamw import fused_adamw_cuda, fused_adamw_update  # noqa: E402
from .fused_ce import fused_linear_cross_entropy  # noqa: E402
from .fused_lora_cuda import fused_lora_matmul_cuda  # noqa: E402
from .fused_norm import (fused_layer_norm, fused_rms_norm,  # noqa: E402
                         layer_norm_cuda, rms_norm_cuda)
from .int8 import quantize_per_channel, w8_matmul  # noqa: E402
from .int8_cuda import w8_matmul_cuda  # noqa: E402
from .paged_attention import (gather_block_kv,  # noqa: E402
                              paged_decode_attention,
                              paged_decode_attention_q,
                              paged_prefill_attention,
                              paged_prefill_attention_q,
                              paged_verify_attention,
                              paged_verify_attention_q, quantize_block_kv,
                              write_chunk_kv, write_chunk_kv_q,
                              write_decode_kv, write_decode_kv_q,
                              write_window_kv, write_window_kv_q)
from .paged_attention_cuda import (paged_attention_cuda,  # noqa: E402
                                   paged_attention_int8_cuda)
# the modules, not their functions of the same names, stay the package's
# attributes (``ops.stream_matmul.k_slices``)
from . import stream_matmul, stream_matmul_cuda  # noqa: E402

# every kernel wrapper of the port, by kernel name
KERNEL_WRAPPERS = {"rms_norm": rms_norm_cuda,
                   "layer_norm": layer_norm_cuda,
                   "paged_attention": paged_attention_cuda,
                   "flash_fwd": flash_fwd_cuda,
                   "flash_bwd_dq": flash_bwd_dq_cuda,
                   "flash_bwd_dkv": flash_bwd_dkv_cuda,
                   "flash_fwd_stream": flash_fwd_stream_cuda,
                   "flash_bwd_dq_stream": flash_bwd_dq_stream_cuda,
                   "flash_bwd_dkv_stream": flash_bwd_dkv_stream_cuda,
                   "fused_adamw": fused_adamw_cuda,
                   "w8_matmul": w8_matmul_cuda,
                   "paged_attention_int8": paged_attention_int8_cuda,
                   "fused_lora_matmul": fused_lora_matmul_cuda,
                   "decode_tick": decode_tick_cuda,
                   "stream_matmul": stream_matmul_cuda.stream_matmul_cuda}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS.values():
        w.launches = 0


def launch_counts() -> dict:
    return {name: w.launches for name, w in KERNEL_WRAPPERS.items()}


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` ({kernel: launches}) to the wrappers' counters: what
    one replay of a CUDA graph launches (see :func:`captured_launches`)."""
    for name, n in counts.items():
        KERNEL_WRAPPERS[name].launches += n


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph's capture: yields a dict that, on exit, holds the
    launches the wrappers counted inside the block ({kernel: launches}, the
    kernels launched at least once), and takes them back from the counters
    — a captured call launches nothing until the graph is replayed."""
    before = launch_counts()
    got = {}
    try:
        yield got
    finally:
        for name, n in launch_counts().items():
            if n != before[name]:
                got[name] = n - before[name]
                KERNEL_WRAPPERS[name].launches = before[name]


__all__ = ["KERNEL_MODES", "KERNEL_WRAPPERS", "add_launch_counts",
           "captured_launches", "decode_tick_cuda",
           "flash_bwd_dkv_cuda", "flash_bwd_dkv_stream_cuda",
           "flash_bwd_dq_cuda", "flash_bwd_dq_stream_cuda", "flash_fwd_cuda",
           "flash_fwd_stream_cuda", "fused_adamw_cuda",
           "fused_adamw_update", "fused_layer_norm",
           "fused_linear_cross_entropy", "fused_lora_matmul_cuda",
           "fused_rms_norm", "gather_block_kv", "kernel_mode",
           "launch_counts", "layer_norm_cuda",
           "paged_attention_cuda", "paged_attention_int8_cuda",
           "paged_decode_attention", "paged_decode_attention_q",
           "paged_prefill_attention", "paged_prefill_attention_q",
           "paged_verify_attention", "paged_verify_attention_q",
           "quantize_block_kv", "quantize_per_channel",
           "reset_launch_counts", "rms_norm_cuda", "set_kernel_mode",
           "use_kernel", "use_megakernel", "w8_matmul", "w8_matmul_cuda", "write_chunk_kv",
           "write_chunk_kv_q", "write_decode_kv", "write_decode_kv_q",
           "write_window_kv", "write_window_kv_q"]
