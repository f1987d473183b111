"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package ``paddle_tpu`` stays the reference; this package mirrors its
module names so each counterpart is easy to find (``paddle_tpu_torch.ops.
fused_norm`` ports ``paddle_tpu.ops.fused_norm``, and so on). It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing from
``paddle_tpu``.

The first slice is paged continuous-batching serving of a Llama model:

    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama3_8b_config
    from paddle_tpu_torch.inference.serving import GenerationServer

    model = LlamaForCausalLM(llama3_8b_config())          # on the card
    srv = GenerationServer(model, cache="paged", max_batch=8)
    rid = srv.submit(prompt_ids, max_new_tokens=32)
    out = srv.run()[rid]

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
with ``device=None`` and no CUDA device they raise instead of quietly
running on the CPU (:func:`resolve_device`).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; raises when there is none.
    An explicit device (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is
    returned as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: paddle_tpu_torch runs on the "
                "card by default — pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
