"""``summary`` — port of ``paddle_tpu/hapi/summary.py``: parameter counts
by sublayer, counted as the JAX package counts them (the network itself
included, each shared tensor once in the totals)."""
from __future__ import annotations

import numpy as np


def summary(net, input_size=None, dtypes=None, input=None):
    rows = []
    total_params = 0
    trainable_params = 0
    for name, layer in net.named_sublayers(include_self=True):
        n_params = 0
        for _, p in layer._parameters.items():
            if p is None:
                continue
            n = int(np.prod(p.shape)) if p.shape else 1
            n_params += n
        if not name:
            continue
        if n_params:
            rows.append((name, type(layer).__name__, n_params))
    seen = set()
    for _, p in net.named_parameters():
        if id(p) in seen:
            continue
        seen.add(id(p))
        n = int(np.prod(p.shape)) if p.shape else 1
        total_params += n
        if getattr(p, "trainable", p.requires_grad):
            trainable_params += n
    lines = [f"{'Layer':<45}{'Type':<25}{'Params':>12}"]
    lines.append("-" * 82)
    for name, tname, n in rows:
        lines.append(f"{name:<45}{tname:<25}{n:>12,}")
    lines.append("-" * 82)
    lines.append(f"Total params: {total_params:,}")
    lines.append(f"Trainable params: {trainable_params:,}")
    lines.append(f"Non-trainable params: {total_params - trainable_params:,}")
    print("\n".join(lines))
    return {"total_params": total_params, "trainable_params": trainable_params}
