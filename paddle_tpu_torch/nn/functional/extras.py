"""``gather_tree`` — port of ``paddle_tpu/nn/functional/extras.py``
(the beam-search backtrace; the file's other ops are not ported yet)."""
from __future__ import annotations

import torch


def gather_tree(ids, parents):
    """Beam-search backtrace (the reference's ``gather_tree`` op): ids and
    parents (T, B, beam), step t's token of beam j and the beam it grew
    from. Walks each final beam back from step T - 1 and returns the
    tokens of its path, int64 (T, B, beam). Plain device ops, no host
    read: it runs inside a CUDA graph."""
    ids = ids.long()
    parents = parents.long()
    T, B, K = ids.shape
    beams = torch.arange(K, device=ids.device).expand(B, K)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(ids[t], 1, beams)
        beams = torch.gather(parents[t], 1, beams)
    return torch.stack(out)
