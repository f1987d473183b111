"""LoRA for training and for batched serving — port of
``paddle_tpu/nn/lora.py``.

Training side: :class:`LoRALinear` wraps a projection with a trainable
low-rank residual ``y = x W + ((x32 A) B) · alpha/r``; the base weight is
frozen (``trainable = False``, see ``parallel.ParallelEngine``) so only the
factors flow through the optimizer. :func:`attach_lora` / :func:`merge_lora`
walk a model and wrap or fold the configured projection attributes in
place; :func:`export_adapter` / :func:`load_adapter` round-trip the factors
through ``.npz`` files in the JAX package's format (``A:<module path>``,
``B:<module path>``, ``__meta__`` JSON), so either package reads a file
the other wrote, and the serving registry (``inference/lora.py``) takes
what :func:`load_adapter` returns.

Serving side (``bgmv``, ``lora_matmul``): a projection's adapter factors
for a batch arrive in one of two forms:

* gathered per batch entry, ``(A (E, in, R), B (E, R, out), s (E,))`` — the
  JAX package's form (``AdapterPool.gather_rows``);
* :class:`PooledFactors` — the adapter pool's stacked tensors at one layer
  plus a per-entry page index, which the CUDA kernel reads in place (no
  per-row copies of the factors).

Null entries (page 0) carry zero factors and s = 0, so their delta is an
exact zero.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn


class LoRALinear(nn.Module):
    """A frozen projection plus a trainable rank-``r`` residual.

    ``base`` is a bias-free Llama ``Linear`` or an ``nn.Linear`` (weight
    (in, out)); its parameters are frozen (``trainable = False``,
    ``requires_grad`` off). The factors stay fp32 under a bf16 base: the
    delta ``((x32 @ A) @ B) · scaling`` is computed in fp32 and cast to the
    base output's dtype at the end. ``lora_A`` is Normal(0, 0.02), drawn
    from ``generator`` (a ``torch.Generator`` on the base's device; None
    takes PyTorch's default one), ``lora_B`` zeros, so the wrapped layer
    computes the base's function until training moves B."""

    def __init__(self, base, rank: int, alpha: Optional[float] = None,
                 generator=None):
        super().__init__()
        if rank < 1:
            raise ValueError(f"LoRA rank must be >= 1, got {rank}")
        self.base = base
        self.rank = int(rank)
        self.alpha = float(alpha if alpha is not None else rank)
        self.scaling = self.alpha / self.rank
        w = base.weight
        in_f, out_f = w.shape
        for p in base.parameters():
            p.trainable = False
            p.requires_grad_(False)
        a = torch.empty(in_f, self.rank, dtype=torch.float32,
                        device=w.device)
        self.lora_A = nn.Parameter(a.normal_(0.0, 0.02, generator=generator))
        self.lora_B = nn.Parameter(torch.zeros(self.rank, out_f,
                                               dtype=torch.float32,
                                               device=w.device))

    def _delta(self, x):
        return torch.matmul(torch.matmul(x.float(), self.lora_A),
                            self.lora_B) * self.scaling

    def forward(self, x):
        y = self.base(x)
        return y + self._delta(x).to(y.dtype)

    def stream(self, x):
        """The decode paths' product: the base's batch-invariant product
        plus the delta (each row's delta is computed alike)."""
        y = self.base.stream(x)
        return y + self._delta(x).to(y.dtype)

    @torch.no_grad()
    def merged_weight(self) -> torch.Tensor:
        """The base weight with the low-rank delta folded in: fp32, on
        the base's device."""
        return self.base.weight.float() + self.scaling * (self.lora_A
                                                          @ self.lora_B)

    def extra_repr(self):
        in_f, out_f = self.base.weight.shape
        return (f"in_features={in_f}, out_features={out_f}, "
                f"rank={self.rank}, alpha={self.alpha}")


def _projection_types():
    from ..models.llama import Linear as LlamaLinear
    from .layer.common import Linear

    return (LlamaLinear, Linear)


def _wrap_sites(model, targets: Iterable[str]):
    """(owner, attribute, child) for every ``targets`` attribute that is a
    projection (or already a :class:`LoRALinear`) anywhere in the model,
    in module order and then target order (as the JAX walk)."""
    tset = tuple(targets)
    linear = _projection_types()
    for layer in model.modules():
        for tname in tset:
            child = layer._modules.get(tname)
            if isinstance(child, (LoRALinear,) + linear):
                yield layer, tname, child


def attach_lora(model, rank: int, alpha: Optional[float] = None,
                targets: Iterable[str] = (), generator=None):
    """Replace every ``targets`` attribute that is a plain projection with
    a :class:`LoRALinear` of the given rank (``lora_A`` drawn from
    ``generator``, site after site). Idempotent on already wrapped sites;
    raises ValueError when no target is found. Returns the model (mutated
    in place)."""
    sites = list(_wrap_sites(model, targets))
    if not sites:
        raise ValueError(f"attach_lora found no Linear targets "
                         f"{tuple(targets)}")
    for layer, tname, child in sites:
        if isinstance(child, LoRALinear):
            continue
        setattr(layer, tname, LoRALinear(child, rank, alpha, generator))
    return model


@torch.no_grad()
def merge_lora(model, targets: Iterable[str] = ()):
    """Fold every :class:`LoRALinear`'s delta into its base weight (in
    place, in the weight's dtype) and put the plain projection back,
    trainable again — the inverse of :func:`attach_lora` for inference
    export."""
    for layer, tname, child in list(_wrap_sites(model, targets)):
        if not isinstance(child, LoRALinear):
            continue
        base = child.base
        base.weight.copy_(child.merged_weight().to(base.weight.dtype))
        for p in base.parameters():
            p.trainable = True
        setattr(layer, tname, base)
    return model


def lora_parameters(model) -> List[nn.Parameter]:
    """The trainable A/B factors — hand these to the optimizer."""
    out = []
    for layer in model.modules():
        if isinstance(layer, LoRALinear):
            out.extend([layer.lora_A, layer.lora_B])
    return out


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def lora_state(model) -> Dict[str, Dict]:
    """{module_path: {"A": f32 ndarray, "B": f32 ndarray}} plus a
    ``"__meta__"`` entry carrying rank and alpha — the adapter checkpoint
    payload."""
    state: Dict[str, Dict] = {}
    meta = None
    for path, layer in model.named_modules():
        if not isinstance(layer, LoRALinear):
            continue
        state[path] = {"A": _host(layer.lora_A), "B": _host(layer.lora_B)}
        if meta is None:
            meta = {"rank": layer.rank, "alpha": layer.alpha}
    if meta is None:
        raise ValueError("model has no LoRALinear layers to export")
    state["__meta__"] = meta
    return state


@torch.no_grad()
def load_lora_state(model, state: Dict[str, Dict]):
    """Restore exported factors into an already-attached model (copied in
    place into the live factors)."""
    for path, layer in model.named_modules():
        if isinstance(layer, LoRALinear) and path in state:
            for key, p in (("A", layer.lora_A), ("B", layer.lora_B)):
                p.copy_(torch.as_tensor(np.asarray(state[path][key],
                                                   np.float32)))
    return model


def export_adapter(model, path: str) -> None:
    """Save the adapter checkpoint as ``.npz``: keys ``A:<module path>`` /
    ``B:<module path>`` and the JSON ``__meta__`` as uint8 bytes."""
    state = lora_state(model)
    meta = state.pop("__meta__")
    arrays = {}
    for mpath, ab in state.items():
        arrays[f"A:{mpath}"] = ab["A"]
        arrays[f"B:{mpath}"] = ab["B"]
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8)
    np.savez(path, **arrays)


def load_adapter(path: str) -> Dict[str, Dict]:
    """Load an ``.npz`` adapter checkpoint back into the :func:`lora_state`
    dict (for :func:`load_lora_state` or ``inference.lora.AdapterRegistry.
    register``)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode("utf-8"))
        state: Dict[str, Dict] = {"__meta__": meta}
        for key in z.files:
            if key.startswith("A:"):
                mpath = key[2:]
                state[mpath] = {"A": np.asarray(z[key], np.float32),
                                "B": np.asarray(z[f"B:{mpath}"],
                                                np.float32)}
    return state


@dataclasses.dataclass(frozen=True)
class PooledFactors:
    """One target's factors for a batch, read from the adapter pool pages:
    ``a`` (pages, L, in, R), ``b`` (pages, L, R, out), ``scale`` (pages,)
    f32 with alpha/r baked in, the pool ``layer`` and ``aidx`` (E,) int32,
    the page of each batch entry."""

    a: torch.Tensor
    b: torch.Tensor
    scale: torch.Tensor
    layer: int
    aidx: torch.Tensor

    def gather(self):
        """The per-entry copies ``(A (E, in, R), B (E, R, out), s (E,))``."""
        idx = self.aidx.long()
        return (self.a[idx, self.layer], self.b[idx, self.layer],
                self.scale[idx])


def _gathered(ab):
    return ab.gather() if isinstance(ab, PooledFactors) else ab


def _rows_delta(x, A, B):
    """fp32 ``(x32 @ A_e) @ B_e`` of every row of x (E, S, in), a row at a
    time (each row's products alike, whatever S and E: batch-invariant):
    ``x32 @ A`` in chunks of 8 rank columns, as the fused kernel's grid
    takes them, and the rank contraction summed in rank order, as its
    epilogue sums it — so a zero-padded rank (``LoRAGeometry.rank_pad``)
    adds exact zeros after the real terms. Returns (E * S, out)."""
    E, S, K = x.shape
    idx = torch.arange(E, device=x.device).repeat_interleave(S)
    xr = x.reshape(E * S, 1, K).float()
    Ai = A.float()[idx]
    xa = torch.cat([torch.bmm(xr, Ai[..., j:j + 8])
                    for j in range(0, Ai.shape[-1], 8)], -1)[:, 0]
    Bi = B.float()[idx]
    d = xa[:, :1] * Bi[:, 0]
    for r in range(1, xa.shape[1]):
        d = d + xa[:, r:r + 1] * Bi[:, r]
    return d


def bgmv(x, ab):
    """Batched gathered LoRA delta ``((x32 @ A) @ B) · s`` per batch entry,
    in fp32, returned in x's dtype (None when ``ab`` is None). x: (E, S,
    in); ``ab``: gathered factors or :class:`PooledFactors`."""
    if ab is None:
        return None
    A, B, s = _gathered(ab)
    d = torch.bmm(torch.bmm(x.float(), A.float()), B.float())
    return (d * s.float()[:, None, None]).to(x.dtype)


def _lora_plain(x, w, A, B, s):
    """Plain twin of the fused kernel (``paddle_tpu.ops.paged_attention_
    pallas._lora_kernel``): the base product accumulated in fp32 over the
    kernel's K slices (``stream_matmul.sliced_sum``), the delta ``(x32 @
    A) @ B`` in fp32, combined as ``y + d · s`` in fp32 and rounded to x's
    dtype once, every row computed alike (batch-invariant, as the
    kernel). The JAX jnp path instead adds the base product and the delta
    each rounded to x's dtype (``nn/lora.py:259-262``); in fp32 the two
    agree."""
    from ..ops.stream_matmul import k_slices, sliced_sum, sm_count

    E, S, K = x.shape
    N = w.shape[1]
    y = sliced_sum(x.reshape(E * S, K), w, k_slices(K, N, sm_count(x.device)))
    d = _rows_delta(x, A, B)
    sr = s.float().repeat_interleave(S)[:, None]
    return (y + d * sr).to(x.dtype).reshape(E, S, N)


def _pad_rank(ab, rp: int):
    """The factors with their rank zero-padded to ``rp``: zero columns of A
    and zero rows of B (``LoRAGeometry.rank_pad``, as the JAX
    ``fused_lora_matmul`` pads); pooled factors keep their one layer."""
    from torch.nn import functional as F

    if isinstance(ab, PooledFactors):
        R = ab.a.shape[-1]
        a = F.pad(ab.a[:, ab.layer:ab.layer + 1], (0, rp - R))
        b = F.pad(ab.b[:, ab.layer:ab.layer + 1], (0, 0, 0, rp - R))
        return PooledFactors(a.contiguous(), b.contiguous(), ab.scale, 0,
                             ab.aidx)
    A, B, sc = ab
    R = A.shape[-1]
    return F.pad(A, (0, rp - R)), F.pad(B, (0, 0, 0, rp - R)), sc


def lora_matmul(x, w, ab, geometry=None):
    """Base projection plus the per-entry LoRA delta in one op: ``x @ w +
    ((x32 @ A) @ B) · s``. x: (E, S, in); w: (in, out); ``ab``: None (the
    plain projection), gathered factors (plain twin only) or
    :class:`PooledFactors`. On a CUDA tensor the fused kernel runs and
    reads the :class:`PooledFactors` pages in place; on a CPU tensor or
    under ``set_kernel_mode("reference")``, its plain twin. ``geometry``:
    the autotuner's ``LoRAGeometry`` (None: the resolved one, see
    ``ops.geometry_for``): ``rank_pad`` zero-pads the rank on the host
    first (the same bits); ``accum`` other than ``"base_first"`` raises
    (ROADMAP A9c)."""
    from ..autotune.kernel_geometry import check_served
    from ..ops import geometry_for, use_kernel
    from ..ops.fused_lora_cuda import fused_lora_matmul_cuda

    if ab is None:
        return torch.matmul(x, w)
    R = (ab.a if isinstance(ab, PooledFactors) else ab[0]).shape[-1]
    if geometry is None:
        geometry = geometry_for("fused_lora", x.dtype, R)
    geometry.validate()
    check_served("fused_lora", geometry, rank=R, hopper=use_kernel(x))
    rp = geometry.padded_rank(R)
    if rp != R:
        ab = _pad_rank(ab, rp)
    if not use_kernel(x):
        return _lora_plain(x, w, *_gathered(ab))
    return fused_lora_matmul_cuda(x, w, ab.a, ab.b, ab.scale, ab.layer,
                                  ab.aidx)
