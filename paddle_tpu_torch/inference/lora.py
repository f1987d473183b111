"""Multi-tenant LoRA serving: adapter registry + paged adapter-weight pool —
port of ``paddle_tpu/inference/lora.py``.

Many per-customer adapters served over ONE base model, with a device
footprint bounded by a fixed page count:

- :class:`AdapterRegistry` is the host tier: every registered adapter keeps
  its f32 A/B factors in host memory (numpy, the same dicts the JAX package
  takes), so a cold adapter's page can always be uploaded again.
- :class:`AdapterPool` is the device tier: ``max_live_adapters`` pages in
  per-target stacked tensors, padded to ``max_rank``. Page lifecycle
  (refcounts, LRU retention of released pages, pin/unpin, eviction of the
  coldest unpinned page) reuses :class:`~.paged_cache.BlockAllocator`: an
  adapter page is a block of rank-padded factors. Page 0 is the
  permanently-zero NULL adapter: rows without an adapter read page 0 and
  get an exact zero delta.

The model reads the factors in place: :meth:`AdapterPool.layer_factors`
hands each layer a :class:`~paddle_tpu_torch.nn.lora.PooledFactors` per
target (the pool tensors, the layer and the per-row page index), which the
fused LoRA kernel reads through the page index. :meth:`AdapterPool.
gather_rows` builds the JAX package's per-row copies, which the plain twin
uses. Uploads write a page in place (``Tensor.copy_``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..nn.lora import PooledFactors
from .paged_cache import BlockAllocator

# (layer, target) addressing: the seven Llama projection sites. Order is
# load-bearing — it fixes the flat pool tensor layout.
LORA_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")

NULL_PAGE = 0

# module-path suffix -> short target key (parses nn.lora export dicts)
_PATH_TARGETS = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o",
                 "gate_proj": "gate", "up_proj": "up", "down_proj": "down"}


def target_dims(cfg) -> Dict[str, Tuple[int, int]]:
    """(in, out) dims per target for a Llama-family config."""
    h = cfg.hidden_size
    hd = h // cfg.num_attention_heads
    q_out = cfg.num_attention_heads * hd
    kv_out = cfg.num_key_value_heads * hd
    return {"q": (h, q_out), "k": (h, kv_out), "v": (h, kv_out),
            "o": (q_out, h),
            "gate": (h, cfg.intermediate_size),
            "up": (h, cfg.intermediate_size),
            "down": (cfg.intermediate_size, h)}


def adapter_page_bytes(cfg, max_rank: int,
                       targets: Sequence[str] = LORA_TARGETS) -> int:
    """f32 bytes of ONE rank-padded adapter page across all layers and
    targets (the adapter analogue of ``serving.kv_block_bytes``)."""
    dims = target_dims(cfg)
    L = cfg.num_hidden_layers
    n = 0
    for t in targets:
        i, o = dims[t]
        n += L * (i * max_rank + max_rank * o)
    return 4 * n + 4  # + the page's scale slot


@dataclasses.dataclass
class Adapter:
    """One registered adapter: host-resident f32 factors keyed by
    (layer_idx, target). ``uid`` is unique per registration so a pool can
    tell a re-registered name from a warm cached page."""
    name: str
    rank: int
    alpha: float
    weights: Dict[Tuple[int, str], Tuple[np.ndarray, np.ndarray]]
    uid: int = 0

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes + b.nbytes for a, b in self.weights.values())


def _parse_path_key(key: str) -> Optional[Tuple[int, str]]:
    """'model.layers.3.self_attn.q_proj' -> (3, 'q'); None if unparseable."""
    parts = key.split(".")
    tname = _PATH_TARGETS.get(parts[-1])
    if tname is None:
        return None
    for i, p in enumerate(parts):
        if p == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            return int(parts[i + 1]), tname
    return None


class AdapterRegistry:
    """Host-side adapter store (the cold tier). Registration normalizes
    factors to f32 numpy keyed by (layer_idx, target); they stay resident
    for the adapter's lifetime so an evicted device page can always be
    uploaded again."""

    def __init__(self):
        self._adapters: Dict[str, Adapter] = {}
        self._next_uid = 1

    def register(self, name: str, weights: Dict, rank: Optional[int] = None,
                 alpha: Optional[float] = None) -> Adapter:
        """``weights``: either {(layer_idx, target): (A, B)} with short
        target keys from :data:`LORA_TARGETS`, or an export dict keyed by
        module path (its ``__meta__`` supplies rank/alpha)."""
        if name in self._adapters:
            raise ValueError(f"adapter {name!r} already registered")
        norm: Dict[Tuple[int, str], Tuple[np.ndarray, np.ndarray]] = {}
        meta = weights.get("__meta__") if isinstance(weights, dict) else None
        for key, ab in weights.items():
            if key == "__meta__":
                continue
            if isinstance(key, str):
                parsed = _parse_path_key(key)
                if parsed is None:
                    raise ValueError(
                        f"adapter {name!r}: unrecognized module path {key!r}")
                lk = parsed
                a, b = ab["A"], ab["B"]
            else:
                lk = (int(key[0]), str(key[1]))
                a, b = ab
            norm[lk] = (np.asarray(a, dtype=np.float32),
                        np.asarray(b, dtype=np.float32))
        if not norm:
            raise ValueError(f"adapter {name!r} has no weights")
        if meta is not None:
            rank = rank if rank is not None else int(meta["rank"])
            alpha = alpha if alpha is not None else float(meta["alpha"])
        ranks = {a.shape[1] for a, _ in norm.values()}
        if rank is None:
            if len(ranks) != 1:
                raise ValueError(f"adapter {name!r}: mixed ranks {ranks} "
                                 f"need an explicit rank=")
            rank = ranks.pop()
        for (l, t), (a, b) in norm.items():
            if a.shape[1] != rank or b.shape[0] != rank:
                raise ValueError(
                    f"adapter {name!r} ({l}, {t}): factor rank "
                    f"{a.shape[1]}/{b.shape[0]} != declared rank {rank}")
        ad = Adapter(name=name, rank=int(rank),
                     alpha=float(alpha if alpha is not None else rank),
                     weights=norm, uid=self._next_uid)
        self._next_uid += 1
        self._adapters[name] = ad
        return ad

    def unregister(self, name: str) -> None:
        del self._adapters[name]

    def get(self, name: str) -> Adapter:
        return self._adapters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._adapters

    def __len__(self) -> int:
        return len(self._adapters)

    def names(self) -> List[str]:
        return list(self._adapters)

    @property
    def host_bytes(self) -> int:
        return sum(a.nbytes for a in self._adapters.values())


@dataclasses.dataclass
class LoRAConfig:
    """Serving-side pool shape, fixed at server construction."""
    registry: AdapterRegistry
    max_live_adapters: int = 8
    max_rank: int = 8
    targets: Tuple[str, ...] = LORA_TARGETS

    def validate(self):
        if self.max_live_adapters < 1:
            raise ValueError(f"max_live_adapters must be >= 1, got "
                             f"{self.max_live_adapters}")
        if self.max_rank < 1:
            raise ValueError(f"max_rank must be >= 1, got {self.max_rank}")
        bad = [t for t in self.targets if t not in LORA_TARGETS]
        if bad:
            raise ValueError(f"unknown LoRA targets {bad}; "
                             f"valid: {LORA_TARGETS}")


class AdapterPool:
    """Device-resident paged pool of rank-padded adapter factors.

    Layout: per target ``t`` two stacked f32 tensors, ``A_t`` (pages, L,
    in_t, max_rank) and ``B_t`` (pages, L, max_rank, out_t), plus one
    (pages,) f32 scale vector with alpha/r baked in. ``pages =
    max_live_adapters + 1``; page 0 is the null adapter (all-zero factors,
    scale 0).

    Residency reuses :class:`BlockAllocator` over page ids: acquire() refs a
    resident page or allocates one (evicting the coldest unpinned released
    page) and uploads from the registry; release() drops the ref but keeps
    the page on the LRU, so the next request for the same adapter is a hit,
    not an upload. True ranks below max_rank upload into zero-padded columns,
    which keeps every adapter's delta exact. ``device``: where the page
    tensors live (the server's device; None = the CUDA card)."""

    def __init__(self, model_cfg, cfg: LoRAConfig, device=None):
        cfg.validate()
        device = resolve_device(device)
        self.registry = cfg.registry
        self.max_live_adapters = cfg.max_live_adapters
        self.max_rank = cfg.max_rank
        self.targets = tuple(cfg.targets)
        self.num_layers = model_cfg.num_hidden_layers
        self._dims = target_dims(model_cfg)
        self.page_bytes = adapter_page_bytes(model_cfg, self.max_rank,
                                             self.targets)
        pages = self.max_live_adapters + 1
        self.alloc = BlockAllocator(pages, 1, kv_quant="none",
                                    bytes_per_block=self.page_bytes)
        L, R = self.num_layers, self.max_rank
        kw = dict(dtype=torch.float32, device=device)
        self._tensors: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {
            t: (torch.zeros((pages, L, self._dims[t][0], R), **kw),
                torch.zeros((pages, L, R, self._dims[t][1]), **kw))
            for t in self.targets}
        self._scale = torch.zeros((pages,), **kw)
        self._resident: Dict[str, int] = {}    # name -> page (live or cached)
        self._page_name: Dict[int, str] = {}
        self._page_uid: Dict[int, int] = {}    # page -> registration uid
        self._validated: Dict[str, int] = {}   # name -> validated uid
        self.hits = 0
        self.uploads = 0

    # ------------------------------------------------------------- validation
    def validate(self, name: str) -> Adapter:
        """Submit-time feasibility gate: the adapter must exist, fit the
        pool's rank budget, and its factors must match the model's
        projection shapes. Raises ValueError with an actionable message."""
        try:
            ad = self.registry.get(name)
        except KeyError:
            raise ValueError(f"unknown adapter {name!r} — register it "
                             f"before submit") from None
        if self._validated.get(name) == ad.uid:
            return ad
        if ad.rank > self.max_rank:
            raise ValueError(
                f"adapter {name!r} rank {ad.rank} exceeds the pool's "
                f"max_rank {self.max_rank} — it cannot fit an adapter page")
        for (l, t), (a, b) in ad.weights.items():
            if t not in self.targets:
                raise ValueError(f"adapter {name!r} targets {t!r} which this "
                                 f"pool does not serve ({self.targets})")
            if l < 0 or l >= self.num_layers:
                raise ValueError(f"adapter {name!r} addresses layer {l} of a "
                                 f"{self.num_layers}-layer model")
            i, o = self._dims[t]
            if a.shape != (i, ad.rank) or b.shape != (ad.rank, o):
                raise ValueError(
                    f"adapter {name!r} ({l}, {t}): factor shapes "
                    f"{a.shape}/{b.shape} do not match model dims "
                    f"({i}, r)/(r, {o})")
        self._validated[name] = ad.uid
        return ad

    # -------------------------------------------------------------- residency
    def is_resident(self, name: str) -> bool:
        return name in self._resident

    def can_acquire(self, name: str) -> bool:
        """Admission headroom check — True when acquire() cannot fail."""
        try:
            ad = self.registry.get(name)
        except KeyError:
            return False
        page = self._resident.get(name)
        if page is not None and self._page_uid.get(page) == ad.uid:
            return True
        return self.alloc.blocks_free + self.alloc.evictable_cached >= 1

    def acquire(self, name: str) -> int:
        """Take a ref on the adapter's device page, uploading (and possibly
        evicting the coldest released adapter) on a miss. Returns the page
        id the request's slot carries into the model."""
        ad = self.validate(name)
        page = self._resident.get(name)
        if page is not None and self._page_uid.get(page) != ad.uid:
            # re-registered under the same name: the cached page holds the
            # OLD factors. Orphan it (LRU pressure reclaims it) and upload
            # afresh.
            self._resident.pop(name, None)
            self._page_name.pop(page, None)
            self._page_uid.pop(page, None)
            page = None
        if page is not None:
            self.alloc.ref(page)
            self.hits += 1
            return page
        page = self.alloc.alloc()  # may raise: every page refed or pinned
        old = self._page_name.pop(page, None)
        if old is not None:
            self._resident.pop(old, None)
        self._page_uid.pop(page, None)
        # a hash makes free() keep the page on the allocator's LRU (the
        # warm-adapter cache); uid-keyed so a re-registered name never
        # collides with its own stale page
        self.alloc.register(page, hash(("adapter", name, ad.uid)))
        self._upload(page, ad)
        self.uploads += 1
        self._resident[name] = page
        self._page_name[page] = name
        self._page_uid[page] = ad.uid
        return page

    def release(self, page: int) -> None:
        """Drop one ref on a page (kept on the LRU for warm reuse)."""
        if page == NULL_PAGE:
            return
        self.alloc.free(page)

    def pin(self, name: str) -> None:
        self.alloc.pin(self._resident[name])

    def unpin(self, name: str) -> None:
        page = self._resident.get(name)
        if page is not None:
            self.alloc.unpin(page)

    def warm(self, names: Iterable[str]) -> None:
        """Replay queued-demand order (most urgent FIRST) into the page LRU,
        so that under pressure eviction reaches the adapters with waiting
        requests last, the most urgent one last of all."""
        for name in reversed(list(names)):
            page = self._resident.get(name)
            if page is not None:
                self.alloc.touch(page)

    # ---------------------------------------------------------------- device
    def _upload(self, page: int, ad: Adapter) -> None:
        """Write one adapter's rank-padded factors into ``page``, in place;
        the pool's shapes never change."""
        L, R = self.num_layers, self.max_rank
        for t in self.targets:
            i, o = self._dims[t]
            a_stack = np.zeros((L, i, R), np.float32)
            b_stack = np.zeros((L, R, o), np.float32)
            for (l, lt), (a, b) in ad.weights.items():
                if lt != t:
                    continue
                a_stack[l, :, :ad.rank] = a
                b_stack[l, :ad.rank, :] = b
            A, B = self._tensors[t]
            A[page].copy_(torch.from_numpy(a_stack))
            B[page].copy_(torch.from_numpy(b_stack))
        self._scale[page] = ad.scale

    def layer_factors(self, idx) -> List[Dict[str, PooledFactors]]:
        """Per layer, {target: :class:`PooledFactors`} for the page index
        vector ``idx`` (E,) int32 on the pool's device — what the model
        threads to ``nn.lora.lora_matmul``; nothing is copied."""
        return [{t: PooledFactors(A, B, self._scale, layer, idx)
                 for t, (A, B) in self._tensors.items()}
                for layer in range(self.num_layers)]

    def gather_rows(self, idx) -> List[Dict[str, Tuple]]:
        """Per layer, {target: (A (E, in, R), B (E, R, out), scale (E,))}
        gathered for page index vector ``idx`` — the JAX package's
        per-row copies."""
        return [{t: f.gather() for t, f in layer.items()}
                for layer in self.layer_factors(idx)]

    # ----------------------------------------------------------------- stats
    @property
    def pool_bytes(self) -> int:
        return self.page_bytes * (self.max_live_adapters + 1)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.uploads
        return self.hits / n if n else 0.0

    def stats(self) -> Dict:
        return {"adapter_pages": self.max_live_adapters,
                "adapter_page_bytes": self.page_bytes,
                "adapter_pool_bytes": self.pool_bytes,
                "adapters_registered": len(self.registry),
                "adapters_resident": len(self._resident),
                "adapter_hits": self.hits,
                "adapter_uploads": self.uploads,
                "adapter_hit_rate": self.hit_rate,
                "adapter_evictions": self.alloc.evictions,
                "adapter_host_bytes": self.registry.host_bytes}
