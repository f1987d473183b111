"""Paged KV-cache block allocator — free list, refcounts, prefix caching.

Host-only Python, copied from ``paddle_tpu/inference/paged_cache.py`` (the
port imports nothing from the JAX package) and trimmed to what the port's
paged server, its swap preemption (``kv_offload.py``) and the adapter pool
use: warm-tier and fault-injection bookkeeping are left out with the
features that drive them.

- **free list**: block id 0 is the reserved SCRATCH block — never
  allocated; idle and prefilling rows of the decode batch write it, so a
  stale table entry can never corrupt a live block.
- **refcounts**: prompt-prefix blocks can be shared by many requests; a
  block returns to circulation only when its last user releases it.
- **prefix caching**: every FULL prompt block gets a chained content hash
  ``h_i = hash((h_{i-1}, tokens[i*bs:(i+1)*bs]))``, so a hit on block i
  implies blocks 0..i-1 matched too. Released blocks that carry a hash are
  kept on an LRU list instead of freed; a later request with the same
  prefix re-refs them and skips their prefill. Fresh allocation prefers
  free blocks and only then evicts the coldest cached one.
- **last-token rule**: matching is capped at ``(n-1)//bs`` blocks so the
  final prompt token is always recomputed — its logits give the first
  generated token.
- **pinning**: a pinned block (live or cached) is never evicted; the
  adapter pool pins hot adapter pages through it.
- **chain seed**: the pool format (``kv_quant``) seeds every chain, as in
  the JAX package, so int8 and fp blocks never alias. The port adds an
  optional per-request ``salt`` to the seed: the server passes the request's
  LoRA adapter identity, because with adapters on the K/V projections a
  block's contents depend on the adapter, not only on its tokens (the JAX
  server hashes tokens only and shares such blocks across adapters).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Set

SCRATCH_BLOCK = 0


class BlockAllocator:
    """Refcounted fixed-size KV block allocator with prefix caching."""

    def __init__(self, num_blocks: int, block_size: int,
                 kv_quant: str = "none", bytes_per_block: int = 0):
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (one scratch + one "
                             f"usable), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_quant = kv_quant
        self.bytes_per_block = int(bytes_per_block)
        # LIFO free list over ids 1..N-1 (0 = scratch)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._hash_of: Dict[int, int] = {}   # bid -> chain hash
        self._by_hash: Dict[int, int] = {}   # chain hash -> bid
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # cached, ref==0
        self._pinned: Set[int] = set()       # never evicted (live or cached)
        self.peak_in_use = 0
        self.fresh_allocs = 0
        self.prefix_hit_blocks = 0
        self.prefix_lookup_blocks = 0
        self.evictions = 0
        # swap bookkeeping (inference/kv_offload.py drives these)
        self.swap_out_blocks = 0
        self.swap_in_blocks = 0
        self.host_bytes_in_use = 0
        self.host_bytes_peak = 0

    # ----------------------------------------------------------------- stats
    @property
    def blocks_in_use(self) -> int:
        """Blocks referenced by live requests (excludes cached + free)."""
        return len(self._ref)

    @property
    def blocks_cached(self) -> int:
        return len(self._lru)

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def pinned_blocks(self) -> int:
        return len(self._pinned)

    @property
    def evictable_cached(self) -> int:
        """Cached blocks eviction may actually reclaim (unpinned)."""
        return sum(1 for bid in self._lru if bid not in self._pinned)

    def ref_counts(self) -> Dict[int, int]:
        """Copy of the live refcount map (bid -> refs): the conservation
        check (``GenerationServer.assert_conserved``) compares it with the
        block-table entries of the occupied slots."""
        return dict(self._ref)

    def stats(self) -> Dict[str, int]:
        looked = self.prefix_lookup_blocks
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "blocks_in_use": self.blocks_in_use,
                "blocks_cached": self.blocks_cached,
                "blocks_free": self.blocks_free,
                "peak_blocks_in_use": self.peak_in_use,
                "fresh_allocs": self.fresh_allocs,
                "prefix_hit_blocks": self.prefix_hit_blocks,
                "prefix_lookup_blocks": looked,
                "prefix_hit_rate":
                    (self.prefix_hit_blocks / looked) if looked else 0.0,
                "evictions": self.evictions,
                "kv_quant": self.kv_quant,
                "bytes_per_block": self.bytes_per_block,
                "bytes_in_use": self.bytes_per_block * self.blocks_in_use,
                "pinned_blocks": self.pinned_blocks,
                "swap_out_blocks": self.swap_out_blocks,
                "swap_in_blocks": self.swap_in_blocks,
                "host_bytes_in_use": self.host_bytes_in_use,
                "host_bytes_peak": self.host_bytes_peak}

    # ------------------------------------------------------- swap bookkeeping
    def note_swap_out(self, nblocks: int, nbytes: int) -> None:
        """Record ``nblocks`` parked to host (``nbytes`` of host pool)."""
        self.swap_out_blocks += nblocks
        self.host_bytes_in_use += nbytes
        self.host_bytes_peak = max(self.host_bytes_peak,
                                   self.host_bytes_in_use)

    def note_swap_in(self, nblocks: int, nbytes: int) -> None:
        """Record ``nblocks`` restored from host (releasing ``nbytes``)."""
        self.swap_in_blocks += nblocks
        self.host_bytes_in_use -= nbytes

    def note_host_release(self, nbytes: int) -> None:
        """Record a parked copy discarded without restore (cancel)."""
        self.host_bytes_in_use -= nbytes

    def _note_use(self):
        self.peak_in_use = max(self.peak_in_use, self.blocks_in_use)

    # ------------------------------------------------------------ allocation
    def alloc(self) -> int:
        """Hand out one private block (ref=1, no hash). Prefers the free
        list; falls back to evicting the coldest unpinned cached block."""
        if self._free:
            bid = self._free.pop()
        else:
            bid = next((c for c in self._lru if c not in self._pinned), None)
            if bid is None:
                raise RuntimeError(
                    f"paged KV pool exhausted: all {self.num_blocks - 1} "
                    f"usable blocks are referenced by live requests or "
                    f"pinned — raise num_blocks or lower max_batch/max_len")
            del self._lru[bid]
            h = self._hash_of.pop(bid)
            self._by_hash.pop(h, None)
            self.evictions += 1
        self._ref[bid] = 1
        self.fresh_allocs += 1
        self._note_use()
        return bid

    def ref(self, bid: int) -> None:
        """Take an additional reference on a live or cached block."""
        if bid in self._ref:
            self._ref[bid] += 1
        elif bid in self._lru:
            del self._lru[bid]
            self._ref[bid] = 1
        else:
            raise KeyError(f"block {bid} is neither live nor cached")
        self._note_use()

    def free(self, bid: int) -> None:
        """Drop one reference; at zero the block is kept on the LRU list
        when it carries a prefix hash, else returned to the free list."""
        n = self._ref.get(bid)
        if n is None:
            raise KeyError(f"block {bid} is not live")
        if n > 1:
            self._ref[bid] = n - 1
            return
        del self._ref[bid]
        if bid in self._hash_of:
            self._lru[bid] = None
            self._lru.move_to_end(bid)
        else:
            self._free.append(bid)

    def truncate(self, table: List[int], n_tokens: int) -> List[int]:
        """Release the tail of ``table`` so that it covers only ``n_tokens``
        positions: the speculative rollback. Blocks reserved for drafts
        that the verify window rejected go back through :meth:`free` (a
        shared prefix block drops a reference, a hashed one lands on the
        LRU list). Returns the kept prefix of ``table``."""
        keep = -(-n_tokens // self.block_size)  # ceil; 0 tokens keeps none
        for bid in table[keep:]:
            self.free(bid)
        return list(table[:keep])

    # --------------------------------------------------------------- pinning
    def pin(self, bid: int) -> None:
        """Freeze a live or cached block against eviction; refcounts are
        untouched. Idempotent."""
        if bid not in self._ref and bid not in self._lru:
            raise KeyError(f"block {bid} is neither live nor cached")
        self._pinned.add(bid)

    def unpin(self, bid: int) -> None:
        """Release a pin (idempotent; unknown ids are a no-op)."""
        self._pinned.discard(bid)

    def touch(self, bid: int) -> None:
        """Make a CACHED block the most recently used, so eviction reaches
        it last; live or unknown blocks are a no-op."""
        if bid in self._lru:
            self._lru.move_to_end(bid)

    # --------------------------------------------------------- prefix caching
    def chain_hashes(self, tokens: Sequence[int],
                     salt: tuple = ()) -> List[int]:
        """Chained content hash per FULL block of ``tokens``, seeded with the
        pool format (and ``salt``, when given). With no salt the chain equals
        the JAX allocator's."""
        bs = self.block_size
        out: List[int] = []
        h = hash(("kv_quant", self.kv_quant, *salt))
        for i in range(len(tokens) // bs):
            h = hash((h, tuple(tokens[i * bs:(i + 1) * bs])))
            out.append(h)
        return out

    def match_prefix(self, tokens: Sequence[int],
                     salt: tuple = ()) -> List[int]:
        """Longest cached prefix of ``tokens`` as a list of block ids — each
        returned block is re-ref'd for the caller. Capped at ``(n-1)//bs``
        blocks (last-token rule)."""
        limit = max((len(tokens) - 1) // self.block_size, 0)
        hashes = self.chain_hashes(tokens, salt)[:limit]
        out: List[int] = []
        for h in hashes:
            bid = self._by_hash.get(h)
            if bid is None:
                break
            self.ref(bid)
            out.append(bid)
        self.prefix_lookup_blocks += len(hashes)
        self.prefix_hit_blocks += len(out)
        return out

    def probe_prefix(self, tokens: Sequence[int], salt: tuple = ()) -> int:
        """Read-only: how many leading full prompt blocks of ``tokens`` are
        resident, capped like :meth:`match_prefix`. Takes no references and
        touches no counter or LRU order."""
        limit = max((len(tokens) - 1) // self.block_size, 0)
        hits = 0
        for h in self.chain_hashes(tokens, salt)[:limit]:
            if h not in self._by_hash:
                break
            hits += 1
        return hits

    def contains_hash(self, chain_hash: int) -> bool:
        """Read-only: is this chain hash resident (live or cached)?"""
        return chain_hash in self._by_hash

    def match_hashes(self, hashes: Sequence[int]) -> List[int]:
        """Longest still-resident prefix of an explicit chain-hash list,
        re-ref'd for the caller: the swap-in fast path (every hit is a
        block restored without an upload). Touches no prefix-hit
        counter."""
        out: List[int] = []
        for h in hashes:
            bid = self._by_hash.get(h)
            if bid is None:
                break
            self.ref(bid)
            out.append(bid)
        return out

    def register(self, bid: int, chain_hash: int) -> None:
        """Publish a fully-prefilled prompt block under its chain hash so
        later requests can reuse it. First writer wins; a block already
        carrying a hash keeps it."""
        if chain_hash in self._by_hash or bid in self._hash_of:
            return
        if bid not in self._ref:
            raise KeyError(f"block {bid} is not live")
        self._by_hash[chain_hash] = bid
        self._hash_of[bid] = chain_hash
