"""Host KV offload — swap preemption and the warm KV tier for the paged
serving pool; port of ``paddle_tpu/inference/kv_offload.py``.

When the device block pool runs dry, the server preempts a victim request
by copying its KV blocks — fp rows, or int8 codes and their f32 scales —
into host memory, freeing the device blocks for more urgent work. On
resume the blocks are restored and the request continues where it
stopped: the round trip is a bit-exact copy, and the decode products are
batch-invariant (``ops/stream_matmul.py``), so a resumed request's greedy
tokens equal those of a run that was never preempted.

On torch:

- **swap-out** gathers the victim's blocks from every layer's pool tensor
  with one ``index_select`` a tensor into its slice of one pinned host
  buffer (one copy a pool tensor, then one stream synchronize before the
  checksum reads it).
- **swap-in** scatters the uploaded blocks back with ``index_copy_`` into
  the SAME pool tensors: the executor's CUDA graphs read the pools by
  address, so a pool is never reallocated or replaced, and a resumed
  request replays the graphs already captured.
- Prefix-cache integration, as in JAX: the victim's chain hashes ride in
  the :class:`SwapHandle`; swap-out frees the device blocks through the
  refcount path (hashed prompt blocks land on the LRU, still shareable);
  swap-in first re-matches those hashes (``BlockAllocator.match_hashes``)
  and uploads only the rest.

The warm tier (:class:`WarmTier`) is the middle rung of the hot (device)
→ warm (host) → cold (re-prefill) ladder: under pool pressure the server
demotes its coldest cached prefix blocks (:meth:`KVOffloadEngine.demote`:
the swap-out gather, each block's CRC taken after the copy has
synchronised), and a later prefix match promotes them
(:meth:`KVOffloadEngine.match_prefix_tiered`: fresh blocks written with
``index_copy_`` into the same pool tensors). A swapped-in or promoted
payload covers its whole block (int8 codes and scales included), so those
blocks are never cleared: ``PagedExecutor.clear_blocks`` clears only the
blocks a pass writes first.

Fault hooks (``faults``: a :class:`~paddle_tpu_torch.faults.FaultInjector`):
``host_put`` makes the host pool refuse a swap-out, ``swap_corrupt`` flips
a bit of a parked payload before its CRC is checked (the server then
re-prefills the request), and the warm walk fires ``warm_corrupt``, a site
that ``faults.SITES`` does not list, as the JAX module does: no plan can
reach it. With ``telemetry`` set (the server's
:class:`~paddle_tpu_torch.telemetry.ServingTelemetry`, enabled), the copies
emit ``swap_out`` / ``swap_in`` spans and the ``serving_swap_*`` and
``serving_tier_*`` histograms and counters; a span runs from the call to
its return (a swap-out's copy has synchronised by then; a swap-in's or a
promotion's upload is only enqueued, as JAX's dispatch is).

Only the blocks a victim holds move (JAX pads every copy to the table
width, to compile one program; eager copies need no padding).
"""
from __future__ import annotations

import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["SwapHandle", "HostKVPool", "WarmTier", "KVOffloadEngine",
           "payload_checksum"]


def payload_checksum(arrays: Sequence) -> int:
    """CRC32 over a parked payload's raw bytes (order-sensitive): numpy
    arrays or CPU tensors (any dtype, bfloat16 included)."""
    c = 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.contiguous().reshape(-1).view(torch.uint8).numpy()
        c = zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8), c)
    return c


@dataclass
class SwapHandle:
    """Resume ticket for one preempted request: where it stopped, which
    chain hashes its prompt blocks carry, and how much host memory the
    parked copy occupies. The block CONTENTS live in the
    :class:`HostKVPool` under ``rid``."""

    rid: int
    n_tokens: int            # KV-valid positions [0, n_tokens)
    last_token: int          # next decode input (its KV is not written yet)
    n_blocks: int            # live table entries parked on host
    # chain hashes of its leading full prompt blocks
    hashes: List[int] = field(default_factory=list)
    nbytes: int = 0          # logical bytes charged to the host pool
    checksum: int = 0        # CRC32 of the parked payload (0 = unverified)


class HostKVPool:
    """Byte-budgeted host store for swapped block stacks.

    ``capacity_bytes=None`` means unbounded (host DRAM dwarfs HBM); a
    bounded pool makes :meth:`put` refuse once full, which the server
    treats as "this victim cannot be preempted"."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0 or None, got {capacity_bytes}")
        self.capacity_bytes = capacity_bytes
        self._store: Dict[int, List] = {}
        self.bytes_in_use = 0
        self.bytes_peak = 0
        self.puts = 0
        self.takes = 0
        # refusals are a capacity signal: the server's telemetry snapshot
        # exports every stats() field as a serving_host_pool_* gauge
        self.rejects = 0

    def fits(self, nbytes: int) -> bool:
        return (self.capacity_bytes is None
                or self.bytes_in_use + nbytes <= self.capacity_bytes)

    def put(self, rid: int, arrays: List, nbytes: int) -> bool:
        if rid in self._store:
            raise KeyError(f"request {rid} already has a parked KV copy")
        if not self.fits(nbytes):
            self.rejects += 1
            return False
        self._store[rid] = arrays
        self.bytes_in_use += nbytes
        self.bytes_peak = max(self.bytes_peak, self.bytes_in_use)
        self.puts += 1
        return True

    def take(self, rid: int, nbytes: int) -> List:
        arrays = self._store.pop(rid)
        self.bytes_in_use -= nbytes
        self.takes += 1
        return arrays

    def peek(self, rid: int) -> List:
        """Read a parked payload without removing it — ``snapshot()``
        copies already-swapped requests' KV through this."""
        return self._store[rid]

    def discard(self, rid: int, nbytes: int) -> None:
        if self._store.pop(rid, None) is not None:
            self.bytes_in_use -= nbytes

    def stats(self) -> Dict[str, int]:
        return {"bytes_in_use": self.bytes_in_use,
                "bytes_peak": self.bytes_peak,
                "puts": self.puts, "takes": self.takes,
                "rejects": self.rejects,
                "parked": len(self._store)}

    def __len__(self) -> int:
        return len(self._store)


class WarmTier:
    """Hash-keyed warm tier: per-block host copies of DEMOTED prefix
    blocks, addressable by the chain hash the allocator's prefix cache
    uses. Where :class:`HostKVPool` parks whole per-request block stacks
    under a rid, the warm tier holds single shareable prompt blocks under
    their content hash; a later prefix match promotes one back,
    CRC-verified, and a failed check breaks the chain walk (the request
    re-prefills those tokens — the cold rung, never wrong tokens).

    An entry is one host buffer of the block's bytes, held as a view a
    pool tensor. LRU over chain hashes; a bounded tier evicts its coldest
    entries to make room (the block falls to the cold tier). Bytes are
    ledgered apart from the swap pool, so that the server's conservation
    audit holds each ledger to its own invariant."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0 or None, got {capacity_bytes}")
        self.capacity_bytes = capacity_bytes
        # chain_hash -> (per-pool block tensors, nbytes, checksum)
        self._store: "OrderedDict[int, Tuple[List, int, int]]" = \
            OrderedDict()
        self.bytes_in_use = 0
        self.bytes_peak = 0
        self.demoted_blocks = 0
        self.promoted_blocks = 0
        self.hit_blocks = 0
        self.rejects = 0
        self.evictions = 0
        self.corruptions = 0

    def __contains__(self, chain_hash: int) -> bool:
        return chain_hash in self._store

    def __len__(self) -> int:
        return len(self._store)

    def put(self, chain_hash: int, arrays: List, nbytes: int,
            checksum: int) -> bool:
        """Admit one demoted block; evicts coldest entries until it fits.
        False (and ``rejects`` ticks) when it can never fit."""
        if chain_hash in self._store:
            return True                   # already warm: nothing to copy
        if self.capacity_bytes is not None:
            if nbytes > self.capacity_bytes:
                self.rejects += 1
                return False
            while self.bytes_in_use + nbytes > self.capacity_bytes:
                _, (_, old_bytes, _) = self._store.popitem(last=False)
                self.bytes_in_use -= old_bytes
                self.evictions += 1
        self._store[chain_hash] = (arrays, int(nbytes), int(checksum))
        self.bytes_in_use += nbytes
        self.bytes_peak = max(self.bytes_peak, self.bytes_in_use)
        self.demoted_blocks += 1
        return True

    def peek(self, chain_hash: int) -> Tuple[List, int, int]:
        """Read an entry without removing it (refreshes its LRU
        position)."""
        self._store.move_to_end(chain_hash)
        return self._store[chain_hash]

    def take(self, chain_hash: int) -> Tuple[List, int, int]:
        """Remove an entry — promotion back to the device (the bytes move
        tiers) or a corruption drop."""
        entry = self._store.pop(chain_hash)
        self.bytes_in_use -= entry[1]
        return entry

    def drop_corrupt(self, chain_hash: int) -> None:
        self.take(chain_hash)
        self.corruptions += 1

    def entries(self) -> List[Tuple[int, List, int, int]]:
        """(hash, arrays, nbytes, checksum) rows in LRU order — what a
        snapshot carries (``GenerationServer.snapshot`` / ``evacuate``)."""
        return [(h, arrs, nb, crc)
                for h, (arrs, nb, crc) in self._store.items()]

    def clear(self) -> None:
        """Drop every entry (a full evacuate: the snapshot carries the
        copies). Counters keep their history; only occupancy resets."""
        self._store.clear()
        self.bytes_in_use = 0

    def stats(self) -> Dict[str, int]:
        return {"blocks": len(self._store),
                "bytes_in_use": self.bytes_in_use,
                "bytes_peak": self.bytes_peak,
                "demoted_blocks": self.demoted_blocks,
                "promoted_blocks": self.promoted_blocks,
                "hit_blocks": self.hit_blocks,
                "rejects": self.rejects,
                "evictions": self.evictions,
                "corruptions": self.corruptions}


def _host_buffer(shapes, dtypes, pin: bool) -> List[torch.Tensor]:
    """One host buffer (pinned when ``pin``) holding a tensor of each shape
    and dtype, each 16-byte aligned; returns the tensors."""
    sizes = [int(np.prod(sh)) * torch.empty((), dtype=dt).element_size()
             for sh, dt in zip(shapes, dtypes)]
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + -(-size // 16) * 16)
    buf = torch.empty(starts[-1], dtype=torch.uint8, pin_memory=pin)
    return [buf[off:off + size].view(dt).view(sh)
            for sh, dt, size, off in zip(shapes, dtypes, sizes, starts)]


def _own_block(arrays: List[torch.Tensor], i: int
               ) -> Tuple[List[torch.Tensor], int]:
    """Block ``i`` of a gathered payload (one tensor a pool, leading dim the
    blocks) copied into one host buffer of its own — a warm entry holds
    exactly its block's bytes — as a view a pool, and the CRC32 of those
    bytes (:func:`payload_checksum` of the views, in one pass)."""
    rows = [a[i] for a in arrays]
    buf = torch.cat([r.reshape(-1).view(torch.uint8) for r in rows])
    out, off = [], 0
    for r in rows:
        n = r.numel() * r.element_size()
        out.append(buf[off:off + n].view(r.dtype).view(r.shape))
        off += n
    return out, zlib.crc32(buf.numpy())


class KVOffloadEngine:
    """Swap-out / swap-in, demotion and promotion over a server's flat pool
    list (every layer's K and V pool tensors, or int8 codes and scales),
    which it updates in place. Keeps the host pool, the warm tier, and
    ``swap_out_s``, the host wall time of the swap-outs' device-to-host
    copies (each waited for)."""

    def __init__(self, alloc, capacity_bytes: Optional[int] = None,
                 warm_capacity_bytes: Optional[int] = None):
        self.alloc = alloc
        self.host = HostKVPool(capacity_bytes)
        self.swap_out_s = 0.0
        # hash-addressed warm tier for demoted prefix blocks; the
        # allocator's read-only probe consults it through warm_probe
        self.warm = WarmTier(warm_capacity_bytes)
        alloc.warm_probe = self.warm.__contains__
        # optional ServingTelemetry, set by the owning server (spans and
        # histograms of the copies)
        self.telemetry = None
        # optional FaultInjector: the host_put / swap_corrupt hooks
        self.faults = None

    def _timed(self) -> bool:
        tel = self.telemetry
        return tel is not None and tel.enabled

    # ------------------------------------------------------------ KV capture
    def gather_payload(self, table: Sequence[int],
                       pools: List[torch.Tensor]) -> List[torch.Tensor]:
        """Non-destructive device-to-host copy of a table's blocks: one
        ``index_select`` a pool tensor, each copied into its slice of one
        pinned host buffer (on a CUDA device; one allocation a payload,
        which the caching host allocator reuses), complete when this
        returns. Returns a view of the buffer a pool tensor."""
        if not pools:
            return []
        dev = pools[0].device
        n = len(table)
        idx = torch.tensor(list(table), dtype=torch.long, device=dev)
        pin = dev.type == "cuda"
        out = _host_buffer([(n,) + tuple(p.shape[1:]) for p in pools],
                           [p.dtype for p in pools], pin)
        for p, host in zip(pools, out):
            host.copy_(torch.index_select(p, 0, idx), non_blocking=pin)
        if pin:
            torch.cuda.current_stream(dev).synchronize()
        return out

    # ----------------------------------------------------------- tier ladder
    def demote(self, victims: Sequence[Tuple[int, int]],
               pools: List[torch.Tensor]) -> int:
        """Move cached (ref 0) prefix blocks from the device to the warm
        tier. ``victims`` is ``[(bid, chain_hash), ...]`` from
        ``BlockAllocator.coldest_cached``. One gather
        (:meth:`gather_payload`, synchronised before it returns, so that
        no block is handed out again before its bytes are on the host)
        copies every victim; each block is then CRC-stamped and admitted
        to the warm tier, and only blocks the tier accepted leave the
        device's prefix cache (``evict_cached``). Returns the number of
        blocks demoted."""
        if not victims:
            return 0
        timed = self._timed()
        t0 = self.telemetry.clock() if timed else 0.0
        a = self.alloc
        arrays = self.gather_payload([bid for bid, _ in victims], pools)
        moved = 0
        for i, (bid, h) in enumerate(victims):
            block, checksum = _own_block(arrays, i)
            if not self.warm.put(h, block, a.bytes_per_block, checksum):
                break                     # the tier can never hold it
            a.evict_cached(bid)
            moved += 1
        if timed and moved:
            reg = self.telemetry.registry
            reg.histogram(
                "serving_tier_demote_s",
                "HBM->warm tier demotion wall time (batched)"
            ).observe(self.telemetry.clock() - t0)
            reg.counter(
                "serving_tier_demoted_bytes",
                "KV bytes demoted to the warm tier"
            ).inc(moved * a.bytes_per_block)
        return moved

    def match_prefix_tiered(self, tokens: Sequence[int],
                            pools: List[torch.Tensor], salt: tuple = ()
                            ) -> Tuple[List[int], List[torch.Tensor],
                                       Dict[str, int]]:
        """Cross-tier prefix match, the warm-aware twin of
        ``BlockAllocator.match_prefix`` (``salt`` seeds the chain as
        there). Walks the chain hashes of ``tokens`` (last-token rule): a
        hot hit re-refs the resident block; a warm hit allocates a fresh
        device block and CRC-verifies the parked copy; the warm hits are
        then stacked into one pinned host buffer (on a CUDA device) and
        written with one ``index_copy_`` a pool tensor, in place, and
        registered under their hashes. The first miss (or a failed CRC, or
        a dry device pool) stops the walk; tokens past it re-prefill,
        which IS the cold tier.

        Returns ``(table, pools, {"hot": n, "warm": n})`` — every block in
        ``table`` is ref'd for the caller; ``pools`` is the same list."""
        a = self.alloc
        limit = max((len(tokens) - 1) // a.block_size, 0)
        hashes = a.chain_hashes(tokens, salt)[:limit]
        table: List[int] = []
        warm_bids: List[int] = []
        warm_hashes: List[int] = []
        warm_blocks: List[List[torch.Tensor]] = []
        hot = 0
        for h in hashes:
            bid = a.ref_hash(h)
            if bid is not None:
                table.append(bid)
                hot += 1
                continue
            if h not in self.warm:
                break
            arrs, _, checksum = self.warm.peek(h)
            if self.faults is not None and \
                    self.faults.fire("warm_corrupt") is not None:
                arrs = [x.clone() for x in arrs]
                self.faults.corrupt(arrs)
            if checksum and payload_checksum(arrs) != checksum:
                # a damaged parked block: drop it (cold from here on)
                self.warm.drop_corrupt(h)
                if self._timed():
                    self.telemetry.registry.counter(
                        "serving_tier_corruptions",
                        "warm-tier blocks that failed CRC verification"
                    ).inc()
                break
            if a.blocks_free + a.evictable_cached < 1:
                break                     # no headroom to promote into
            try:
                bid = a.alloc()
            except RuntimeError:
                break
            table.append(bid)
            warm_bids.append(bid)
            warm_hashes.append(h)
            warm_blocks.append(arrs)
        a.prefix_lookup_blocks += len(hashes)
        a.prefix_hit_blocks += hot
        if warm_bids:
            timed = self._timed()
            t0 = self.telemetry.clock() if timed else 0.0
            dev = pools[0].device
            pin = dev.type == "cuda"
            idx = torch.tensor(warm_bids, dtype=torch.long, device=dev)
            n = len(warm_blocks)
            stacks = _host_buffer(
                [(n,) + tuple(x.shape) for x in warm_blocks[0]],
                [x.dtype for x in warm_blocks[0]], pin)
            for j, (p, stack) in enumerate(zip(pools, stacks)):
                torch.stack([blk[j] for blk in warm_blocks], out=stack)
                p.index_copy_(0, idx, stack.to(dev, non_blocking=pin))
            for bid, h in zip(warm_bids, warm_hashes):
                a.register(bid, h)
                self.warm.take(h)         # the bytes move tiers
            self.warm.promoted_blocks += len(warm_bids)
            self.warm.hit_blocks += len(warm_bids)
            a.note_promote(len(warm_bids))
            if timed:
                reg = self.telemetry.registry
                reg.histogram(
                    "serving_tier_promote_s",
                    "warm->HBM tier promotion wall time (batched)"
                ).observe(self.telemetry.clock() - t0)
                reg.counter(
                    "serving_tier_promoted_bytes",
                    "KV bytes promoted back from the warm tier"
                ).inc(len(warm_bids) * a.bytes_per_block)
        return table, pools, {"hot": hot, "warm": len(warm_bids)}

    def forget_warm(self, chain_hash: int) -> None:
        """A hash just (re)registered in the hot prefix cache supersedes
        any warm copy (same chain hash, same KV by construction): drop it,
        so that no hash is resident in both tiers."""
        if chain_hash in self.warm:
            self.warm.take(chain_hash)

    def tier_stats(self) -> Dict[str, int]:
        """Warm-tier occupancy and traffic, ``warm_``-prefixed for merging
        into ``GenerationServer.kv_stats()``."""
        return {f"warm_{k}": v for k, v in self.warm.stats().items()}

    # ------------------------------------------------------------- swap out
    def swap_out(self, rid: int, table: Sequence[int], hashes: Sequence[int],
                 pools: List[torch.Tensor], n_tokens: int,
                 last_token: int) -> Optional[SwapHandle]:
        """Park a request's KV on host and free its device blocks.

        ``table`` must already be truncated to exactly the blocks covering
        ``n_tokens`` (the server drops speculative reservations first).
        Returns None — and changes nothing — when the host pool is full
        (or an injected ``host_put`` fault says it is)."""
        timed = self._timed()
        tel = self.telemetry
        t_tel = tel.clock() if timed else 0.0
        a = self.alloc
        n = len(table)
        nbytes = n * a.bytes_per_block
        if self.faults is not None and \
                self.faults.fire("host_put") is not None:
            return None
        if not self.host.fits(nbytes):
            return None
        t0 = time.perf_counter()
        arrays = self.gather_payload(table, pools)
        self.swap_out_s += time.perf_counter() - t0
        checksum = payload_checksum(arrays)
        if not self.host.put(rid, arrays, nbytes):
            return None
        for bid in table:
            a.free(bid)                   # hashed blocks land on the LRU
        a.note_swap_out(n, nbytes)
        if timed:
            t1 = tel.clock()
            tel.registry.histogram(
                "serving_swap_out_s",
                "device->host KV swap-out wall time").observe(t1 - t_tel)
            tel.registry.counter(
                "serving_swap_out_bytes", "KV bytes parked to host").inc(
                    nbytes)
            tel.tracer.complete(rid, "swap_out", t_tel, t1, blocks=n,
                                bytes=nbytes)
        return SwapHandle(rid=rid, n_tokens=int(n_tokens),
                          last_token=int(last_token), n_blocks=n,
                          hashes=list(hashes), nbytes=nbytes,
                          checksum=checksum)

    # -------------------------------------------------------------- swap in
    def restore_cost(self, handle: SwapHandle) -> int:
        """Upper bound on fresh device blocks a resume needs (the server's
        admission headroom check): leading chain hashes still resident
        restore for free. Read-only."""
        resident = 0
        for h in handle.hashes:
            if not self.alloc.contains_hash(h):
                break
            resident += 1
        return max(handle.n_blocks - resident, 0)

    def swap_in(self, handle: SwapHandle, pools: List[torch.Tensor]
                ) -> Union[None, str, Tuple[List[int], List[torch.Tensor]]]:
        """Restore a parked request: re-match still-resident prefix blocks
        by chain hash (no upload), allocate and upload the rest with one
        ``index_copy_`` a pool tensor (in place), and re-register restored
        full prompt blocks for prefix sharing (dropping their warm
        copies).

        Returns ``(table, pools)``; None — changing nothing — if the
        device pool lacks headroom (the caller keeps the entry queued); or
        ``"corrupt"`` when the parked payload fails its CRC check (the
        payload is dropped and the accounting rolled back; the caller
        re-prefills the request from its tokens). An injected
        ``swap_corrupt`` fault flips a bit of a copy of the payload (it
        may be shared with a snapshot) before the check."""
        timed = self._timed()
        tel = self.telemetry
        t0 = tel.clock() if timed else 0.0
        a = self.alloc
        matched = a.match_hashes(handle.hashes)
        need = handle.n_blocks - len(matched)
        if a.blocks_free + a.evictable_cached < need:
            for bid in matched:           # roll back: nothing restored
                a.free(bid)
            return None
        fresh: List[int] = []
        try:
            for _ in range(need):
                fresh.append(a.alloc())
        except RuntimeError:
            # headroom said yes but alloc refused (an injected exhaustion
            # fault): roll everything back
            for bid in fresh + matched:
                a.free(bid)
            return None
        table = matched + fresh
        arrays = self.host.take(handle.rid, handle.nbytes)
        if self.faults is not None and \
                self.faults.fire("swap_corrupt") is not None:
            arrays = [x.clone() for x in arrays]
            self.faults.corrupt(arrays)
        if handle.checksum and payload_checksum(arrays) != handle.checksum:
            for bid in table:
                a.free(bid)
            a.note_host_release(handle.nbytes)
            if timed:
                tel.registry.counter(
                    "serving_swap_corruptions",
                    "parked KV payloads that failed CRC verification"
                ).inc()
            return "corrupt"
        if fresh:
            dev = pools[0].device
            idx = torch.tensor(fresh, dtype=torch.long, device=dev)
            lo = len(matched)
            for p, arr in zip(pools, arrays):
                p.index_copy_(0, idx, arr[lo:handle.n_blocks].to(
                    dev, non_blocking=dev.type == "cuda"))
        for i in range(len(matched), min(len(handle.hashes), len(table))):
            a.register(table[i], handle.hashes[i])
            self.forget_warm(handle.hashes[i])
        a.note_swap_in(handle.n_blocks, handle.nbytes)
        if timed:
            t1 = tel.clock()
            tel.registry.histogram(
                "serving_swap_in_s",
                "host->device KV swap-in wall time").observe(t1 - t0)
            tel.registry.counter(
                "serving_swap_in_bytes",
                "KV bytes restored from host").inc(handle.nbytes)
            tel.tracer.complete(handle.rid, "swap_in", t0, t1,
                                blocks=handle.n_blocks,
                                prefix_hits=len(matched),
                                bytes=handle.nbytes)
        return table, pools

    def discard(self, handle: SwapHandle) -> None:
        """Drop a parked copy without restoring it (cancelled request)."""
        self.host.discard(handle.rid, handle.nbytes)
        self.alloc.note_host_release(handle.nbytes)

    def adopt(self, handle: SwapHandle, arrays: List) -> None:
        """Re-park a captured payload into this engine's host pool (restore
        or migration): the request then resumes through the checksum-
        verified :meth:`swap_in`, so a payload corrupted in transit
        degrades to re-prefill instead of wrong tokens."""
        if not self.host.put(handle.rid, arrays, handle.nbytes):
            raise RuntimeError(
                f"host pool cannot hold restored request {handle.rid} "
                f"({handle.nbytes} bytes) — raise host_pool_bytes on the "
                f"restoring server")
        self.alloc.note_swap_out(handle.n_blocks, handle.nbytes)
