"""Host KV offload — swap preemption for the paged serving pool; port of
the swap half of ``paddle_tpu/inference/kv_offload.py`` (``payload_checksum``,
``SwapHandle``, ``HostKVPool`` and ``KVOffloadEngine``'s ``swap_out``,
``restore_cost``, ``swap_in``, ``discard`` and ``adopt``).

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

Only the blocks a victim holds move (JAX pads every copy to the table
width, to compile one program; eager copies need no padding). Not ported:
the warm tier (``WarmTier``, ``demote``, ``match_prefix_tiered``), the
fault hooks and the telemetry spans.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["SwapHandle", "HostKVPool", "KVOffloadEngine", "payload_checksum"]


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

    def fits(self, nbytes: int) -> bool:
        return (self.capacity_bytes is None
                or self.bytes_in_use + nbytes <= self.capacity_bytes)

    def put(self, rid: int, arrays: List, nbytes: int) -> bool:
        if rid in self._store:
            raise KeyError(f"request {rid} already has a parked KV copy")
        if not self.fits(nbytes):
            return False
        self._store[rid] = arrays
        self.bytes_in_use += nbytes
        self.bytes_peak = max(self.bytes_peak, self.bytes_in_use)
        return True

    def take(self, rid: int, nbytes: int) -> List:
        arrays = self._store.pop(rid)
        self.bytes_in_use -= nbytes
        return arrays

    def discard(self, rid: int, nbytes: int) -> None:
        if self._store.pop(rid, None) is not None:
            self.bytes_in_use -= nbytes

    def __len__(self) -> int:
        return len(self._store)


class KVOffloadEngine:
    """Swap-out / swap-in over a server's flat pool list (every layer's K
    and V pool tensors, or int8 codes and scales), which it updates in
    place. Keeps the host pool, and ``swap_out_s``, the host wall time of
    the swap-outs' device-to-host copies (each waited for)."""

    def __init__(self, alloc, capacity_bytes: Optional[int] = None):
        self.alloc = alloc
        self.host = HostKVPool(capacity_bytes)
        self.swap_out_s = 0.0

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
        sizes = [n * p[0].numel() * p.element_size() for p in pools]
        starts = [0]
        for size in sizes:              # each slice 16-byte aligned
            starts.append(starts[-1] + -(-size // 16) * 16)
        buf = torch.empty(starts[-1], dtype=torch.uint8, pin_memory=pin)
        out = []
        for p, size, off in zip(pools, sizes, starts):
            host = buf[off:off + size].view(p.dtype).view(
                (n,) + tuple(p.shape[1:]))
            host.copy_(torch.index_select(p, 0, idx), non_blocking=pin)
            out.append(host)
        if pin:
            torch.cuda.current_stream(dev).synchronize()
        return out

    # ------------------------------------------------------------- swap out
    def swap_out(self, rid: int, table: Sequence[int], hashes: Sequence[int],
                 pools: List[torch.Tensor], n_tokens: int,
                 last_token: int) -> Optional[SwapHandle]:
        """Park a request's KV on host and free its device blocks.

        ``table`` must already be truncated to exactly the blocks covering
        ``n_tokens`` (the server drops speculative reservations first).
        Returns None — and changes nothing — when the host pool is full."""
        import time

        a = self.alloc
        n = len(table)
        nbytes = n * a.bytes_per_block
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
        full prompt blocks for prefix sharing.

        Returns ``(table, pools)``; None — changing nothing — if the
        device pool lacks headroom (the caller keeps the entry queued); or
        ``"corrupt"`` when the parked payload fails its CRC check (the
        payload is dropped and the accounting rolled back)."""
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
            for bid in fresh + matched:
                a.free(bid)
            return None
        table = matched + fresh
        arrays = self.host.take(handle.rid, handle.nbytes)
        if handle.checksum and payload_checksum(arrays) != handle.checksum:
            for bid in table:
                a.free(bid)
            a.note_host_release(handle.nbytes)
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
        a.note_swap_in(handle.n_blocks, handle.nbytes)
        return table, pools

    def discard(self, handle: SwapHandle) -> None:
        """Drop a parked copy without restoring it (cancelled request)."""
        self.host.discard(handle.rid, handle.nbytes)
        self.alloc.note_host_release(handle.nbytes)

    def adopt(self, handle: SwapHandle, arrays: List) -> None:
        """Re-park a captured payload into this engine's host pool (restore
        or migration): the request then resumes through the checksum-
        verified :meth:`swap_in`."""
        if not self.host.put(handle.rid, arrays, handle.nbytes):
            raise RuntimeError(
                f"host pool cannot hold restored request {handle.rid} "
                f"({handle.nbytes} bytes) — raise host_pool_bytes on the "
                f"restoring server")
        self.alloc.note_swap_out(handle.n_blocks, handle.nbytes)
