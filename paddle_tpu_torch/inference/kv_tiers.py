"""Two-tier KV memory plane: a host-RAM capacity tier under the block table
(port of ``paddle_tpu/inference/kv_tiers.py``).

The device pool (:class:`~paddle_tpu_torch.inference.paged_cache
.PagedKVCache`) is the hot tier; this module is the capacity tier, a
host-RAM block pool holding whole spilled pages (the raw storage rows plus,
on quantized pools, their row-parallel scale rows) keyed like the structures
they left: prefix pages by chained block hash, parked-request pages by a
per-spill slot key.

Rules the pool enforces, as in the reference:

* pages move whole and bitwise — a spill is one device-to-host gather of a
  block's rows over every layer, a restore writes the same raw storage
  back; int8/fp8 pages move as their bytes, so a restored page re-enters
  the prefix index bit for bit.
* prefix pages are unpinned: at the byte budget the least recently used
  unpinned page is dropped (``host_evictions``). Parked-request pages are
  pinned (dropping one would lose live sequence state), and a ``put`` that
  cannot make room refuses instead.
* accounting is block-exact (``num/used/free/available``), so a leak drill
  can assert ``free == num == available`` on both tiers after a drain.

A :class:`HostPage` holds CPU tensors (pinned when the cache is on a CUDA
device, so a restore's host-to-device copy is asynchronous); the pool
itself only counts and orders them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

__all__ = ["HostPage", "HostKVTier"]


class HostPage:
    """One spilled block: raw storage rows over every layer (``[layers,
    block_size, kv_heads, head_dim]``) and, on a quantized pool, the
    parallel scale rows (``[layers, block_size, kv_heads]``)."""

    __slots__ = ("k", "v", "k_scale", "v_scale")

    def __init__(self, k, v, k_scale=None, v_scale=None):
        self.k = k
        self.v = v
        self.k_scale = k_scale
        self.v_scale = v_scale

    @property
    def nbytes(self) -> int:
        n = self.k.nbytes + self.v.nbytes
        if self.k_scale is not None:
            n += self.k_scale.nbytes + self.v_scale.nbytes
        return n


class HostKVTier:
    """Host-RAM block pool with LRU eviction of unpinned pages."""

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        self._pages: "OrderedDict[object, HostPage]" = OrderedDict()
        self._pinned: Dict[object, bool] = {}
        # telemetry, read through PagedKVCache.tier_stats
        self.spills = 0
        self.restores = 0
        self.spill_bytes = 0
        self.restore_bytes = 0
        self.spill_seconds = 0.0
        self.restore_seconds = 0.0
        self.host_evictions = 0

    @classmethod
    def from_bytes(cls, byte_budget: int,
                   bytes_per_block: int) -> "HostKVTier":
        """Size the pool from a byte budget in whole blocks; a budget below
        one block gives a zero-capacity tier (every spill refuses and the
        device pool falls back to plain eviction)."""
        return cls(max(0, int(byte_budget) // max(1, int(bytes_per_block))))

    # -- accounting -----------------------------------------------------
    @property
    def used_blocks(self) -> int:
        return len(self._pages)

    @property
    def free_blocks(self) -> int:
        return self.num_blocks - len(self._pages)

    @property
    def available_blocks(self) -> int:
        """Free blocks plus unpinned (evictable) resident pages: what a
        pinned ``put`` could obtain right now."""
        return self.free_blocks + sum(
            1 for k in self._pages if not self._pinned.get(k, False))

    # -- pool -----------------------------------------------------------
    def __contains__(self, key: object) -> bool:
        return key in self._pages

    def get(self, key: object) -> Optional[HostPage]:
        return self._pages.get(key)

    def touch(self, key: object) -> None:
        if key in self._pages:
            self._pages.move_to_end(key)

    def put(self, key: object, page: HostPage,
            pinned: bool = False) -> Optional[List[object]]:
        """Insert a page, evicting LRU unpinned pages while the pool is
        full. Returns the evicted keys (so the owner can drop its own index
        entries), or None when no room could be made: the page was not
        inserted and the caller must fall back."""
        evicted: List[object] = []
        if key in self._pages:  # replace in place
            self._pages.move_to_end(key)
            self._pages[key] = page
            self._pinned[key] = bool(pinned)
            return evicted
        while len(self._pages) >= self.num_blocks:
            victim = next((k for k in self._pages
                           if not self._pinned.get(k, False)), None)
            if victim is None:
                return None
            del self._pages[victim]
            self._pinned.pop(victim, None)
            self.host_evictions += 1
            evicted.append(victim)
        self._pages[key] = page
        self._pinned[key] = bool(pinned)
        return evicted

    def pop(self, key: object) -> Optional[HostPage]:
        self._pinned.pop(key, None)
        return self._pages.pop(key, None)

    # -- telemetry ------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return {
            "host_num_blocks": self.num_blocks,
            "host_used_blocks": self.used_blocks,
            "host_free_blocks": self.free_blocks,
            "host_available_blocks": self.available_blocks,
            "spills": self.spills,
            "restores": self.restores,
            "spill_bytes": self.spill_bytes,
            "restore_bytes": self.restore_bytes,
            "spill_seconds": self.spill_seconds,
            "restore_seconds": self.restore_seconds,
            "host_evictions": self.host_evictions,
        }
