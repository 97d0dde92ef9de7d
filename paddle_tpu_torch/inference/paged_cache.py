"""Paged KV cache for serving (port of
``paddle_tpu/inference/paged_cache.py``).

Layout ``[layers, num_blocks * block_size + 1, kv_heads, head_dim]``: flat
and token-major, so a block-table gather indexes one axis and a write is
one ``index_copy_`` at ``slot = block_id * block_size + offset``. The one
extra row at index ``num_blocks * block_size`` is the sentinel slot: the
reference's bucket-pad tokens scatter there with ``mode="drop"``, which
torch has no counterpart of, so here they write into this spare row, which
no block table ever names. That keeps the write a single device op with no
host sync (a boolean mask would need one).

The cache is updated in place — the JAX package rebinds functional
arrays and donates them through the jitted step instead.

The allocator is host-side Python (a free list); the block table is also
kept device-resident (:meth:`tables_device`) with host mutations queued as
``(slot, index, block)`` deltas and applied in one scatter per step. A
hybrid attention+SSM engine sizes the cache by its attention layers only
(``num_layers``); its SSM layers keep per-slot state instead of pages.

Quantized pages (``quant="int8"`` or ``"fp8"``): the pages hold int8 or
fp8 e4m3 values and two fp32 arrays ``k_scale``/``v_scale [layers, rows +
1, kv_heads]`` hold each token row's per-head abs-max scale, laid out
parallel to the pages (sentinel row included), so a write lands the scales
at the same slots as the rows and freeing a block frees both.
A KV handoff (``inference/kv_handoff.py``) reads a request's rows with one
gather over every layer and lands them with :meth:`write_all` (or
:meth:`write_all_quantized`, pages and scales as they are), and carries the
blocks' refcounts. Without a prefix index every owned block's refcount is
1; prefix sharing (the index, copy-on-write) and the host-RAM tier are not
ported yet (ROADMAP.md A.6, A.7), so :meth:`slot_spill_pages` is None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.quantization import kv as _kvq

__all__ = ["PagedKVCache"]


class PagedKVCache:
    #: the host-RAM tier (``kv_tiers.HostKVTier``): not ported (A.7)
    host_tier = None

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int, max_seqs: int,
                 dtype: torch.dtype = torch.float32,
                 blocks_per_seq: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 quant: Optional[str] = None):
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_seqs = max_seqs
        self.device = torch.device(device or "cpu")
        rows = num_blocks * block_size
        shape = (num_layers, rows + 1, num_kv_heads, head_dim)
        self.quant = quant
        self.k_scale = self.v_scale = None
        if quant is None:
            self.k = torch.zeros(shape, dtype=dtype, device=self.device)
            self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        else:
            # int8 or fp8 pages, made, written and gathered through byte
            # views (every torch has those kernels for uint8)
            dtype = _kvq.storage_dtype(quant)
            self.k = torch.zeros(shape, dtype=torch.uint8,
                                 device=self.device).view(dtype)
            self.v = torch.zeros(shape, dtype=torch.uint8,
                                 device=self.device).view(dtype)
            self.k_scale = torch.zeros(shape[:-1], dtype=_kvq.scale_dtype(),
                                       device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        # host-side bookkeeping
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: List[List[int]] = [[] for _ in range(max_seqs)]
        self.seq_lens = np.zeros((max_seqs,), np.int32)
        self._active = [False] * max_seqs
        # device-resident block table + pending host-side deltas
        self._bps = int(blocks_per_seq if blocks_per_seq is not None
                        else num_blocks)
        self._tables_dev = torch.zeros((max_seqs, self._bps),
                                       dtype=torch.int32, device=self.device)
        self._dirty: List[Tuple[int, int, int]] = []
        # refcounts adopted from a handoff record (block -> count); a block
        # absent here counts 1, its owner's
        self._refs: Dict[int, int] = {}

    @property
    def sentinel(self) -> int:
        """Write slot of pad tokens: the spare row past the last block."""
        return self.num_blocks * self.block_size

    def layer(self, li: int) -> Tuple[torch.Tensor, torch.Tensor,
                                      Optional[torch.Tensor],
                                      Optional[torch.Tensor]]:
        """Layer ``li``'s pages ``[num_blocks*block_size, kv, d]`` and, for a
        quantized pool, their scales ``[num_blocks*block_size, kv]`` (None
        otherwise): ``(k, v, k_scale, v_scale)``, views without the
        sentinel row."""
        rows = self.sentinel
        if self.quant is None:
            return self.k[li, :rows], self.v[li, :rows], None, None
        return (self.k[li, :rows], self.v[li, :rows],
                self.k_scale[li, :rows], self.v_scale[li, :rows])

    # -- allocator ------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def available_blocks(self) -> int:
        """Blocks an allocation could obtain right now (the free list;
        the reference adds evictable prefix-index entries, not ported)."""
        return len(self._free)

    def allocate_slot(self) -> Optional[int]:
        for i in range(self.max_seqs):
            if not self._active[i]:
                self._active[i] = True
                self._tables[i] = []
                self.seq_lens[i] = 0
                return i
        return None

    def free_slot(self, slot: int) -> None:
        for b in self._tables[slot]:
            self._refs.pop(b, None)
        self._free.extend(reversed(self._tables[slot]))
        self._tables[slot] = []
        self.seq_lens[slot] = 0
        self._active[slot] = False

    def ensure_capacity(self, slot: int, new_len: int) -> bool:
        """Grow ``slot``'s block list to cover ``new_len`` tokens; False
        if the pool is exhausted (the caller finishes or queues)."""
        need = -(-new_len // self.block_size)
        table = self._tables[slot]
        while len(table) < need:
            if not self._free:
                return False
            idx = len(table)
            b = self._free.pop()
            table.append(b)
            if idx < self._bps:
                self._dirty.append((slot, idx, b))
        return True

    def trim_slot(self, slot: int, new_len: int) -> None:
        """Drop trailing blocks not needed to cover ``new_len`` tokens."""
        need = max(1, -(-new_len // self.block_size)) if new_len > 0 else 0
        table = self._tables[slot]
        while len(table) > need:
            b = table.pop()
            self._refs.pop(b, None)
            self._free.append(b)

    def block_refs(self, slot: int) -> List[int]:
        """Refcounts of ``slot``'s blocks in table order (1 for a block
        its slot owns alone, the only kind without a prefix index)."""
        return [self._refs.get(b, 1) for b in self._tables[slot]]

    def set_block_refs(self, slot: int, refs: List[int]) -> None:
        """Adopt a handoff record's refcounts onto ``slot``'s blocks;
        table entries past the record's keep their own count."""
        for b, r in zip(self._tables[slot], refs):
            self._refs[b] = int(r)

    def slot_spill_pages(self, slot: int):
        """A slot's pages parked in the host tier: None, since the tier is
        not ported (ROADMAP.md A.7)."""
        return None

    def slot_mapping(self, slot: int, start: int, n: int) -> np.ndarray:
        """Flat cache positions for tokens ``[start, start+n)`` of a slot."""
        table = np.asarray(self._tables[slot], np.int64)
        pos = np.arange(start, start + n)
        return (table[pos // self.block_size] * self.block_size
                + pos % self.block_size).astype(np.int32)

    def tables_device(self) -> torch.Tensor:
        """Device-resident ``[max_seqs, blocks_per_seq]`` block table with
        the queued host deltas applied in one scatter. Entries past a
        sequence's length are stale and masked by ``valids`` downstream."""
        if self._dirty:
            d = np.asarray(self._dirty, np.int64)
            idx = torch.from_numpy(d[:, 0] * self._bps + d[:, 1])
            val = torch.from_numpy(d[:, 2].astype(np.int32))
            self._tables_dev.view(-1).index_copy_(
                0, idx.to(self.device), val.to(self.device))
            self._dirty.clear()
        return self._tables_dev

    def tables_array(self, slots) -> torch.Tensor:
        """The dense block-table rows of ``slots`` ``[len(slots),
        blocks_per_seq]`` on the cache's device (the reference's
        ``tables_array()[slots]``): the device table after the queued
        deltas, where entries past a sequence's length are stale and masked
        by its length downstream."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        return self.tables_device()[idx]

    # -- device writes --------------------------------------------------
    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
              slots: torch.Tensor) -> None:
        """Write ``k_new``/``v_new [n, kv, d]`` at flat positions ``slots
        [n]`` of one layer, in place; pad tokens aimed at
        :attr:`sentinel` land in the spare row. A quantized pool quantizes
        the full-width rows on scatter and writes their scales at the same
        slots."""
        slots = slots.to(device=self.device, dtype=torch.long)
        if self.quant is not None:
            kq, ks = _kvq.quantize_kv(k_new, self.quant)
            vq, vs = _kvq.quantize_kv(v_new, self.quant)
            self.k[layer].view(torch.uint8).index_copy_(
                0, slots, kq.view(torch.uint8))
            self.v[layer].view(torch.uint8).index_copy_(
                0, slots, vq.view(torch.uint8))
            self.k_scale[layer].index_copy_(0, slots, ks)
            self.v_scale[layer].index_copy_(0, slots, vs)
            return
        self.k[layer].index_copy_(0, slots, k_new.to(self.k.dtype))
        self.v[layer].index_copy_(0, slots, v_new.to(self.v.dtype))

    def write_all(self, k_new: torch.Tensor, v_new: torch.Tensor,
                  slots) -> None:
        """Write ``k_new``/``v_new [layers, n, kv, d]`` at flat positions
        ``slots [n]`` of every layer at once (a handoff's install).
        Full-width rows; a quantized pool quantizes them on scatter."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        k_new = k_new.to(self.device)
        v_new = v_new.to(self.device)
        if self.quant is not None:
            kq, ks = _kvq.quantize_kv(k_new, self.quant)
            vq, vs = _kvq.quantize_kv(v_new, self.quant)
            self.write_all_quantized(kq, vq, ks, vs, slots)
            return
        self.k.index_copy_(1, idx, k_new.to(self.k.dtype))
        self.v.index_copy_(1, idx, v_new.to(self.v.dtype))

    def write_all_quantized(self, kq: torch.Tensor, vq: torch.Tensor,
                            ks: torch.Tensor, vs: torch.Tensor,
                            slots) -> None:
        """Write already-quantized pages ``[layers, n, kv, d]`` and their
        scales ``[layers, n, kv]`` at ``slots`` of every layer, as they are
        (a handoff between two pools of one quant mode)."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        for dst, src in ((self.k, kq), (self.v, vq)):
            dst.view(torch.uint8).index_copy_(
                1, idx, src.to(self.device).view(torch.uint8))
        self.k_scale.index_copy_(1, idx, ks.to(self.device,
                                                self.k_scale.dtype))
        self.v_scale.index_copy_(1, idx, vs.to(self.device,
                                                self.v_scale.dtype))

    # -- sizing ---------------------------------------------------------
    @property
    def bytes_per_block(self) -> int:
        """Device bytes one block costs across all layers: its pages and,
        for a quantized pool, their scales (:func:`~paddle_tpu_torch.
        quantization.kv.page_row_bytes`; the sentinel row is no block's).
        Equal-byte pool sizing reads this."""
        kv, d = self.k.shape[-2], self.k.shape[-1]
        return (self.block_size * self.num_layers
                * _kvq.page_row_bytes(kv, d, self.k.dtype, self.quant))
