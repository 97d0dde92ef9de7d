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
blocks' refcounts.

Cross-request prefix sharing, as in the reference: :meth:`register_prefix`
records a chained hash per full block of a prompt into an LRU index (the
index holds one reference on every indexed block, beside the slots'),
:meth:`adopt_prefix` links a new slot onto the longest indexed run, bumping
refcounts instead of re-prefilling, and gives an aligned, fully cached
prompt a private copy of its last block (the first decode token writes
there), so a shared page is never written while another holder can read
it. A block is freed only when its count reaches 0, and allocation under
pressure evicts (LRU) only index entries that no slot holds.
:meth:`_copy_block` is one ``index_copy_`` over every layer for each of the
pages and, on a quantized pool, the scales; it needs no host sync.

The host-RAM tier (``host_tier_bytes``; :mod:`~paddle_tpu_torch.inference
.kv_tiers`): under pressure a cold index entry spills its whole page to
host RAM instead of being evicted, a paused request's private tail can be
parked there (:meth:`spill_slot`), and both come back bitwise. On a CUDA
cache each direction is one batched transfer: out, one gather over every
layer and one copy into a pinned host buffer, after which the caller waits
for that copy before the device block is handed out again; in, one copy
from pinned memory and one ``index_copy_``. :meth:`stage_restore` issues
that copy on a side stream and records an event, which the compute stream
waits on before the ``index_copy_`` of :meth:`restore_slot`.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.inference.kv_tiers import HostKVTier, HostPage
from paddle_tpu_torch.quantization import kv as _kvq

__all__ = ["PagedKVCache"]


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A one-byte page (int8, fp8) as bytes: every torch has gather, scatter
    and cat kernels for uint8, not all for fp8."""
    if t.element_size() == 1 and t.dtype != torch.uint8:
        return t.view(torch.uint8)
    return t


class _Staged:
    """A restore whose host-to-device copy was issued on a side stream:
    the device planes, the event recorded after the copy, and the pinned
    sources kept alive until then."""

    __slots__ = ("planes", "event", "host")

    def __init__(self, planes, event, host):
        self.planes = planes
        self.event = event
        self.host = host


class PagedKVCache:
    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int, max_seqs: int,
                 dtype: torch.dtype = torch.float32,
                 blocks_per_seq: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 quant: Optional[str] = None,
                 host_tier_bytes: Optional[int] = None):
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
        # per-block refcounts: an allocated block starts at 1; freeing a
        # slot decrements and only a count of 0 returns the block to the
        # free list. A handoff carries counts, prefix sharing bumps them.
        self._refs: Dict[int, int] = {}
        # device-resident block table + pending host-side deltas
        self._bps = int(blocks_per_seq if blocks_per_seq is not None
                        else num_blocks)
        self._tables_dev = torch.zeros((max_seqs, self._bps),
                                       dtype=torch.int32, device=self.device)
        self._dirty: List[Tuple[int, int, int]] = []
        # prompt-prefix hash -> block id, insertion order == LRU order; the
        # index holds +1 ref on every entry's block
        self._prefix: "OrderedDict[bytes, int]" = OrderedDict()
        self.prefix_evictions = 0
        # the host-RAM tier (None: single-tier). ``_spilled`` holds the
        # prefix hashes whose page lives in the host tier; ``_slot_spill``
        # maps a slot to its parked page run.
        self.host_tier: Optional[HostKVTier] = (
            HostKVTier.from_bytes(host_tier_bytes, self.bytes_per_block)
            if host_tier_bytes else None)
        self._spilled: "OrderedDict[bytes, bool]" = OrderedDict()
        self._slot_spill: Dict[int, Dict] = {}
        self._spill_seq = 0
        self._side = None       # the staged restores' stream (CUDA)
        self.prefix_spills = 0
        self.prefix_restores = 0
        self.slot_spills = 0
        self.slot_restores = 0

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

    def _planes(self) -> List[torch.Tensor]:
        """The device tensors a page spans: pages, then (quantized) scales."""
        if self.quant is None:
            return [self.k, self.v]
        return [self.k, self.v, self.k_scale, self.v_scale]

    # -- allocator ------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def prefix_blocks(self) -> int:
        """Number of blocks the prefix index holds."""
        return len(self._prefix)

    @property
    def available_blocks(self) -> int:
        """Blocks an allocation could obtain right now: the free list plus
        index entries no sequence holds (evictable under pressure).
        Admission reads this; ``free_blocks`` alone undercounts a warm
        index."""
        return len(self._free) + sum(
            1 for b in self._prefix.values() if self._refs.get(b, 1) == 1)

    def allocate_slot(self) -> Optional[int]:
        for i in range(self.max_seqs):
            if not self._active[i]:
                self._active[i] = True
                self._tables[i] = []
                self.seq_lens[i] = 0
                return i
        return None

    def free_slot(self, slot: int) -> None:
        """Release a slot: each block's count drops by one and only a block
        left at 0 is freed (the index or another slot may hold the rest);
        parked pages die with the slot."""
        rec = self._slot_spill.pop(slot, None)
        if rec:
            for key in rec["keys"]:
                self.host_tier.pop(key)
        for b in reversed(self._tables[slot]):
            n = self._refs.get(b, 1) - 1
            if n <= 0:
                self._refs.pop(b, None)
                self._free.append(b)
            else:
                self._refs[b] = n
        self._tables[slot] = []
        self.seq_lens[slot] = 0
        self._active[slot] = False

    def _append_block(self, slot: int, b: int) -> None:
        idx = len(self._tables[slot])
        self._tables[slot].append(b)
        if idx < self._bps:
            self._dirty.append((slot, idx, b))

    def _take_block(self, exclude: Tuple[int, ...] = ()) -> Optional[int]:
        """One block from the free list, else the LRU index entry that only
        the index holds: spilled to the host tier where there is one (the
        page survives, bitwise), else evicted, so that allocation never
        fails only because the host budget is spent. ``exclude`` names
        blocks that must not be taken (runs about to be linked)."""
        if self._free:
            return self._free.pop()
        for h, b in self._prefix.items():
            if b in exclude:
                continue
            if self._refs.get(b, 1) == 1:  # only the index holds it
                if (self.host_tier is not None
                        and self._spill_prefix_block(h, b)):
                    return b
                del self._prefix[h]
                self._refs.pop(b, None)
                self.prefix_evictions += 1
                return b
        return None

    def ensure_capacity(self, slot: int, new_len: int) -> bool:
        """Grow ``slot``'s block list to cover ``new_len`` tokens; False
        if the pool is exhausted (the caller finishes or queues). Under
        pressure cold index entries go LRU-first, never a block a sequence
        still holds."""
        need = -(-new_len // self.block_size)
        while len(self._tables[slot]) < need:
            b = self._take_block()
            if b is None:
                return False
            self._refs[b] = 1
            self._append_block(slot, b)
        return True

    def trim_slot(self, slot: int, new_len: int) -> None:
        """Drop trailing blocks not needed to cover ``new_len`` tokens (a
        speculative rollback returns over-reserved pages). A shared block
        is never dropped."""
        need = max(1, -(-new_len // self.block_size)) if new_len > 0 else 0
        table = self._tables[slot]
        rec = self._slot_spill.get(slot)
        if rec:  # the parked run is the tail: trim it from the end
            while len(table) + len(rec["keys"]) > need and rec["keys"]:
                self.host_tier.pop(rec["keys"].pop())
            if not rec["keys"]:
                del self._slot_spill[slot]
            else:
                return  # the resident head sits below the parked run
        while len(table) > need:
            if self._refs.get(table[-1], 1) != 1:
                break
            b = table.pop()
            self._refs.pop(b, None)
            self._free.append(b)

    def block_refs(self, slot: int) -> List[int]:
        """Refcounts of ``slot``'s blocks in table order (a handoff record
        carries them)."""
        return [self._refs.get(b, 1) for b in self._tables[slot]]

    def set_block_refs(self, slot: int, refs: List[int]) -> None:
        """Adopt a handoff record's refcounts onto ``slot``'s blocks;
        table entries past the record's keep their own count."""
        for b, r in zip(self._tables[slot], refs):
            self._refs[b] = int(r)

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

    # -- prefix sharing -------------------------------------------------
    def _chain_hashes(self, tokens, limit: int) -> List[bytes]:
        """Chained per-block hashes of the full blocks of
        ``tokens[:limit]``: ``h_i = sha256(h_{i-1} || block_i)``, so a hit on
        block i implies the whole prefix matches and lookup is a walk."""
        bs = self.block_size
        out: List[bytes] = []
        h = b"paddle_tpu.prefix"
        for i in range(limit // bs):
            blk = np.asarray(tokens[i * bs:(i + 1) * bs], np.int32)
            h = hashlib.sha256(h + blk.tobytes()).digest()
            out.append(h)
        return out

    def register_prefix(self, slot: int, tokens, valid_len: int) -> int:
        """Index every full block of ``tokens[:valid_len]`` that ``slot``
        holds and the index lacks, taking +1 ref on each (so freeing the
        slot cannot recycle it while a later request may link it). Returns
        the number of blocks newly indexed."""
        table = self._tables[slot]
        added = 0
        for i, h in enumerate(self._chain_hashes(tokens, int(valid_len))):
            if i >= len(table):
                break
            if h in self._prefix:
                self._prefix.move_to_end(h)  # refresh LRU
                continue
            b = table[i]
            if self._spilled.pop(h, None):
                # the slot holds a bitwise-identical resident copy: index
                # that and drop the host page
                self.host_tier.pop(h)
            self._prefix[h] = b
            self._refs[b] = self._refs.get(b, 1) + 1
            added += 1
        return added

    def peek_prefix(self, tokens) -> int:
        """Longest indexed run of this prompt, in tokens, counting both
        tiers (a spilled page still saves the re-prefill). Read-only: no
        refcount change, no LRU refresh, no restore."""
        matched = 0
        for h in self._chain_hashes(tokens, len(tokens)):
            if h not in self._prefix and h not in self._spilled:
                break
            matched += self.block_size
        return matched

    def peek_prefix_resident(self, tokens) -> int:
        """Longest device-resident indexed run, in tokens. Capacity
        estimates read this: a spilled hit saves prefill compute but still
        needs device blocks to restore into."""
        matched = 0
        for h in self._chain_hashes(tokens, len(tokens)):
            if h not in self._prefix:
                break
            matched += self.block_size
        return matched

    def adopt_prefix(self, slot: int, tokens) -> int:
        """Link ``slot`` (freshly allocated, empty table) onto the longest
        indexed run of ``tokens``'s full blocks, bumping refcounts instead
        of re-prefilling. If the run covers the whole prompt, the block
        holding its last position is copied (the next decode write lands
        there); when no block is free for the copy, that block is not
        linked and the caller re-prefills it. Spilled entries in the run
        are restored from the host tier in one batch first; the run stops
        at the first page that cannot be seated. Returns the tokens
        covered."""
        n = len(tokens)
        entries: List[Tuple[bytes, Optional[int]]] = []
        for h in self._chain_hashes(tokens, n):
            if h in self._prefix:
                self._prefix.move_to_end(h)
                entries.append((h, self._prefix[h]))
            elif self.host_tier is not None and h in self._spilled:
                entries.append((h, None))
            else:
                break
        if not entries:
            return 0
        pending: List[Tuple[bytes, HostPage]] = []
        for h, b in entries:
            if b is None:
                # take the page out of the tier first: the restore's
                # allocations may spill other entries, and the room they
                # need must never come from a page this run needs
                del self._spilled[h]
                pending.append((h, self.host_tier.pop(h)))
        if pending:
            resident = tuple(b for _, b in entries if b is not None)
            restored = self._restore_prefix_entries(pending,
                                                    exclude=resident)
            got = {h: b for (h, _), b in zip(pending, restored)}
            cut = len(entries)
            for i, (h, b) in enumerate(entries):
                if b is None:
                    nb = got.get(h)
                    if nb is None:
                        cut = i
                        break
                    entries[i] = (h, nb)
            entries = entries[:cut]
        if not entries:
            return 0
        run = [b for _, b in entries]
        covered = len(run) * self.block_size
        private_last: Optional[int] = None
        if covered >= n:
            # an aligned, fully cached prompt: position n-1 lies in the
            # last linked block and the first decode step writes there
            src = run.pop()
            covered -= self.block_size
            # the run is not ref-bumped yet, so its entries look evictable
            # to the copy's allocation: exclude the whole run
            private_last = self._copy_block(src, exclude=tuple(run))
        for b in run:
            self._refs[b] = self._refs.get(b, 1) + 1
            self._append_block(slot, b)
        if private_last is not None:
            self._refs[private_last] = 1
            self._append_block(slot, private_last)
            covered += self.block_size
        return covered

    def cow_block(self, slot: int, index: int) -> bool:
        """Copy-on-write ``slot``'s table entry ``index``: replace a shared
        block with a fresh device copy this slot alone holds. No-op for a
        private block; False when no block can be had."""
        b = self._tables[slot][index]
        if self._refs.get(b, 1) <= 1:
            return True
        nb = self._copy_block(b)
        if nb is None:
            return False
        self._refs[b] -= 1
        self._refs[nb] = 1
        self._tables[slot][index] = nb
        if index < self._bps:
            self._dirty.append((slot, index, nb))
        return True

    def _block_rows(self, blocks: List[int]) -> torch.Tensor:
        """The flat rows of ``blocks``, in order, as a device index."""
        bs = self.block_size
        rows = torch.from_numpy((np.asarray(blocks, np.int64)[:, None] * bs
                                 + np.arange(bs)[None, :]).reshape(-1))
        if self.device.type == "cuda":   # an asynchronous copy: no sync
            rows = rows.pin_memory()
        return rows.to(self.device, non_blocking=True)

    def _copy_block(self, src: int,
                    exclude: Tuple[int, ...] = ()) -> Optional[int]:
        """Allocate a block and copy ``src``'s rows into it over every
        layer: one ``index_copy_`` for each of the pages (and, quantized,
        the scales), no host sync. ``exclude`` names blocks the
        destination must not be taken from (runs about to be linked)."""
        b = self._take_block(exclude=(src,) + tuple(exclude))
        if b is None:
            return None
        bs = self.block_size
        dst = torch.arange(b * bs, (b + 1) * bs, device=self.device)
        src_rows = torch.arange(src * bs, (src + 1) * bs, device=self.device)
        for t in self._planes():
            r = _raw(t)
            r.index_copy_(1, dst, r.index_select(1, src_rows))
        return b

    def clear_prefix(self) -> int:
        """Drop every index entry, releasing the index's refs (blocks with
        no other holder return to the free list), and the host tier's
        prefix pages. Returns the entries dropped. Leak drills call this
        before asserting ``free_blocks == num_blocks``."""
        dropped = 0
        for b in self._prefix.values():
            n = self._refs.get(b, 1) - 1
            if n <= 0:
                self._refs.pop(b, None)
                self._free.append(b)
            else:
                self._refs[b] = n
            dropped += 1
        self._prefix.clear()
        for h in list(self._spilled):
            self.host_tier.pop(h)
            dropped += 1
        self._spilled.clear()
        return dropped

    # -- host tier (spill / restore) -----------------------------------
    def _gather_pages(self, blocks: List[int]) -> List[HostPage]:
        """Device-to-host copy of whole pages, one transfer for the batch:
        one gather of every block's rows over every layer, one copy into a
        (pinned, on CUDA) host buffer, waited for before returning, so the
        blocks may be handed out again. Raw storage moves (quantized pages
        stay quantized), so the round trip is bitwise."""
        rows = self._block_rows(blocks)
        cuda = self.device.type == "cuda"
        host = []
        for t in self._planes():
            got = _raw(t).index_select(1, rows)
            if cuda:
                buf = torch.empty(got.shape, dtype=got.dtype,
                                  pin_memory=True)
                buf.copy_(got, non_blocking=True)
                got = buf
            host.append(got.view(t.dtype))
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()
        bs = self.block_size
        out = []
        for i in range(len(blocks)):
            sl = slice(i * bs, (i + 1) * bs)
            out.append(HostPage(*[p[:, sl] for p in host]))
        return out

    def _stack_pages(self, pages: List[HostPage]):
        """The pages' planes stacked along the row axis ``(k, v, k_scale,
        v_scale)`` (None scales on a full-width pool), in pinned memory on
        a CUDA cache so the host-to-device copy is asynchronous."""
        pin = self.device.type == "cuda"
        out = []
        for name in ("k", "v", "k_scale", "v_scale"):
            parts = [getattr(p, name) for p in pages]
            if parts[0] is None:
                out.append(None)
                continue
            if len(parts) == 1 and parts[0].is_contiguous():
                # a page spilled alone is its own (pinned) buffer already
                out.append(parts[0])
                continue
            dt = parts[0].dtype
            raw = [_raw(x) for x in parts]
            shape = list(raw[0].shape)
            shape[1] = sum(x.shape[1] for x in raw)
            buf = torch.empty(shape, dtype=raw[0].dtype, pin_memory=pin)
            torch.cat(raw, dim=1, out=buf)
            out.append(buf.view(dt))
        return tuple(out)

    def _scatter_pages(self, blocks: List[int], planes) -> None:
        """Host-to-device restore of whole pages: one copy of each stacked
        plane and one ``index_copy_`` per cache tensor. ``planes`` is
        :meth:`_stack_pages`'s tuple, or a :class:`_Staged` restore whose
        copy the compute stream waits for first."""
        rows = self._block_rows(blocks)
        if isinstance(planes, _Staged):
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(planes.event)
            src = planes.planes
            for p in src:
                if p is not None:
                    p.record_stream(stream)
        else:
            src = [None if p is None else
                   p.to(self.device, non_blocking=True) for p in planes]
        for t, p in zip(self._planes(), src):
            _raw(t).index_copy_(1, rows, _raw(p))

    def _tier_dropped(self, evicted: List[object]) -> None:
        """The host tier dropped unpinned LRU pages to make room: drop the
        matching spilled-prefix entries (the data is gone from both tiers,
        which is what an eviction means)."""
        for key in evicted:
            if self._spilled.pop(key, None) is not None:
                self.prefix_evictions += 1

    def _spill_prefix_block(self, h: bytes, b: int) -> bool:
        """Move index entry ``h`` (block ``b``, refs 1) to the host tier.
        On success the device block is the caller's; on refusal (a
        zero-capacity tier, or one full of pinned pages) the caller evicts
        instead."""
        t0 = time.perf_counter()
        page = self._gather_pages([b])[0]
        evicted = self.host_tier.put(h, page, pinned=False)
        if evicted is None:
            return False
        self._tier_dropped(evicted)
        del self._prefix[h]
        self._refs.pop(b, None)
        self._spilled[h] = True
        self.prefix_spills += 1
        self.host_tier.spills += 1
        self.host_tier.spill_bytes += page.nbytes
        self.host_tier.spill_seconds += time.perf_counter() - t0
        return True

    def _restore_prefix_entries(self, entries: List[Tuple[bytes, HostPage]],
                                exclude: Tuple[int, ...]) -> List[int]:
        """Bring spilled prefix pages back: a device block per page (never
        taken from ``exclude``, the resident run being adopted), one
        scatter for the batch, and each hash re-indexed with the index's
        own hold. Returns the blocks restored, cut at the first allocation
        failure (pages past the cut go back to the tier, or are dropped if
        it refuses them)."""
        t0 = time.perf_counter()
        blocks: List[int] = []
        for i, (h, page) in enumerate(entries):
            b = self._take_block(exclude=exclude + tuple(blocks))
            if b is None:
                for hh, pp in entries[i:]:
                    back = self.host_tier.put(hh, pp, pinned=False)
                    if back is None:
                        self.prefix_evictions += 1
                    else:
                        self._tier_dropped(back)
                        self._spilled[hh] = True
                entries = entries[:i]
                break
            blocks.append(b)
        if not blocks:
            return []
        self._scatter_pages(blocks, self._stack_pages(
            [p for _, p in entries]))
        nbytes = 0
        for (h, page), b in zip(entries, blocks):
            self._prefix[h] = b
            self._refs[b] = 1
            nbytes += page.nbytes
        self.prefix_restores += len(blocks)
        self.host_tier.restores += len(blocks)
        self.host_tier.restore_bytes += nbytes
        self.host_tier.restore_seconds += time.perf_counter() - t0
        return blocks

    def _private_suffix(self, slot: int) -> int:
        """Start of the longest tail of ``slot``'s table that no one else
        holds."""
        table = self._tables[slot]
        start = len(table)
        while start > 0 and self._refs.get(table[start - 1], 1) == 1:
            start -= 1
        return start

    def spillable_suffix(self, slot: int) -> int:
        """Blocks :meth:`spill_slot` could park right now: the longest tail
        of the slot's table that no one else holds. Admission reads this
        without side effects."""
        if (self.host_tier is None or not self._active[slot]
                or slot in self._slot_spill):
            return 0
        return len(self._tables[slot]) - self._private_suffix(slot)

    def spill_slot(self, slot: int) -> int:
        """Park a paused request's pages: move the longest tail of its
        table that no one else holds to the host tier (pinned: parked pages
        are live sequence state, never dropped) and free the device blocks;
        the shared head stays. All or none, so the table stays a
        contiguous prefix. Returns the blocks spilled."""
        if (self.host_tier is None or not self._active[slot]
                or slot in self._slot_spill):
            return 0
        table = self._tables[slot]
        start = self._private_suffix(slot)
        blocks = table[start:]
        if not blocks or self.host_tier.available_blocks < len(blocks):
            return 0
        t0 = time.perf_counter()
        pages = self._gather_pages(blocks)
        self._spill_seq += 1
        keys = [("slot", slot, self._spill_seq, i)
                for i in range(len(blocks))]
        nbytes = 0
        for key, page in zip(keys, pages):
            self._tier_dropped(self.host_tier.put(key, page, pinned=True)
                               or [])
            nbytes += page.nbytes
        self._slot_spill[slot] = {"start": start, "keys": keys}
        for b in blocks:
            self._refs.pop(b, None)
            self._free.append(b)
        del table[start:]
        self.slot_spills += len(blocks)
        self.host_tier.spills += len(blocks)
        self.host_tier.spill_bytes += nbytes
        self.host_tier.spill_seconds += time.perf_counter() - t0
        return len(keys)

    def slot_spilled(self, slot: int) -> int:
        """Number of parked host-tier blocks this slot is waiting on."""
        rec = self._slot_spill.get(slot)
        return len(rec["keys"]) if rec else 0

    def slot_spill_pages(self, slot: int):
        """``(start_block_index, [HostPage, ...])`` of a parked slot, None
        for a resident one: a handoff export assembles its record from
        these, with no restore round trip."""
        rec = self._slot_spill.get(slot)
        if not rec:
            return None
        return rec["start"], [self.host_tier.get(k) for k in rec["keys"]]

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def stage_restore(self, slot: int):
        """Begin the host-to-device copy of a parked slot's pages without
        touching the block table. On a CUDA cache the copy runs on a side
        stream, overlapping whatever the device is computing, and records
        an event; :meth:`restore_slot` (``staged=``) makes the compute
        stream wait on it before writing the pages. Elsewhere this is the
        stacked planes."""
        rec = self._slot_spill.get(slot)
        if not rec:
            return None
        host = self._stack_pages([self.host_tier.get(k)
                                  for k in rec["keys"]])
        if self.device.type != "cuda":
            return host
        side = self._side_stream()
        # the side stream must not start before the pages' earlier writes
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            planes = [None if p is None else
                      p.to(self.device, non_blocking=True) for p in host]
            ev = torch.cuda.Event()
            ev.record(side)
        return _Staged(planes, ev, host)

    def restore_slot(self, slot: int, staged=None) -> bool:
        """Bring a parked slot's pages back: allocate device blocks
        (spilling or evicting cold index entries under pressure), write the
        staged (or freshly stacked) planes in one update, and reattach the
        blocks to the slot's table. False when the pool cannot seat the
        run yet: the slot stays parked and the caller retries."""
        rec = self._slot_spill.get(slot)
        if not rec:
            return True
        t0 = time.perf_counter()
        need = len(rec["keys"])
        blocks: List[int] = []
        for _ in range(need):
            b = self._take_block(exclude=tuple(self._tables[slot])
                                 + tuple(blocks))
            if b is None:
                self._free.extend(blocks)  # roll back, stay parked
                return False
            blocks.append(b)
        pages = [self.host_tier.get(k) for k in rec["keys"]]
        planes = staged if staged is not None else self._stack_pages(pages)
        self._scatter_pages(blocks, planes)
        nbytes = sum(p.nbytes for p in pages)
        for key in rec["keys"]:
            self.host_tier.pop(key)
        del self._slot_spill[slot]
        for b in blocks:
            self._refs[b] = 1
            self._append_block(slot, b)
        self.slot_restores += need
        self.host_tier.restores += need
        self.host_tier.restore_bytes += nbytes
        self.host_tier.restore_seconds += time.perf_counter() - t0
        return True

    @property
    def spilled_prefix_blocks(self) -> int:
        """Index entries whose page lives in the host tier."""
        return len(self._spilled)

    def tier_stats(self) -> Dict[str, float]:
        """Per-tier counters for the serving gauges."""
        out = {
            "prefix_spills": self.prefix_spills,
            "prefix_restores": self.prefix_restores,
            "slot_spills": self.slot_spills,
            "slot_restores": self.slot_restores,
            "spilled_prefix_blocks": len(self._spilled),
            "parked_slots": len(self._slot_spill),
            "resident_prefix_blocks": len(self._prefix),
        }
        if self.host_tier is not None:
            out.update(self.host_tier.stats())
        return out

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
