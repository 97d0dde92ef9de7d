"""Ragged paged attention: CUDA kernel ``csrc/ragged_paged_attention.cu``
(the split-context family of ``csrc/ragged.cuh``) and its plain twin.

Port of ``paddle_tpu/ops/pallas/ragged_paged_attention.py``. Queries are
packed token-major, ``q[t]`` one token of some sequence; ``rows[t]`` names
its block-table row and ``valids[t]`` how many cached positions it sees
(its position + 1, so a prompt chunk is causal within itself once its K/V
are in the cache). Pad tokens have ``valids = 0`` and come out exactly 0.
The kernel takes every head dim that is a multiple of 16 up to 256: it is
built at a padded head dim of 64, 128 or 256 and masks the columns past
the real one. It splits each token's context into splits of
:data:`SPLIT_KEYS` keys (flash decoding, ``csrc/ragged.cuh``); a token of
several splits leaves fp32 partials that a second launch merges, in
scratch the wrapper allocates behind the output (:func:`empty_out`, which
#9's wrapper shares: it runs the same family).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "gather_paged_kv", "launches", "SPLIT_KEYS"]

#: kernel launches made by :func:`ragged_paged_attention` (never by the twin)
launches = 0

#: head dims the kernel takes: every multiple of 16 up to 256
_HEAD_DIMS = tuple(range(16, 257, 16))
_SMEM_LIMIT = 232448      # dynamic shared memory one block may use on H100
_PAIRS = {(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
          (torch.bfloat16, torch.bfloat16)}


#: keys of a context split (``csrc/ragged.cuh:kSplitKeys``): a token's keys
#: are cut at 0, SPLIT_KEYS, 2 * SPLIT_KEYS, ...
SPLIT_KEYS = 256
_TILE_ROWS = 32                  # ragged.cuh: kTileRows
#: page element bytes -> (bytes of K rows a ring stage holds, the ring's
#: depth): ``ragged.cuh``'s page policies' ``kStageBytes`` and ``kRing``
#: (bf16; fp32)
PAGE_GEOMETRY = {2: (8192, 3), 4: (16384, 2)}


def _stage_keys(d: int, esz: int) -> int:
    """Keys a stage of the page ring holds (``Geo::SK``): about the page
    policy's stage bytes of K rows at the padded head dim, 16 to 64 keys."""
    budget = PAGE_GEOMETRY[esz][0]
    return min(64, max(16, budget // (_launch.head_dim_bucket(d) * esz)))


def _smem_bytes(d: int, esz: int) -> int:
    """Dynamic shared memory of one block of the kernel family
    (``csrc/ragged.cuh`` ``Geo::kSmem``) at the padded head dim of ``d``
    over pages of ``esz`` bytes an element: a ring of the policy's depth of
    K and V stages (rows padded by 16 bytes), the tile's q rows and softmax
    weights in fp32, the split's table entries. The layout does not depend
    on the GQA group or the block size."""
    dp = _launch.head_dim_bucket(d)
    sk = _stage_keys(d, esz)
    ring = PAGE_GEOMETRY[esz][1]
    stage = sk * 2 * (dp * esz + 16)
    return (ring * stage + _TILE_ROWS * (dp + 4) * 4
            + _TILE_ROWS * (sk + 4) * 4 + (SPLIT_KEYS + 2) * 4)


def empty_out(q: torch.Tensor, width: int, block_size: int) -> torch.Tensor:
    """The kernel's output like ``q``, and behind it in one allocation
    (256-byte aligned) the fp32 partials of tokens whose keys span several
    splits: ``[t, hq, nsp, d]`` accumulators and ``[t, hq, nsp]`` (m, l)
    pairs, ``nsp`` the splits of a full table row (``width * block_size``
    keys). Where a table row fits one split there are none."""
    t, hq, d = q.shape
    nsp = -(-width * block_size // SPLIT_KEYS)
    if nsp <= 1:
        return torch.empty_like(q)
    head = q.numel() * q.element_size()
    nbytes = -(-head // 256) * 256 + t * hq * nsp * (d + 2) * 4
    buf = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    return buf[:head].view(q.dtype).view(q.shape)


def gather_paged_kv(cache: torch.Tensor, block_tables: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """``cache [ctx_total, kv, d]`` (one layer, flat) through ``tables
    [b, max_blocks]`` -> ``[b, max_blocks*block_size, kv, d]``."""
    idx = (block_tables[:, :, None].long() * block_size
           + torch.arange(block_size, device=cache.device)[None, None, :])
    return cache[idx.reshape(idx.shape[0], -1)]


def ragged_paged_attention_plain(q, k_cache, v_cache, block_tables, rows,
                                 valids, block_size: int,
                                 scale: Optional[float] = None):
    """The reference's composed ragged attention
    (``inference/attention.py:ragged_attention_xla``): gather each
    token's table row, fp32 scores with GQA folded in, positions at or
    past ``valids[t]`` masked, softmax, PV. One deliberate difference: a
    pad token (``valids == 0``) comes out exactly 0, as the kernel's does,
    instead of the reference's uniform average over masked columns."""
    t, hq, d = q.shape
    kv = k_cache.shape[-2]
    tab = block_tables[rows.long()]
    k = gather_paged_kv(k_cache, tab, block_size).float()   # t c kv d
    v = gather_paged_kv(v_cache, tab, block_size).float()
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(t, kv, hq // kv, d)
    scores = torch.einsum("tkgd,tckd->tkgc", qg, k) * s
    ctx = k.shape[1]
    visible = (torch.arange(ctx, device=q.device)[None, :]
               < valids[:, None])                               # t c
    scores = scores.masked_fill(~visible[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("tkgc,tckd->tkgd", probs, v).reshape(t, hq, d)
    out = out * (valids > 0)[:, None, None]
    return out.to(q.dtype)


def ragged_paged_attention(q, k_cache, v_cache, block_tables, rows, valids,
                           block_size: int, scale: Optional[float] = None):
    """Mixed prefill/decode attention; returns ``[t, hq, d]`` in q's dtype.

    ``q [t, hq, d]``; ``k_cache``/``v_cache`` flat ``[num_blocks*block_size,
    kv, d]`` (one layer); ``block_tables [max_seqs, width]`` int32;
    ``rows``/``valids [t]`` int32. CPU tensors take the plain twin; CUDA
    tensors launch the kernel.
    """
    global launches
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_cache, v_cache,
                                            block_tables, rows, valids,
                                            block_size, scale)
    dev = _launch.check_cuda("ragged_paged_attention", q, k_cache, v_cache,
                             block_tables, rows, valids)
    t, hq, d = q.shape
    hkv = k_cache.shape[1]
    _launch.require(
        k_cache.dim() == 3 and k_cache.shape == v_cache.shape
        and k_cache.shape[2] == d and k_cache.shape[0] % block_size == 0,
        f"ragged_paged_attention: caches {tuple(k_cache.shape)} / "
        f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)} and "
        f"block_size {block_size}")
    _launch.require(hq % hkv == 0 and hq // hkv <= 32,
                    f"ragged_paged_attention: {hq} query heads over {hkv} "
                    f"kv heads (needs a whole group of at most 32)")
    _launch.require((q.dtype, k_cache.dtype) in _PAIRS
                    and v_cache.dtype == k_cache.dtype,
                    f"ragged_paged_attention: q {q.dtype} over pages "
                    f"{k_cache.dtype} is not supported")
    _launch.require(d in _HEAD_DIMS,
                    f"ragged_paged_attention: head_dim {d} is not a multiple "
                    f"of 16 in 16..256")
    for name, ix in (("block_tables", block_tables), ("rows", rows),
                     ("valids", valids)):
        _launch.require(ix.dtype == torch.int32,
                        f"ragged_paged_attention: {name} must be int32")
    _launch.require(block_tables.dim() == 2 and rows.shape == (t,)
                    and valids.shape == (t,),
                    "ragged_paged_attention: tables [S, W], rows/valids [t]")
    _launch.require(k_cache.data_ptr() % 16 == 0
                    and v_cache.data_ptr() % 16 == 0,
                    "ragged_paged_attention: pages must be 16-byte aligned")
    smem = _smem_bytes(d, k_cache.element_size())
    _launch.require(smem <= _SMEM_LIMIT,
                    f"ragged_paged_attention: head_dim {d} over "
                    f"{k_cache.dtype} pages needs {smem} bytes of shared "
                    f"memory")
    if q.data_ptr() % 16:   # the kernel reads q rows in 16-byte vectors
        q = q.clone()
    out = empty_out(q, block_tables.shape[1], block_size)
    _launch.launch("ptt_ragged_paged_attn", q.data_ptr(), k_cache.data_ptr(),
                   v_cache.data_ptr(), block_tables.data_ptr(),
                   rows.data_ptr(), valids.data_ptr(), out.data_ptr(), t, hq,
                   hkv, d, block_size, block_tables.shape[1],
                   float(scale if scale is not None else 1.0 / math.sqrt(d)),
                   _launch.DTYPE_CODE[q.dtype],
                   _launch.DTYPE_CODE[k_cache.dtype], _launch.stream_of(dev))
    launches += 1
    return out
