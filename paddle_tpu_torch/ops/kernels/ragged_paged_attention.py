"""Ragged paged attention: CUDA kernel ``csrc/ragged_paged_attention.cu``
and its plain twin.

Port of ``paddle_tpu/ops/pallas/ragged_paged_attention.py``. Queries are
packed token-major, ``q[t]`` one token of some sequence; ``rows[t]`` names
its block-table row and ``valids[t]`` how many cached positions it sees
(its position + 1, so a prompt chunk is causal within itself once its K/V
are in the cache). Pad tokens have ``valids = 0`` and come out exactly 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "gather_paged_kv", "launches"]

#: kernel launches made by :func:`ragged_paged_attention` (never by the twin)
launches = 0

_HEAD_DIMS = (64, 128)
_SMEM_LIMIT = 232448      # dynamic shared memory one block may use on H100
_PAIRS = {(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
          (torch.bfloat16, torch.bfloat16)}


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
                    f"ragged_paged_attention: head_dim {d} not in "
                    f"{_HEAD_DIMS}")
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
    esz = k_cache.element_size()
    group = hq // hkv
    smem = (block_size * (d * esz + 16) + block_size * d * esz
            + group * d * 4 + group * block_size * 4)
    _launch.require(smem <= _SMEM_LIMIT,
                    f"ragged_paged_attention: block_size {block_size} needs "
                    f"{smem} bytes of shared memory")
    out = torch.empty_like(q)
    _launch.launch("ptt_ragged_paged_attn", q.data_ptr(), k_cache.data_ptr(),
                   v_cache.data_ptr(), block_tables.data_ptr(),
                   rows.data_ptr(), valids.data_ptr(), out.data_ptr(), t, hq,
                   hkv, d, block_size, block_tables.shape[1],
                   float(scale if scale is not None else 1.0 / math.sqrt(d)),
                   _launch.DTYPE_CODE[q.dtype],
                   _launch.DTYPE_CODE[k_cache.dtype], _launch.stream_of(dev))
    launches += 1
    return out
