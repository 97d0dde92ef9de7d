"""Ragged paged attention over quantized KV pages: CUDA kernel
``csrc/quant.cuh`` (built by ``quant.cu``, fp32 q, and ``quant_bf16.cu``,
bf16 q) and its plain twin.

Port of ``paddle_tpu/ops/pallas/quant.py``. The same function as the
ragged op (:mod:`.ragged_paged_attention`): packed token-major queries
``q [t, hq, d]``, token ``t`` reading block-table row ``rows[t]`` and
seeing its first ``valids[t]`` cached positions; the pages of one layer are
int8 or fp8 e4m3 ``[num_blocks * block_size, kv, d]`` with fp32 per-row,
per-head scales ``[num_blocks * block_size, kv]`` (what
:func:`paddle_tpu_torch.quantization.kv.quantize_kv` writes), so row ``i``
of head ``g`` stands for ``k[i, g] * k_scale[i, g]``. Scores, softmax and
PV run in fp32; the output takes q's dtype. A pad token (``valids == 0``)
comes out exactly 0.

The reference runs its Pallas kernel for int8 pages with ``head_dim % 128
== 0`` only and composes everything else; here the kernel takes int8 and
fp8 pages at every head_dim that is a multiple of 16 up to 256 (built at a
padded head dim of 64, 128 or 256, the columns past the real one masked),
so a CUDA tensor never takes the twin.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.ops.kernels import _launch
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import gather_paged_kv

__all__ = ["ragged_paged_attention_quant",
           "ragged_paged_attention_quant_plain", "gather_paged_scales",
           "eligible", "launch_plan", "PAGE_DTYPES", "launches"]

#: kernel launches made by :func:`ragged_paged_attention_quant` (never by
#: the twin)
launches = 0

_SMEM_LIMIT = 232448      # dynamic shared memory one block may use on H100
_MAX_STAGES, _MIN_STAGES = 4, 2   # the page ring's depth
_SMS = 132                # SMs of an H100
_CONSUMERS = 4            # consumer warps a pipelined block, 4 // heads a head
_MIN_BLOCKS = 2 * 132     # two blocks an SM
#: page dtype -> its code in the C interface (``csrc/common.cuh``)
PAGE_DTYPES = {torch.int8: 2}
if hasattr(torch, "float8_e4m3fn"):
    PAGE_DTYPES[torch.float8_e4m3fn] = 3
_Q_DTYPES = (torch.float32, torch.bfloat16)


def eligible(q_shape, kv_heads: int, head_dim: int,
             page_dtype: torch.dtype = torch.int8) -> bool:
    """Whether the kernel takes this shape and page type: a head_dim that
    is a multiple of 16 up to 256, whole GQA groups of at most 32 query
    heads, int8 or fp8 e4m3 pages."""
    _, hq, _ = q_shape
    return (_launch.head_dim_bucket(head_dim) != 0 and hq % kv_heads == 0
            and hq // kv_heads <= 32 and page_dtype in PAGE_DTYPES)


def gather_paged_scales(scales: torch.Tensor, block_tables: torch.Tensor,
                        block_size: int) -> torch.Tensor:
    """Row-parallel scales ``[ctx_total, kv]`` through ``tables [b,
    max_blocks]`` -> ``[b, max_blocks*block_size, kv]``: the scale twin of
    :func:`gather_paged_kv`, the same index math."""
    idx = (block_tables[:, :, None].long() * block_size
           + torch.arange(block_size, device=scales.device)[None, None, :])
    return scales[idx.reshape(idx.shape[0], -1)]


def _gather_pages(cache, tables, block_size):
    """:func:`gather_paged_kv` through a byte view (torch has no gather for
    fp8 on every device)."""
    return gather_paged_kv(cache.view(torch.uint8), tables,
                           block_size).view(cache.dtype)


def ragged_paged_attention_quant_plain(q, k_cache, v_cache, k_scale, v_scale,
                                       block_tables, rows, valids,
                                       block_size: int,
                                       scale: Optional[float] = None):
    """The reference's composed path over quantized pages
    (``inference/attention.py:ragged_attention_xla`` with
    ``k_scale``/``v_scale``): gather each token's table row and its scales,
    dequantize first (``k.f32 * scale``), fp32 scores with GQA folded in,
    positions at or past ``valids[t]`` masked, softmax, PV. As the port's
    other ragged twin, a pad token (``valids == 0``) gives exactly 0 where
    the reference's composed path gives a uniform average."""
    t, hq, d = q.shape
    kv = k_cache.shape[-2]
    tab = block_tables[rows.long()]
    ks = gather_paged_scales(k_scale, tab, block_size).float()   # t c kv
    vs = gather_paged_scales(v_scale, tab, block_size).float()
    k = _gather_pages(k_cache, tab, block_size).float() * ks[..., None]
    v = _gather_pages(v_cache, tab, block_size).float() * vs[..., None]
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


def ragged_paged_attention_quant(q, k_cache, v_cache, k_scale, v_scale,
                                 block_tables, rows, valids, block_size: int,
                                 scale: Optional[float] = None):
    """Ragged attention over int8 or fp8 KV pages; returns ``[t, hq, d]``
    in q's dtype.

    ``q [t, hq, d]`` fp32 or bf16; ``k_cache``/``v_cache`` flat
    ``[num_blocks*block_size, kv, d]`` int8 or float8_e4m3fn (one layer);
    ``k_scale``/``v_scale [num_blocks*block_size, kv]`` fp32;
    ``block_tables [max_seqs, width]``, ``rows``/``valids [t]`` int32. CPU
    tensors take the plain twin; CUDA tensors launch the kernel or raise.
    """
    global launches
    if q.device.type == "cpu":
        return ragged_paged_attention_quant_plain(
            q, k_cache, v_cache, k_scale, v_scale, block_tables, rows,
            valids, block_size, scale)
    dev = _launch.check_cuda("ragged_paged_attention_quant", q, k_cache,
                             v_cache, k_scale, v_scale, block_tables, rows,
                             valids)
    t, hq, d = q.shape
    hkv = k_cache.shape[1]
    _launch.require(
        k_cache.dim() == 3 and k_cache.shape == v_cache.shape
        and k_cache.shape[2] == d and k_cache.shape[0] % block_size == 0,
        f"ragged_paged_attention_quant: caches {tuple(k_cache.shape)} / "
        f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)} and "
        f"block_size {block_size}")
    _launch.require(
        k_scale.shape == k_cache.shape[:2] and v_scale.shape ==
        k_cache.shape[:2] and k_scale.dtype == torch.float32
        and v_scale.dtype == torch.float32,
        f"ragged_paged_attention_quant: scales {tuple(k_scale.shape)} "
        f"{k_scale.dtype} / {tuple(v_scale.shape)} {v_scale.dtype} must be "
        f"fp32 {tuple(k_cache.shape[:2])}")
    _launch.require(q.dtype in _Q_DTYPES,
                    f"ragged_paged_attention_quant: q {q.dtype} is not "
                    f"float32 or bfloat16")
    _launch.require(k_cache.dtype in PAGE_DTYPES
                    and v_cache.dtype == k_cache.dtype,
                    f"ragged_paged_attention_quant: pages {k_cache.dtype} / "
                    f"{v_cache.dtype} are not int8 or float8_e4m3fn")
    _launch.require(eligible(q.shape, hkv, d, k_cache.dtype),
                    f"ragged_paged_attention_quant: q {tuple(q.shape)} over "
                    f"{hkv} kv heads (needs a head_dim that is a multiple "
                    f"of 16 in 16..256 and whole groups of at most 32 query "
                    f"heads)")
    for name, ix in (("block_tables", block_tables), ("rows", rows),
                     ("valids", valids)):
        _launch.require(ix.dtype == torch.int32,
                        f"ragged_paged_attention_quant: {name} must be int32")
    _launch.require(block_tables.dim() == 2 and rows.shape == (t,)
                    and valids.shape == (t,),
                    "ragged_paged_attention_quant: tables [S, W], "
                    "rows/valids [t]")
    _launch.require(k_cache.data_ptr() % 16 == 0
                    and v_cache.data_ptr() % 16 == 0,
                    "ragged_paged_attention_quant: pages must be 16-byte "
                    "aligned")
    plan = launch_plan(t, hq, hkv, d, block_size, block_tables.shape[1])
    _launch.require(plan["stages"] > 0,
                    f"ragged_paged_attention_quant: block_size {block_size} "
                    f"needs {plan['smem']} bytes of shared memory at "
                    f"{_MIN_STAGES} stages")
    out = torch.empty_like(q)
    _launch.launch("ptt_ragged_paged_attn_quant", q.data_ptr(),
                   k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                   v_scale.data_ptr(), block_tables.data_ptr(),
                   rows.data_ptr(), valids.data_ptr(), out.data_ptr(), t, hq,
                   hkv, d, block_size, block_tables.shape[1],
                   float(scale if scale is not None else 1.0 / math.sqrt(d)),
                   _launch.DTYPE_CODE[q.dtype], PAGE_DTYPES[k_cache.dtype],
                   _launch.stream_of(dev))
    launches += 1
    return out


def heads_per_block(t: int, hq: int, hkv: int) -> int:
    """The query heads one block takes (``heads_per_block`` in the .cu):
    the widest of 4, 2 and 1 that divides the GQA group and still gives
    two blocks an SM over ``t`` tokens and ``hkv`` kv heads, else 1."""
    group = hq // hkv
    for hb in (4, 2):
        if group % hb == 0 and t * hkv * (group // hb) >= _MIN_BLOCKS:
            return hb
    return 1


def smem_bytes(block_size: int, d: int, heads: int, stages: int,
               width: int) -> int:
    """Dynamic shared memory of one block (``csrc/quant.cuh:smem_bytes``):
    ``stages`` stages of a padded K page, a V page and their two scale
    columns (each stage rounded up to 16 bytes), three mbarriers a stage,
    the score ring (a row of ``block_size`` fp32 scores a stage and head),
    the block's q rows in fp32 at the padded head dim of ``d``, a row of
    ``block_size`` fp32 softmax weights a consumer warp, four scoring-warp
    maxima a stage and head, and the token's block-table row (``width``
    int32 entries)."""
    dp = _launch.head_dim_bucket(d)
    stage = -(-block_size * ((dp + 16) + dp + 2 * 4) // 16) * 16
    return (stages * stage + 3 * stages * 8
            + stages * heads * block_size * 4 + heads * dp * 4
            + _CONSUMERS * block_size * 4 + stages * heads * 4 * 4
            + width * 4)


def blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks an H100 SM holds at once by its 228 KB of shared memory (1 KB
    reserved a block) and its 2048 threads (``blocks_per_sm``; registers
    are not counted)."""
    return min(233472 // (smem + 1024), 2048 // threads)


def ring_stages(block_size: int, d: int, heads: int, width: int,
                blocks: int = 1, threads: int = 192) -> int:
    """The ring's depth (``ring_stages``): the most stages, up to 4, that
    fit the H100's 227 KB, or 2 where the grid (``blocks`` of ``threads``)
    is more than 132 SMs hold at that depth; 0 where not even 2 fit
    (refused)."""
    ns = _MAX_STAGES
    while ns >= _MIN_STAGES and smem_bytes(block_size, d, heads, ns,
                                           width) > _SMEM_LIMIT:
        ns -= 1
    if ns < _MIN_STAGES:
        return 0
    if blocks > _SMS * blocks_per_sm(smem_bytes(block_size, d, heads, ns,
                                                width), threads):
        return _MIN_STAGES
    return ns


def scorer_warps(heads: int) -> int:
    """Scoring warps of a block of ``heads`` query heads: 4 for one head (a
    decode step's small grid, latency), 2 for 2 or 4 (large grids)."""
    return 4 if heads == 1 else 2


def score_groups(block_size: int, stages: int, threads: int = 128) -> int:
    """Pages a block's ``threads`` scoring threads score at once (a thread
    a row, every head of the block): doubled while a page has a row for
    each thread and the count divides the ring's depth (each group then
    waits on its own stages' mbarriers one phase after another)."""
    g = 1
    while (g * 2 <= stages and stages % (g * 2) == 0
           and g * 2 * block_size <= threads):
        g *= 2
    return g


def wide_schedule(t: int, hkv: int) -> bool:
    """Whether a launch takes the wide schedule (``wide_schedule`` in the
    .cu; a block a (token, kv head), two stages): its grid already gives the
    card more than two blocks an SM (a prefill chunk). Else the pipelined
    one (a decode step)."""
    return t * hkv > 2 * _SMS


def wide_smem_bytes(block_size: int, d: int, group: int) -> int:
    """The wide schedule's dynamic shared memory (``wide_smem_bytes``): two
    stages of a padded K page, a V page and their scale columns, then the
    group's q rows and p rows in fp32, at the padded head dim."""
    dp = _launch.head_dim_bucket(d)
    stage = -(-block_size * ((dp + 16) + dp + 2 * 4) // 16) * 16
    return 2 * stage + group * dp * 4 + group * block_size * 4


def launch_plan(t: int, hq: int, hkv: int, d: int, block_size: int,
                width: int) -> dict:
    """The kernel's launch (``dispatch_hb`` and the launchers in the .cu).
    Wide: a block a (token, kv head) of max(group, 4) warps, two stages.
    Pipelined: heads a block, the ring's stages, shared memory, the grid
    (tokens, kv heads, head groups), the block's threads (4 consumer warps,
    a copy warp and 2 or 4 scoring warps) and the pages its scorers take at
    once."""
    group = hq // hkv
    if wide_schedule(t, hkv):
        smem = wide_smem_bytes(block_size, d, group)
        return dict(schedule="wide", heads=group,
                    stages=2 if smem <= _SMEM_LIMIT else 0, smem=smem,
                    grid=(t, hkv, 1), threads=max(group, 4) * 32)
    hb = heads_per_block(t, hq, hkv)
    threads = (_CONSUMERS + 1 + scorer_warps(hb)) * 32
    grid = (t, hkv, group // hb)
    ns = ring_stages(block_size, d, hb, width, grid[0] * grid[1] * grid[2],
                     threads)
    return dict(schedule="pipelined", heads=hb, stages=ns,
                smem=smem_bytes(block_size, d, hb, ns or _MIN_STAGES, width),
                grid=grid, threads=threads,
                score_groups=score_groups(block_size, ns,
                                          scorer_warps(hb) * 32))
