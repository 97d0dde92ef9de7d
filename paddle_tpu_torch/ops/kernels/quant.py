"""Ragged paged attention over quantized KV pages: CUDA kernel
``csrc/quant.cu`` and its plain twin.

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
           "eligible", "PAGE_DTYPES", "launches"]

#: kernel launches made by :func:`ragged_paged_attention_quant` (never by
#: the twin)
launches = 0

_SMEM_LIMIT = 232448      # dynamic shared memory one block may use on H100
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
    group = hq // hkv
    smem = smem_bytes(block_size, d, group)
    _launch.require(smem <= _SMEM_LIMIT,
                    f"ragged_paged_attention_quant: block_size {block_size} "
                    f"needs {smem} bytes of shared memory")
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


def smem_bytes(block_size: int, d: int, group: int) -> int:
    """Dynamic shared memory of one block (``csrc/quant.cu:smem_bytes``):
    two stages of a padded K page, a V page and their two scale columns,
    each stage rounded up to 16 bytes, then the group's q rows and p rows in
    fp32, all at the padded head dim of ``d``."""
    dp = _launch.head_dim_bucket(d)
    stage = -(-block_size * ((dp + 16) + dp + 2 * 4) // 16) * 16
    return 2 * stage + group * dp * 4 + group * block_size * 4
