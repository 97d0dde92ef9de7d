"""Paged attention ops (port of ``paddle_tpu/inference/attention.py``): the
ragged op of the compiled step, over full-width or quantized pages, and the
decode-only op of the eager engine.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.ops.kernels import paged_attention as _paged
from paddle_tpu_torch.ops.kernels import quant as _quant
from paddle_tpu_torch.ops.kernels.quant import gather_paged_scales
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    gather_paged_kv, ragged_paged_attention, ragged_paged_attention_plain)

__all__ = ["gather_paged_kv", "gather_paged_scales", "ragged_attention_xla",
           "paged_attention_ragged", "paged_attention_decode"]


def ragged_attention_xla(qa, kc, vc, tables, rows, valids, block_size: int,
                         scale: Optional[float] = None, k_scale=None,
                         v_scale=None):
    """The composed ragged attention (the reference's
    ``ragged_attention_xla``, here the kernels' plain twins): packed
    queries ``qa [t, hq, d]``, ``tables [max_seqs, width]``, ``rows`` and
    ``valids [t]``. ``k_scale``/``v_scale [ctx_total, kv]`` fp32 mark the
    caches as quantized pages, dequantized after the gather (the twin of
    the quantized kernel). A pad token (``valids == 0``) gives exactly 0."""
    if k_scale is None:
        return ragged_paged_attention_plain(qa, kc, vc, tables, rows, valids,
                                            block_size, scale)
    return _quant.ragged_paged_attention_quant_plain(
        qa, kc, vc, k_scale, v_scale, tables, rows, valids, block_size,
        scale)


def _idx(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, device=dev).to(torch.int32).contiguous()


def paged_attention_decode(q, k_cache, v_cache, block_tables, seq_lens,
                           block_size: int, scale: Optional[float] = None):
    """Single-token decode attention over a paged cache (public op).

    ``q [b, heads, d]``; ``k_cache``/``v_cache`` flat
    ``[num_blocks*block_size, kv, d]`` (one layer); ``block_tables [b,
    max_blocks]``; ``seq_lens [b]``, the valid cached tokens of each
    sequence including the one just written. Returns ``[b, heads, d]``.
    The paged decode kernel on CUDA — where the reference sends a shape
    the kernel refuses, or a query that needs gradients, to the composed
    path, the port raises — and its plain twin on the CPU. Index arrays
    are cast to int32 on the query's device.
    """
    dev = q.device
    return _paged.paged_decode_attention(
        q.contiguous(), k_cache, v_cache, _idx(block_tables, dev),
        _idx(seq_lens, dev), block_size, scale)


def paged_attention_ragged(q, k_cache, v_cache, block_tables, rows, valids,
                           block_size: int, scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """Mixed prefill/decode attention over a paged cache (public op).

    ``q`` packed ``[t, heads, d]``; ``k_cache``/``v_cache`` flat
    ``[num_blocks*block_size, kv, d]``; ``block_tables [max_seqs, width]``;
    ``rows``/``valids [t]``. With ``k_scale``/``v_scale [num_blocks *
    block_size, kv]`` the pages are int8 or fp8 and go to the quantized
    kernel. The kernels on CUDA, their plain twins
    (:func:`ragged_attention_xla`) on CPU. Index arrays are cast to int32
    on the query's device.
    """
    dev = q.device
    idx = (_idx(block_tables, dev), _idx(rows, dev), _idx(valids, dev))
    if k_scale is None:
        return ragged_paged_attention(q.contiguous(), k_cache, v_cache, *idx,
                                      block_size, scale)
    return _quant.ragged_paged_attention_quant(
        q.contiguous(), k_cache, v_cache, k_scale, v_scale, *idx, block_size,
        scale)
