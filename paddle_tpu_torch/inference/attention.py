"""Paged attention ops (port of ``paddle_tpu/inference/attention.py``, the
ragged path). The decode-only op ``paged_attention_decode`` and the
quantized-page arguments are not ported yet (ROADMAP.md B: kernels 9, 10).
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    gather_paged_kv, ragged_paged_attention,
    ragged_paged_attention_plain as ragged_attention_xla)

__all__ = ["gather_paged_kv", "ragged_attention_xla",
           "paged_attention_ragged"]


def paged_attention_ragged(q, k_cache, v_cache, block_tables, rows, valids,
                           block_size: int, scale: Optional[float] = None):
    """Mixed prefill/decode attention over a paged cache (public op).

    ``q`` packed ``[t, heads, d]``; ``k_cache``/``v_cache`` flat
    ``[num_blocks*block_size, kv, d]``; ``block_tables [max_seqs, width]``;
    ``rows``/``valids [t]``. The ragged paged-attention kernel on CUDA,
    its plain twin (:func:`ragged_attention_xla`) on CPU. Index arrays are
    cast to int32 on the query's device.
    """
    dev = q.device

    def idx(a):
        return torch.as_tensor(a, device=dev).to(torch.int32).contiguous()

    return ragged_paged_attention(q.contiguous(), k_cache, v_cache,
                                  idx(block_tables), idx(rows), idx(valids),
                                  block_size, scale)
