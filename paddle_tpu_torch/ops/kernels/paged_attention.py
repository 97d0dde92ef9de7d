"""Paged decode attention: CUDA kernel ``csrc/paged_attention.cu`` (the
split-context family of ``csrc/ragged.cuh`` instantiated for decode only)
and its plain twin.

Port of ``paddle_tpu/ops/pallas/paged_attention.py``. One decode token per
sequence: ``q [b, hq, d]`` over a flat paged cache ``[num_blocks *
block_size, kv, d]`` (one layer), ``block_tables [b, max_blocks]`` int32 and
``seq_lens [b]`` int32, the valid cached tokens of each sequence including
the one just written. The eager engine calls it in every attention layer of
every decode step. The kernel takes every head dim that is a multiple of 16
up to 256: it is built at a padded head dim of 64, 128 or 256 and masks the
columns past the real one. The function is the ragged op's decode special
case (``rows = arange(b)``, ``valids = seq_lens``), and the kernel is #8's
family planned for single-token tiles: a sequence's keys are cut into splits
of :data:`SPLIT_KEYS <.ragged_paged_attention.SPLIT_KEYS>`, whose partials a
second launch merges in scratch behind the output
(:func:`.ragged_paged_attention.empty_out`). A row's bits are those of the
same row in #8's call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.ops.kernels import _launch
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as _ragged
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import gather_paged_kv

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "eligible", "launches"]

#: kernel launches made by :func:`paged_decode_attention` (never by the twin)
launches = 0

_PAIRS = {(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
          (torch.bfloat16, torch.bfloat16)}


def eligible(q_shape, kv_heads: int, head_dim: int) -> bool:
    """Whether the kernel takes this shape (the reference's ``eligible``
    with the port's limits): a head_dim that is a multiple of 16 up to 256
    and whole GQA groups of at most 32 query heads."""
    _, hq, _ = q_shape
    return (_launch.head_dim_bucket(head_dim) != 0 and hq % kv_heads == 0
            and hq // kv_heads <= 32)


def paged_decode_attention_plain(q, k_cache, v_cache, block_tables,
                                 seq_lens, block_size: int,
                                 scale: Optional[float] = None):
    """The reference's composed decode attention
    (``inference/attention.py:69-87``): gather each sequence's pages, fp32
    scores with GQA folded in, positions at or past ``seq_lens[b]`` masked,
    softmax, PV. One deliberate difference, as in the ragged twin: a row
    with ``seq_lens == 0`` comes out exactly 0, as the kernel's does (and
    the TPU kernel's), instead of the composed path's uniform average over
    masked columns."""
    b, hq, d = q.shape
    kv = k_cache.shape[-2]
    k = gather_paged_kv(k_cache, block_tables, block_size).float()  # b c kv d
    v = gather_paged_kv(v_cache, block_tables, block_size).float()
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, kv, hq // kv, d)
    scores = torch.einsum("bkgd,bckd->bkgc", qg, k) * s
    ctx = k.shape[1]
    lens = seq_lens.to(q.device)
    visible = torch.arange(ctx, device=q.device)[None, :] < lens[:, None]
    scores = scores.masked_fill(~visible[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", probs, v).reshape(b, hq, d)
    out = out * (lens > 0)[:, None, None]
    return out.to(q.dtype)


def paged_decode_attention(q, k_cache, v_cache, block_tables, seq_lens,
                           block_size: int, scale: Optional[float] = None):
    """Decode attention over a paged cache; returns ``[b, hq, d]`` in q's
    dtype. CPU tensors take the plain twin (differentiable); CUDA tensors
    launch the kernel, which has no backward: a query that requires grad
    is refused, as is a shape :func:`eligible` refuses."""
    global launches
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_cache, v_cache,
                                            block_tables, seq_lens,
                                            block_size, scale)
    if torch.is_grad_enabled() and q.requires_grad:
        raise ValueError("paged_decode_attention: the kernel is "
                         "inference-only (no backward); call it under "
                         "torch.no_grad() or with a query that does not "
                         "require grad")
    dev = _launch.check_cuda("paged_decode_attention", q, k_cache, v_cache,
                             block_tables, seq_lens)
    b, hq, d = q.shape
    hkv = k_cache.shape[1]
    _launch.require(
        k_cache.dim() == 3 and k_cache.shape == v_cache.shape
        and k_cache.shape[2] == d and k_cache.shape[0] % block_size == 0,
        f"paged_decode_attention: caches {tuple(k_cache.shape)} / "
        f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)} and "
        f"block_size {block_size}")
    _launch.require(eligible(q.shape, hkv, d),
                    f"paged_decode_attention: q {tuple(q.shape)} over {hkv} "
                    f"kv heads (needs a head_dim that is a multiple of 16 in "
                    f"16..256 and whole groups of at most 32 query heads)")
    _launch.require((q.dtype, k_cache.dtype) in _PAIRS
                    and v_cache.dtype == k_cache.dtype,
                    f"paged_decode_attention: q {q.dtype} over pages "
                    f"{k_cache.dtype} is not supported")
    for name, ix in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        _launch.require(ix.dtype == torch.int32,
                        f"paged_decode_attention: {name} must be int32")
    _launch.require(block_tables.dim() == 2 and block_tables.shape[0] == b
                    and seq_lens.shape == (b,),
                    "paged_decode_attention: tables [b, max_blocks], "
                    "seq_lens [b]")
    _launch.require(k_cache.data_ptr() % 16 == 0
                    and v_cache.data_ptr() % 16 == 0,
                    "paged_decode_attention: pages must be 16-byte aligned")
    if q.data_ptr() % 16:   # the kernel reads q rows in 8- or 16-byte vectors
        q = q.clone()
    out = _ragged.empty_out(q, block_tables.shape[1], block_size)
    _launch.launch("ptt_paged_decode_attn", q.data_ptr(), k_cache.data_ptr(),
                   v_cache.data_ptr(), block_tables.data_ptr(),
                   seq_lens.data_ptr(), out.data_ptr(), b, hq, hkv, d,
                   block_size, block_tables.shape[1],
                   float(scale if scale is not None else 1.0 / math.sqrt(d)),
                   _launch.DTYPE_CODE[q.dtype],
                   _launch.DTYPE_CODE[k_cache.dtype], _launch.stream_of(dev))
    launches += 1
    return out
