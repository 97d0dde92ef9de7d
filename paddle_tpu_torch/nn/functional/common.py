"""Linear algebra and attention (port of
``paddle_tpu/nn/functional/common.py``, the parts on the ported path).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["matmul", "linear", "scaled_dot_product_attention"]


def _sdpa_math(q, k, v, mask=None, is_causal: bool = False):
    """The reference's composed attention core over ``[batch, seq, heads,
    head_dim]``: GQA kv-head repeat, fp32 scores, an optional boolean or
    additive mask, top-left causal mask, softmax cast to q's dtype, PV.
    Plain PyTorch on any device; the flash kernel's twin
    (``ops/kernels/flash_attention.flash_attention_plain``) is this math
    plus the log-sum-exp."""
    sq, d = q.shape[1], q.shape[3]
    sk, hk = k.shape[1], k.shape[2]
    if q.shape[2] != hk:
        rep = q.shape[2] // hk
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(qt.float(), kt.float().transpose(-1, -2))
    scores = scores / math.sqrt(d)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, -1e30)
        else:
            scores = scores + mask.float()
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=scores.device).tril()
        scores = scores.masked_fill(~keep, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return matmul(probs, vt).transpose(1, 2)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` under JAX's type promotion: ``torch.matmul`` refuses
    mixed dtypes, while ``jnp`` promotes ``f32 @ bf16`` to f32 — the
    compiled decode step relies on that (its residual stream turns fp32
    at the first RMSNorm), so promote explicitly."""
    if x.dtype != w.dtype:
        ct = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(ct), w.to(ct)
    return x @ w


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight (+ bias)`` with Paddle's ``[in, out]`` weight."""
    y = matmul(x, weight)
    return y if bias is None else y + bias


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = False):
    """Attention on Paddle's flash layout ``[batch, seq, heads,
    head_dim]`` with GQA (``heads(query)`` a multiple of
    ``heads(key)``). Runs the flash-attention forward kernel on CUDA
    tensors and its plain PyTorch twin on CPU tensors."""
    if attn_mask is not None or (dropout_p > 0.0 and training):
        raise NotImplementedError(
            "attention masks and attention dropout are not ported yet "
            "(ROADMAP.md A.2: nn/functional)")
    from paddle_tpu_torch.incubate.nn.functional import flash_attention_impl
    return flash_attention_impl(query, key, value, is_causal=is_causal)
