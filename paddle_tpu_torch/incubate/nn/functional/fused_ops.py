"""Fused op surface (port of
``paddle_tpu/incubate/nn/functional/fused_ops.py``).

Where the reference chose between a Pallas kernel (on TPU) and a composed
XLA path, the port has one route per device: a CUDA tensor goes through
the hand-written kernel, a CPU tensor through its plain PyTorch twin.
RoPE and SwiGLU are plain tensor code in the reference and stay so.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.kernels import flash_attention as _flash
from paddle_tpu_torch.ops.kernels import rms_norm as _rms

__all__ = ["fused_rms_norm", "fused_rotary_position_embedding", "swiglu",
           "flash_attention_impl", "rope_tables"]


def fused_rms_norm(x: torch.Tensor, norm_weight: torch.Tensor,
                   epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm through the RMSNorm forward kernel; output in ``x``'s dtype
    (the TPU kernel's contract)."""
    return _rms.rms_norm(x.contiguous(), norm_weight, epsilon)


def rope_tables(positions: torch.Tensor, head_dim: int, base: float):
    """Neox-style ``(sin, cos)`` of shape ``[n, head_dim]`` for fp32
    ``positions [n]``: ``inv_freq = 1/base**(arange(0, d, 2)/d)``, the
    angle table ``outer(pos, inv_freq)`` repeated over both halves."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=positions.device)
                          / head_dim))
    freqs = positions.float()[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.sin(emb), torch.cos(emb)


def _rotate_neox(t: torch.Tensor, sin: torch.Tensor,
                 cos: torch.Tensor) -> torch.Tensor:
    tf = t.float()
    half = tf.shape[-1] // 2
    rot = torch.cat([-tf[..., half:], tf[..., :half]], dim=-1)
    return (tf * cos + rot * sin).to(t.dtype)


def fused_rotary_position_embedding(q, k=None, v=None,
                                    use_neox_rotary_style: bool = True,
                                    rotary_emb_base: float = 10000.0):
    """Neox-style RoPE on ``[batch, seq, heads, head_dim]`` tensors at
    positions ``0..seq-1``, math in fp32, results in each input's dtype.
    Returns ``(q, k, v)`` with ``None`` where no tensor was given; ``v``
    passes through untouched, as in the reference."""
    if not use_neox_rotary_style:
        raise NotImplementedError("only neox-style RoPE is ported "
                                  "(ROADMAP.md A.2: fused_ops)")
    s, d = q.shape[1], q.shape[-1]
    sin, cos = rope_tables(torch.arange(s, device=q.device), d,
                           rotary_emb_base)
    sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    return (_rotate_neox(q, sin, cos),
            None if k is None else _rotate_neox(k, sin, cos), v)


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None):
    """``silu(x) * y``; one argument splits the last axis in half."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def flash_attention_impl(query, key, value, is_causal: bool = False):
    """The flash-attention forward kernel on ``[b, s, h, d]`` tensors."""
    return _flash.flash_attention(query.contiguous(), key.contiguous(),
                                  value.contiguous(), is_causal)
