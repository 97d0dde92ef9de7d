"""Fused op surface (port of
``paddle_tpu/incubate/nn/functional/fused_ops.py``).

Where the reference chose between a Pallas kernel (on TPU) and a composed
XLA path, the port has one route per device: a CUDA tensor goes through
the hand-written kernel, a CPU tensor through its plain PyTorch twin.
The kernel ops are differentiable through their autograd Functions, whose
backward is a kernel too. RoPE and SwiGLU are plain tensor code in the
reference and stay so.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch import flags
from paddle_tpu_torch.ops.kernels import flash_attention as _flash
from paddle_tpu_torch.ops.kernels import fused_block as _fb
from paddle_tpu_torch.ops.kernels import rms_norm as _rms

__all__ = ["fused_rms_norm", "fused_rotary_position_embedding", "swiglu",
           "flash_attention_impl", "fused_block", "fused_block_enabled",
           "rope_tables"]


def fused_rms_norm(x: torch.Tensor, norm_weight: torch.Tensor,
                   epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm through the RMSNorm kernels (forward, and backward under
    autograd); output in ``x``'s dtype (the TPU kernel's contract)."""
    return _rms.RMSNormFunction.apply(x, norm_weight, float(epsilon))


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


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style: bool = True,
                                    rotary_emb_base: float = 10000.0):
    """Neox-style RoPE on ``[batch, seq, heads, head_dim]`` tensors, math
    in fp32, results in each input's dtype. Returns ``(q, k, v)`` with
    ``None`` where no tensor was given; each tensor given is rotated, ``v``
    included, as in the reference.

    ``sin``/``cos`` are ``[1, max_pos, 1, head_dim]`` tables (made from
    ``rotary_emb_base`` at positions ``0..seq-1`` when not given);
    ``position_ids [batch, seq]`` picks each token's table row, so a
    serving step rotates at explicit positions; without it the tables'
    first ``seq`` rows apply."""
    if not use_neox_rotary_style:
        raise NotImplementedError("only neox-style RoPE is ported "
                                  "(ROADMAP.md A.2: fused_ops)")
    s, d = q.shape[1], q.shape[-1]
    if sin is None or cos is None:
        sin, cos = rope_tables(torch.arange(s, device=q.device), d,
                               rotary_emb_base)
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    if position_ids is not None:
        pos = position_ids.long()
        sin = sin[0, :, 0][pos][:, :, None, :]
        cos = cos[0, :, 0][pos][:, :, None, :]
    else:
        sin, cos = sin[:, :s], cos[:, :s]
    sin, cos = sin.float(), cos.float()
    return tuple(None if t is None else _rotate_neox(t, sin, cos)
                 for t in (q, k, v))


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None):
    """``silu(x) * y``; one argument splits the last axis in half."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def flash_attention_impl(query, key, value, is_causal: bool = False):
    """Flash attention on ``[b, s, h, d]`` tensors: the forward kernel,
    and the backward kernel under autograd."""
    return _flash.FlashAttentionFunction.apply(query, key, value,
                                               bool(is_causal))


def fused_block_enabled() -> bool:
    """The ``pallas_fused_block`` flag: ``auto`` takes the fused block
    (the kernel on CUDA tensors, its twin on CPU tensors) and ``on`` is
    its alias; ``off`` the composed path."""
    mode = str(flags.flag("pallas_fused_block")).lower()
    if mode not in ("on", "off", "auto"):
        raise ValueError(f"pallas_fused_block must be 'on', 'off' or "
                         f"'auto', got {mode!r}")
    return mode != "off"


def fused_block(q, k, v, resid, wn, wo, wg, wu, wd, eps: float = 1e-6):
    """The fused decoder block after QKV and RoPE (counterpart of
    ``paddle_tpu/ops/pallas/__init__.py:fused_block_pallas``): causal
    attention, o-projection and residual, RMSNorm, SwiGLU MLP and
    residual, differentiable. q, k and v are cast to the residual's
    dtype (autograd carries the cast). Raises for a shape the kernel
    cannot take; callers check ``ops.kernels.fused_block.ineligible_reason``
    first."""
    dt = resid.dtype
    return _fb.FusedBlockFunction.apply(float(eps), q.to(dt), k.to(dt),
                                        v.to(dt), resid, wn, wo, wg, wu, wd)
