"""RMSNorm, composed (port of ``paddle_tpu/nn/functional/norm.py``).

This is the reference's composed path, dtype rules included: statistics
in fp32, the normalized row cast back to ``x``'s dtype, THEN multiplied
by the weight — so a bf16 ``x`` with an fp32 weight promotes to fp32.
The compiled decode step uses it (as the JAX step uses the same math,
``decode_step._rms``). The model's layers go through
:func:`paddle_tpu_torch.incubate.nn.functional.fused_rms_norm`, whose
kernel returns ``x``'s dtype instead (see ROADMAP.md section C).
"""

from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6):
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
