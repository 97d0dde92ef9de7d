"""The abs-max scale the quantization helpers share (port of
``abs_max_scale`` in ``paddle_tpu/quantization/observers.py``; the
observer layers around it are not ported)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["abs_max_scale"]


def abs_max_scale(x: torch.Tensor, dim: Optional[int] = None,
                  bit_length: int = 8) -> torch.Tensor:
    """Symmetric abs-max quantization scale ``absmax(x) / qmax`` in fp32,
    over ``dim`` (the reference's ``axis``; None reduces everything to a
    scalar). ``dim=0`` gives an ``[in, out]`` weight one scale per output
    channel."""
    qmax = float(2 ** (bit_length - 1) - 1)
    a = x.float().abs()
    m = a.amax() if dim is None else a.amax(dim=dim)
    return m / qmax
