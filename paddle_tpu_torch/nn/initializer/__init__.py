"""Parameter initializers (port of ``paddle_tpu/nn/initializer``; only
``Normal`` and ``Constant`` are on the ported path)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["Normal", "Constant"]


class Normal:
    """Draws from N(mean, std²) with an explicit generator."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape: Sequence[int], dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        return out.normal_(self.mean, self.std, generator=generator)


class Constant:
    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, shape: Sequence[int], dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)
