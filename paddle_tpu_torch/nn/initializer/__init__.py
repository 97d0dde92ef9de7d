"""Parameter initializers (port of ``paddle_tpu/nn/initializer``; only
``Normal``, ``Constant`` and ``XavierUniform`` are on the ported path)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["Normal", "Constant", "XavierUniform"]


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


class XavierUniform:
    """Draws a 2-D ``[in, out]`` weight from U(-limit, limit), ``limit =
    sqrt(6 / (in + out))``, in fp32 and then cast, with an explicit
    generator (the reference's default ``XavierUniform()``)."""

    def __call__(self, shape: Sequence[int], dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        if len(shape) != 2:
            raise NotImplementedError(
                "XavierUniform is ported for 2-D weights only "
                "(ROADMAP.md A.2)")
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        out.uniform_(-limit, limit, generator=generator)
        return out.to(dtype)
